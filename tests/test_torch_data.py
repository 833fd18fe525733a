"""Corpus loading, chunking, snapshots and the PDF extractor: the port's
copies against the JAX package's modules on the same generated input.

The raw statements come from ``ragfin_tpu_torch.eval.statements`` (a seeded
``extract_data`` tree with the three statement roles the chunker keys on);
the PDF is written by the test itself with uncompressed text operators.
Everything here is host code, so records and reports must be equal, not close.
"""

import json

import pytest

from ragfin_tpu.data import chunker as j_chunker
from ragfin_tpu.data import loader as j_loader
from ragfin_tpu.data import pdf_extractor as j_pdf
from ragfin_tpu_torch.data import chunker as t_chunker
from ragfin_tpu_torch.data import loader as t_loader
from ragfin_tpu_torch.data import pdf_extractor as t_pdf
from ragfin_tpu_torch.eval.statements import quarter_statements, write_extract_data


def _dump(records):
    return [r.model_dump() for r in records]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("extract_data")
    write_extract_data(str(root), seed=5)
    write_extract_data(str(root), seed=6, prefix="hdfc")
    return str(root)


def test_generated_tree_has_the_three_roles(tree):
    import numpy as np

    files = quarter_statements(np.random.default_rng(0), "Q3_FY2024")
    roles = t_chunker.classify_quarterly_files(files.values())
    assert roles["fin"] is files["financial_results"]
    assert roles["segmental"] is files["segmental_results"]
    assert roles["balance"] is files["balance_sheet"]
    assert j_chunker.classify_quarterly_files(files.values()).keys() == roles.keys()


@pytest.mark.parametrize("prefix", ["icici", "hdfc", "absent"])
def test_build_corpus_equal(tree, prefix):
    got = t_loader.build_corpus(tree, company_prefix=prefix)
    want = j_loader.build_corpus(tree, company_prefix=prefix)
    assert _dump(got) == _dump(want)
    assert len(got) == (0 if prefix == "absent" else 16)
    if got:
        assert {c.chunk_type for c in got} == {
            "profitability_analysis", "balance_sheet_analysis", "financial_ratios", "segment_analysis",
        }
        assert all(c.id.startswith(prefix + "_") for c in got)


@pytest.mark.parametrize("period", ["Q1_FY2024", "Q4_FY2024", "Q2_FY2031", "bad"])
def test_period_keys_equal(period):
    assert t_chunker.period_keys(period) == j_chunker.period_keys(period)


def test_chunker_handles_nulls_and_missing_roles_alike(tree):
    import numpy as np

    files = quarter_statements(np.random.default_rng(1), "Q1_FY2024")
    files["segmental_results"]["consolidatedSegmentalResults"]["segmentRevenue"]["treasury"]["june2023"] = None
    del files["balance_sheet"]
    docs = list(files.values())
    got = t_chunker.create_complete_context_chunks(docs, "Q1_FY2024", id_prefix="axis")
    want = j_chunker.create_complete_context_chunks(docs, "Q1_FY2024", id_prefix="axis")
    assert _dump(got) == _dump(want) and len(got) == 3
    assert t_chunker.create_complete_context_chunks(docs[1:], "Q1_FY2024") == []


def test_snapshots_cross_packages(tree, tmp_path):
    chunks_t = t_loader.build_corpus(tree)
    chunks_j = j_loader.build_corpus(tree)
    t_loader.save_chunk_snapshot(chunks_t, str(tmp_path / "t.json"))
    j_loader.save_chunk_snapshot(chunks_j, str(tmp_path / "j.json"))
    assert json.load(open(tmp_path / "t.json")) == json.load(open(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    for path in ("t.json", "j.json"):
        got = t_loader.load_chunk_snapshot(str(tmp_path / path))
        want = j_loader.load_chunk_snapshot(str(tmp_path / path))
        assert _dump(got) == _dump(want) and len(got) == 16
        # The snapshot shape drops primary_value and company: defaults return.
        assert all(c.primary_value == 0.0 and c.company == "ICICI Bank" for c in got)


def test_chunks_to_api_equal(tree):
    got = t_loader.chunks_to_api(t_loader.build_corpus(tree))
    want = j_loader.chunks_to_api(j_loader.build_corpus(tree))
    assert _dump(got) == _dump(want)
    assert all(c.size == len(c.text) and c.type for c in got)


def _write_pdf(path, lines, array_line=None):
    """A one-page PDF whose content stream holds plain text operators."""
    ops = b"BT /F1 10 Tf 72 720 Td " + b" 0 -14 Td ".join(
        b"(" + line.encode() + b") Tj" for line in lines
    )
    if array_line:
        ops += b" 0 -14 Td " + array_line
    ops += b" ET"
    objs = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] /Contents 4 0 R "
        b"/Resources << /Font << /F1 5 0 R >> >> >>",
        b"<< /Length %d >>\nstream\n" % len(ops) + ops + b"\nendstream",
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
    ]
    out = b"%PDF-1.4\n"
    for i, obj in enumerate(objs, 1):
        out += b"%d 0 obj\n" % i + obj + b"\nendobj\n"
    out += b"trailer\n<< /Root 1 0 R /Size 6 >>\n%%EOF\n"
    with open(path, "wb") as f:
        f.write(out)


def test_extract_report_equal_on_a_written_pdf(tmp_path):
    path = str(tmp_path / "hdfc_consolidated_q1.pdf")
    _write_pdf(
        path,
        [
            "HDFC Bank Limited",
            "CONSOLIDATED FINANCIAL RESULTS FOR THE QUARTER",
            "(Rs. in crore)",
            "Total income 42,569.10 38,770.25",
            "Net profit for the period 8,471.00 7,284.50",
            r"Provisions \(other than tax\) 1,204.00 (310.50)",
        ],
        array_line=b"[(Interest )-250(earned 34,055.00 30,100.75)] TJ",
    )
    got, want = t_pdf.extract_report(path), j_pdf.extract_report(path)
    assert got == want
    assert got["char_count"] > 100 and len(got["lineItems"]) >= 3
    assert "Interest earned 34,055.00" in got["text"]
    assert t_pdf.extract_text(path) == j_pdf.extract_text(path)


def test_content_stream_cases_equal():
    cases = [
        (b"BT /F1 10 Tf (Hello) Tj 0 -12 Td (World 1,234) Tj ET", {}),
        (b"BT [(Net )-250(Profit)] TJ ET", {}),
        (rb"BT (a\(b\)c\\d\151) Tj ET", {}),
    ]
    for content, fonts in cases:
        assert t_pdf.extract_stream_text(content, fonts) == j_pdf.extract_stream_text(content, fonts)
    tf = t_pdf.Font(two_byte=True, cmap={0x0041: "N", 0x0042: "P"})
    jf = j_pdf.Font(two_byte=True, cmap={0x0041: "N", 0x0042: "P"})
    content = b"BT /F2 8 Tf <00410042> Tj ET"
    assert t_pdf.extract_stream_text(content, {b"F2": tf}) == \
        j_pdf.extract_stream_text(content, {b"F2": jf}) == "NP"
    for name in ("five", "five.tab", "uni00A0", "f_f", "unknownglyph"):
        assert t_pdf.glyph_to_unicode(name) == j_pdf.glyph_to_unicode(name)
    text = "Total income 42,569.10 38,770.25\nNet profit (1,200.5) 300\nno numbers here"
    assert t_pdf.parse_line_items(text) == j_pdf.parse_line_items(text)
    for head in ("CONSOLIDATED SEGMENTAL RESULTS", "standalone balance sheet", "nothing"):
        assert t_pdf.detect_report_type(head) == j_pdf.detect_report_type(head)
