"""The plain reference agrees with the program on the CPU at small sizes."""

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.lib import judge, spec, weights
from benchmark.reference import encoder, search
from benchmark.reference.tokenizer import Tokenizer

from _bench_cells import RAW, SCOPED, small_cell

TEXTS = ["What was ICICI Bank's net profit in Q4 FY2025?", "HDFC Bank EPS",
         "Show the most recent deposits of Axis Bank.", "₹1,234.5 crore, 12.3% YoY in 2024"]


@pytest.mark.parametrize("name", [SCOPED, RAW])
def test_tokenizer_matches_the_program(name):
    config = spec.cell(name)["config"]
    ours = judge.tokenizer_for(config, spec.ROOT)
    if config["deployment"].get("checkpoint"):
        from ragfin_tpu_torch.models.domain_encoder import load_encoder_checkpoint

        theirs = load_encoder_checkpoint(f"{spec.ROOT}/{config['deployment']['checkpoint']}")[1]
    else:
        from ragfin_tpu_torch.models.tokenizer import WordPieceTokenizer

        theirs = WordPieceTokenizer(max_len=256)
    for t in TEXTS:
        assert ours.encode(t) == theirs.encode(t)


def test_encoder_matches_the_program_in_float32():
    from ragfin_tpu_torch.models.minilm import MiniLMConfig, MiniLMEncoder
    from benchmark.lib.system import _minilm_state

    config = spec.cell(RAW)["config"]
    arch = dict(config, num_hidden_layers=2)
    w = weights.seeded(arch, 5, "cpu")
    model = MiniLMEncoder(MiniLMConfig(num_layers=2, dtype=torch.float32))
    model.load_state_dict(_minilm_state(w))
    tok = Tokenizer(max_len=256)
    ids = [tok.encode(t) for t in TEXTS]
    s = max(map(len, ids))
    pad = torch.tensor([i + [0] * (s - len(i)) for i in ids])
    mask = torch.tensor([[1] * len(i) + [0] * (s - len(i)) for i in ids])
    with torch.no_grad():
        theirs = model(pad, mask)
    ours = encoder.encode(w, arch, ids, "cpu")
    assert torch.allclose(ours, theirs, atol=2e-6)


def test_int8_semantics_match_the_program():
    from ragfin_tpu_torch.index.vector_index import _exact_rerank_host
    from ragfin_tpu_torch.ops.quantize import quantize_corpus_t
    from ragfin_tpu_torch.ops.topk import fused_topk_int8_plain

    g = torch.Generator().manual_seed(3)
    x = search.unit_rows(torch.randn(5000, 384, generator=g))
    q = search.unit_rows(torch.randn(7, 384, generator=g))
    c8, scale = quantize_corpus_t(x.T.contiguous())
    _, short = fused_topk_int8_plain(q, c8, scale, 16, n_valid=5000)
    p_s, p_i = _exact_rerank_host(q.numpy(), short.numpy(), x.numpy(), 10)
    r_s, r_i = search.int8_topk(x, q, torch.arange(5000), 10, 16)
    assert np.array_equal(p_i, r_i.numpy())
    assert np.allclose(p_s, r_s.numpy(), atol=1e-6)


@pytest.mark.parametrize("name", [SCOPED, RAW])
def test_cell_is_correct_at_a_small_size(name):
    out = bench_run.run_cell(small_cell(name), 2**31 + 5, 1.0, False, "cpu", rows=8192,
                             log=lambda *a, **k: None)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    assert list(out["checks"]) == ["qvec_cos_gap", "score_err", "order_gap", "hit_gap", "scope_violations", "missing"]


def test_closing_the_system_frees_the_index():
    import gc
    import weakref

    from benchmark.lib import corpus
    from benchmark.lib.system import System

    cell = small_cell(RAW)
    layout = corpus.Layout.from_config(cell["config"]["corpus"], 4096)
    records = corpus.make_records(layout, System.record_class())
    w = weights.seeded(cell["config"], 1, "cpu")
    enabled = gc.isenabled()
    gc.disable()
    try:
        system = System(cell["config"], spec.ROOT, records, corpus.make_vectors(layout, 1, "cpu"), w,
                        cell["mix"]["entry"], "cpu")
        system.entry(["HDFC Bank EPS"], top_k=10)
        index, embedder = weakref.ref(system.index), weakref.ref(system.embedder)
        system.close()
        del system
        assert index() is None and embedder() is None
    finally:
        if enabled:
            gc.enable()
