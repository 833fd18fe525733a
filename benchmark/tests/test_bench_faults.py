"""A run with the timed path broken underneath comes out not correct.

Each case drives a whole CPU run of a cell (the harness's look for a card
skipped) with one fault planted in the program where its answer or its
tokens are produced, and expects ``correct`` false by the cell's own limits.
"""

import numpy as np
import pytest
import torch

from benchmark import run as bench_run

from _bench_cells import RAW, SCOPED, small_cell


def _run(name):
    return bench_run.run_cell(small_cell(name), 2**31 + 21, 1.0, False, "cpu", rows=8192,
                              log=lambda *a, **k: None)


def _failing(out):
    return [k for k, v in out["checks"].items() if v["value"] > v["limit"]]


def _shift_top(fn):
    """The top answer of the first query moved to the next row."""
    def broken(*args, **kwargs):
        s, i = fn(*args, **kwargs)
        i = i.clone()
        i[..., 0, 0] = i[..., 0, 0] + 1
        return s, i
    return broken


def _drop_best(fn):
    """The int8 shortlist's best candidate of every query left out."""
    def broken(*args, **kwargs):
        s, i = fn(*args, **kwargs)
        i = i.clone()
        i[:, 0] = i[:, -1]
        return s, i
    return broken


def test_scoped_answer_altered(monkeypatch):
    from ragfin_tpu_torch.index import vector_index as vi

    monkeypatch.setattr(vi, "cosine_topk_dense_multi", _shift_top(vi.cosine_topk_dense_multi))
    monkeypatch.setattr(vi, "cosine_topk_dense", _shift_top(vi.cosine_topk_dense))
    out = _run(SCOPED)
    assert not out["correct"] and _failing(out)


def test_raw_answer_altered(monkeypatch):
    from ragfin_tpu_torch.index import vector_index as vi

    monkeypatch.setattr(vi, "cosine_topk_fused_int8", _drop_best(vi.cosine_topk_fused_int8))
    out = _run(RAW)
    assert not out["correct"] and _failing(out)


@pytest.mark.parametrize("name", [SCOPED, RAW])
def test_token_altered(monkeypatch, name):
    from ragfin_tpu_torch.models.tokenizer import WordPieceTokenizer

    encode = WordPieceTokenizer.encode

    def broken(self, text):
        ids = encode(self, text)
        return ids[:1] + [(ids[1] + 1) % self.vocab_size] + ids[2:]

    monkeypatch.setattr(WordPieceTokenizer, "encode", broken)
    out = _run(name)
    assert not out["correct"] and "qvec_cos_gap" in _failing(out)


@pytest.mark.parametrize("name", [SCOPED, RAW])
def test_half_the_answers_left_out(monkeypatch, name):
    from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex

    post = DeviceVectorIndex._postprocess_device_hits

    def broken(self, queries, *args, **kwargs):
        out = post(self, queries, *args, **kwargs)
        return [hits if i % 2 else [] for i, hits in enumerate(out)]

    monkeypatch.setattr(DeviceVectorIndex, "_postprocess_device_hits", broken)
    out = _run(name)
    assert not out["correct"] and "missing" in _failing(out)


def test_unbroken_runs_are_correct():
    for name in (SCOPED, RAW):
        out = _run(name)
        assert out["correct"], (name, out["checks"])
