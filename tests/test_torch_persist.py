"""Flat-index persistence across the two packages.

An index over 200 generated filings, embedded once with the committed trained
encoder, is saved by ``ragfin_tpu`` and loaded by ``ragfin_tpu_torch`` and the
reverse, as f32, bf16 and int8. Both sides then search the same query
embeddings: ids must be equal, scores within 1e-6 (f32 and int8, whose order
is repaired exactly in f32 on the host) or 1e-2 (bf16: XLA and torch
accumulate the bf16 products differently). ``stats()`` must agree apart from
the port's ``device`` entry. An int8 index saves its f32 shadow rows, not the
dequantised matrix: after a reload they equal the original embeddings within
2e-7 (both packages normalise the loaded rows once more, which moves the last
bit), where int8 rounding would move them by about 1e-3.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from ragfin_tpu.eval.distractors import generate_distractors as j_generate
from ragfin_tpu.index.vector_index import DeviceVectorIndex as JIndex
from ragfin_tpu.models.embedder import TrainedEmbedder as JEmbedder
from ragfin_tpu.utils import indexio as j_indexio
from ragfin_tpu_torch.eval.distractors import generate_distractors as t_generate
from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex as TIndex
from ragfin_tpu_torch.models.embedder import TrainedEmbedder as TEmbedder
from ragfin_tpu_torch.utils import indexio as t_indexio

N = 200
SEED = 11
SHADOW_TOL = 2e-7
TOL = {"float32": 1e-6, "bfloat16": 1e-2, "int8": 1e-6}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}


@pytest.fixture(scope="module")
def corpus():
    jc, tc = j_generate(N + 8, seed=SEED), t_generate(N + 8, seed=SEED)
    embedder = JEmbedder()
    emb = np.asarray(embedder.encode_texts([c.text for c in jc[:N]]), np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    rng = np.random.default_rng(SEED)
    queries = emb[rng.integers(0, N, 12)] + 0.05 * rng.standard_normal((12, emb.shape[1]))
    queries = (queries / np.linalg.norm(queries, axis=1, keepdims=True)).astype(np.float32)
    return {"j": jc, "t": tc, "emb": emb, "queries": queries, "embedder": embedder}


def _jax_index(corpus, dtype):
    idx = JIndex(corpus["emb"], corpus["j"][:N], dtype=JDTYPE[dtype], normalize=False)
    idx.embedder = corpus["embedder"]
    return idx


def _torch_index(corpus, dtype):
    idx = TIndex(corpus["emb"], corpus["t"][:N], dtype=dtype, normalize=False, device="cpu")
    idx.embedder = TEmbedder(device="cpu")
    return idx


def _search(index, queries, k=10):
    s, i = index.search_embeddings(queries, top_k=k)
    return np.asarray(s, np.float32), np.asarray(i)


def _assert_same_search(a, b, queries, dtype):
    sa, ia = _search(a, queries)
    sb, ib = _search(b, queries)
    assert np.array_equal(ia, ib)
    np.testing.assert_allclose(sa, sb, rtol=0, atol=TOL[dtype])


def _stats(index):
    out = dict(index.stats())
    out.pop("device", None)  # the port's extra entry
    return out


@pytest.fixture
def no_native_library(monkeypatch):
    """Force the port's copy of indexio onto its numpy route."""
    monkeypatch.setattr(t_indexio, "_lib", None)
    monkeypatch.setattr(t_indexio, "_load_attempted", True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_jax_saved_index_loads_in_the_port(corpus, tmp_path, dtype):
    jidx = _jax_index(corpus, dtype)
    jidx.save(str(tmp_path))
    loaded = TIndex.load(str(tmp_path), device="cpu")
    assert loaded.n == N and loaded.quantized == (dtype == "int8")
    assert str(loaded.matrix_t.dtype) == f"torch.{dtype}"
    assert _stats(loaded) == _stats(jidx)
    assert [r.model_dump() for r in loaded.records] == [r.model_dump() for r in jidx.records]
    assert isinstance(loaded.embedder, TEmbedder) and loaded.embedder.device.type == "cpu"
    _assert_same_search(jidx, loaded, corpus["queries"], dtype)
    if dtype == "int8":
        np.testing.assert_allclose(loaded._exact_rows, corpus["emb"], rtol=0, atol=SHADOW_TOL)
        assert np.array_equal(np.asarray(jidx.matrix_t), loaded.matrix_t.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_port_saved_index_loads_in_jax(corpus, tmp_path, dtype):
    tidx = _torch_index(corpus, dtype)
    tidx.save(str(tmp_path))
    meta = json.load(open(tmp_path / "index.json"))
    assert meta["dtype"] == dtype and meta["embedder"]["backend"] == "trained"
    assert (tmp_path / "matrix.rgfi").exists() == t_indexio.available()
    loaded = JIndex.load(str(tmp_path))
    assert loaded.n == N and str(loaded.matrix_t.dtype) == dtype
    assert _stats(loaded) == _stats(tidx)
    assert isinstance(loaded.embedder, JEmbedder)
    _assert_same_search(loaded, tidx, corpus["queries"], dtype)
    if dtype == "int8":
        np.testing.assert_allclose(loaded._exact_rows, corpus["emb"], rtol=0, atol=SHADOW_TOL)
    # And the port loads its own file back.
    again = TIndex.load(str(tmp_path), device="cpu")
    assert _stats(again) == _stats(tidx)
    _assert_same_search(again, tidx, corpus["queries"], dtype)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_numpy_route_without_the_native_library(corpus, tmp_path, no_native_library, dtype):
    assert not t_indexio.available()
    tidx = _torch_index(corpus, dtype)
    tidx.save(str(tmp_path))
    assert (tmp_path / "matrix.npz").exists() and not (tmp_path / "matrix.rgfi").exists()
    _assert_same_search(JIndex.load(str(tmp_path)), tidx, corpus["queries"], dtype)
    _assert_same_search(TIndex.load(str(tmp_path), device="cpu"), tidx, corpus["queries"], dtype)


def test_indexio_files_cross_packages(corpus, tmp_path, monkeypatch):
    emb = corpus["emb"]
    if t_indexio.available():
        t_indexio.write_array(str(tmp_path / "t.rgfi"), emb)
        assert np.array_equal(j_indexio.read_array(str(tmp_path / "t.rgfi")), emb)
        j_indexio.write_array(str(tmp_path / "j.rgfi"), emb)
        assert np.array_equal(t_indexio.read_array(str(tmp_path / "j.rgfi")), emb)
    monkeypatch.setattr(t_indexio, "_lib", None)
    monkeypatch.setattr(t_indexio, "_load_attempted", True)
    t_indexio.write_array(str(tmp_path / "n.rgfi"), emb)  # writes n.rgfi.npy
    assert (tmp_path / "n.rgfi.npy").exists()
    assert np.array_equal(t_indexio.read_array(str(tmp_path / "n.rgfi")), emb)
    assert np.array_equal(j_indexio.read_array(str(tmp_path / "n.rgfi")), emb)
    with pytest.raises(t_indexio.IndexIOError):
        t_indexio.read_array(str(tmp_path / "missing.rgfi"))


def test_corrupted_rgfi_raises_in_both(corpus, tmp_path):
    if not t_indexio.available():
        pytest.skip("the native library is not built")
    _torch_index(corpus, "float32").save(str(tmp_path))
    path = tmp_path / "matrix.rgfi"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(t_indexio.IndexIOError, match="checksum"):
        TIndex.load(str(tmp_path), device="cpu")
    with pytest.raises(j_indexio.IndexIOError, match="checksum"):
        JIndex.load(str(tmp_path))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_extended_with_frozen_embedder_equals_jax(corpus, dtype):
    new_j, new_t = corpus["j"][N:], corpus["t"][N:]
    jidx = _jax_index(corpus, dtype)
    tidx = _torch_index(corpus, dtype)
    tidx.embedder = corpus["embedder"]  # the same new embeddings on both sides
    jext = jidx.extended_with(new_j, refit=False)
    text = tidx.extended_with(new_t, refit=False)
    assert text.n == jext.n == N + 8 and text.quantized == jext.quantized
    assert text.embedder is corpus["embedder"] and text.device.type == "cpu"
    assert [r.id for r in text.records] == [r.id for r in jext.records]
    np.testing.assert_array_equal(
        np.asarray(jext.matrix_t.astype(jnp.float32)), text.matrix_t.float().numpy()
    )
    if dtype == "int8":
        assert np.array_equal(text._exact_rows, jext._exact_rows)
        assert np.array_equal(text._exact_rows[:N], corpus["emb"])
    _assert_same_search(jext, text, corpus["queries"], dtype)
    assert text.extended_with(new_t[:0]).n == N + 8  # refit changes nothing for this embedder


def test_moved_checkpoint_falls_back_to_the_packaged_one(corpus, tmp_path):
    _torch_index(corpus, "float32").save(str(tmp_path))
    meta = json.load(open(tmp_path / "index.json"))
    meta["embedder"]["checkpoint"] = str(tmp_path / "moved_away")
    json.dump(meta, open(tmp_path / "index.json", "w"))
    loaded = TIndex.load(str(tmp_path), device="cpu")
    assert os.path.exists(os.path.join(loaded.embedder.checkpoint, "config.json"))


def test_hashed_branches_raise(corpus, tmp_path):
    """The hashed and minilm branches load (tests/test_torch_hashed_index.py
    and tests/test_torch_minilm_hf.py hold them to JAX); what still raises
    is what raises in JAX: a tuned encoder whose table file is gone, and an
    insert into an index without an embedder."""
    hashed = JIndex.build(corpus["j"][:24])  # the JAX default: featurizer + bag encoder
    hashed.save(str(tmp_path / "hashed"))
    loaded = TIndex.load(str(tmp_path / "hashed"), device="cpu")
    assert loaded.embedder.backend == "hashed" and loaded.featurizer.n_docs == 24
    meta = json.load(open(tmp_path / "hashed" / "index.json"))
    meta["encoder"]["tuned"] = True
    json.dump(meta, open(tmp_path / "hashed" / "index.json", "w"))
    with pytest.raises(ValueError, match="tuned"):
        TIndex.load(str(tmp_path / "hashed"), device="cpu")
    tidx = _torch_index(corpus, "float32")
    tidx.save(str(tmp_path / "minilm"))
    meta = json.load(open(tmp_path / "minilm" / "index.json"))
    meta["embedder"] = {"backend": "minilm", "checkpoint": None}
    json.dump(meta, open(tmp_path / "minilm" / "index.json", "w"))
    assert TIndex.load(str(tmp_path / "minilm"), device="cpu").embedder.pretrained is False
    tidx.embedder = None
    with pytest.raises(ValueError, match="no embedder"):
        tidx.extended_with(corpus["t"][N:])
