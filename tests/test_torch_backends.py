"""Settings and engine wiring of the three embedding backends, against the
JAX package: ``Settings.validate()`` gives JAX's issues for every backend and
index type, ``minilm_checkpoint`` comes from ``RAGFIN_MINILM_CHECKPOINT``,
the engine picks each backend's checkpoint as JAX's does, a loaded IVF index
keeps its saved hashed embedder, and a hashed flat engine's ``health()``
equals JAX's."""

import itertools

import numpy as np
import pytest

from ragfin_tpu.config import settings as JS
from ragfin_tpu.index.vector_index import DeviceVectorIndex as JIndex
from ragfin_tpu.index.ivf_index import IVFVectorIndex as JIVF
from ragfin_tpu.serving.engine import RagFinEngine as JEngine
from ragfin_tpu_torch.config import settings as TS
from ragfin_tpu_torch.eval.distractors import generate_distractors as t_distractors
from ragfin_tpu_torch.models.embedder import HashedEmbedder, MiniLMEmbedder, TrainedEmbedder
from ragfin_tpu_torch.serving.engine import RagFinEngine as TEngine
from ragfin_tpu.eval.distractors import generate_distractors as j_distractors
from tests._jax_fasthash import jax_native_from_port_build  # noqa: F401


@pytest.mark.parametrize(
    "backend,index_type,weight,minilm",
    list(itertools.product(("hashed", "trained", "minilm", "bogus"), ("flat", "ivf"),
                           (0.0, 0.5), (None, "some/dir"))),
)
def test_validate_equals_jax(backend, index_type, weight, minilm):
    kw = dict(default_model="fake", embed_backend=backend, index_type=index_type,
              integrity_weight=weight, minilm_checkpoint=minilm)
    assert TS.Settings(**kw).validate() == JS.Settings(**kw).validate()


def test_minilm_checkpoint_comes_from_the_environment(monkeypatch):
    monkeypatch.setenv("RAGFIN_MINILM_CHECKPOINT", "/ckpt/minilm")
    monkeypatch.setenv("RAGFIN_EMBED_BACKEND", "minilm")
    t, j = TS._from_env(), JS._from_env()
    assert t.minilm_checkpoint == j.minilm_checkpoint == "/ckpt/minilm"
    assert t.embed_backend == j.embed_backend == "minilm"
    assert TS.Settings().minilm_checkpoint is None


def _bare_engine(**settings):
    """An engine object with settings and a device, nothing built."""
    eng = TEngine.__new__(TEngine)
    eng.settings = TS.Settings(**settings)
    eng.device = "cpu"
    return eng


def test_make_embedder_picks_each_backends_checkpoint(tmp_path):
    assert _bare_engine(embed_backend="hashed")._make_embedder() is None
    trained = _bare_engine(embed_backend="trained", minilm_checkpoint=str(tmp_path))._make_embedder()
    assert isinstance(trained, TrainedEmbedder)
    minilm = _bare_engine(embed_backend="minilm", trained_checkpoint="unused",
                          minilm_checkpoint=str(tmp_path))._make_embedder()
    assert isinstance(minilm, MiniLMEmbedder) and minilm.checkpoint == str(tmp_path)
    assert minilm.pretrained is False  # an empty directory: seeded random weights
    with pytest.raises(ValueError, match="unknown embed backend"):
        _bare_engine(embed_backend="bogus")._make_embedder()


@pytest.fixture(scope="module")
def chunks():
    return j_distractors(600, seed=2), t_distractors(600, seed=2)


def test_hashed_engine_health_equals_jax(chunks):
    common = dict(default_model="fake", index_dir="", batch_queries=False,
                  embed_backend="hashed", integrity_weight=0.5)
    je = JEngine(JS.Settings(**common), chunks=chunks[0])
    te = TEngine(TS.Settings(**common), chunks=chunks[1], device="cpu")
    try:
        hj, ht = je.health(), te.health()
        assert isinstance(te.vector_index.embedder, HashedEmbedder)
        assert set(ht) == set(hj)
        assert set(ht["vector_index"]) - set(hj["vector_index"]) == {"dtype", "device"}
        for key in set(hj) - {"vector_index"}:
            assert ht[key] == hj[key], key
        assert ht["integrity_active"] is True and ht["config_issues"] == []
        te.warmup()
        q = "What was the net profit?"
        a, b = te.vector_rag.search(q, top_k=3), je.vector_rag.search(q, top_k=3)
        assert [h["id"] for h in a] == [h["id"] for h in b]
    finally:
        te.close()
        je.close()


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_loaded_ivf_keeps_its_saved_hashed_embedder(chunks, tmp_path, saver):
    from ragfin_tpu_torch.index.ivf_index import IVFVectorIndex as TIVF
    from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex as TIndex

    if saver == "jax":
        JIVF.from_dense(JIndex.build(chunks[0]), cell=64, nprobe=4).save(str(tmp_path))
    else:
        TIVF.from_dense(TIndex.build(chunks[1], device="cpu"), cell=64, nprobe=4).save(str(tmp_path))
    # The settings name the trained backend; the saved hashed embedder wins.
    te = TEngine(TS.Settings(default_model="fake", embed_backend="trained",
                             index_dir=str(tmp_path), batch_queries=False), chunks=[], device="cpu")
    try:
        idx = te.vector_index
        assert isinstance(idx.embedder, HashedEmbedder) and idx.featurizer is not None
        hits = te.vector_rag.search("What was the net profit?", top_k=3)
        assert len(hits) == 3 and all(np.isfinite(h["score"]) for h in hits)
    finally:
        te.close()


def test_minilm_engine_builds_with_random_weights_without_a_checkpoint(chunks):
    settings = TS.Settings(default_model="fake", index_dir="", batch_queries=False,
                           embed_backend="minilm")
    assert settings.validate() == ["embed_backend=minilm without minilm_checkpoint (random init)"]
    te = TEngine(settings, chunks=chunks[1][:40], device="cpu")
    try:
        emb = te.vector_index.embedder
        assert isinstance(emb, MiniLMEmbedder) and emb.state_dict()["pretrained"] is False
        assert len(te.vector_rag.search("net profit", top_k=2)) == 2
    finally:
        te.close()
