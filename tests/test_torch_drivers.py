"""The port's drivers outside the package, on the CPU (RAGFIN_DEVICE=cpu).

- ``scripts/serving_concurrent_torch.py``: its measuring loop against the
  vector adapter -> MCP client -> MCP server -> VectorRAG -> batcher stack
  over a generated ``extract_data`` tree and 2,000 distractors: two clients
  for about 2 s, no errors, batcher counters read; before it, every hit over
  HTTP equals the engine object's for the same question (ids and scores
  within 1e-5), and so does every response under load (ids outside tie
  bands of 1e-5). The script's own ``main`` runs once, back to back.
- ``scripts/trained_eval_torch.py`` and ``scripts/distractor_eval_torch.py``:
  each script's report against what the JAX harness functions
  (``evaluate_retrieval``, ``tie_aware_agreement``) give on the same corpus,
  questions and embeddings. The trained eval shares the slab cache: the test
  writes the distractors' slabs (the 16 real chunks' encodings, perturbed,
  with bitwise-duplicate rows) and the script encodes the real chunks itself;
  queries are encoded once by the port's encoder for both packages. The
  distractor eval's JAX index holds the port's matrix with JAX's own fitted
  featurizer and bag encoder. A question whose hits differ must show a tie
  within 1e-5 at the k-th place, and the JAX harness scores the port's hits
  for it: the summaries are always compared. At the tests' seeds no question
  differs.
- ``examples/demo_torch.py`` as a subprocess: exit 0.
"""

import http.client
import json
import os
import subprocess
import sys
from urllib.parse import urlsplit

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragfin_tpu.data.loader import build_corpus as j_build_corpus
from ragfin_tpu.eval.distractors import generate_distractors as j_distractors
from ragfin_tpu.eval.harness import evaluate_retrieval as j_evaluate
from ragfin_tpu.eval.harness import tie_aware_agreement as j_tie_aware
from ragfin_tpu.eval.datasets import load_holdout_phrasings as j_holdout
from ragfin_tpu.index.vector_index import DeviceVectorIndex as JIndex
from ragfin_tpu.retrieval.queryfilter import FilteredSearch as JFiltered
from ragfin_tpu_torch.data.loader import build_corpus as t_build_corpus
from ragfin_tpu_torch.eval.distractors import generate_distractors as t_distractors
from ragfin_tpu_torch.eval.datasets import load_holdout_phrasings as t_holdout
from ragfin_tpu_torch.eval.statements import write_extract_data
from ragfin_tpu_torch.index.ivf_index import IVFVectorIndex as TIVF
from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex as TIndex
from ragfin_tpu_torch.retrieval.queryfilter import FilteredSearch as TFiltered
from tests._jax_fasthash import jax_native_from_port_build  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import distractor_eval_torch  # noqa: E402
import serving_concurrent_torch  # noqa: E402
import trained_eval_torch  # noqa: E402

TIE = 1e-5
TIMING = ("wall_s", "mean_latency_ms")


def strip(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in TIMING}


@pytest.fixture
def env(monkeypatch, tmp_path):
    """The drivers' environment: the CPU, no reference, output in tmp_path."""
    for key in ("REFERENCE_ROOT", "ARMS", "SLAB", "TRAINED_DTYPE", "ENCODE_ONLY"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("RAGFIN_DEVICE", "cpu")
    monkeypatch.setenv("EVAL_OUT", str(tmp_path))
    return monkeypatch


def generated_chunks(tmp_path, n):
    """Both packages' copies of the scripts' corpus (generated tree, seed 0,
    + n distractors, seed 1), asserted equal."""
    tree = write_extract_data(str(tmp_path / "tree"), seed=0)
    jc = j_build_corpus(tree) + j_distractors(n, seed=1)
    tc = t_build_corpus(tree) + t_distractors(n, seed=1)
    assert [c.model_dump() for c in jc] == [c.model_dump() for c in tc]
    return jc, tc


def tie_equal(label, a, b) -> bool:
    """Two hit lists of (id, score): equal ids with scores within 1e-5, or
    ids that differ only inside a tie band at the k-th place. Returns
    whether the ids differ."""
    if [i for i, _ in a] == [i for i, _ in b]:
        np.testing.assert_allclose([s for _, s in b], [s for _, s in a], atol=TIE)
        return False
    floor = min(s for _, s in a + b) - TIE
    kth = min(a[-1][1], b[-1][1])
    common = {i for i, _ in a} & {i for i, _ in b}
    for i, s in a + b:
        if i not in common:
            assert s >= floor and abs(s - kth) <= TIE, (label, i, s, kth)
    return True


def assert_same_arm(name, summary, questions_j, questions_t, j_searcher, t_searcher, k):
    """The script's summary of an arm against the JAX harness on the same
    inputs. A question whose ids differ must differ only inside a tie band
    at the k-th place; the JAX harness then scores the port's hits for that
    question, so the summaries are compared whatever ties occur. Returns the
    ids of the questions that differ."""
    differing, hits = [], {}
    for qj, qt in zip(questions_j, questions_t):
        jh = j_searcher.search_texts([qj.question], top_k=k)[0]
        th = t_searcher.search_texts([qt.question], top_k=k)[0]
        hits[qj.question] = jh
        if tie_equal((name, qj.id), [(h.id, h.score) for h in jh], [(h.id, h.score) for h in th]):
            differing.append(qj.id)
            hits[qj.question] = th

    class Replay:
        """Each question's hits as settled above."""

        def search_texts(self, queries, top_k, method="auto"):
            return [hits[q] for q in queries]

    assert strip(summary) == strip(j_evaluate(Replay(), questions_j, k=k).summary()), name
    return differing


# --- the trained eval --------------------------------------------------------

N_TRAINED = 16_368  # + 16 real chunks = 16,384: 8 IVF cells of 2048
SLAB = 16  # slab 0 is the 16 real chunks, which the script encodes itself


def test_trained_eval_against_jax(env, tmp_path):
    from ragfin_tpu_torch.models.embedder import TrainedEmbedder

    # Each question text is encoded once and then served from a cache, for
    # the script and for both packages' searches alike: the tier groups of
    # FilteredSearch re-encode a question per group, and the bf16 encoder
    # on the CPU is the slow part of this test.
    encode = TrainedEmbedder.encode_texts
    seen: dict = {}

    def cached(self, texts):
        todo = list(dict.fromkeys(t for t in texts if t not in seen))
        if todo:
            seen.update(zip(todo, encode(self, todo)))
        return np.stack([seen[t] for t in texts]) if texts else encode(self, texts)

    env.setattr(TrainedEmbedder, "encode_texts", cached)
    env.setenv("DISTRACTOR_N", str(N_TRAINED))
    env.setenv("SLAB", str(SLAB))
    env.setenv("ARMS", "pipeline,raw,ivf")
    jc, tc = generated_chunks(tmp_path, N_TRAINED)
    emb = TrainedEmbedder(batch_size=512, pad_multiple=192, device="cpu")
    real = emb.encode_texts([c.text for c in tc[:16]])
    # Distractor rows: the real rows perturbed, in groups of 4 bitwise-equal rows.
    rng = np.random.default_rng(9)
    base = real[rng.integers(0, 16, N_TRAINED // 4)] + 0.6 * rng.standard_normal(
        (N_TRAINED // 4, real.shape[1])).astype(np.float32) / np.sqrt(real.shape[1])
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    rows = np.repeat(base, 4, axis=0).astype(np.float16)
    cache = trained_eval_torch.emb_dir(N_TRAINED)
    os.makedirs(cache)
    with open(os.path.join(cache, "encoder.json"), "w") as f:
        json.dump({k: emb.meta.get(k) for k in ("steps", "final_loss", "wall_s", "seed")}, f)
    for start in range(SLAB, N_TRAINED + 16, SLAB):
        np.save(os.path.join(cache, f"slab_{start:08d}.npy"), rows[start - 16 : start - 16 + SLAB])

    report = trained_eval_torch.main()
    assert report["n_chunks"] == N_TRAINED + 16 and report["reference_root"] is None
    # The script encoded the real chunks into slab 0 and kept the rest.
    np.testing.assert_array_equal(np.load(os.path.join(cache, "slab_00000000.npy")),
                                  real.astype(np.float16))
    with open(os.path.join(str(tmp_path), f"trained_eval_torch_{N_TRAINED}.json")) as f:
        assert json.load(f)["results"].keys() == report["results"].keys()
    matrix = np.concatenate([real.astype(np.float16).astype(np.float32), rows.astype(np.float32)])

    class SharedQueries:
        """The port's query encoder for both packages."""

        backend = "trained"

        def encode_texts(self, texts):
            return emb.encode_texts(list(texts))

    jidx = JIndex(matrix, jc, dtype=jnp.float32)
    tidx = TIndex(matrix, tc, dtype="float32", device="cpu")
    jidx.embedder = tidx.embedder = SharedQueries()
    jq, tq = j_holdout(), t_holdout()
    results = report["results"]
    differing = {}
    for name, js, ts, k in (
        ("holdout_phrasings_k10_trained", JFiltered(jidx), TFiltered(tidx), 10),
        ("holdout_phrasings_k3_trained", JFiltered(jidx), TFiltered(tidx), 3),
        ("holdout_phrasings_k10_raw_trained", jidx, tidx, 10),
    ):
        differing[name] = assert_same_arm(name, results[name], jq, tq, js, ts, k)
    assert set(results) == set(differing) | {"ivf_vs_exact_overlap@10_trained"}
    assert not any(differing.values()), differing  # no tie at the k-th place at these seeds

    # IVF against the host-exact oracle, scored by JAX's tie_aware_agreement
    # on the port's IVF ids.
    ivf_out = results["ivf_vs_exact_overlap@10_trained"]
    ivf = TIVF.from_dense(tidx, cell=2048, iters=3)
    assert ivf_out["n_cells"] == ivf.ivf.n_cells == 8
    questions = [q.question for q in tq]
    qv = emb.encode_texts(questions)
    s_all = matrix @ qv.T
    exact_wide = []
    for qi in range(len(questions)):
        order = np.lexsort((np.arange(len(matrix)), -s_all[:, qi]))[:128]
        exact_wide.append([(tc[i].id, float(s_all[i, qi])) for i in order])
    curve = ivf_out["agreement_by_nprobe"]
    assert sorted(int(p) for p in curve) == [2, 8]
    for nprobe, got in curve.items():
        approx = ivf.search_texts(questions, top_k=10, nprobe=int(nprobe))
        overlap, tie_aware, trunc = j_tie_aware(
            exact_wide, [[h.id for h in hits] for hits in approx], k=10, wide=128)
        assert (got["overlap"], got["tie_aware"], got["tie_truncated"]) == (
            round(overlap, 4), round(tie_aware, 4), trunc)
    assert curve[8]["tie_aware"] == 1.0  # full probe is exact


# --- the distractor eval -----------------------------------------------------

N_HASHED = 4080  # + 16 real chunks = 4,096: the IVF arm's minimum


def test_distractor_eval_against_jax(env, tmp_path):
    env.setenv("DISTRACTOR_N", str(N_HASHED))
    env.setenv("ARMS", "base,ivf")
    report = distractor_eval_torch.main()
    with open(os.path.join(str(tmp_path), f"distractor_eval_torch_{N_HASHED}.json")) as f:
        assert json.load(f)["results"].keys() == report["results"].keys()
    assert report["n_chunks"] == N_HASHED + 16 and report["reference_root"] is None

    jc, tc = generated_chunks(tmp_path, N_HASHED)
    tidx = TIndex.build(tc, device="cpu")  # the script's own build, again
    rows = tidx.matrix_t[:, : tidx.n].T.numpy()
    j_own = JIndex.build(jc)  # JAX's fitted featurizer and bag encoder
    jidx = JIndex(rows, jc, dtype=jnp.float32, normalize=False)
    jidx.embedder, jidx.encoder, jidx.featurizer = j_own.embedder, j_own.encoder, j_own.featurizer
    jq, tq = j_holdout(), t_holdout()
    results = report["results"]
    arms = {}
    for name, js, ts, k in (
        ("holdout_phrasings_k10", JFiltered(jidx), TFiltered(tidx), 10),
        ("holdout_phrasings_k3", JFiltered(jidx), TFiltered(tidx), 3),
        ("holdout_phrasings_k10_raw_embedding", jidx, tidx, 10),
    ):
        arms[name] = assert_same_arm(name, results[name], jq, tq, js, ts, k)
    assert set(results) == set(arms) | {"ivf_vs_exact_overlap@10", "inscope_notes"}
    assert not any(arms.values()), arms  # no tie at the k-th place at these seeds

    # The IVF arm's overlap, with JAX's exact tier in the port's place.
    ivf = TIVF.from_dense(tidx, cell=2048, iters=3)
    questions = [q.question for q in tq]
    exact = jidx.search_texts(questions, top_k=10)
    curve = results["ivf_vs_exact_overlap@10"]["agreement_by_nprobe"]
    assert list(curve) == [2]
    approx = ivf.search_texts(questions, top_k=10, nprobe=2)
    overlaps = [len({h.id for h in e} & {h.id for h in a}) / len(e) for e, a in zip(exact, approx) if e]
    assert curve[2] == round(float(np.mean(overlaps)), 4) == 1.0


# --- the concurrent-load benchmark ------------------------------------------


def test_concurrent_loop_against_the_engine(env, tmp_path):
    from ragfin_tpu_torch.config.settings import Settings
    from ragfin_tpu_torch.serving.engine import RagFinEngine
    from ragfin_tpu_torch.serving.main import launch

    _, chunks = generated_chunks(tmp_path, 2000)
    engine = RagFinEngine(Settings(embed_backend="hashed", index_dir="", batch_queries=True,
                                   device="cpu"), chunks=chunks)
    servers = launch(services=("vector_mcp", "vector_adapter"),
                     ports={"vector_mcp": 0, "vector_adapter": 0}, engine=engine)
    url = f"http://127.0.0.1:{servers['vector_adapter'].port}/search"
    questions = [q.question for q in t_holdout()]
    try:
        parts = urlsplit(url)
        conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=60)
        try:
            for q in questions:  # the warm pass, one at a time
                got = serving_concurrent_torch.post(conn, parts.path, q)["results"]
                want = engine.vector_rag.search(q, 3)
                assert [h["id"] for h in got] == [h["id"] for h in want], q
                np.testing.assert_allclose([h["score"] for h in got], [h["score"] for h in want],
                                           atol=TIE)
        finally:
            conn.close()
        record: list = []
        r = serving_concurrent_torch.level(url, questions, 2, 2.0, record)
        # Every response under load against the engine object's, one at a time.
        assert len(record) == r["done"]
        want = {q: [(h["id"], h["score"]) for h in engine.vector_rag.search(q, 3)] for q in questions}
        for q, got in record:
            tie_equal(q, want[q], [(h["id"], h["score"]) for h in got])
    finally:
        for s in servers.values():
            s.stop()
        engine.close()
    assert r["errors"] == 0 and r["first_error"] is None, r
    assert r["done"] > 0 and r["qps"] > 0 and r["p95_ms"] >= r["p50_ms"] > 0
    assert r["batches"] >= 1 and r["queries"] == r["done"]
    assert 1 <= r["batch_mean"] <= 2 and r["batch_p90"] <= 2
    assert r["keep_alive"] is False  # the server answers HTTP/1.0, one connection a request
    line = serving_concurrent_torch.line(2000, r, " dtype=float32", "cpu")
    assert line.startswith("serving_concurrent N=2000 C=2 dtype=float32: ") and "errors=0" in line


def test_concurrent_main_back_to_back(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAGFIN_")}
    env.update(RAGFIN_DEVICE="cpu", SERVE_N="1000", CLIENTS="2", DURATION="1",
               SERVE_DTYPE="float32,int8", EVAL_OUT=str(tmp_path), PYTHONPATH=ROOT)
    env.pop("REFERENCE_ROOT", None)
    out = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "serving_concurrent_torch.py")],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [x for x in out.stdout.splitlines() if x.startswith("serving_concurrent")]
    assert [x.split(":")[0] for x in lines] == [
        "serving_concurrent N=1000 C=2 dtype=float32 [back-to-back]",
        "serving_concurrent N=1000 C=2 dtype=int8 [back-to-back]",
    ]
    assert all("errors=0" in x and x.endswith("[cpu]") for x in lines)
    with open(tmp_path / "probe_results_h100.log") as f:
        assert f.read().splitlines() == lines


# --- the demo ----------------------------------------------------------------


def test_demo_runs_on_the_cpu_when_asked(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAGFIN_")}
    env.update(RAGFIN_DEVICE="cpu", PYTHONPATH=ROOT)
    env.pop("REFERENCE_ROOT", None)
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "demo_torch.py")],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    for step in range(1, 7):
        assert f"=== {step}. " in out.stdout
    assert "indexed 16 chunks" in out.stdout and "recall@10 = " in out.stdout
