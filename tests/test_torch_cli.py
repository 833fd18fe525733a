"""The port's command line against the JAX package's, subcommand by
subcommand, through ``main([...])`` on one generated ``extract_data`` tree.

The port runs with ``RAGFIN_DEVICE=cpu``. Exit codes must be equal and the
printed JSON equal after dropping latencies and the port's ``device`` entry;
scores may differ by 2e-3 (the two bf16 encoder forwards, see
``tests/test_torch_engine.py``). ``build-index`` embeds with the hashed
backend in both packages, so its whole report must be equal, and each
package's saved index serves the other's ``query`` command. ``train``
fine-tunes the same projection table on the same batches: recall and F1
before are equal, after within TRAIN_AFTER_TOL.
"""

import io
import json

import pytest
import torch

from ragfin_tpu import cli as j_cli
from ragfin_tpu.config import settings as j_settings
from ragfin_tpu_torch import cli as t_cli
from ragfin_tpu_torch.config import settings as t_settings
from ragfin_tpu_torch.eval.statements import write_extract_data

SCORE_TOL = 2e-3
# After two epochs the tuned tables differ by last bits (embedding_bag's
# backward and XLA's scatter-add sum in other orders): one question of 16
# may change its hits only inside a tie band (equal at 2 and at 30 epochs
# on this tree).
TRAIN_AFTER_TOL = 1 / 16
DROPPED = {"device", "mean_latency_ms", "p50_latency_ms", "p95_latency_ms", "qps", "evaluation_date"}


def same(a, b, path="$"):
    if isinstance(a, dict) and isinstance(b, dict):
        ka, kb = set(a) - DROPPED, set(b) - DROPPED
        assert ka == kb, f"{path}: keys {sorted(ka ^ kb)} differ"
        for k in ka:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), f"{path}: lengths {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif path.endswith("score") and isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= SCORE_TOL, f"{path}: {a} != {b}"
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    write_extract_data(str(root / "extract_data"), seed=33)
    kinds = {
        "net profit": "profitability_analysis", "total customer deposits": "balance_sheet_health",
        "basic EPS": "key_ratios", "treasury segment revenue": "segment_performance",
    }
    questions = [
        {
            "id": f"q{n}_{i}", "category": kind.split("_")[0],
            "question": f"What was ICICI Bank's {topic} in Q{n} FY2024?",
            "expected_relevant_chunks": [f"icici_q{n}_fy2024_{kind}"],
            "ground_truth_answer": "", "key_supporting_facts": [],
        }
        for n in range(1, 5) for i, (topic, kind) in enumerate(kinds.items())
    ]
    (root / "qa.json").write_text(json.dumps({"questions": questions}))
    return root


@pytest.fixture(autouse=True)
def cpu_port(monkeypatch):
    """The port on the CPU, both packages' cached settings rebuilt from this
    environment and dropped again afterwards."""
    monkeypatch.setenv("RAGFIN_DEVICE", "cpu")
    monkeypatch.setenv("RAGFIN_BATCH_QUERIES", "0")
    for mod in (j_settings, t_settings):
        mod.get_config.cache_clear()
    yield
    for mod in (j_settings, t_settings):
        mod.get_config.cache_clear()


def run_both(capsys, argv_for):
    """(rc, stdout) of the JAX CLI and of the port's for argv_for(side)."""
    out = []
    for side, cli in (("j", j_cli), ("t", t_cli)):
        capsys.readouterr()
        rc = cli.main(argv_for(side))
        out.append((rc, capsys.readouterr().out))
    return out


def test_chunk_equal(tree, tmp_path, capsys):
    (rj, oj), (rt, ot) = run_both(
        capsys, lambda s: ["chunk", "--data", str(tree / "extract_data"), "--out", str(tmp_path / f"{s}.json")]
    )
    assert rj == rt == 0
    assert oj.replace("j.json", "X") == ot.replace("t.json", "X") and "wrote 16 chunks" in ot
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()


@pytest.mark.parametrize("index_type", ["flat", "ivf"])
def test_build_index_reports_the_same_shape(tree, tmp_path, capsys, index_type):
    (rj, oj), (rt, ot) = run_both(
        capsys,
        lambda s: ["build-index", "--data", str(tree / "extract_data"), "--out", str(tmp_path / s),
                   "--index-type", index_type, "--cell", "8", "--nprobe", "2"],
    )
    assert rj == rt == 0
    j, t = json.loads(oj), json.loads(ot)
    same(j, t)
    assert set(t) - set(j) <= {"device"} and t.get("device", "cpu") == "cpu"
    assert t["chunks"] == 16 and t["graph_facts"] > 16
    marker = "ivf.json" if index_type == "ivf" else "index.json"
    for side in ("j", "t"):
        assert (tmp_path / side / marker).exists() and (tmp_path / side / "graph" / "graph.json").exists()
        meta = json.load(open(tmp_path / side / marker))
        assert meta["featurizer"]["n_docs"] == 16 and meta["encoder"]["tuned"] is False
    # Each package's saved index serves both packages' query command alike.
    question = "What was ICICI Bank's net profit in Q1 FY2024?"
    for side in ("j", "t"):
        (rqj, qj), (rqt, qt) = run_both(
            capsys,
            lambda s: ["query", question, "--mode", "vector", "--data", str(tree / "extract_data"),
                       "--index", str(tmp_path / side)],
        )
        assert rqj == rqt == 0
        same(json.loads(qj), json.loads(qt))
        assert json.loads(qt)["contexts"][0]["id"] == "icici_q1_fy2024_profitability_analysis"


@pytest.mark.parametrize("mode", ["vector", "graph", "hybrid"])
def test_query_equal(tree, capsys, mode):
    (rj, oj), (rt, ot) = run_both(
        capsys,
        lambda s: ["query", "What was ICICI Bank's net profit in Q1 FY2024?", "--mode", mode, "--k", "3",
                   "--data", str(tree / "extract_data"), "--index", ""],
    )
    assert rj == rt == 0
    same(json.loads(oj), json.loads(ot))


def test_query_without_a_question(tree, capsys):
    (rj, _), (rt, _) = run_both(
        capsys, lambda s: ["query", "--data", str(tree / "extract_data"), "--index", ""]
    )
    assert rj == rt == 2


def test_query_interactive_equal(tree, capsys, monkeypatch):
    outs = []
    for cli in (j_cli, t_cli):
        monkeypatch.setattr("sys.stdin", io.StringIO("What was the basic EPS in Q3 FY2024?\nquit\n"))
        capsys.readouterr()
        rc = cli.main(["query", "--interactive", "--mode", "vector",
                       "--data", str(tree / "extract_data"), "--index", ""])
        outs.append((rc, capsys.readouterr().out))
    (rj, oj), (rt, ot) = outs
    assert rj == rt == 0
    assert oj == ot and oj.count("\nQ: ") == 5 and "Your question" in oj


@pytest.mark.parametrize("extra,want_rc", [
    ([], 0), (["--raw"], 0), (["--min-recall", "1.01"], 1), (["--k", "3", "--min-recall", "0.5"], 0),
])
def test_eval_equal(tree, tmp_path, capsys, extra, want_rc):
    (rj, oj), (rt, ot) = run_both(
        capsys,
        lambda s: ["eval", "--path", str(tree / "qa.json"), "--data", str(tree / "extract_data"),
                   "--index", "", "--summary", str(tmp_path / f"{s}.json"), *extra],
    )
    assert rj == rt == want_rc
    j, t = json.loads(oj), json.loads(ot)
    same(j, t)
    assert t["retrieval_recall"]["mean"] > 0.5
    rs_j, rs_t = (json.loads((tmp_path / f"{s}.json").read_text()) for s in ("j", "t"))
    for doc in (rs_j, rs_t):
        doc.get("system_configuration", {}).pop("system_type", None)
    same(_without_timings(rs_j), _without_timings(rs_t))


def _without_timings(doc):
    if isinstance(doc, dict):
        return {k: _without_timings(v) for k, v in doc.items()
                if "time" not in k.lower() and "latency" not in k.lower() and "qps" not in k.lower()}
    if isinstance(doc, list):
        return [_without_timings(v) for v in doc]
    return doc


def test_eval_needs_a_path(tree, capsys):
    """The JAX CLI's default eval files sit on a fixed mount of the reference
    repository; the port has no such default and says so before it builds
    anything."""
    assert t_cli.main(["eval", "--data", str(tree / "extract_data"), "--index", ""]) == 2
    assert "--path" in capsys.readouterr().err


def test_extract_pdf_equal(tmp_path, capsys):
    from test_torch_data import _write_pdf

    path = str(tmp_path / "report.pdf")
    _write_pdf(path, ["Axis Bank Limited", "STANDALONE FINANCIAL RESULTS", "Total income 1,234.50 1,100.25",
                      "Net profit for the period 300.00 250.75"])
    for extra in ([], ["--full-text"]):
        (rj, oj), (rt, ot) = run_both(capsys, lambda s: ["extract-pdf", path, *extra])
        assert rj == rt == 0 and json.loads(oj) == json.loads(ot)
        assert ("text" in json.loads(ot)) == bool(extra)


def test_train_is_parsed_and_raises(tree, monkeypatch, capsys):
    """Without a card and without RAGFIN_DEVICE=cpu, train raises before it
    trains; without --qa it says so and exits 2 (the JAX CLI's default QA
    file lies in the reference repository)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    argv = ["train", "--data", str(tree / "extract_data"), "--epochs", "2", "--k", "3",
            "--checkpoint-dir", str(tree / "ckpt_refused")]
    assert t_cli.main(argv) == 2 and "--qa" in capsys.readouterr().err
    monkeypatch.delenv("RAGFIN_DEVICE")
    t_settings.get_config.cache_clear()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cli.main(argv + ["--qa", str(tree / "qa.json")])
    assert not (tree / "ckpt_refused").exists()


def test_train_equal(tree, capsys):
    """train --epochs 2 in both CLIs over the tree's 16 chunks and QA file:
    pairs and the recall and F1 before fine-tuning equal, after within
    TRAIN_AFTER_TOL; one train-state checkpoint per package is written only
    past epoch 10, so none here."""
    (rj, oj), (rt, ot) = run_both(
        capsys,
        lambda s: ["train", "--data", str(tree / "extract_data"), "--qa", str(tree / "qa.json"),
                   "--epochs", "2", "--k", "3", "--checkpoint-dir", str(tree / f"ckpt_{s}")],
    )
    assert rj == rt == 0
    j, t = json.loads(oj), json.loads(ot)
    assert set(t) == set(j) == {"pairs", "before", "after"}
    assert t["pairs"] == j["pairs"] == 16 and t["before"] == j["before"]
    for key in ("recall", "f1"):
        assert abs(t["after"][key] - j["after"][key]) <= TRAIN_AFTER_TOL, (j, t)
    assert not (tree / "ckpt_t").exists() and not (tree / "ckpt_j").exists()


def test_bench_and_serve_are_parsed(monkeypatch):
    import runpy

    from ragfin_tpu_torch.serving import main as serving_main

    seen = {}
    monkeypatch.setattr(runpy, "run_module", lambda name, run_name: seen.update(module=name, run=run_name))
    monkeypatch.setenv("BENCH_N", "7")
    assert t_cli.main(["bench", "--n", "4096"]) == 0
    import os

    assert seen == {"module": "bench_torch", "run": "__main__"} and os.environ["BENCH_N"] == "4096"
    monkeypatch.setattr(serving_main, "main", lambda argv=None: seen.update(serve=argv))
    assert t_cli.main(["serve", "--model", "fake"]) == 0 and seen["serve"] == ["--model", "fake"]
    assert t_cli.main(["serve"]) == 0 and seen["serve"] == []


def test_same_subcommands_flags_and_defaults():
    """Every subcommand of the JAX parser exists in the port with the same
    flags and defaults (the two default paths under the reference mount are
    ``None`` in the port: it reads the mount's place from the settings)."""
    import argparse

    def spec(cli):
        captured = {}
        real = argparse.ArgumentParser.parse_args

        def grab(self, argv=None):
            captured["parser"] = self
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                cli.main([])
        finally:
            argparse.ArgumentParser.parse_args = real
        sub = next(a for a in captured["parser"]._actions if isinstance(a, argparse._SubParsersAction))
        return {
            name: {a.dest: (tuple(a.option_strings), a.default, a.nargs, tuple(a.choices or ()))
                   for a in p._actions if a.dest != "help"}
            for name, p in sub.choices.items()
        }

    j, t = spec(j_cli), spec(t_cli)
    assert set(j) == set(t) == {"chunk", "build-index", "query", "eval", "extract-pdf", "serve", "train", "bench"}
    for name in j:
        assert set(j[name]) == set(t[name]), name
        for dest, want in j[name].items():
            got = t[name][dest]
            if (name, dest) == ("train", "qa"):
                assert got[1] is None and want[1].endswith("qa_subset.json")
                got, want = got[:1] + got[2:], want[:1] + want[2:]
            assert got == want, (name, dest)
