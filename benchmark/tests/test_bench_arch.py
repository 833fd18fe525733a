"""A configuration names its encoder architecture by ``model_type``, and the
harness finds the architecture's plain reference (``reference/models/``) and
the program's parameter names (``lib/states/``) by that name.

The pins are the BERT reference's readings before its code moved behind the
lookup: the seeded weights, the reference's vectors of the four texts of
``test_bench_reference.py`` (float32 on one CPU thread, since the products'
rounding follows how the threads split them), and the FLOPs ``step_mfu``
counts.
"""

import hashlib
import os
import re
import shutil

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.lib import judge, spec, weights

from _bench_cells import RAW, SCOPED, small_cell
from test_bench_reference import TEXTS

SEEDED_WEIGHTS = "41b37becfadb4c8d677d0af6de047fe536a37d1160b5caf92960c6ca09d2b0cb"
SEEDED_VECTORS = "ffa961830a9e691b018f9e58522f27303074772ba25eb36041d57ae65ed56433"
CHECKPOINT_VECTORS = "2e106ddf5e03b35d2302e92f62e02ce6435de13814df3da6f53a6489945f1752"


def _sha(named):
    h = hashlib.sha256()
    for name, x in named:
        h.update(name.encode())
        h.update(np.ascontiguousarray(torch.as_tensor(x).numpy(), np.float32).tobytes())
    return h.hexdigest()


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _seeded_config():
    return dict(spec.cell(RAW)["config"], num_hidden_layers=2)


def test_seeded_weights_are_pinned():
    config = _seeded_config()
    w = weights.seeded(config, 5, "cpu")
    assert list(w) == [name for name, _ in spec.arch(config).shapes(config)]
    assert _sha(w.items()) == SEEDED_WEIGHTS


def test_seeded_reference_vectors_are_pinned(one_thread):
    config = _seeded_config()
    w = weights.seeded(config, 5, "cpu")
    tok = judge.tokenizer_for(config, spec.ROOT)
    vectors = spec.arch(config).encode(w, config, [tok.encode(t) for t in TEXTS], "cpu")
    assert _sha([("", vectors)]) == SEEDED_VECTORS


def test_checkpoint_reference_vectors_are_pinned(one_thread):
    config = spec.cell(SCOPED)["config"]
    w = judge.encoder_weights(config, spec.ROOT, 0, "cpu")
    tok = judge.tokenizer_for(config, spec.ROOT)
    vectors = spec.arch(config).encode(w, config, [tok.encode(t) for t in TEXTS], "cpu")
    assert _sha([("", vectors)]) == CHECKPOINT_VECTORS


@pytest.mark.parametrize("name, layers, flops", [
    (SCOPED, 4, (142_172_160, 184_694_784)),  # on test_bench_roofline's hand-worked token lists
    (RAW, 6, (213_258_240, 277_042_176)),
])
def test_matmul_flops_are_pinned(name, layers, flops):
    config = spec.cell(name)["config"]
    assert config["num_hidden_layers"] == layers
    arch = spec.arch(config)
    assert (arch.matmul_flops([10], config), arch.matmul_flops([10, 3], config)) == flops


def test_a_new_architecture_is_new_files(tmp_path, monkeypatch):
    models, states = tmp_path / "models", tmp_path / "states"
    models.mkdir()
    states.mkdir()
    shutil.copy(os.path.join(spec.MODELS_DIR, "bert.py"), models / "bert_copy.py")
    shutil.copy(os.path.join(spec.STATES_DIR, "bert.py"), states / "bert_copy.py")
    monkeypatch.setattr(spec, "MODELS_DIR", str(models))
    monkeypatch.setattr(spec, "STATES_DIR", str(states))
    cell = small_cell(RAW)
    cell["config"] = dict(cell["config"], model_type="bert_copy")
    assert spec.arch(cell["config"]).__file__ == str(models / "bert_copy.py")
    assert spec.states(cell["config"]).__file__ == str(states / "bert_copy.py")
    out = bench_run.run_cell(cell, 2**31 + 5, 1.0, False, "cpu", rows=8192, log=lambda *a, **k: None)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0


@pytest.mark.parametrize("lookup, path", [(spec.arch, "benchmark/reference/models/nonesuch.py"),
                                          (spec.states, "benchmark/lib/states/nonesuch.py")])
def test_an_unknown_model_type_names_the_missing_file(lookup, path):
    with pytest.raises(KeyError, match=re.escape(path)):
        lookup({"model_type": "nonesuch"})


def test_the_reference_refuses_an_unknown_pooling():
    config = dict(_seeded_config(), num_hidden_layers=1, pooling="max")
    with pytest.raises(ValueError, match="pooling 'max'"):
        spec.arch(config).encode(weights.seeded(config, 1, "cpu"), config, [[101, 7, 102]], "cpu")
