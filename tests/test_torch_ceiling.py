"""``ops/ceiling.py:ceiling_plain`` against the Pallas ceiling probes' bodies.

The probes of ``scripts/kernel_probe.py`` are closures over fixed 1M-column
shapes inside a script, so they cannot be called at test size. Each body is
restated here in ``jnp``, line for line, and looped over the corpus tiles as
the probe's grid loops them (one ``acc`` carried from tile to tile):

- ``ceiling_parts_1m`` ``:891-912`` (``dma``, ``matmul``, row maximum) and
  ``ceiling_1m`` ``:718-730`` / ``ceiling_tiled_1m`` ``:960-972`` (row maximum
  over a flat and a tile-major corpus);
- ``ceiling_q64`` ``:1080-1107`` (``mm``, ``mask``, ``rowmax``, ``prologue``
  with the ``n_valid`` iota mask);
- ``ceiling_q1024`` ``:255-291`` (int8: ``mmint``, ``rowmaxint``, ``mm``,
  ``rowmax``, ``prologue``).

The int stages must agree bitwise; the float stages within rel 1e-5 (both
sides take f32 products of the same values on the CPU, only the order of the
sums inside a dot product differs). A card-only test holds the CUDA kernel
against the plain version at small shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragfin_tpu.ops import topk as JT
from ragfin_tpu_torch.ops import topk as TT
from ragfin_tpu_torch.ops.ceiling import (
    INT_MASK, STAGES, ceiling, ceiling_plain, corpus_xor, is_exact, ladder_stages,
)

D = 32
BN = 256
N_TILES = 5
N_PAD = BN * N_TILES
N_VALID = BN * 4 + 77  # inside the last tile
Q = 9
FLOAT_RTOL = 1e-5


def _float_inputs(seed=0, tie=False):
    rng = np.random.default_rng(seed)
    ct = rng.standard_normal((D, N_PAD)).astype(np.float32)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    if tie:
        # Two equal columns in tile 1 that hold every row's maximum: the
        # arg-maximum must be the lower one.
        ct[:, BN + 40] = ct[:, BN + 200] = 0.0
        ct[0, BN + 40] = ct[0, BN + 200] = 1e3
        q[:, 0] = np.abs(q[:, 0]) + 1.0
    # bf16 values, as the probes generate them.
    ct = np.asarray(jnp.asarray(ct).astype(jnp.bfloat16).astype(jnp.float32))
    q = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    return q, ct


def _bf16(x):
    return torch.from_numpy(np.array(x)).to(torch.bfloat16)


def _jnp_float_probe(q, ct, stage, n_valid):
    """The float probe bodies, carried over the tiles in grid order."""
    qj = jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32)
    acc = jnp.zeros((q.shape[0], 1), jnp.float32)
    for j in range(ct.shape[1] // BN):
        tile = jnp.asarray(ct[:, j * BN : (j + 1) * BN]).astype(jnp.bfloat16)
        if stage == "dma":  # kernel_probe.py:902
            acc = acc + jnp.sum(tile[0:1, 0:1].astype(jnp.float32))
            continue
        # :904 / :1089 (bf16 x bf16 has no CPU kernel in XLA: the same values in f32)
        s = jnp.dot(qj, tile.astype(jnp.float32), preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
        if stage in ("matmul", "mm"):  # :906, :1091
            acc = acc + s[:, :1]
            continue
        col0 = j * BN  # :1093-1095
        iota_row = jax.lax.broadcasted_iota(jnp.int32, (1, BN), 1)
        s = jnp.where((col0 + iota_row) < n_valid, s, JT.NEG_INF)
        if stage == "mask":  # :1097
            acc = acc + s[:, :1]
        elif stage == "rowmax":  # :908, :726, :968, :1099
            acc = acc + jnp.max(s, axis=-1, keepdims=True)
        else:  # prologue :1101-1103
            mx = jnp.max(s, axis=-1, keepdims=True)
            am = jnp.argmax(s, axis=-1).astype(jnp.float32)
            acc = acc + mx + am[:, None]
    return np.asarray(acc)[:, 0]


@pytest.mark.parametrize("stage", ["dma", "matmul", "mm", "mask", "rowmax", "prologue"])
@pytest.mark.parametrize("layout", ["flat", "tile_major"])
def test_float_stages_match_probe_bodies(stage, layout):
    q, ct = _float_inputs()
    n_valid = N_VALID if stage in ("mask", "rowmax", "prologue") else None
    want = _jnp_float_probe(q, ct, stage, N_PAD if n_valid is None else n_valid)
    corpus = _bf16(ct)
    if layout == "tile_major":
        corpus = TT.tile_corpus_t(corpus, block_n=BN)
        got = ceiling_plain(_bf16(q), corpus, stage, n_valid=n_valid)
    else:
        got = ceiling_plain(_bf16(q), corpus, stage, BN, n_valid=n_valid)
    assert got.dtype == torch.float32 and got.shape == (Q,)
    np.testing.assert_allclose(got.numpy(), want, rtol=FLOAT_RTOL, atol=1e-5)


def test_prologue_tie_takes_the_lowest_column():
    q, ct = _float_inputs(tie=True)
    want = _jnp_float_probe(q, ct, "prologue", N_PAD)
    got = ceiling_plain(_bf16(q), _bf16(ct), "prologue", BN)
    np.testing.assert_allclose(got.numpy(), want, rtol=FLOAT_RTOL)
    # With the tie resolved upward the sum would be 160 larger.
    rowmax = ceiling_plain(_bf16(q), _bf16(ct), "rowmax", BN)
    others = sum(
        int(np.argmax(q @ ct[:, j * BN : (j + 1) * BN], axis=1)[0]) for j in (0, 2, 3, 4)
    )
    assert float((got - rowmax)[0]) == pytest.approx(40 + others, abs=1e-2)


def test_fully_masked_tile_sums_to_minus_infinity():
    q, ct = _float_inputs()
    got = ceiling_plain(_bf16(q), _bf16(ct), "rowmax", BN, n_valid=BN * 2)
    want = _jnp_float_probe(q, ct, "rowmax", BN * 2)
    assert np.all(np.isneginf(got.numpy())) and np.all(np.isneginf(want))


def _int_inputs(seed=1):
    rng = np.random.default_rng(seed)
    c8 = rng.integers(-127, 128, (D, N_PAD)).astype(np.int8)
    q8 = rng.integers(-127, 127, (Q, D)).astype(np.int8)
    scales = rng.uniform(1e-3, 2e-2, (1, N_PAD)).astype(np.float32)
    return q8, c8, scales


def _jnp_int8_probe(q8, c8, scales, stage, n_valid):
    """ceiling_q1024's body (:255-291), carried over the tiles."""
    int_mode = stage in ("mmint", "rowmaxint")
    acc = jnp.zeros((q8.shape[0], 1), jnp.int32 if int_mode else jnp.float32)
    for j in range(c8.shape[1] // BN):
        tile = jnp.asarray(c8[:, j * BN : (j + 1) * BN])
        cs = jnp.asarray(scales[:, j * BN : (j + 1) * BN])
        int_scores = jnp.dot(jnp.asarray(q8), tile, preferred_element_type=jnp.int32)  # :264
        col0 = j * BN
        iota_row = jax.lax.broadcasted_iota(jnp.int32, (1, BN), 1)
        if stage == "mmint":  # :266
            acc = acc + int_scores[:, :1]
        elif stage == "rowmaxint":  # :268-273
            masked = jnp.where((col0 + iota_row) < n_valid, int_scores, jnp.int32(-(2**31) + 1))
            acc = acc + jnp.max(masked, axis=-1, keepdims=True)
        elif stage == "mm":  # :275-276
            scores = int_scores.astype(jnp.float32) * cs
            acc = acc + scores[:, :1]
        else:  # :278-287
            scores = int_scores.astype(jnp.float32) * cs
            scores = jnp.where((col0 + iota_row) < n_valid, scores, JT.NEG_INF)
            if stage == "rowmax":
                acc = acc + jnp.max(scores, axis=-1, keepdims=True)
            else:
                m = jnp.max(scores, axis=-1, keepdims=True)
                a = jnp.argmax(scores, axis=-1).astype(jnp.float32)
                acc = acc + m + a[:, None]
    return np.asarray(acc.astype(jnp.float32))[:, 0]  # :291


@pytest.mark.parametrize("stage", ["mmint", "rowmaxint", "mm", "rowmax", "prologue"])
@pytest.mark.parametrize("layout", ["flat", "tile_major"])
def test_int8_stages_match_probe_body(stage, layout):
    q8, c8, scales = _int_inputs()
    want = _jnp_int8_probe(q8, c8, scales, stage, N_VALID)
    corpus, sc = torch.from_numpy(c8), torch.from_numpy(scales)
    if layout == "tile_major":
        corpus, sc = TT.tile_corpus_t(corpus, block_n=BN), TT.tile_scales(sc, block_n=BN)
        got = ceiling_plain(torch.from_numpy(q8), corpus, stage, n_valid=N_VALID, scales=sc)
    else:
        got = ceiling_plain(torch.from_numpy(q8), corpus, stage, BN, n_valid=N_VALID, scales=sc)
    if stage in ("mmint", "rowmaxint"):
        assert np.array_equal(got.numpy(), want)  # int32 sums: bitwise
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=FLOAT_RTOL)


def test_int_mask_value_and_int8_dma():
    q8, c8, _ = _int_inputs()
    assert INT_MASK == -(2**31) + 1
    # A fully masked tile contributes the mask value itself, as in the probe.
    got = ceiling_plain(torch.from_numpy(q8), torch.from_numpy(c8), "rowmaxint", BN, n_valid=BN * 4)
    want = _jnp_int8_probe(q8, c8, None if False else np.ones((1, N_PAD), np.float32), "rowmaxint", BN * 4)
    assert np.array_equal(got.numpy(), want)
    dma = ceiling_plain(torch.from_numpy(q8), torch.from_numpy(c8), "dma", BN)
    assert np.array_equal(dma.numpy(), np.full(Q, float(c8[0, ::BN].astype(np.int64).sum()), np.float32))


def test_wrapper_takes_the_plain_version_on_the_cpu_and_validates():
    q, ct = _float_inputs()
    before = ceiling.launches
    got = ceiling(_bf16(q), _bf16(ct), "rowmax", BN, n_valid=N_VALID)
    assert torch.equal(got, ceiling_plain(_bf16(q), _bf16(ct), "rowmax", BN, n_valid=N_VALID))
    assert ceiling.launches == before  # counts kernel launches only
    q8, c8, scales = _int_inputs()
    with pytest.raises(ValueError, match="unknown ceiling stage"):
        ceiling(_bf16(q), _bf16(ct), "merge", BN)
    with pytest.raises(ValueError, match="only over an int8"):
        ceiling(_bf16(q), _bf16(ct), "mmint", BN)
    with pytest.raises(ValueError, match="needs the column scales"):
        ceiling(torch.from_numpy(q8), torch.from_numpy(c8), "rowmax", BN)
    with pytest.raises(TypeError, match="int8 queries"):
        ceiling(_bf16(q), torch.from_numpy(c8), "mmint", BN)
    with pytest.raises(ValueError, match="multiple of 128"):
        ceiling(_bf16(q), _bf16(ct), "rowmax", 100)
    with pytest.raises(ValueError, match="read_check"):
        ceiling(_bf16(q), _bf16(ct), "dma", BN, read_check=True)


def test_corpus_xor_is_layout_independent():
    _, ct = _float_inputs()
    _, c8, _ = _int_inputs()
    for corpus in (_bf16(ct), torch.from_numpy(ct), torch.from_numpy(c8)):
        assert corpus_xor(corpus) == corpus_xor(TT.tile_corpus_t(corpus, block_n=BN))
    words = torch.from_numpy(ct).numpy().view(np.uint32)
    assert corpus_xor(torch.from_numpy(ct)) == int(np.bitwise_xor.reduce(words.reshape(-1)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_ladder_stages_cover_the_dtype(dtype):
    """The ladder is every stage that exists over the dtype, once, block read
    first; only integer sums are held bitwise."""
    stages = ladder_stages(dtype)
    int_only = {"mmint", "rowmaxint"}
    assert set(stages) == set(STAGES) - (set() if dtype == torch.int8 else int_only)
    assert len(set(stages)) == len(stages) and stages[0] == "dma" and stages[-1] == "prologue"
    exact = {s for s in stages if is_exact(dtype, s)}
    assert exact == ({"dma"} | int_only if dtype == torch.int8 else set())


def test_synthetic_inputs_are_seeded_unit_vectors():
    from ragfin_tpu_torch.utils.synthetic import normal_bf16, unit_corpus_t, unit_queries

    ct = unit_corpus_t(50, seed=3, device="cpu", d=96)
    assert ct.shape == (96, 50) and ct.dtype == torch.bfloat16
    assert torch.equal(ct, unit_corpus_t(50, seed=3, device="cpu", d=96))
    assert not torch.equal(ct, unit_corpus_t(50, seed=4, device="cpu", d=96))
    # Unit up to the rounding to bf16 (8 bits of mantissa).
    torch.testing.assert_close(ct.float().norm(dim=0), torch.ones(50), rtol=0, atol=1e-2)
    qs = unit_queries((2, 5, 96), seed=1, device="cpu")
    assert qs.dtype == torch.float32
    torch.testing.assert_close(qs.norm(dim=-1), torch.ones(2, 5), rtol=0, atol=1e-6)
    x = normal_bf16((4, 7), 0, "cpu")
    assert x.shape == (4, 7) and x.dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("nq", [3, 40])
def test_kernel_matches_plain_on_the_card(dtype, nq):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    n, bn, d = 128 * 37 + 52, 512, 96
    n_valid = n - 300
    if dtype == "int8":
        ct = torch.from_numpy(rng.integers(-127, 128, (d, n)).astype(np.int8)).cuda()
        q = torch.from_numpy(rng.integers(-127, 127, (nq, d)).astype(np.int8)).cuda()
        sc = torch.from_numpy(rng.uniform(1e-3, 2e-2, (1, n)).astype(np.float32)).cuda()
    else:
        tdt = getattr(torch, dtype)
        ct = torch.from_numpy(rng.standard_normal((d, n)).astype(np.float32)).cuda().to(tdt)
        q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32)).cuda().to(tdt)
        sc = None
    for stage in ladder_stages(ct.dtype):
        before = ceiling.launches
        got = ceiling(q, ct, stage, bn, n_valid=n_valid, scales=sc)
        torch.cuda.synchronize()
        assert ceiling.launches == before + 1
        want = ceiling_plain(q, ct, stage, bn, n_valid=n_valid, scales=sc)
        if is_exact(ct.dtype, stage):
            assert torch.equal(got, want), stage
        else:
            # f32 sums in another order: inside a dot product and over tiles.
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3, msg=stage)
    _, seen = ceiling(q, ct, "dma", bn, read_check=True)
    assert seen == corpus_xor(ct)


def test_card_label_is_the_first_line_of_nvidia_smi(monkeypatch):
    """Every device time is labelled with the card's name and power limit as
    nvidia-smi prints them; a host with several cards labels with the first."""
    import subprocess
    import types

    from ragfin_tpu_torch.utils import profiling

    seen = {}

    def fake_run(cmd, **kwargs):
        seen["cmd"] = cmd
        return types.SimpleNamespace(stdout="Card A, 700.00 W\nCard B, 350.00 W\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert profiling.card() == "Card A, 700.00 W"
    assert seen["cmd"] == ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
