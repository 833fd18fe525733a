"""The port's top-k tiers (ragfin_tpu_torch.ops.topk) against the JAX tiers
and the host-exact numpy oracle, on the same seeded inputs.

On the CPU the fused wrappers run their plain PyTorch versions (the CUDA
kernels are held against those on the card by chip_smoke.py); the JAX fused
kernels run in Pallas interpret mode, as tests/test_topk.py runs them.

Tolerances: ids must equal the oracle's exactly, ties included (the inputs
have no near-ties closer than f32 rounding except exact duplicates, which
score bitwise-equal in every implementation). f32 scores agree to 1e-5
(summation order differs between numpy, XLA and torch). The fused int8
scores are bitwise equal to JAX's: the integer dot is exact and both apply
the column scale, then the row scale, as single f32 multiplies.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ragfin_tpu.ops import topk as jtopk
from ragfin_tpu.ops.quantize import quantize_corpus_t as j_quantize_corpus_t
from ragfin_tpu_torch.ops import topk as ttopk
from ragfin_tpu_torch.ops.quantize import quantize_corpus_t as t_quantize_corpus_t

INT32_MAX = 0x7FFFFFFF


def _numpy_oracle(q, ct, k, n_valid=None):
    scores = q @ ct
    if n_valid is not None:
        scores[:, n_valid:] = -np.inf
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, order, axis=1), order


def _random_unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    corpus_t = _random_unit(rng, 1000, 64).T.copy()
    queries = _random_unit(rng, 9, 64)
    return queries, corpus_t


@pytest.fixture(scope="module")
def int8_data(data):
    q, c = data
    c8, sc = j_quantize_corpus_t(jnp.asarray(c))
    return q, np.asarray(c8), np.asarray(sc)


@pytest.mark.parametrize("k", [1, 3, 10, 64])
class TestAgainstOracle:
    def test_dense(self, data, k):
        q, c = data
        s, i = ttopk.cosine_topk_dense(_t(q), _t(c), k)
        es, ei = _numpy_oracle(q, c, k)
        np.testing.assert_allclose(_np(s), es, rtol=1e-5, atol=1e-5)
        assert np.array_equal(_np(i), ei)

    def test_blocked(self, data, k):
        q, c = data
        s, i = ttopk.cosine_topk_blocked(_t(q), _t(c), k, block=192)
        es, ei = _numpy_oracle(q, c, k)
        np.testing.assert_allclose(_np(s), es, rtol=1e-5, atol=1e-5)
        assert np.array_equal(_np(i), ei)

    def test_fused_matches_oracle_and_jax(self, data, k):
        q, c = data
        s, i = ttopk.cosine_topk_fused(_t(q), _t(c), k)
        es, ei = _numpy_oracle(q, c, k)
        np.testing.assert_allclose(_np(s), es, rtol=1e-5, atol=1e-5)
        assert np.array_equal(_np(i), ei)
        js, ji = jtopk.cosine_topk_fused(jnp.asarray(q), jnp.asarray(c), k, block_q=8, block_n=256)
        np.testing.assert_allclose(_np(s), np.asarray(js), rtol=0, atol=1e-5)
        assert np.array_equal(_np(i), np.asarray(ji))

    def test_fused_tiled_layout(self, data, k):
        q, c = data
        tiles = ttopk.tile_corpus_t(_t(c), block_n=256)
        assert tuple(tiles.shape) == (4, 64, 256)
        np.testing.assert_array_equal(
            _np(tiles), np.asarray(jtopk.tile_corpus_t(jnp.asarray(c), block_n=256))
        )
        s, i = ttopk.cosine_topk_fused(_t(q), tiles, k, n_valid=c.shape[1])
        es, ei = _numpy_oracle(q, c, k)
        np.testing.assert_allclose(_np(s), es, rtol=1e-5, atol=1e-5)
        assert np.array_equal(_np(i), ei)

    def test_fused_int8_bitwise_equal_to_jax(self, int8_data, k):
        q, c8, sc = int8_data
        s, i = ttopk.cosine_topk_fused_int8(_t(q), _t(c8), _t(sc), k)
        js, ji = jtopk.cosine_topk_fused_int8(
            jnp.asarray(q), jnp.asarray(c8), jnp.asarray(sc), k, block_q=8, block_n=256
        )
        np.testing.assert_array_equal(_np(s), np.asarray(js))
        assert np.array_equal(_np(i), np.asarray(ji))

    def test_fused_int8_tiled_equals_flat(self, int8_data, k):
        q, c8, sc = int8_data
        flat = ttopk.cosine_topk_fused_int8(_t(q), _t(c8), _t(sc), k)
        tiled = ttopk.cosine_topk_fused_int8(
            _t(q), ttopk.tile_corpus_t(_t(c8), 256), ttopk.tile_scales(_t(sc), 256), k,
            n_valid=c8.shape[1],
        )
        np.testing.assert_array_equal(_np(flat[0]), _np(tiled[0]))
        np.testing.assert_array_equal(_np(flat[1]), _np(tiled[1]))

    def test_dense_int8_matches_jax(self, int8_data, k):
        """The dense int8 tier keeps its own scaling order (int * qscale *
        scales), so it is compared with JAX's dense int8 tier, not the fused."""
        q, c8, sc = int8_data
        s, i = ttopk.cosine_topk_dense_int8(_t(q), _t(c8), _t(sc), k)
        js, ji = jtopk.cosine_topk_dense_int8(jnp.asarray(q), jnp.asarray(c8), jnp.asarray(sc), k)
        np.testing.assert_allclose(_np(s), np.asarray(js), rtol=1e-6, atol=1e-7)
        assert np.array_equal(_np(i), np.asarray(ji))


class TestMasksAndMulti:
    def test_row_mask_and_score_mult_match_jax(self, data):
        q, c = data
        rng = np.random.default_rng(3)
        mask = rng.random(c.shape[1]) < 0.3
        mult = rng.uniform(0.2, 1.0, c.shape[1]).astype(np.float32)
        s, i = ttopk.cosine_topk_dense(_t(q), _t(c), 7, row_mask=_t(mask), score_mult=_t(mult))
        js, ji = jtopk.cosine_topk_dense(
            jnp.asarray(q), jnp.asarray(c), 7,
            row_mask=jnp.asarray(mask), score_mult=jnp.asarray(mult),
        )
        np.testing.assert_allclose(_np(s), np.asarray(js), rtol=1e-5, atol=1e-5)
        assert np.array_equal(_np(i), np.asarray(ji))
        assert mask[_np(i)].all()

    def test_dense_multi_matches_jax(self, data, int8_data):
        q, c = data
        _, c8, sc = int8_data
        rng = np.random.default_rng(4)
        masks = rng.random((3, c.shape[1])) < np.array([[0.1], [0.5], [1.0]])
        s, i = ttopk.cosine_topk_dense_multi(_t(q), _t(c), 6, _t(masks), n_valid=990)
        js, ji = jtopk.cosine_topk_dense_multi(
            jnp.asarray(q), jnp.asarray(c), 6, jnp.asarray(masks), n_valid=990
        )
        np.testing.assert_allclose(_np(s), np.asarray(js), rtol=1e-5, atol=1e-5)
        assert np.array_equal(_np(i), np.asarray(ji))
        s8, i8 = ttopk.cosine_topk_dense_multi_int8(_t(q), _t(c8), _t(sc), 6, _t(masks))
        js8, ji8 = jtopk.cosine_topk_dense_multi_int8(
            jnp.asarray(q), jnp.asarray(c8), jnp.asarray(sc), 6, jnp.asarray(masks)
        )
        np.testing.assert_allclose(_np(s8), np.asarray(js8), rtol=1e-6, atol=1e-7)
        assert np.array_equal(_np(i8), np.asarray(ji8))


class TestFusedContract:
    def test_n_valid_masks_padded_columns(self, data):
        q, c = data
        c_pad = np.concatenate([c, np.ones((c.shape[0], 24), np.float32)], axis=1)
        s, i = ttopk.cosine_topk_fused(_t(q), _t(c_pad), 5, n_valid=c.shape[1])
        assert int(_np(i).max()) < c.shape[1]
        es, ei = _numpy_oracle(q, c_pad, 5, n_valid=c.shape[1])
        assert np.array_equal(_np(i), ei)

    @pytest.mark.parametrize("int8", [False, True])
    def test_k_greater_than_n_valid_gives_sentinels(self, int8):
        """Slots past the valid columns are (-inf, INT32_MAX), as the JAX
        fused kernels leave them (the dense tier returns the masked ids)."""
        rng = np.random.default_rng(0)
        c = rng.standard_normal((16, 300)).astype(np.float32)
        q = rng.standard_normal((2, 16)).astype(np.float32)
        if int8:
            c8, sc = j_quantize_corpus_t(jnp.asarray(c))
            s, i = ttopk.cosine_topk_fused_int8(_t(q), _t(np.asarray(c8)), _t(np.asarray(sc)), 8, n_valid=5)
            js, ji = jtopk.cosine_topk_fused_int8(
                jnp.asarray(q), c8, sc, 8, n_valid=5, block_q=8, block_n=256
            )
            np.testing.assert_array_equal(_np(s), np.asarray(js))
        else:
            s, i = ttopk.cosine_topk_fused(_t(q), _t(c), 8, n_valid=5)
            js, ji = jtopk.cosine_topk_fused(jnp.asarray(q), jnp.asarray(c), 8, n_valid=5, block_q=8, block_n=256)
            np.testing.assert_allclose(_np(s), np.asarray(js), rtol=0, atol=1e-5)
        assert np.array_equal(_np(i), np.asarray(ji))
        assert (_np(i)[:, 5:] == INT32_MAX).all() and np.isneginf(_np(s)[:, 5:]).all()

    def test_k_greater_than_physical_columns(self):
        rng = np.random.default_rng(1)
        q, c = _random_unit(rng, 2, 16), _random_unit(rng, 4, 16).T.copy()
        s, i = ttopk.cosine_topk_fused(_t(q), _t(c), 6)
        assert tuple(s.shape) == (2, 6)
        assert (_np(i)[:, 4:] == INT32_MAX).all()
        assert np.array_equal(_np(i)[:, :4], _numpy_oracle(q, c, 4)[1])

    def test_tile_major_requires_n_valid(self, data, int8_data):
        q, c = data
        tiles = ttopk.tile_corpus_t(_t(c), block_n=256)
        with pytest.raises(ValueError, match="requires n_valid"):
            ttopk.cosine_topk_fused(_t(q), tiles, 3)
        _, c8, sc = int8_data
        with pytest.raises(ValueError, match="requires n_valid"):
            ttopk.cosine_topk_fused_int8(
                _t(q), ttopk.tile_corpus_t(_t(c8), 256), ttopk.tile_scales(_t(sc), 256), 3
            )

    def test_duplicate_rows_tie_break_to_lowest_id(self):
        rng = np.random.default_rng(9)
        base = _random_unit(rng, 40, 32)
        corpus = np.concatenate([base, base[:10], base[:10]], axis=0)
        ct = corpus.T.copy()
        q = base[:5]
        es, ei = _numpy_oracle(q, ct, 6)
        for fn, kw in (
            (ttopk.cosine_topk_dense, {}),
            (ttopk.cosine_topk_blocked, {"block": 16}),
            (ttopk.cosine_topk_fused, {}),
        ):
            s, i = fn(_t(q), _t(ct), 6, **kw)
            assert np.array_equal(_np(i), ei), fn.__name__
        c8, sc = t_quantize_corpus_t(_t(ct))
        s8, i8 = ttopk.cosine_topk_fused_int8(_t(q), c8, sc, 6)
        js8, ji8 = jtopk.cosine_topk_fused_int8(
            jnp.asarray(q), jnp.asarray(_np(c8)), jnp.asarray(_np(sc)), 6, block_q=8, block_n=128
        )
        assert np.array_equal(_np(i8), np.asarray(ji8))
        np.testing.assert_array_equal(_np(s8), np.asarray(js8))

    def test_tie_heavy_scores(self):
        rng = np.random.default_rng(6)
        pool = _random_unit(rng, 4, 8)
        c = pool[rng.integers(0, 4, 640)].T.copy()
        q = _random_unit(rng, 2, 8)
        es, ei = _numpy_oracle(q, c, 9)
        s, i = ttopk.cosine_topk_fused(_t(q), _t(c), 9)
        assert np.array_equal(_np(i), ei)
        s, i = ttopk.cosine_topk_fused(_t(q), ttopk.tile_corpus_t(_t(c), 128), 9, n_valid=640)
        assert np.array_equal(_np(i), ei)

    @pytest.mark.parametrize("int8", [False, True])
    def test_all_zero_query_row_gives_no_nan(self, data, int8_data, int8):
        q, c = data
        q0 = np.concatenate([q[:2], np.zeros((1, q.shape[1]), np.float32)])
        if int8:
            _, c8, sc = int8_data
            s, i = ttopk.cosine_topk_fused_int8(_t(q0), _t(c8), _t(sc), 5)
            js, ji = jtopk.cosine_topk_fused_int8(
                jnp.asarray(q0), jnp.asarray(c8), jnp.asarray(sc), 5, block_q=8, block_n=256
            )
            np.testing.assert_array_equal(_np(s), np.asarray(js))
        else:
            s, i = ttopk.cosine_topk_fused(_t(q0), _t(c), 5)
            js, ji = jtopk.cosine_topk_fused(jnp.asarray(q0), jnp.asarray(c), 5, block_q=8, block_n=256)
        assert not np.isnan(_np(s)).any()
        assert np.array_equal(_np(i), np.asarray(ji))
        assert np.array_equal(_np(i)[2], np.arange(5))  # all scores 0: lowest ids

    def test_bf16_fast_matches_jax(self, data):
        """The fast tier over a bf16 corpus rounds the queries to bf16 and
        accumulates in f32, like JAX's fused fast tier."""
        q, c = data
        cb = jnp.asarray(c, jnp.bfloat16)
        js, ji = jtopk.cosine_topk_fused(jnp.asarray(q), cb, 7, precision="fast", block_q=8, block_n=256)
        tb = torch.from_numpy(np.asarray(cb.astype(jnp.float32))).to(torch.bfloat16)
        s, i = ttopk.cosine_topk_fused(_t(q), tb, 7, precision="fast")
        np.testing.assert_allclose(_np(s), np.asarray(js), rtol=0, atol=1e-5)
        assert np.array_equal(_np(i), np.asarray(ji))


class TestDispatch:
    def test_auto_on_cpu_uses_dense(self, data):
        q, c = data
        before = ttopk.cosine_topk_fused.launches
        s, i = ttopk.cosine_topk(_t(q), _t(c), 3)
        assert np.array_equal(_np(i), _numpy_oracle(q, c, 3)[1])
        assert ttopk.cosine_topk_fused.launches == before

    def test_unknown_method_raises(self, data):
        q, c = data
        with pytest.raises(ValueError):
            ttopk.cosine_topk(_t(q), _t(c), 3, method="bogus")

    def test_cpu_plain_versions_count_no_launches(self, data, int8_data):
        q, c = data
        _, c8, sc = int8_data
        before = (ttopk.cosine_topk_fused.launches, ttopk.cosine_topk_fused_int8.launches)
        ttopk.cosine_topk_fused(_t(q), _t(c), 3)
        ttopk.cosine_topk_fused_int8(_t(q), _t(c8), _t(sc), 3)
        assert (ttopk.cosine_topk_fused.launches, ttopk.cosine_topk_fused_int8.launches) == before


@pytest.mark.cuda
class TestOnCard:
    """Runs only where a CUDA card is present (chip_smoke.py covers the same
    comparisons at the main path's shapes)."""

    @pytest.fixture(autouse=True)
    def _need_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card; the CPU has no kernel to launch")

    @pytest.mark.parametrize("k", [3, 64, 70])
    def test_kernels_match_plain(self, data, int8_data, k):
        q, c = data
        _, c8, sc = int8_data
        dev = torch.device("cuda")
        s, i = ttopk.cosine_topk_fused(_t(q).to(dev), _t(c).to(dev), k, n_valid=997)
        ps, pi = ttopk.fused_topk_plain(_t(q).to(dev), _t(c).to(dev), k, n_valid=997)
        np.testing.assert_allclose(s.cpu().numpy(), ps.cpu().numpy(), rtol=0, atol=1e-5)
        assert np.array_equal(i.cpu().numpy(), pi.cpu().numpy())
        s8, i8 = ttopk.cosine_topk_fused_int8(_t(q).to(dev), _t(c8).to(dev), _t(sc).to(dev), k)
        p8, pi8 = ttopk.fused_topk_int8_plain(_t(q).to(dev), _t(c8).to(dev), _t(sc).to(dev), k)
        np.testing.assert_array_equal(s8.cpu().numpy(), p8.cpu().numpy())
        assert np.array_equal(i8.cpu().numpy(), pi8.cpu().numpy())
