"""The port's int8 quantization (ragfin_tpu_torch.ops.quantize) against the
JAX package's, on the same seeded inputs.

Tolerance: the int8 values are bitwise equal (both round half to even). The
scales are bitwise equal to the JAX device path, which XLA computes as
``absmax * f32(1/127)``; against an exact division by 127 (the JAX numpy
host-quantize path) they may differ by 1 ulp, which is the bound checked
there.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ragfin_tpu.ops.quantize import quantize_corpus_t as j_corpus
from ragfin_tpu.ops.quantize import quantize_queries as j_queries
from ragfin_tpu_torch.ops.quantize import quantize_corpus_t as t_corpus
from ragfin_tpu_torch.ops.quantize import quantize_queries as t_queries


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((300, 64)).astype(np.float32)
    a[:20] = np.round(a[:20] * 4) / 4  # values landing on .5 quantization steps
    a[20] = 0.0  # all-zero row: the 1e-12 scale floor
    return a


def test_queries_bitwise_equal(x):
    jq, js = j_queries(jnp.asarray(x))
    tq, ts = t_queries(torch.from_numpy(x.copy()))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (300, 1)


def test_corpus_bitwise_equal(x):
    ct = np.ascontiguousarray(x.T)
    jq, js = j_corpus(jnp.asarray(ct))
    tq, ts = t_corpus(torch.from_numpy(ct.copy()))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tuple(ts.shape) == (1, 300)


def test_bf16_corpus_matches(x):
    ct = jnp.asarray(np.ascontiguousarray(x.T), jnp.bfloat16)
    jq, js = j_corpus(ct)
    tb = torch.from_numpy(np.asarray(ct.astype(jnp.float32))).to(torch.bfloat16)
    tq, ts = t_corpus(tb)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_scales_within_one_ulp_of_exact_division(x):
    _, ts = t_queries(torch.from_numpy(x.copy()))
    absmax = np.abs(x).max(axis=1)
    exact = np.maximum(absmax, np.float32(1e-12)) / np.float32(127.0)
    ulps = np.abs(ts.numpy()[:, 0].view(np.int32) - exact.view(np.int32))
    assert ulps.max() <= 1
