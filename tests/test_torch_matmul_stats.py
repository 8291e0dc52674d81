"""Kernel B1 of the PyTorch port, the matmul with BatchNorm statistics
(``mxnet_tpu_torch/ops/matmul_stats.py``), against the JAX package's
``mxnet_tpu.ops.pallas_fused`` in Pallas interpret mode on the same numpy
inputs.

On the CPU the port's wrapper takes its plain version; the CUDA kernel runs
only on the card, where ``chip_smoke.py`` holds it against the same plain
version. Tolerances:
- y: float32 ``rtol=1e-5, atol=1e-6`` (the two sum K products in different
  orders); bfloat16 one ulp of the larger magnitude (an f32 accumulator
  that differs in its last bits can round to the neighbouring bf16);
- s1, s2: ``rtol=1e-5`` of sum|acc| and sum acc^2 per column (the bound of
  a reordered f32 sum's error, relative to the sum of magnitudes);
- gradients: ``rtol=1e-4, atol=1e-5`` (float32, two backward passes of
  different association).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_fused as pf
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import matmul_stats as ms

# (id, M, K, N): the Pallas envelope, its XLA fallback shapes (N % 128,
# M without a 16-aligned divisor), K = 1 and a ragged mix
SHAPES = [("envelope", 256, 64, 128), ("n64_fallback", 256, 64, 64),
          ("m_unaligned", 250, 32, 128), ("k1", 64, 1, 128),
          ("ragged", 17, 3, 65), ("two_col_tiles", 48, 16, 256)]


def _inputs(case):
    _, m, k, n = case
    rng = np.random.default_rng(zlib.crc32(case[0].encode()))
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    return x, w


def _jax_fwd(x, w, dtype):
    jx = jnp.asarray(x).astype(dtype)
    jw = jnp.asarray(w.T).astype(dtype)          # the JAX kernel takes (K, N)
    y, s1, s2 = pf.matmul_stats(jx, jw, True)
    return (np.asarray(y.astype(jnp.float32)), np.asarray(s1),
            np.asarray(s2))


def _stats_close(got, want, scale):
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-5 * scale), \
        np.max(np.abs(got - want) / scale)


@pytest.mark.parametrize("case", SHAPES, ids=[c[0] for c in SHAPES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_interpret(case, dtype):
    x, w = _inputs(case)
    tdt = getattr(torch, dtype)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    y, s1, s2 = ms.matmul_stats(tx, tw)
    assert y.dtype == tdt and s1.dtype == s2.dtype == torch.float32
    jy, js1, js2 = _jax_fwd(x, w, getattr(jnp, dtype))
    y = y.float().numpy()
    assert y.shape == jy.shape
    if dtype == "float32":
        np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-6)
    else:
        mag = np.maximum(np.abs(y), np.abs(jy))
        ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(
            np.maximum(mag, 1e-30))) - 7), 0.0)
        assert np.all(np.abs(y - jy) <= ulp)
    acc = (tx.double() @ tw.double().t()).numpy()
    _stats_close(s1.numpy(), js1, np.abs(acc).sum(0))
    _stats_close(s2.numpy(), js2, (acc * acc).sum(0))


def test_bf16_statistics_come_from_the_accumulator():
    # an accumulator that bf16 cannot hold: summing the rounded y would be
    # off by far more than the tolerance
    x = np.full((64, 3), 1.0, np.float32)
    w = np.array([[1.0, 2 ** -8, 2 ** -9]], np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    y, s1, s2 = ms.matmul_stats(tx, tw)
    acc = 1.0 + 2 ** -8 + 2 ** -9
    assert float(y[0, 0]) != acc                      # y is rounded
    assert float(s1[0]) == pytest.approx(64 * acc, rel=1e-7)
    assert float(s2[0]) == pytest.approx(64 * acc * acc, rel=1e-7)


# which of y, s1, s2 the scalar mixes: an output left out reaches the
# backward as None
PARTS = {"all": (1, 1, 1), "stats_only": (0, 1, 1), "y_s2": (1, 0, 1),
         "y_s1": (1, 1, 0)}


@pytest.mark.parametrize("parts", list(PARTS))
@pytest.mark.parametrize("case", SHAPES[:3], ids=[c[0] for c in SHAPES[:3]])
def test_gradient_matches_jax(case, parts):
    x, w = _inputs(case)
    rng = np.random.default_rng(1)
    m, n = x.shape[0], w.shape[0]
    use_y, use_s1, use_s2 = PARTS[parts]
    t = rng.standard_normal((m, n)).astype(np.float32) * use_y
    a = rng.standard_normal(n).astype(np.float32) * use_s1
    b = (rng.standard_normal(n) / m).astype(np.float32) * use_s2

    def jloss(jx, jw):
        y, s1, s2 = pf.matmul_stats(jx, jw, True)
        return jnp.sum(y * t) + jnp.sum(s1 * a) + jnp.sum(s2 * b)

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(w.T))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y, s1, s2 = ms.matmul_stats(tx, tw)
    terms = [(y * torch.from_numpy(t)).sum(), (s1 * torch.from_numpy(a)).sum(),
             (s2 * torch.from_numpy(b)).sum()]
    sum(term for term, use in zip(terms, PARTS[parts]) if use).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw).T,
                               rtol=1e-4, atol=1e-5)


def test_gradient_with_unused_statistics():
    x, w = _inputs(SHAPES[0])
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y, _, _ = ms.matmul_stats(tx, tw)
    y.sum().backward()
    ones = np.ones((x.shape[0], w.shape[0]), np.float32)
    np.testing.assert_allclose(tx.grad.numpy(), ones @ w, rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), ones.T @ x, rtol=1e-5)


ATTR_TABLE = [
    {"kernel": "(1, 1)", "no_bias": "True", "layout": "NHWC"},
    {"kernel": (1, 1), "no_bias": True, "layout": "NHWC", "stride": (1, 1),
     "pad": (0, 0), "dilate": (1, 1), "num_group": 1},
    {"kernel": "(1, 1)", "no_bias": "True", "layout": "NCHW"},
    {"kernel": "(1, 1)", "no_bias": "True"},
    {"kernel": "(3, 3)", "no_bias": "True", "layout": "NHWC"},
    {"kernel": "(1, 1)", "no_bias": "True", "layout": "NHWC",
     "stride": "(2, 2)"},
    {"kernel": "(1, 1)", "no_bias": "True", "layout": "NHWC", "pad": "(1, 1)"},
    {"kernel": "(1, 1)", "no_bias": "True", "layout": "NHWC",
     "dilate": "(2, 2)"},
    {"kernel": "(1, 1)", "no_bias": "False", "layout": "NHWC"},
    {"kernel": "(1, 1)", "layout": "NHWC"},
    {"kernel": "(1, 1)", "no_bias": "True", "layout": "NHWC",
     "num_group": "2"},
    {"no_bias": "True", "layout": "NHWC"},
]

BN_TABLE = [{}, {"axis": 1}, {"axis": "3"}, {"axis": -1},
            {"axis": 3, "use_global_stats": True},
            {"axis": 3, "use_global_stats": "False"}, {"axis": 2}]


@pytest.mark.parametrize("i", range(len(ATTR_TABLE)))
def test_conv1x1_fusable_matches_jax(i):
    attrs = ATTR_TABLE[i]
    assert ms.conv1x1_fusable(dict(attrs)) == pf.conv1x1_fusable(dict(attrs))


@pytest.mark.parametrize("i", range(len(BN_TABLE)))
def test_bn_fusable_matches_jax(i):
    attrs = BN_TABLE[i]
    assert ms.bn_fusable(dict(attrs)) == pf.bn_fusable(dict(attrs))


def test_apply_conv1x1_stats_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = (rng.standard_normal((24, 16, 1, 1)) * 0.2).astype(np.float32)
    jy, (js1, js2, jcount) = pf.apply_conv1x1_stats(
        jnp.asarray(x), jnp.asarray(w), interpret=True)
    copies = ms.LAYOUT_COPIES
    y, (s1, s2, count) = ms.apply_conv1x1_stats(torch.from_numpy(x),
                                                torch.from_numpy(w))
    assert ms.LAYOUT_COPIES == copies          # contiguous NHWC: no copy
    assert count == jcount == 40.0 and isinstance(count, float)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=1e-5)
    # an NCHW tensor seen as NHWC is not contiguous: counted and copied
    nchw = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    y2, _ = ms.apply_conv1x1_stats(nchw.permute(0, 2, 3, 1),
                                   torch.from_numpy(w))
    assert ms.LAYOUT_COPIES == copies + 1
    np.testing.assert_array_equal(y2.numpy(), y.numpy())


def test_cpu_tensors_take_the_plain_version():
    x, w = _inputs(SHAPES[0])
    before = ms.LAUNCHES
    got = ms.matmul_stats(torch.from_numpy(x), torch.from_numpy(w))
    want = ms.matmul_stats_reference(torch.from_numpy(x), torch.from_numpy(w))
    assert ms.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_float64_accumulates_in_float64():
    x, w = _inputs(SHAPES[4])
    y, s1, s2 = ms.matmul_stats(torch.from_numpy(x).double(),
                                torch.from_numpy(w).double())
    assert y.dtype == s1.dtype == s2.dtype == torch.float64
    jax.config.update("jax_enable_x64", True)
    try:
        jy, js1, js2 = pf.matmul_stats(jnp.asarray(x, jnp.float64),
                                       jnp.asarray(w.T, jnp.float64), True)
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-12)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=1e-12)


@pytest.mark.parametrize("bad", ["rank", "k", "dtype", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(4, 3)
    w = torch.zeros(5, 3)
    if bad == "rank":
        x = x[None]
    elif bad == "k":
        w = torch.zeros(5, 4)
    elif bad == "dtype":
        w = w.double()
    else:
        x, w = x.to("meta"), w.to("meta")
    with pytest.raises(MXNetError):
        ms.matmul_stats(x, w)
