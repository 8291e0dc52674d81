"""The arithmetic of kernel B1's float32 route on the card, ``tf32x3``
(``csrc/matmul_stats.cu``), emulated on the CPU: each operand is split into
two TF32 terms, ``big = tf32(a)`` and ``small = tf32(a - big)``, and the
product is ``x_small w_big + x_big w_small + x_big w_big``. TF32 rounding
(``cvt.rna.tf32.f32``: nearest, ties away from zero, the low 13 bits
cleared) is done with bit masks on the float32 bits, and the three products
of TF32 values are taken exactly (float64), as the tensor cores take them.

At every (K, N) of ResNet-50's fused Conv1x1->BatchNorm pairs (M cut to
256 rows; inputs from a numpy seed) the emulation must meet the tolerances
``chip_smoke.py`` (``b1_check``) holds the kernel to against the plain
version, ``matmul_stats_reference`` (full FP32): y within 1e-5 P, s1 within
1e-5 of sum P and s2 of sum P^2 per column, P = |x| @ |w|.T. A single TF32
pass misses them: that is why the kernel takes three.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import matmul_stats as ms
from test_torch_matmul_stats_route import STEP_SHAPES

ROWS = 256
TOL = 1e-5
KN = sorted({(k, n) for _, k, n in STEP_SHAPES})


def tf32(a):
    """float32 ``a`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it."""
    bits = a.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(a):
    big = tf32(a)
    return big, tf32(a - big)


def _operands(k, n):
    rng = np.random.default_rng(k * 10007 + n)
    x = rng.standard_normal((ROWS, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def _stats(acc):
    """y, s1, s2 from a float64 accumulator, as the kernel returns them."""
    return (acc.float(), acc.sum(0).float(), (acc * acc).sum(0).float())


def _excess(x, w, got):
    """Largest error of (y, s1, s2) against the plain version, each as a
    share of its tolerance (<= 1 passes)."""
    yr, r1, r2 = ms.matmul_stats_reference(x, w)
    p = x.double().abs() @ w.double().abs().t()
    y, s1, s2 = got
    return (float(((y - yr).double().abs() / (TOL * p)).max()),
            float(((s1 - r1).double().abs() / (TOL * p.sum(0))).max()),
            float(((s2 - r2).double().abs() / (TOL * (p * p).sum(0))).max()))


def test_tf32_rounding_clears_13_bits_to_nearest_away():
    one = 1.0 + 2.0 ** -11            # halfway between TF32 1 and 1 + 2^-10
    a = torch.tensor([1.0, one, -one, 1.0 + 2.0 ** -12, 3.0 * 2.0 ** 126,
                      1.0 + 2.0 ** -10 + 2.0 ** -23], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         3.0 * 2.0 ** 126, 1.0 + 2.0 ** -10],
                        dtype=torch.float32)
    got = tf32(a)
    assert torch.equal(got, want)
    assert not bool((got.view(torch.int32) & 0x1FFF).any())


def test_split_is_exact_to_2_pow_minus_22():
    x, _ = _operands(512, 128)
    big, small = split(x)
    assert not bool((small.view(torch.int32) & 0x1FFF).any())
    rest = x.double() - big.double() - small.double()
    assert float((rest.abs() / x.double().abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize("k,n", KN, ids=str)
def test_three_tf32_products_meet_the_kernel_tolerance(k, n):
    x, w = _operands(k, n)
    (xb, xs), (wb, ws) = split(x), split(w)
    xb, xs, wb, ws = (t.double() for t in (xb, xs, wb, ws))
    acc = xs @ wb.t() + xb @ ws.t() + xb @ wb.t()
    assert max(_excess(x, w, _stats(acc))) <= 1.0


@pytest.mark.parametrize("k,n", KN, ids=str)
def test_one_tf32_product_misses_it(k, n):
    x, w = _operands(k, n)
    acc = tf32(x).double() @ tf32(w).double().t()
    assert _excess(x, w, _stats(acc))[0] > 1.0
