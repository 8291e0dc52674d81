"""Kernel B1 on the card: ``matmul_stats`` against its plain version at
three ResNet-50 step shapes and two edge shapes of the wgmma route, the
statistics bitwise equal across two runs, and the launches counted by
route.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_matmul_stats_card.py -q

Without CUDA each test skips, with its reason. Tolerances (the kernel and
the plain version sum the K products in different orders in f32; P is
|x| @ |w|.T, the sum of the products' magnitudes): y within one bf16 ulp
of the larger magnitude plus 1e-5 P; s1 within 1e-5 of sum P and s2 of
sum P^2, per column.
"""
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import matmul_stats as ms

#: (M, K, N): three of the 12 step shapes (batch 128, 224x224, NHWC) and
#: two edges (ragged M, N and K; fewer tiles than SMs; N-tile width 128)
CARD_SHAPES = [(6272, 2048, 512), (25088, 1024, 256), (100352, 128, 512),
               (17, 72, 520), (100003, 8, 264)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the matmul_stats kernels launch "
                    "only on the card (chip_smoke.py phase 4 runs them)")


def _operands(m, k, n, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((n, k), generator=gen, device="cuda")
         / k ** 0.5).to(dtype)
    return x, w


def _assert_close(x, w, got):
    y, s1, s2 = got
    yr, r1, r2 = ms.matmul_stats_reference(x, w)
    p = x.float().abs() @ w.float().abs().t()
    yf, yrf = y.float(), yr.float()
    allowed = 1e-5 * p
    if x.dtype == torch.bfloat16:
        mag = torch.maximum(yf.abs(), yrf.abs())
        allowed += torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(
            mag.clamp_min(1e-30))) - 7), torch.zeros_like(mag))
    assert bool(((yf - yrf).abs() <= allowed).all())
    assert bool(((s1 - r1).abs() <= 1e-5 * p.sum(0)).all())
    assert bool(((s2 - r2).abs() <= 1e-5 * (p * p).sum(0)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_wgmma_kernel_matches_plain_version(shape):
    _need_card()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x, w = _operands(*shape)
        before = dict(ms.LAUNCHES_BY_ROUTE)
        got = ms.matmul_stats(x, w)
        torch.cuda.synchronize()
        assert ms.LAUNCHES_BY_ROUTE["wgmma"] == before["wgmma"] + 1
        _assert_close(x, w, got)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.gpu
def test_statistics_are_bitwise_repeatable():
    _need_card()
    x, w = _operands(25088, 256, 1024)
    y, s1, s2 = ms.matmul_stats(x, w)
    y2, t1, t2 = ms.matmul_stats(x, w)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(s1, t1) and torch.equal(s2, t2)


@pytest.mark.gpu
def test_launches_counted_by_route():
    _need_card()
    before = dict(ms.LAUNCHES_BY_ROUTE)
    total = ms.LAUNCHES
    x, w = _operands(1000, 64, 64)
    ms.matmul_stats(x, w)                            # wgmma
    got = ms._launch(x, w, "wmma")                   # the wmma kernel forced
    _assert_close(x, w, got)
    ms.matmul_stats(*_operands(1000, 3, 65))         # K, N not % 8: wmma
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    buf[1:].copy_(x.reshape(-1))
    xm = buf[1:].view(x.shape)                       # 2 bytes off: wmma
    assert xm.data_ptr() % 16
    _assert_close(xm, w, ms.matmul_stats(xm, w))
    xf, wf = _operands(1000, 64, 64, torch.float32)
    ms.matmul_stats(xf, wf)                          # f32
    torch.cuda.synchronize()
    after = {r: ms.LAUNCHES_BY_ROUTE[r] - before[r] for r in before}
    assert after == {"wgmma": 1, "wmma": 3, "f32": 1}
    assert ms.LAUNCHES == total + 5
    with pytest.raises(MXNetError, match="route"):
        ms._launch(xf, wf, "wgmma")
