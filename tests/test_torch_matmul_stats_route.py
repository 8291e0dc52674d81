"""Kernel B1's routing in the PyTorch port (``ops/matmul_stats.py``):
which CUDA kernel a shape takes, and the wgmma kernel's tile configuration,
against what ``csrc/matmul_stats.cu`` states. Pure functions of the shape:
nothing here launches a kernel, so it runs on the CPU; the kernels
themselves are held against the plain version on the card
(``tests/test_torch_matmul_stats_card.py``, ``chip_smoke.py`` phase 4).
"""
import os
import re

import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import matmul_stats as ms

SRC = os.path.join(os.path.dirname(ms.__file__), os.pardir, "csrc",
                   "matmul_stats.cu")

#: (M, K, N) of ResNet-50's fused Conv1x1->BatchNorm pairs at batch 128,
#: 224x224, NHWC, and how many pairs a step has of each
STEP_SHAPES = {
    (401408, 64, 64): 1, (401408, 64, 256): 4, (401408, 256, 64): 2,
    (401408, 256, 128): 1, (100352, 128, 512): 4, (100352, 512, 128): 3,
    (100352, 512, 256): 1, (25088, 256, 1024): 6, (25088, 1024, 256): 5,
    (25088, 1024, 512): 1, (6272, 512, 2048): 3, (6272, 2048, 512): 2}
H100_SMS = 132


def _note():
    with open(SRC) as f:
        return f.read()


def test_step_shapes_are_33_pairs():
    assert sum(STEP_SHAPES.values()) == 33


@pytest.mark.parametrize("shape", list(STEP_SHAPES), ids=str)
def test_step_shapes_take_wgmma(shape):
    m, k, n = shape
    assert ms.kernel_route(m, k, n, torch.bfloat16, True) == "wgmma"


@pytest.mark.parametrize("m,k,n,dtype,aligned,want", [
    (1000, 3, 64, torch.bfloat16, True, "wmma"),      # K % 8
    (1000, 1, 64, torch.bfloat16, True, "wmma"),
    (1000, 64, 65, torch.bfloat16, True, "wmma"),     # N % 8
    (1000, 64, 1, torch.bfloat16, True, "wmma"),
    (1000, 64, 64, torch.bfloat16, False, "wmma"),    # misaligned pointer
    (401408, 64, 64, torch.bfloat16, False, "wmma"),
    (1, 8, 8, torch.bfloat16, True, "wgmma"),         # M does not decide
    (100003, 72, 520, torch.bfloat16, True, "wgmma"),
    (1000, 64, 64, torch.float32, True, "f32"),       # float32: no TF32
    (1000, 3, 65, torch.float32, False, "f32"),
])
def test_other_shapes_take_their_routes(m, k, n, dtype, aligned, want):
    assert ms.kernel_route(m, k, n, dtype, aligned) == want


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_route_rejects_other_dtypes(dtype):
    with pytest.raises(MXNetError, match="float32 and bfloat16"):
        ms.kernel_route(64, 64, 64, dtype, True)


def _smem_bytes(bn, stages):
    """A block's shared memory as the kernel lays it out (WgSmem): the
    ring's stages (x 128x64, w BNx64 bf16), the y staging tile (128xBN
    bf16), the 8 warps' two rows of column sums (skewed by a float every
    32), the full and empty mbarriers, 1 KB of alignment slack."""
    return (stages * (128 * 64 * 2 + bn * 64 * 2) + 128 * bn * 2
            + 8 * 2 * (bn + bn // 32) * 4 + 2 * stages * 8 + 1024)


def test_configurations_are_the_source_notes():
    note = _note()
    stated = {int(bn): (int(st), int(smem), int(acc)) for bn, st, smem, acc
              in re.findall(r"BN\s+(\d+): (\d+) stages, (\d+) bytes of "
                            r"shared memory, (\d+) accumulators", note)}
    # the kernel's own ring depths
    stages = {int(bn): int(st) for bn, st in re.findall(
        r"struct WgCfg<(\d+)> \{ static constexpr int kStages = (\d+); \}",
        note)}
    assert set(stages) == {64, 128, 256}
    assert stated == {bn: (st, _smem_bytes(bn, st), bn // 2)
                      for bn, st in stages.items()}
    assert all(smem <= 232448 for _, smem, _ in stated.values())


def test_step_shape_tiles_are_the_source_notes():
    stated = {(int(m), int(k), int(n)): (int(bn), int(t)) for m, k, n, bn, t
              in re.findall(r"\((\d+), (\d+), (\d+)\) -> (\d+), (\d+)",
                            _note())}
    assert set(stated) == set(STEP_SHAPES)
    for (m, k, n), (bn, tiles) in stated.items():
        assert ms.wgmma_tile_n(m, n, H100_SMS) == bn
        assert -(-m // ms.WGMMA_BM) * -(-n // bn) == tiles


@pytest.mark.parametrize("m,n,sms,want", [
    (1000, 8, 132, 64), (1000, 64, 132, 64), (1000, 72, 132, 128),
    (1000, 128, 132, 128),
    # wider: the width with fewer tile-columns a block, 256 on a tie
    (401408, 256, 132, 256), (25088, 256, 132, 128), (6272, 512, 132, 256),
    (401408, 264, 132, 128), (100003, 520, 132, 128),
    (25088, 256, 196, 256),     # 196 SMs: one round either way
])
def test_tile_width_rule(m, n, sms, want):
    assert ms.wgmma_tile_n(m, n, sms) == want


def test_wgmma_is_not_forced_on_what_it_does_not_take():
    # CPU tensors never reach the kernels; a forced route is checked first
    x = torch.zeros(4, 3, dtype=torch.bfloat16, device="meta")
    w = torch.zeros(5, 3, dtype=torch.bfloat16, device="meta")
    with pytest.raises(MXNetError, match="route 'wgmma' does not take"):
        ms._launch(x, w, "wgmma")
