"""``rtc``'s user kernels on the card: an ``Rtc`` CUDA kernel (NVRTC) and a
``TritonKernel`` against their plain versions, and a refused launch.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rtc_card.py -q

Without CUDA each test skips, with its reason. Tolerance: exact (``2x``
rounds the same everywhere).
"""
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError

SCALE_BODY = ("int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
              "if (i < x_dims[0] * x_dims[1]) y[i] = 2.0f * x[i];")


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: Rtc and TritonKernel launch only "
                    "on the card (chip_smoke.py phase 7 runs them)")


@pytest.mark.gpu
def test_rtc_scale_on_the_card():
    _need_card()
    x = mt.nd.array(_rng("card").standard_normal((8, 128)), ctx=mt.gpu(0))
    y = mt.nd.zeros((8, 128), ctx=mt.gpu(0))
    k = rtc.Rtc("scale", [("x", x)], [("y", y)], SCALE_BODY)
    before = rtc.RTC_LAUNCHES
    k.push([x], [y], (8,), (128,))
    torch.cuda.synchronize()
    assert rtc.RTC_LAUNCHES == before + 1
    np.testing.assert_array_equal(y.asnumpy(), 2.0 * x.asnumpy())
    with pytest.raises(MXNetError, match="cuLaunchKernel"):
        k.push([x], [y], (1,), (2048,))


@pytest.mark.gpu
def test_triton_kernel_scale_on_the_card():
    _need_card()
    import triton
    import triton.language as tl

    @triton.jit
    def scale(x_ptr, n, o_ptr, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        tl.store(o_ptr + offs, tl.load(x_ptr + offs, mask=m) * 2.0, mask=m)

    x = mt.nd.array(_rng("tcard").standard_normal((1000,)), ctx=mt.gpu(0))
    k = rtc.TritonKernel(scale, out_like=0, BLOCK=256,
                         grid=lambda meta: (triton.cdiv(meta["n"],
                                                        meta["BLOCK"]),))
    y = k(x, 1000)
    np.testing.assert_array_equal(y.asnumpy(), 2.0 * x.asnumpy())
