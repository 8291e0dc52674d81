"""``rtc``'s user kernels on the card: an ``Rtc`` CUDA kernel (NVRTC) and a
``TritonKernel`` against their plain versions, a refused launch, pushes
with new tensors each call, pushes after the thread's current CUDA
context changed (cleared, another context, a new thread), both wrappers
captured in a CUDA graph and replayed, and a first push inside a capture
refused.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rtc_card.py -q

Without CUDA each test skips, with its reason. Tolerance: exact (``2x``
rounds the same everywhere).
"""
import ctypes
import threading
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


@pytest.mark.gpu
def test_rtc_push_with_new_tensors_each_call():
    """Every push carries its own tensors' pointers: results land in the
    arrays of that push, also after earlier arrays were freed and their
    memory handed out again."""
    _need_card()
    r = _rng("fresh")
    k = None
    for i in range(6):
        x = mt.nd.array(r.standard_normal((8, 128)), ctx=mt.gpu(0))
        y = mt.nd.zeros((8, 128), ctx=mt.gpu(0))
        if k is None:
            k = rtc.Rtc("scale", [("x", x)], [("y", y)], SCALE_BODY)
        k.push([x], [y], (8,), (128,))
        np.testing.assert_array_equal(y.asnumpy(), 2.0 * x.asnumpy())
        del x, y


@pytest.mark.gpu
def test_rtc_push_after_the_thread_context_changed():
    """A push makes its kernel's context current in the calling thread
    whatever is current there: no context (cleared, or a thread that never
    touched CUDA), or another library's own context on the same device."""
    _need_card()
    r = _rng("ctx")
    drv = rtc._lib("driver")
    vp = ctypes.c_void_p
    x = mt.nd.array(r.standard_normal((8, 128)), ctx=mt.gpu(0))
    y = mt.nd.zeros((8, 128), ctx=mt.gpu(0))
    k = rtc.Rtc("scale", [("x", x)], [("y", y)], SCALE_BODY)
    k.push([x], [y], (8,), (128,))
    torch.cuda.synchronize()
    primary = k._funcs[0][0].value

    def current():
        cur = vp()
        assert drv.cuCtxGetCurrent(ctypes.byref(cur)) == 0
        return cur.value

    dev = ctypes.c_int()
    assert drv.cuDeviceGet(ctypes.byref(dev), 0) == 0
    create, destroy = drv.cuCtxCreate_v2, drv.cuCtxDestroy_v2
    create.argtypes = [ctypes.POINTER(vp), ctypes.c_uint, ctypes.c_int]
    destroy.argtypes = [vp]
    create.restype = destroy.restype = ctypes.c_int
    other = vp()
    try:
        for switch in ("cleared", "another context"):
            # new values while PyTorch's (primary) context is current
            x.data.copy_(torch.from_numpy(r.standard_normal((8, 128))
                                          .astype(np.float32)))
            torch.cuda.synchronize()
            if switch == "cleared":
                assert drv.cuCtxSetCurrent(None) == 0
            else:       # made current by its creation
                assert create(ctypes.byref(other), 0, dev) == 0
                assert current() == other.value != primary
            k.push([x], [y], (8,), (128,))
            assert current() == primary, switch
            torch.cuda.synchronize()
            np.testing.assert_array_equal(y.asnumpy(), 2.0 * x.asnumpy())
    finally:
        if other.value:
            assert destroy(other) == 0

    x2 = mt.nd.array(r.standard_normal((8, 128)), ctx=mt.gpu(0))
    y2 = mt.nd.zeros((8, 128), ctx=mt.gpu(0))
    got = []

    def push_in_a_new_thread():
        k.push([x2], [y2], (8,), (128,))
        got.append(current())

    t = threading.Thread(target=push_in_a_new_thread)
    t.start()
    t.join()
    torch.cuda.synchronize()
    assert got == [primary]
    np.testing.assert_array_equal(y2.asnumpy(), 2.0 * x2.asnumpy())


def _triton_scale():
    import triton
    import triton.language as tl

    @triton.jit
    def scale(x_ptr, n, o_ptr, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        tl.store(o_ptr + offs, tl.load(x_ptr + offs, mask=m) * 2.0, mask=m)

    return rtc.TritonKernel(scale, out_like=0, BLOCK=256,
                            grid=lambda meta: (triton.cdiv(meta["n"],
                                                           meta["BLOCK"]),))


@pytest.mark.gpu
def test_rtc_and_triton_kernel_captured_in_a_cuda_graph():
    """An Rtc push and a TritonKernel call, each made once eagerly, then
    captured into a CUDA graph: replays after new input values equal the
    eager results on those values."""
    _need_card()
    r = _rng("graph")
    x = mt.nd.array(r.standard_normal((8, 128)), ctx=mt.gpu(0))
    y = mt.nd.zeros((8, 128), ctx=mt.gpu(0))
    k = rtc.Rtc("scale", [("x", x)], [("y", y)], SCALE_BODY)
    tk = _triton_scale()
    k.push([x], [y], (8,), (128,))
    tk(x, 1024)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    before = rtc.RTC_LAUNCHES
    with torch.cuda.graph(g):
        k.push([x], [y], (8,), (128,))
        out = tk(x, 1024)
    assert rtc.RTC_LAUNCHES == before + 1
    for _ in range(3):
        x.data.copy_(torch.from_numpy(r.standard_normal((8, 128))
                                      .astype(np.float32)))
        g.replay()
        torch.cuda.synchronize()
        want = 2.0 * x.asnumpy()
        np.testing.assert_array_equal(y.asnumpy(), want)
        np.testing.assert_array_equal(out.asnumpy(), want)


@pytest.mark.gpu
def test_first_push_inside_a_capture_raises():
    _need_card()
    x = mt.nd.zeros((8, 128), ctx=mt.gpu(0))
    y = mt.nd.zeros((8, 128), ctx=mt.gpu(0))
    k = rtc.Rtc("scale_fresh", [("x", x)], [("y", y)], SCALE_BODY)
    g = torch.cuda.CUDAGraph()
    with pytest.raises(MXNetError, match="push it once before the capture"):
        with torch.cuda.graph(g):
            k.push([x], [y], (8,), (128,))
    # outside a capture the same push compiles and runs
    k.push([x], [y], (8,), (128,))
    torch.cuda.synchronize()
