"""``rtc`` of the PyTorch port on the CPU: what can be checked without the
card. ``Rtc``'s decorated source against the reference's ``MXRtc::decorate``
layout, ``TritonKernel``'s ``out_like`` resolution and its plain
``reference`` on CPU tensors, ``Rtc.push``'s argument packing (each push
writes its own arrays' pointers into per-thread kernelParams) and launch
shape cache, the precise errors of ``Rtc``,
``TritonKernel`` and ``PallasKernel``, and the JAX package's ``PallasKernel``
test kernels (interpret mode) against the port's plain versions of them.

The kernels themselves run only on the card: ``chip_smoke.py`` (phase 7)
builds and holds them against their plain versions, and so do the
``gpu``-marked tests of ``tests/test_torch_rtc_card.py`` where a card is
present. Tolerances: ``scale`` exactly
(one multiplication by 2 rounds the same everywhere); ``addmul``
``rtol=1e-6``: a compiler may contract ``a*b + a`` into one fused
multiply-add, which rounds once instead of twice.
"""
import ctypes
import threading
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _cpu(a):
    return mt.nd.array(a, ctx=mt.cpu())


SCALE_BODY = ("int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
              "if (i < x_dims[0] * x_dims[1]) y[i] = 2.0f * x[i];")


def test_decorated_source_is_the_reference_layout():
    x = _cpu(np.zeros((8, 128), np.float32))
    b = _cpu(np.zeros((3,), np.float32))
    y = _cpu(np.zeros((8, 128), np.float32))
    k = rtc.Rtc("scale", [("x", x), ("b", b)], [("y", y)], SCALE_BODY)
    assert k.source == (
        '\nextern "C" __global__ void scale(const float* x,const float* b,'
        'float* y) {\n'
        "const int x_ndim = 2;\n"
        "const int x_dims[] = {8,128};\n"
        "const int b_ndim = 1;\n"
        "const int b_dims[] = {3};\n"
        "const int y_ndim = 2;\n"
        "const int y_dims[] = {8,128};\n"
        + SCALE_BODY + "\n}\n")
    assert (k.num_inputs, k.num_outputs) == (2, 1)


def test_rtc_errors_on_the_cpu():
    x = _cpu(np.ones((4,), np.float32))
    with pytest.raises(MXNetError, match="float32 only"):
        rtc.Rtc("k", [("x", _cpu(np.ones((4,), np.float16)))], [("y", x)],
                "")
    with pytest.raises(MXNetError, match="no dimensions"):
        rtc.Rtc("k", [("x", _cpu(np.float32(1.0)))], [("y", x)], "")
    k = rtc.Rtc("k", [("x", x)], [("y", x)], "y[0] = x[0];")
    with pytest.raises(MXNetError, match="card only"):
        k.push([x], [x], (1,), (1,))
    with pytest.raises(MXNetError, match="takes 1 inputs and 1 outputs"):
        k.push([x, x], [x], (1,), (1,))
    with pytest.raises(MXNetError, match="float32 only"):
        k.push([_cpu(np.ones((4,), np.int32))], [x], (1,), (1,))
    before = rtc.RTC_LAUNCHES
    with pytest.raises(MXNetError):
        k.push([x], [x], (1,), (1,))
    assert rtc.RTC_LAUNCHES == before


def test_missing_nvrtc_names_the_paths_tried(monkeypatch):
    monkeypatch.setattr(rtc, "_nvrtc_candidates",
                        lambda: ["/nonexistent/lib64/libnvrtc.so"])
    with pytest.raises(MXNetError, match="/nonexistent/lib64/libnvrtc.so"):
        rtc._load_nvrtc()


def test_pallas_kernel_points_at_triton_kernel():
    with pytest.raises(MXNetError, match="TritonKernel"):
        rtc.PallasKernel(lambda x_ref, o_ref: None, out_like=0)
    # the JAX package's Rtc points the other way, at PallasKernel
    with pytest.raises(mx.MXNetError, match="PallasKernel"):
        mx.rtc.Rtc("k", [], [], "")


@pytest.mark.parametrize("opt", ["in_specs", "out_specs", "interpret"])
def test_triton_kernel_rejects_pallas_options(opt):
    with pytest.raises(MXNetError, match=opt):
        rtc.TritonKernel(None, **{opt: [None]})


def _scale_ref(x, *scalars):
    return x * 2.0


def _addmul_ref(a, b, *scalars):
    return a * b + a


def test_triton_kernel_runs_reference_on_the_cpu():
    x = _rng("ref").standard_normal((8, 128)).astype(np.float32)
    before = rtc.TRITON_LAUNCHES
    y = rtc.TritonKernel(None, out_like=0, reference=_scale_ref)(_cpu(x))
    assert isinstance(y, mt.nd.NDArray) and y.context == mt.cpu()
    np.testing.assert_array_equal(y.asnumpy(), 2.0 * x)
    assert rtc.TRITON_LAUNCHES == before   # nothing launched


@pytest.mark.parametrize("spec", ["index", "shape_dtype", "list", "object"])
def test_out_like_resolution(spec):
    r = _rng(spec)
    a = r.standard_normal((3, 4)).astype(np.float32)
    b = r.integers(0, 5, (2,)).astype(np.int32)
    if spec == "index":
        out_like, ref = 1, (lambda a, b: b + 1)
        want = [((2,), np.int32)]
    elif spec == "shape_dtype":
        out_like, ref = ((4, 3), "float16"), (lambda a, b: a.t().half())
        want = [((4, 3), np.float16)]
    elif spec == "list":
        out_like = [0, ((5,), np.float32)]
        ref = (lambda a, b: (a * 2, torch.zeros(5)))
        want = [((3, 4), np.float32), ((5,), np.float32)]
    else:
        out_like = torch.empty((1, 4), dtype=torch.float32, device="meta")
        ref = (lambda a, b: a[:1])
        want = [((1, 4), np.float32)]
    got = rtc.TritonKernel(None, out_like=out_like, reference=ref)(
        _cpu(a), _cpu(b))
    got = got if isinstance(got, list) else [got]
    assert [(g.shape, g.dtype) for g in got] == want


def test_triton_kernel_cpu_errors():
    x = _cpu(np.ones((2, 2), np.float32))
    with pytest.raises(MXNetError, match="no plain `reference`"):
        rtc.TritonKernel(None, out_like=0)(x)
    with pytest.raises(MXNetError, match="out_like specifies"):
        rtc.TritonKernel(None, out_like=((3,), "float32"),
                         reference=_scale_ref)(x)
    with pytest.raises(MXNetError, match="no array input"):
        rtc.TritonKernel(None, reference=_scale_ref)(3.0)
    with pytest.raises(MXNetError, match="scalar input"):
        rtc.TritonKernel(None, out_like=1, reference=_scale_ref)(x, 4)


@pytest.mark.parametrize("which", ["scale", "addmul"])
def test_jax_pallas_test_kernels_against_port_plain_versions(which):
    """The kernels of ``tests/test_rtc_plugin_predictor.py``: the JAX
    package's PallasKernel in interpret mode against the port's plain
    versions, on the same (8, 128) inputs."""
    r = _rng(which)
    a = r.random((8, 128), dtype=np.float32)
    b = r.random((8, 128), dtype=np.float32)
    if which == "scale":
        def kern(x_ref, o_ref):
            o_ref[...] = x_ref[...] * 2.0
        j = mx.rtc.PallasKernel(kern, out_like=0)(mx.nd.array(a))
        t = rtc.TritonKernel(None, out_like=0, reference=_scale_ref)(_cpu(a))
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    else:
        def kern(a_ref, b_ref, o_ref):
            o_ref[...] = a_ref[...] * b_ref[...] + a_ref[...]
        j = mx.rtc.PallasKernel(kern, out_like=0)(mx.nd.array(a),
                                                  mx.nd.array(b))
        t = rtc.TritonKernel(None, out_like=0, reference=_addmul_ref)(
            _cpu(a), _cpu(b))
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6,
                                   atol=0)


def test_packing_carries_each_push_s_own_pointers():
    """The per-thread kernelParams are made once, but every push writes its
    own arrays' data_ptr()s into them: a pointer from an earlier push (whose
    array may since have been freed) is never left in place."""
    args = rtc._Args(3)
    size = ctypes.sizeof(ctypes.c_void_p)
    assert [args.params[i] for i in range(3)] == [
        ctypes.addressof(args.values) + i * size for i in range(3)]
    r = _rng("pack")
    for step in range(4):
        arrays = [_cpu(r.standard_normal((5, step + 1)).astype(np.float32))
                  for _ in range(2)] + [torch.zeros(7)]
        assert rtc._pack(args.values, arrays, "k") == -1    # the CPU
        want = [a.data.data_ptr() if isinstance(a, mt.nd.NDArray)
                else a.data_ptr() for a in arrays]
        assert [args.values[i] for i in range(3)] == want
        del arrays


def test_packing_is_per_thread():
    args = rtc._Args(2)
    mine = ctypes.addressof(args.values)
    seen = []
    t = threading.Thread(target=lambda: seen.append(
        (ctypes.addressof(args.values), args.params[0])))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and len(seen) == 1
    theirs, their_param0 = seen[0]
    assert theirs != mine and their_param0 == theirs


def test_packing_rejects_what_a_push_cannot_take():
    args = rtc._Args(2)
    x = _cpu(np.ones((4,), np.float32))
    # array by array, in the order push always checked them
    with pytest.raises(MXNetError, match="array 0 .* float32 only"):
        rtc._pack(args.values, [torch.ones(4, dtype=torch.float64), x], "k")
    with pytest.raises(MXNetError, match="array 0 .* on cpu; Rtc kernels "
                                         "run on the card only"):
        rtc._pack(args.values, [x, torch.ones(4, dtype=torch.float64)], "k")
    with pytest.raises(MXNetError, match="array 0 .* is not an NDArray"):
        rtc._pack(args.values, [np.ones(4, np.float32), x], "k")
    with pytest.raises(MXNetError, match="has no arrays"):
        rtc._pack(args.values, [], "k")
    k = rtc.Rtc("k", [], [], "")
    with pytest.raises(MXNetError, match="has no arrays"):
        k.push([], [], (1,), (1,))


def test_launch_shape_is_checked_and_made_once():
    d = rtc._launch_dims((4,), (256,))
    assert list(d) == [4, 1, 1, 256, 1, 1]
    assert rtc._launch_dims((4,), (256,)) is d       # a shape pushed again
    assert list(rtc._launch_dims([2, 3], [32, 4, 2])) == [2, 3, 1, 32, 4, 2]
    for grid, block in (((0,), (1,)), ((1, 1, 1, 1), (1,)), ((1,), ())):
        with pytest.raises(MXNetError, match="must be 1 to 3 positive ints"):
            rtc._launch_dims(grid, block)


@pytest.mark.parametrize("out_like", [0, [0, ((5,), "float32")]])
def test_out_specs_follow_the_inputs(out_like):
    """Explicit specs are resolved once; a spec mirroring an input follows
    that input's shape and dtype at every call."""
    k = rtc.TritonKernel(
        None, out_like=out_like,
        reference=lambda a, n: (a * 2 if out_like == 0
                                else (a * 2, torch.zeros(5))))
    for shape, dtype in (((3, 4), np.float32), ((6,), np.float32),
                         ((2, 2), np.float64)):
        a = mt.nd.NDArray(torch.from_numpy(np.ones(shape, dtype)))
        got = k(a, 1)
        got = got if isinstance(got, list) else [got]
        assert (got[0].shape, got[0].dtype) == (shape, dtype)
        if out_like != 0:
            assert (got[1].shape, got[1].dtype) == ((5,), np.float32)
    with pytest.raises(MXNetError, match="out_like specifies"):
        rtc.TritonKernel(None, out_like=((3,), "float32"),
                         reference=lambda a: a)(_cpu(np.ones(4, np.float32)))


def test_triton_kernel_several_devices_raise():
    x = _cpu(np.ones((2,), np.float32))
    with pytest.raises(MXNetError, match="several devices"):
        rtc.TritonKernel(None, reference=_scale_ref)(
            x, torch.ones(2, device="meta"))
