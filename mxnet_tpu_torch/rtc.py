"""Runtime-compiled user kernels: the user-kernel escape hatch.

Counterpart of ``mxnet_tpu/rtc.py``: ``PallasKernel`` (:30) wraps a user
Pallas kernel body with a grid and an output shape, and ``Rtc`` (:91) only
raises there, since a TPU runs no CUDA. Here both meanings are on the card:

- :class:`TritonKernel` is ``PallasKernel``'s counterpart: a user
  ``@triton.jit`` kernel called as ``kernel[grid](*inputs, *outputs,
  **meta)``, with the outputs allocated from ``out_like`` as the JAX
  package resolves it. For CPU tensors it runs the user's plain
  ``reference`` function instead (the JAX package runs Pallas in
  interpret mode off the TPU); for CUDA tensors it launches the Triton
  kernel or raises, and never runs ``reference``.
- :class:`Rtc` is the reference's ``mx.rtc.Rtc`` (ref: src/common/mxrtc.cc,
  python/mxnet/rtc.py): CUDA source, decorated as ``MXRtc::decorate`` does,
  compiled at run time with NVRTC for the card's architecture (``sm_90a``
  on an H100), loaded and launched with the CUDA driver API on PyTorch's
  current stream, all through ``ctypes``. Float32 only, as in the
  reference.

Neither computes anything itself: the wrapper's work is marshalling
NDArrays in and out, resolving the output spec and the grid, and the
launch. A user kernel on the card is bounded by the bytes it moves (each
input read once, each output written once, at 3.35 TB/s on an H100) unless
it does far more arithmetic than the elementwise kernels the JAX package's
tests run; ``chip_smoke.py`` times the wrapper's host cost per call beside
a direct launch.

:data:`TRITON_LAUNCHES` and :data:`RTC_LAUNCHES` count the launches on the
card (one per call that launched). :func:`launch_cost` is a user kernel's
cost as the JAX package's roofline prices a custom call: ``flopcheck``
prices a ``TritonKernel`` call of a shape-only dry run by it (fake card
inputs: the outputs made, no launch), and ``chip_smoke.py``
bounds a launch by it. ``Rtc.push`` writes into outputs it is given and
takes real card arrays only.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
import sys
import threading

import numpy as np
import torch

from .base import MXNetError, note_kernel, shape_only, torch_dtype
from .context import raw_stream
from .ndarray import NDArray

#: Triton kernel launches by :class:`TritonKernel` (one per call on the card)
TRITON_LAUNCHES = 0

#: kernel launches by :meth:`Rtc.push`
RTC_LAUNCHES = 0


class PallasKernel(object):
    """The JAX package's user-kernel wrapper: Pallas has no meaning on the
    card, so this raises and names :class:`TritonKernel`."""

    def __init__(self, *args, **kwargs):
        raise MXNetError(
            "mx.rtc.PallasKernel wraps a Pallas kernel, which runs on a TPU. "
            "Write the kernel with Triton and wrap it with "
            "mx.rtc.TritonKernel (same out_like and grid contract), or "
            "write it in CUDA for mx.rtc.Rtc.")


def launch_cost(inputs, outputs):
    """``(operations, bytes)`` of one user-kernel launch, as the JAX
    package prices a custom call: one operation per output element, and
    each input and output array's bytes once (Python scalars are free)."""
    ts = [getattr(a, "_data", a) for a in list(inputs) + list(outputs)]
    ts = [t for t in ts if isinstance(t, torch.Tensor)]
    outs = [getattr(a, "_data", a) for a in outputs]
    return (float(sum(t.numel() for t in outs)),
            sum(t.numel() * t.element_size() for t in ts))


def _is_spec(spec):
    """A single explicit output spec: ``(shape, dtype)`` or an object with
    ``shape`` and ``dtype``."""
    if isinstance(spec, tuple) and len(spec) == 2 and isinstance(
            spec[0], (tuple, list, torch.Size)):
        return True
    return hasattr(spec, "shape") and hasattr(spec, "dtype")


class TritonKernel(object):
    """Wrap a user Triton kernel into an NDArray-callable.

    Parameters
    ----------
    kernel : ``@triton.jit`` function
        Called as ``kernel[grid](*inputs, *outputs, **meta)``.
    out_like : int, (shape, dtype), or a list of either
        Output spec: an input index to mirror, an explicit shape and dtype
        (or anything with ``.shape`` and ``.dtype``), or a list of these for
        several outputs. Outputs are ``torch.empty`` on the inputs' device.
    grid : tuple or callable, optional
        The launch grid, or a callable of the kernel's arguments and
        meta-parameters (Triton's own convention); default one program.
    reference : callable, optional
        Plain PyTorch version ``reference(*inputs) -> output(s)``, run for
        CPU tensors only.
    **meta
        Keyword arguments of every launch (``BLOCK=1024``, ``num_warps``).

    Inputs are NDArrays, tensors or numpy arrays (contiguous, on one
    device) and Python scalars, passed on in order.
    """

    def __init__(self, kernel, out_like=0, grid=None, reference=None,
                 in_specs=None, out_specs=None, interpret=None, **meta):
        for what, val in (("in_specs", in_specs), ("out_specs", out_specs),
                          ("interpret", interpret)):
            if val is not None:
                raise MXNetError(
                    "TritonKernel: %s has no Triton meaning (a Triton kernel "
                    "computes its own offsets from tl.program_id, and CPU "
                    "tensors run `reference`); leave it out" % what)
        self.kernel = kernel
        self.out_like = out_like
        self.grid = grid
        self._grid = grid if grid is not None else (1,)
        self.reference = reference
        self.meta = meta
        # out_like resolved once: an explicit spec to (shape, torch dtype),
        # an input index kept to read that input's shape at each call
        self._several = isinstance(out_like, (list, tuple)) and not _is_spec(
            out_like)
        self._specs = [s if isinstance(s, int) else _resolve_spec(s)
                       for s in (out_like if self._several else [out_like])]

    def _mirrored(self, vals):
        """This call's output specs: ``(shape, torch dtype)``, or the input
        tensor an output mirrors."""
        specs = []
        for s in self._specs:
            if isinstance(s, int):
                a = vals[s]
                if not isinstance(a, torch.Tensor):
                    raise MXNetError("TritonKernel: out_like=%d names a "
                                     "scalar input" % s)
                s = a
            specs.append(s)
        return specs

    def __call__(self, *args):
        vals = []
        dev = None
        several = False
        loose = None        # the first input that is not contiguous
        for i, a in enumerate(args):
            if isinstance(a, NDArray):
                a = a._data
            elif isinstance(a, np.ndarray):
                a = torch.from_numpy(np.ascontiguousarray(a))
            if isinstance(a, torch.Tensor):
                if dev is None:
                    dev = a.device
                elif a.device != dev:
                    several = True
                if loose is None and not a.is_contiguous():
                    loose = i
            vals.append(a)
        if dev is None:
            raise MXNetError("TritonKernel: no array input")
        if several:
            raise MXNetError("TritonKernel: inputs on several devices %s"
                             % sorted({str(v.device) for v in vals
                                       if isinstance(v, torch.Tensor)}))
        specs = self._mirrored(vals)
        if dev.type == "cuda":
            if loose is not None:
                raise MXNetError("TritonKernel: input %d is not contiguous "
                                 "(the kernel gets a pointer only)" % loose)
            # an output mirroring a (contiguous) input: empty_like, the
            # cheaper allocation
            outs = [torch.empty_like(s) if isinstance(s, torch.Tensor)
                    else torch.empty(s[0], dtype=s[1], device=dev)
                    for s in specs]
            first = next(v for v in vals if isinstance(v, torch.Tensor))
            if shape_only(first):
                # a dry run: the launch it stands for, priced, not run
                note_kernel("rtc.TritonKernel",
                            *launch_cost(vals, outs), "float32",
                            inputs=[v for v in vals
                                    if isinstance(v, torch.Tensor)])
            else:
                self._launch(vals, outs, dev)
        elif self.reference is None:
            raise MXNetError(
                "TritonKernel: the inputs are on %s; a Triton kernel runs on "
                "the card only, and no plain `reference` function was given "
                "for other devices" % dev)
        else:
            outs = self.reference(*vals)
            outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
            specs = [(tuple(s.shape), s.dtype) if isinstance(s, torch.Tensor)
                     else s for s in specs]
            got = [(tuple(o.shape), o.dtype) for o in outs]
            if got != specs:
                raise MXNetError("TritonKernel: reference returned %s, "
                                 "out_like specifies %s" % (got, specs))
        if self._several:
            return [NDArray(o) for o in outs]
        return NDArray(outs[0])

    def _launch(self, vals, outs, dev):
        global TRITON_LAUNCHES
        if not _TRITON:
            _import_triton(dev)
        # Triton launches on the current device's stream: switch devices
        # only where the inputs lie elsewhere
        if dev.index == torch.accelerator.current_device_index():
            self.kernel[self._grid](*vals, *outs, **self.meta)
        else:
            with torch.cuda.device(dev):
                self.kernel[self._grid](*vals, *outs, **self.meta)
        TRITON_LAUNCHES += 1


def _resolve_spec(spec):
    """An explicit output spec, ``(shape, dtype)`` or an object with
    ``shape`` and ``dtype``, as ``(shape tuple, torch dtype)``."""
    if isinstance(spec, tuple) and len(spec) == 2:
        return tuple(spec[0]), torch_dtype(spec[1])
    return tuple(spec.shape), torch_dtype(spec.dtype)


#: triton, once imported by a launch
_TRITON = []


def _import_triton(dev):
    """Import triton once (inside a launch: the CPU tests import this
    module on hosts without it)."""
    try:
        import triton
    except ImportError:
        raise MXNetError("TritonKernel: the triton package is not "
                         "installed, so the kernel cannot run on %s" % dev)
    _TRITON.append(triton)


# ---------------------------------------------------------------------------
# Rtc: CUDA source through NVRTC and the driver API
# ---------------------------------------------------------------------------

def decorate(name, inputs, outputs, kernel):
    """The reference's ``MXRtc::decorate``: an ``extern "C" __global__``
    function over ``const float*`` inputs and ``float*`` outputs, then for
    each array ``<n>_ndim`` and ``<n>_dims[]`` from its shape, then the
    body."""
    params = ["const float* %s" % n for n, _ in inputs]
    params += ["float* %s" % n for n, _ in outputs]
    src = '\nextern "C" __global__ void %s(%s) {\n' % (name, ",".join(params))
    for n, a in list(inputs) + list(outputs):
        shape = a.shape
        if not shape:
            raise MXNetError("Rtc: array %r has no dimensions" % n)
        if max(shape) > 2 ** 31 - 1:
            raise MXNetError("Rtc: array %r has a dimension past int "
                             "range: %s" % (n, shape))
        src += "const int %s_ndim = %d;\n" % (n, len(shape))
        src += "const int %s_dims[] = {%s};\n" % (
            n, ",".join(str(int(d)) for d in shape))
    return src + kernel + "\n}\n"


_LIBS = {}
_LIB_LOCK = threading.Lock()


def _nvrtc_candidates():
    cands = []
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home:
            cands += sorted(glob.glob(os.path.join(home, "lib64",
                                                   "libnvrtc.so*")))
    for d in sys.path:
        cands += sorted(glob.glob(os.path.join(
            d, "nvidia", "cuda_nvrtc", "lib", "libnvrtc.so*")))
    cands += [p for p in sorted(glob.glob(os.path.join(
        os.path.dirname(torch.__file__), "lib", "libnvrtc*.so*")))
        if "builtins" not in os.path.basename(p)]
    found = ctypes.util.find_library("nvrtc")
    if found:
        cands.append(found)
    return cands


def _load_nvrtc():
    tried = []
    for path in _nvrtc_candidates():
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            tried.append("%s (%s)" % (path, e))
            continue
        P, c_int, c_size_t = ctypes.POINTER, ctypes.c_int, ctypes.c_size_t
        vp, cp = ctypes.c_void_p, ctypes.c_char_p
        for fn, args in (
                ("nvrtcVersion", [P(c_int), P(c_int)]),
                ("nvrtcCreateProgram", [P(vp), cp, cp, c_int, vp, vp]),
                ("nvrtcCompileProgram", [vp, c_int, P(cp)]),
                ("nvrtcGetProgramLogSize", [vp, P(c_size_t)]),
                ("nvrtcGetProgramLog", [vp, cp]),
                ("nvrtcGetCUBINSize", [vp, P(c_size_t)]),
                ("nvrtcGetCUBIN", [vp, cp]),
                ("nvrtcDestroyProgram", [P(vp)])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = c_int
        lib.nvrtcGetErrorString.argtypes = [c_int]
        lib.nvrtcGetErrorString.restype = cp
        return lib, path
    raise MXNetError("Rtc: no NVRTC library could be loaded (tried: %s); "
                     "set CUDA_HOME to a CUDA toolkit" % (
                         "; ".join(tried) or "no candidate found"))


def _load_driver():
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError as e:
        raise MXNetError("Rtc: the CUDA driver library libcuda.so.1 could "
                         "not be loaded (%s)" % e)
    P, c_int, c_uint = ctypes.POINTER, ctypes.c_int, ctypes.c_uint
    vp, cp = ctypes.c_void_p, ctypes.c_char_p
    for fn, args in (
            ("cuInit", [c_uint]),
            ("cuDeviceGet", [P(c_int), c_int]),
            ("cuDevicePrimaryCtxRetain", [P(vp), c_int]),
            ("cuCtxSetCurrent", [vp]),
            ("cuCtxGetCurrent", [P(vp)]),
            ("cuModuleLoadData", [P(vp), vp]),
            ("cuModuleGetFunction", [P(vp), vp, cp]),
            ("cuLaunchKernel", [vp] + [c_uint] * 7 + [vp, P(vp), P(vp)]),
            ("cuGetErrorString", [c_int, P(cp)])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = c_int
    return lib


def _lib(which):
    with _LIB_LOCK:
        if which not in _LIBS:
            _LIBS[which] = _load_nvrtc() if which == "nvrtc" \
                else _load_driver()
        return _LIBS[which]


def _check_cu(drv, res, what):
    if res != 0:
        msg = ctypes.c_char_p()
        drv.cuGetErrorString(res, ctypes.byref(msg))
        raise MXNetError("Rtc: %s failed: CUresult %d (%s)" % (
            what, res, (msg.value or b"unknown").decode()))


def _arch(dev):
    major, minor = torch.cuda.get_device_capability(dev)
    # the arch-specific target on Hopper, as the port's nvcc builds use
    return "sm_%d%d%s" % (major, minor, "a" if (major, minor) == (9, 0)
                          else "")


def compile_cubin(source, name, arch):
    """NVRTC ``source`` for ``arch`` (``sm_90a``) -> the CUBIN bytes;
    raises with NVRTC's log on a failed compile."""
    lib, _path = _lib("nvrtc")

    def check(res, what):
        if res != 0:
            raise MXNetError("Rtc: %s failed: %s" % (
                what, lib.nvrtcGetErrorString(res).decode()))

    prog = ctypes.c_void_p()
    check(lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                 (name + ".cu").encode(), 0, None, None),
          "nvrtcCreateProgram")
    try:
        opts = [("--gpu-architecture=%s" % arch).encode()]
        res = lib.nvrtcCompileProgram(prog, len(opts),
                                      (ctypes.c_char_p * len(opts))(*opts))
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log = ctypes.create_string_buffer(size.value)
        lib.nvrtcGetProgramLog(prog, log)
        if res != 0:
            raise MXNetError("Rtc: NVRTC could not compile kernel %r for %s "
                             "(%s):\n%s\n--- source ---\n%s" % (
                                 name, arch,
                                 lib.nvrtcGetErrorString(res).decode(),
                                 log.value.decode(errors="replace"), source))
        check(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
              "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        check(lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _dims3(dims, what):
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise MXNetError("Rtc.push: %s must be 1 to 3 positive ints, got %r"
                         % (what, dims))
    return dims + (1,) * (3 - len(dims))


def _make_dims(grid_dims, block_dims):
    return (ctypes.c_uint * 6)(*_dims3(grid_dims, "grid_dims"),
                               *_dims3(block_dims, "block_dims"))


#: (grid_dims, block_dims) -> the launch shape as the C launcher takes it
#: (grid x, y, z, block x, y, z), checked and made once per shape pushed
_DIMS = {}


def _launch_dims(grid_dims, block_dims):
    try:
        return _DIMS[grid_dims, block_dims]
    except KeyError:
        if len(_DIMS) >= 1024:
            _DIMS.clear()
        dims = _DIMS[grid_dims, block_dims] = _make_dims(grid_dims,
                                                         block_dims)
        return dims
    except TypeError:       # lists: not hashable
        return _make_dims(grid_dims, block_dims)


class _Args(threading.local):
    """One thread's ``kernelParams`` for a kernel of ``n`` arguments, made
    once per thread: ``values`` holds the arguments (device pointers) and
    ``params`` their addresses. Every push rewrites every value
    (:func:`_pack`), so no pointer outlives the push it came from."""

    def __init__(self, n):
        self.values = (ctypes.c_void_p * n)()
        base = ctypes.addressof(self.values)
        size = ctypes.sizeof(ctypes.c_void_p)
        self.params = (ctypes.c_void_p * n)(*[base + i * size
                                              for i in range(n)])


_F32 = torch.float32


def _pack(values, arrays, name):
    """Check a push's arrays in one pass (float32, contiguous, one device)
    and write each one's current ``data_ptr()`` into ``values``. Returns
    the arrays' device index (-1 on the CPU); raises with :func:`_reject`'s
    message on anything else."""
    dev = None
    try:
        for i, a in enumerate(arrays):
            t = a._data if isinstance(a, NDArray) else a
            if t.dtype is not _F32 or not t.is_contiguous():
                _reject(arrays, name)
            d = t.get_device()
            if dev is None:
                dev = d
            elif d != dev:
                _reject(arrays, name)
            values[i] = t.data_ptr()
    except AttributeError:      # not an array
        _reject(arrays, name)
    if dev is None:
        raise MXNetError("Rtc.push: kernel %r has no arrays" % name)
    return dev


def _reject(arrays, name):
    """Raise for the first array a push cannot take, array by array:
    not an NDArray, not float32, not on the card, not contiguous; then
    arrays on several devices."""
    for i, a in enumerate(arrays):
        t = a.data if isinstance(a, NDArray) else a
        what = "array %d of kernel %r" % (i, name)
        if not isinstance(t, torch.Tensor):
            raise MXNetError("Rtc.push: %s is not an NDArray" % what)
        if t.dtype != torch.float32:
            raise MXNetError("Rtc.push: %s is %s; Rtc kernels take "
                             "float32 only" % (what, t.dtype))
        if not t.is_cuda:
            raise MXNetError("Rtc.push: %s is on %s; Rtc kernels run on "
                             "the card only" % (what, t.device))
        if not t.is_contiguous():
            raise MXNetError("Rtc.push: %s is not contiguous (the kernel "
                             "gets a pointer only)" % what)
    raise MXNetError("Rtc.push: arrays on several devices")


_LAUNCH = []


def _launcher():
    """``[rtc_launch]`` of ``csrc/rtc_launch.cu`` (built at first use):
    cuLaunchKernel behind five pointer arguments, which ctypes converts
    faster than cuLaunchKernel's eleven; it makes the kernel's context
    current in the calling thread first where another one is."""
    with _LIB_LOCK:
        if not _LAUNCH:
            from . import cuda_build
            fn = cuda_build.load("rtc_launch").rtc_launch
            fn.argtypes = [ctypes.c_void_p] * 5
            fn.restype = ctypes.c_int
            _LAUNCH.append(fn)
    return _LAUNCH


class Rtc(object):
    """A CUDA kernel compiled at run time (ref: mx.rtc.Rtc).

    Parameters
    ----------
    name : str
        The kernel's name.
    inputs, outputs : list of (name, NDArray)
        The kernel's parameters: ``const float* <name>`` for each input,
        ``float* <name>`` for each output, in order. Their shapes give the
        ``<name>_ndim`` and ``<name>_dims[]`` constants of the body.
    kernel : str
        The body of the kernel, in CUDA C.

    The decorated source (:attr:`source`) is compiled with NVRTC at the
    first :meth:`push` on a device and loaded into that device's primary
    context, the one PyTorch uses. Later pushes reuse the function, the
    calling thread's ``kernelParams`` arrays and the launch shape, so a
    push costs little more than the launch itself, and pushes work inside
    ``torch.cuda.graph`` capture once the kernel has been pushed on that
    device before the capture.
    """

    def __init__(self, name, inputs, outputs, kernel):
        for n, a in list(inputs) + list(outputs):
            if a.dtype != np.float32:
                raise MXNetError("Rtc: array %r is %s; Rtc kernels take "
                                 "float32 only" % (n, a.dtype))
        self.name = name
        self.num_inputs = len(inputs)
        self.num_outputs = len(outputs)
        self.source = decorate(name, inputs, outputs, kernel)
        self._funcs = {}    # device index -> (context, module, function)
        self._lock = threading.Lock()
        self._args = _Args(self.num_inputs + self.num_outputs)

    def _function(self, index):
        with self._lock:
            got = self._funcs.get(index)
            if got is not None:
                return got
            if torch.cuda.is_current_stream_capturing():
                raise MXNetError(
                    "Rtc.push: kernel %r has not been pushed on cuda:%d "
                    "before, and it cannot be compiled (NVRTC) and loaded "
                    "while a CUDA graph is being captured; push it once "
                    "before the capture" % (self.name, index))
            drv = _lib("driver")
            _check_cu(drv, drv.cuInit(0), "cuInit")
            cudev = ctypes.c_int()
            _check_cu(drv, drv.cuDeviceGet(ctypes.byref(cudev), index),
                      "cuDeviceGet")
            ctx = ctypes.c_void_p()
            # the device's primary context: the one PyTorch's runtime uses
            _check_cu(drv, drv.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                        cudev),
                      "cuDevicePrimaryCtxRetain")
            _check_cu(drv, drv.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
            cubin = compile_cubin(self.source, self.name,
                                  _arch(torch.device("cuda", index)))
            mod = ctypes.c_void_p()
            _check_cu(drv, drv.cuModuleLoadData(ctypes.byref(mod), cubin),
                      "cuModuleLoadData")
            fn = ctypes.c_void_p()
            _check_cu(drv, drv.cuModuleGetFunction(ctypes.byref(fn), mod,
                                                   self.name.encode()),
                      "cuModuleGetFunction")
            self._funcs[index] = (ctx, mod, fn)
            return ctx, mod, fn

    def push(self, inputs, outputs, grid_dims, block_dims):
        """Launch on the card over ``inputs`` and ``outputs`` (lists of
        NDArrays: float32, contiguous, on one CUDA device) with the given
        grid and block (1 to 3 ints each), on PyTorch's current stream,
        without synchronising. Outputs are written in place."""
        global RTC_LAUNCHES
        if len(inputs) != self.num_inputs or len(outputs) != self.num_outputs:
            raise MXNetError("Rtc.push: kernel %r takes %d inputs and %d "
                             "outputs, got %d and %d"
                             % (self.name, self.num_inputs, self.num_outputs,
                                len(inputs), len(outputs)))
        arrays = (*inputs, *outputs)
        args = self._args
        index = _pack(args.values, arrays, self.name)
        if index < 0:
            _reject(arrays, self.name)
        dims = _launch_dims(grid_dims, block_dims)
        ctx, _mod, fn = self._funcs.get(index) or self._function(index)
        # the launcher makes ctx current in this thread where another
        # context is (every push: PyTorch or another library may have
        # switched it since); a refused launch (too many threads a block)
        # never runs, and only this result reports it
        res = (_LAUNCH or _launcher())[0](fn, ctx, dims, raw_stream(index),
                                          args.params)
        if res:
            _check_cu(_lib("driver"), res,
                      "cuCtxSetCurrent or cuLaunchKernel of %r with grid "
                      "%s, block %s" % (self.name, tuple(dims[:3]),
                                        tuple(dims[3:])))
        RTC_LAUNCHES += 1
