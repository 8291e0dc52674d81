"""Matmul with a BatchNorm-statistics epilogue: a hand-written CUDA kernel,
its plain PyTorch version, and the Conv1x1->BatchNorm fusion helpers.

Counterpart of ``mxnet_tpu/ops/pallas_fused.py`` (Pallas kernel ``_kernel``,
entry ``matmul_stats``). A 1x1 NHWC convolution is a matmul, so for
``x`` (M, K) and the weight ``w`` as it lies, (N, K) (OIHW ``(F, C, 1, 1)``
reshaped, no transpose), both functions return ``y = x @ w.T`` in x's dtype
and the f32 column statistics ``s1 = sum(acc)``, ``s2 = sum(acc * acc)`` of
the f32 accumulator ``acc``:

- :func:`matmul_stats` launches ``csrc/matmul_stats.cu`` for CUDA tensors
  (the kernels' design and bounds are in that file's note) and takes the
  plain version for CPU tensors. On the card it launches the kernel that
  :func:`kernel_route` names for the shape or raises; it never falls
  back. It is differentiable: the backward is the
  JAX package's ``_mm_bwd``, with the statistics' cotangents folded into
  the output's (``dy + ds1 + 2 y ds2``) and two ``torch.matmul`` products,
  as the JAX package leaves them to XLA outside its kernel.
- :func:`matmul_stats_reference` is the plain version.
- A fake or meta tensor (``base.shape_only``: memcheck's dry run) off the
  CPU takes the shape-only route: outputs of the right shape, dtype and
  device, nothing computed, no launch counted (it counts in
  :data:`SHAPE_ONLY_CALLS`), and the launch it stands for handed to the
  dry run (``base.note_kernel``) at :func:`launch_cost`. A real CUDA
  tensor never takes it.
- :func:`launch_cost` and :func:`bound_seconds` are the kernel's cost: the
  bytes of one launch and its operations at its route's arithmetic
  (:data:`ARITH`). ``flopcheck`` prices a launch and ``chip_smoke.py``
  bounds one by them, so the two cannot drift apart.

:data:`LAUNCHES` counts the kernel launches of :func:`matmul_stats` (one per
call on the card) and :data:`LAUNCHES_BY_ROUTE` the same by route;
:data:`LAYOUT_COPIES` counts the activations that
:func:`apply_conv1x1_stats` had to copy because they were not
NHWC-contiguous. The counters move under one lock, since entry points run
on several threads; :func:`reset_launches` sets them to 0.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .. import devspec
from ..base import (MXNetError, attr_bool, attr_int, attr_str, attr_tuple,
                    note_kernel, shape_only)

#: kernel launches by :func:`matmul_stats` (one per call that ran on the card)
LAUNCHES = 0

#: the same launches by route (see :func:`kernel_route`)
LAUNCHES_BY_ROUTE = {"wgmma": 0, "wmma": 0, "tf32x3": 0, "f32": 0}

#: activations :func:`apply_conv1x1_stats` copied to make them contiguous
LAYOUT_COPIES = 0

#: calls on fake or meta CUDA tensors (memcheck's dry run), which took the
#: shape-only route: no kernel, no launch counted
SHAPE_ONLY_CALLS = 0

_COUNT_LOCK = threading.Lock()

_FN = None
_SM_COUNT = {}

#: rows of x per tile of the wgmma kernel (two warpgroups of 64)
WGMMA_BM = 128


#: the arithmetic of the kernel's routes -> (passes of the 2MNK products it
#: issues, the compute type whose peak bounds them, a
#: ``devspec.PEAK_BY_DTYPE`` key): bf16 on the tensor cores (``wgmma``,
#: ``wmma``), FP32 SIMT (``f32``), three TF32 products (``tf32x3``)
ARITH = {"bf16": (1, "bfloat16"), "f32": (1, "float32"),
         "tf32x3": (3, "tf32")}

#: each route's arithmetic
ROUTE_ARITH = {"wgmma": "bf16", "wmma": "bf16", "tf32x3": "tf32x3",
               "f32": "f32"}


def launch_cost(m, k, n, arith):
    """``(flops, bytes, compute, passes)`` of one launch at (M, K, N) on
    the arithmetic ``arith`` (:data:`ARITH`): 2MNK FLOPs, issued
    ``passes`` times at the peak of ``compute``; x and w read once, y and
    the (2, N) f32 statistics written once."""
    passes, compute = ARITH[arith]
    itemsize = 2 if arith == "bf16" else 4
    nbytes = (m * k + n * k + m * n) * itemsize + 2 * n * 4
    return 2.0 * m * n * k, nbytes, compute, passes


def bound_seconds(m, k, n, arith, kind="NVIDIA H100"):
    """``(seconds, "bytes" or "operations")``: the least time one launch
    can take on a device kind, the larger of :func:`launch_cost`'s bytes
    over its memory rate and its operations over the peak of their type
    (``devspec``)."""
    flops, nbytes, compute, passes = launch_cost(m, k, n, arith)
    t_bytes = nbytes / devspec.kind_spec(kind)[0].hbm_bytes_per_s
    t_ops = passes * flops / devspec.compute_peak(kind, compute)
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def _acc_dtype(dt):
    """Accumulator and statistics dtype: f32, f64 for f64 inputs (as the
    JAX package's ``_acc_dtype``)."""
    return torch.float64 if dt == torch.float64 else torch.float32


def matmul_stats_reference(x, w):
    """Plain PyTorch version: ``x`` (M, K), ``w`` (N, K) ->
    ``(y (M, N) in x's dtype, s1 (N,), s2 (N,))`` with the statistics taken
    from the f32 (f64 for f64 inputs) accumulator."""
    acc_dt = _acc_dtype(x.dtype)
    acc = x.to(acc_dt) @ w.to(acc_dt).t()
    return acc.to(x.dtype), acc.sum(0), (acc * acc).sum(0)


def kernel_route(m, k, n, dtype, aligned):
    """The kernel a CUDA call of :func:`matmul_stats` takes, by shape:

    - ``"wgmma"``: bfloat16 with ``k % 8 == 0``, ``n % 8 == 0`` and x, w
      16-byte aligned (``aligned``), the rows' byte strides TMA needs;
    - ``"wmma"``: any other bfloat16 shape (a tile kernel on ``mma.sync``
      through ``nvcuda::wmma``);
    - ``"tf32x3"``: float32 with ``k % 4 == 0``, ``n % 4 == 0`` and x, w
      16-byte aligned: the wgmma kernel's schedule on the tensor cores,
      each operand split into two TF32 terms and three products summed
      (FP32-level agreement with the plain version, whatever
      ``allow_tf32`` says);
    - ``"f32"``: any other float32 shape (FP32 FMA).

    Raises for another dtype. ``m`` does not decide the route: TMA clips
    the ragged M edge."""
    if dtype == torch.float32:
        return "tf32x3" if k % 4 == 0 and n % 4 == 0 and aligned else "f32"
    if dtype != torch.bfloat16:
        raise MXNetError("matmul_stats: the kernel takes float32 and "
                         "bfloat16, got %s" % dtype)
    if k % 8 == 0 and n % 8 == 0 and aligned:
        return "wgmma"
    return "wmma"


def wgmma_tile_n(m, n, sms):
    """The wgmma kernel's N-tile width for ``m`` rows and ``n`` columns on
    a card of ``sms`` streaming multiprocessors: 64 up to 64 columns, 128
    up to 128; wider, 256 or 128, whichever gives the fewer tile-columns
    per block of the persistent grid (rounds of ``sms`` tiles times the
    width), 256 on a tie, so that x is read once where the rounds allow."""
    if n <= 64:
        return 64
    if n <= 128:
        return 128
    tiles_m = -(-m // WGMMA_BM)

    def cost(bn):
        return -(-(tiles_m * -(-n // bn)) // sms) * bn
    return 256 if cost(256) <= cost(128) else 128


def tf32x3_tile_n(n):
    """The tf32x3 kernel's N-tile width: 64 up to 64 columns, else 128
    (f32 tiles are twice bf16's; a 256-wide tile and its f32 y staging do
    not fit in a block's shared memory)."""
    return 64 if n <= 64 else 128


def _kernel():
    global _FN
    if _FN is None:
        from .. import cuda_build
        lib = cuda_build.load("matmul_stats")
        lib.matmul_stats.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.matmul_stats.restype = ctypes.c_int
        lib.matmul_stats_wgmma.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.matmul_stats_wgmma.restype = ctypes.c_int
        lib.matmul_stats_tf32x3.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.matmul_stats_tf32x3.restype = ctypes.c_int
        for name, args in (("matmul_stats_block_m", [ctypes.c_int]),
                           ("matmul_stats_reduce_chunk", []),
                           ("matmul_stats_sm_count", [ctypes.c_int])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
        lib.matmul_stats_error_string.argtypes = [ctypes.c_int]
        lib.matmul_stats_error_string.restype = ctypes.c_char_p
        _FN = lib
    return _FN


def _sm_count(lib, index):
    if index not in _SM_COUNT:
        n = lib.matmul_stats_sm_count(index)
        if n <= 0:
            raise MXNetError("matmul_stats: no SM count for cuda:%d" % index)
        _SM_COUNT[index] = n
    return _SM_COUNT[index]


def _check(x, w):
    if x.dim() != 2 or w.dim() != 2:
        raise MXNetError("matmul_stats: x and w must be 2-d, got %s and %s"
                         % (tuple(x.shape), tuple(w.shape)))
    if x.shape[1] != w.shape[1]:
        raise MXNetError("matmul_stats: x (M, K) %s and w (N, K) %s disagree "
                         "on K" % (tuple(x.shape), tuple(w.shape)))
    if x.dtype != w.dtype:
        raise MXNetError("matmul_stats: x is %s, w is %s" % (x.dtype, w.dtype))


def _check_operands(x, w):
    """What a launch requires of its operands beyond :func:`_check`: one
    device, contiguous, not empty, within 32-bit element counts. The
    shape-only route checks it too, so a dry run refuses what the launch
    would."""
    if w.device != x.device:
        raise MXNetError("matmul_stats: w is on %s, x on %s"
                         % (w.device, x.device))
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise MXNetError("matmul_stats: %s must be contiguous" % name)
    m, k = x.shape
    n = w.shape[0]
    if m == 0 or n == 0 or k == 0:
        raise MXNetError("matmul_stats: empty operand (M, N, K) = (%d, %d, %d)"
                         % (m, n, k))
    if max(m * k, n * k, m * n) >= 2 ** 31:
        raise MXNetError("matmul_stats: operands of %d x %d x %d exceed the "
                         "kernel's 32-bit element counts" % (m, k, n))


def _launch(x, w, route=None):
    """The kernel on CUDA tensors; returns ``(y, s1, s2)``. ``route`` forces
    a kernel the shape qualifies for (``"wmma"`` takes every bfloat16
    shape, ``"f32"`` every float32 one), for comparisons; None takes
    :func:`kernel_route`'s."""
    _check_operands(x, w)
    dev = x.device
    m, k = x.shape
    n = w.shape[0]
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    best = kernel_route(m, k, n, x.dtype, aligned)
    if route is None:
        route = best
    elif route != best and (route, best) not in (("wmma", "wgmma"),
                                                 ("f32", "tf32x3")):
        raise MXNetError("matmul_stats: route %r does not take %s (M, K, N) "
                         "= (%d, %d, %d)" % (route, x.dtype, m, k, n))
    lib = _kernel()
    index = dev.index or 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if route in ("wgmma", "tf32x3"):
        # a row (2, N) of partials for each block of the persistent grid
        # (at most one a streaming multiprocessor), then the statistics
        rows = _sm_count(lib, index)
        part = torch.empty(((rows + 1) * 2 * n,), dtype=torch.float32,
                           device=dev)
        stats = part[rows * 2 * n:].view(2, n)
        if route == "wgmma":
            err = lib.matmul_stats_wgmma(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(),
                stats.data_ptr(), m, n, k, wgmma_tile_n(m, n, rows), rows,
                index, stream)
        else:
            # w's two TF32 terms, (2, N, K), for the kernel's B tiles
            wsplit = torch.empty((2, n, k), dtype=torch.float32, device=dev)
            err = lib.matmul_stats_tf32x3(
                x.data_ptr(), w.data_ptr(), wsplit.data_ptr(), y.data_ptr(),
                part.data_ptr(), stats.data_ptr(), m, n, k,
                tf32x3_tile_n(n), rows, index, stream)
    else:
        stats = torch.empty((2, n), dtype=torch.float32, device=dev)
        dtype = 1 if route == "wmma" else 0
        tiles = -(-m // lib.matmul_stats_block_m(dtype))
        chunk = lib.matmul_stats_reduce_chunk()
        part = torch.empty((tiles, 2, n), dtype=torch.float32, device=dev)
        scratch = torch.empty((max(1, -(-tiles // chunk)), 2, n),
                              dtype=torch.float32, device=dev)
        vec = int(dtype == 1 and k % 8 == 0 and aligned)
        err = lib.matmul_stats(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(),
            scratch.data_ptr(), stats.data_ptr(), m, n, k, dtype, vec, index,
            stream)
    if err:
        raise MXNetError("matmul_stats: %s kernel launch failed: %s (error %d)"
                         % (route, lib.matmul_stats_error_string(err).decode(),
                            err))
    _count_launch(route)
    s1, s2 = stats.unbind(0)
    return y, s1, s2


def _count_launch(route):
    """Count one launch on ``route`` (a read-modify-write of two counters
    that threads share, so under the lock)."""
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1
        LAUNCHES_BY_ROUTE[route] += 1


def reset_launches():
    """Set :data:`LAUNCHES`, :data:`LAUNCHES_BY_ROUTE`,
    :data:`LAYOUT_COPIES` and :data:`SHAPE_ONLY_CALLS` to 0."""
    global LAUNCHES, LAYOUT_COPIES, SHAPE_ONLY_CALLS
    with _COUNT_LOCK:
        LAUNCHES = LAYOUT_COPIES = SHAPE_ONLY_CALLS = 0
        for route in LAUNCHES_BY_ROUTE:
            LAUNCHES_BY_ROUTE[route] = 0


def _shape_only(x, w):
    """What a launch returns, shapes only: ``y`` (M, N) in x's dtype and
    the (2, N) statistics the kernel writes, uninitialized. The kernel's
    own scratch (its per-block partial sums, tf32x3's split of w) is not
    made."""
    global SHAPE_ONLY_CALLS
    _check_operands(x, w)
    m, k, n = x.shape[0], x.shape[1], w.shape[0]
    route = kernel_route(m, k, n, x.dtype, True)
    with _COUNT_LOCK:
        SHAPE_ONLY_CALLS += 1
    note_kernel("matmul_stats[%s]" % route,
                *launch_cost(m, k, n, ROUTE_ARITH[route]), inputs=(x, w))
    y = torch.empty((x.shape[0], n), dtype=x.dtype, device=x.device)
    stats = torch.empty((2, n), dtype=_acc_dtype(x.dtype), device=x.device)
    s1, s2 = stats.unbind(0)
    return y, s1, s2


def _forward(x, w):
    _check(x, w)
    if x.device.type == "cpu":
        return matmul_stats_reference(x, w)
    if shape_only(x):
        return _shape_only(x, w)
    if x.device.type != "cuda":
        raise MXNetError("matmul_stats: no kernel for device %s" % x.device)
    return _launch(x, w)


class _MatmulStats(torch.autograd.Function):
    """``(y, s1, s2)`` with the JAX package's ``_mm_bwd`` as backward."""

    @staticmethod
    def forward(ctx, x, w):
        y, s1, s2 = _forward(x, w)
        ctx.save_for_backward(x, w, y)
        ctx.set_materialize_grads(False)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        # dy_eff = dy + ds1 + 2 y ds2 in the accumulator dtype, cast to x's:
        # two passes over the (M, N) product, the casts done on the fly
        x, w, y = ctx.saved_tensors
        acc_dt = _acc_dtype(x.dtype)
        if dy is not None:
            dy_eff = (dy.to(acc_dt, copy=True) if ds1 is None
                      else torch.add(dy, ds1.to(acc_dt)))
        else:
            dy_eff = torch.zeros(y.shape, dtype=acc_dt, device=y.device)
            if ds1 is not None:
                dy_eff += ds1.to(acc_dt)
        if ds2 is not None:
            dy_eff.addcmul_(y, 2.0 * ds2.to(acc_dt))
        dy_eff = dy_eff.to(x.dtype)
        return dy_eff @ w, dy_eff.t() @ x


def matmul_stats(x, w):
    """``x`` (M, K) @ ``w`` (N, K).T -> ``(y (M, N), s1 (N,), s2 (N,))``:
    ``y`` in x's dtype, the statistics f32 (f64 for f64 inputs) from the
    accumulator. Differentiable in ``x`` and ``w``.

    CPU tensors take :func:`matmul_stats_reference`. CUDA tensors launch
    the kernel :func:`kernel_route` names for the shape; the kernels take
    float32 or bfloat16, contiguous, on one device; anything else raises."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _MatmulStats.apply(x, w)
    return _forward(x, w)


# ---------------------------------------------------------------------------
# fusion-pass predicates and the fused call (executor._build_graph_runner)
# ---------------------------------------------------------------------------

def conv1x1_fusable(conv_attrs):
    """True when a Convolution node is a pure NHWC 1x1 matmul this kernel
    covers: kernel (1, 1), stride 1, no pad, dilation, groups or bias."""
    try:
        if attr_str(conv_attrs.get("layout", ""), "") != "NHWC":
            return False
        if attr_tuple(conv_attrs["kernel"]) != (1, 1):
            return False
        if attr_tuple(conv_attrs.get("stride", (1, 1)), (1, 1)) != (1, 1):
            return False
        if attr_tuple(conv_attrs.get("pad", (0, 0)), (0, 0)) != (0, 0):
            return False
        if attr_tuple(conv_attrs.get("dilate", (1, 1)), (1, 1)) != (1, 1):
            return False
        if attr_int(conv_attrs.get("num_group", 1), 1) != 1:
            return False
        if not attr_bool(conv_attrs.get("no_bias", False), False):
            return False
    except (KeyError, ValueError, TypeError, MXNetError):
        return False
    return True


def bn_fusable(bn_attrs):
    """A BatchNorm can consume its producer's statistics: channel-last
    axis, batch statistics."""
    if attr_bool(bn_attrs.get("use_global_stats", False), False):
        return False
    return attr_int(bn_attrs.get("axis", 1), 1) in (-1, 3)


def apply_conv1x1_stats(x, w):
    """NHWC activation ``x`` (..., C), OIHW weight ``w`` (F, C, 1, 1) ->
    ``(y (..., F), (s1, s2, count))`` with ``count`` the number of rows as
    a float, as BatchNorm's ``fused_stats`` branch takes it."""
    global LAYOUT_COPIES
    k = x.shape[-1]
    f = w.shape[0]
    if not x.is_contiguous():
        with _COUNT_LOCK:
            LAYOUT_COPIES += 1
        x = x.contiguous()
    x2 = x.reshape(-1, k)
    y2, s1, s2 = matmul_stats(x2, w.reshape(f, k))
    return y2.reshape(x.shape[:-1] + (f,)), (s1, s2, float(x2.shape[0]))
