"""Matmul with a BatchNorm-statistics epilogue: a hand-written CUDA kernel,
its plain PyTorch version, and the Conv1x1->BatchNorm fusion helpers.

Counterpart of ``mxnet_tpu/ops/pallas_fused.py`` (Pallas kernel ``_kernel``,
entry ``matmul_stats``). A 1x1 NHWC convolution is a matmul, so for
``x`` (M, K) and the weight ``w`` as it lies, (N, K) (OIHW ``(F, C, 1, 1)``
reshaped, no transpose), both functions return ``y = x @ w.T`` in x's dtype
and the f32 column statistics ``s1 = sum(acc)``, ``s2 = sum(acc * acc)`` of
the f32 accumulator ``acc``:

- :func:`matmul_stats` launches ``csrc/matmul_stats.cu`` for CUDA tensors
  (the kernel's design and bound are in that file's note) and takes the
  plain version for CPU tensors. On the card it launches the kernel or
  raises; it never falls back. It is differentiable: the backward is the
  JAX package's ``_mm_bwd``, with the statistics' cotangents folded into
  the output's (``dy + ds1 + 2 y ds2``) and two ``torch.matmul`` products,
  as the JAX package leaves them to XLA outside its kernel.
- :func:`matmul_stats_reference` is the plain version.

:data:`LAUNCHES` counts the kernel launches of :func:`matmul_stats` (one per
call on the card); :data:`LAYOUT_COPIES` counts the activations that
:func:`apply_conv1x1_stats` had to copy because they were not
NHWC-contiguous.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError, attr_bool, attr_int, attr_str, attr_tuple

#: kernel launches by :func:`matmul_stats` (one per call that ran on the card)
LAUNCHES = 0

#: activations :func:`apply_conv1x1_stats` copied to make them contiguous
LAYOUT_COPIES = 0

#: dtypes the kernel takes, by the code its C entry point uses
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_FN = None


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


def _kernel():
    global _FN
    if _FN is None:
        from .. import cuda_build
        lib = cuda_build.load("matmul_stats")
        fn = lib.matmul_stats
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.matmul_stats_block_m.argtypes = [ctypes.c_int]
        lib.matmul_stats_block_m.restype = ctypes.c_int
        lib.matmul_stats_reduce_chunk.argtypes = []
        lib.matmul_stats_reduce_chunk.restype = ctypes.c_int
        lib.matmul_stats_error_string.argtypes = [ctypes.c_int]
        lib.matmul_stats_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.matmul_stats_block_m, lib.matmul_stats_reduce_chunk(),
               lib.matmul_stats_error_string)
    return _FN


def _check(x, w):
    if x.dim() != 2 or w.dim() != 2:
        raise MXNetError("matmul_stats: x and w must be 2-d, got %s and %s"
                         % (tuple(x.shape), tuple(w.shape)))
    if x.shape[1] != w.shape[1]:
        raise MXNetError("matmul_stats: x (M, K) %s and w (N, K) %s disagree "
                         "on K" % (tuple(x.shape), tuple(w.shape)))
    if x.dtype != w.dtype:
        raise MXNetError("matmul_stats: x is %s, w is %s" % (x.dtype, w.dtype))


def _launch(x, w):
    """The kernel on CUDA tensors; returns ``(y, s1, s2)``."""
    global LAUNCHES
    dev = x.device
    if w.device != dev:
        raise MXNetError("matmul_stats: w is on %s, x on %s" % (w.device, dev))
    if x.dtype not in _KERNEL_DTYPES:
        raise MXNetError("matmul_stats: the kernel takes float32 and "
                         "bfloat16, got %s" % x.dtype)
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
    fn, block_m, chunk, err_str = _kernel()
    dtype = _KERNEL_DTYPES[x.dtype]
    tiles = -(-m // block_m(dtype))
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    part = torch.empty((tiles, 2, n), dtype=torch.float32, device=dev)
    scratch = torch.empty((max(1, -(-tiles // chunk)), 2, n),
                          dtype=torch.float32, device=dev)
    stats = torch.empty((2, n), dtype=torch.float32, device=dev)
    vec = int(dtype == 1 and k % 8 == 0 and x.data_ptr() % 16 == 0
              and w.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(),
             scratch.data_ptr(), stats.data_ptr(), m, n, k, dtype, vec,
             dev.index or 0, stream)
    if err:
        raise MXNetError("matmul_stats: kernel launch failed: %s "
                         "(cudaError %d)" % (err_str(err).decode(), err))
    LAUNCHES += 1
    return y, stats[0], stats[1]


def _forward(x, w):
    _check(x, w)
    if x.device.type == "cpu":
        return matmul_stats_reference(x, w)
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
    the kernel, which takes float32 or bfloat16, contiguous, on one device;
    anything else raises."""
    return _MatmulStats.apply(x, w)


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
        LAYOUT_COPIES += 1
        x = x.contiguous()
    x2 = x.reshape(-1, k)
    y2, s1, s2 = matmul_stats(x2, w.reshape(f, k))
    return y2.reshape(x.shape[:-1] + (f,)), (s1, s2, float(x2.shape[0]))
