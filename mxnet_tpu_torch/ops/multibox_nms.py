"""The MultiBox greedy-NMS sweep: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas_multibox.py`` (Pallas kernel
``_nms_kernel``, entry ``nms_alive``). Both functions here take a batch of
score-sorted boxes and return the float32 (B, k) survival mask, 1.0/0.0:

- :func:`nms_alive` launches ``csrc/multibox_nms.cu`` for CUDA tensors (the
  kernel's design and bound are in that file's note) and takes the plain
  version for CPU tensors. On the card it launches the kernel or raises;
  it never falls back.
- :func:`nms_alive_reference` is the plain version, batched over B with a
  Python loop over the k steps, as ``ops/contrib.py:238-247`` of the JAX
  package writes it.
- A fake or meta tensor (``base.shape_only``: memcheck's dry run) off the
  CPU takes the shape-only route: the (B, k) mask uninitialized, and the
  ``l2`` route's scratch made and dropped, nothing computed, no launch
  counted (it counts in :data:`SHAPE_ONLY_CALLS`), and the launch it
  stands for handed to the dry run (``base.note_kernel``) at
  :func:`launch_cost`. A real CUDA tensor never takes it.
- :func:`launch_cost` and :func:`bound_seconds` are the kernel's cost,
  which ``flopcheck`` prices a launch by and ``chip_smoke.py`` bounds one
  by.

The kernel has two routes, picked from k by :func:`kernel_route`: ``"smem"``
(one launch of a thread-block cluster per image, the suppression mask in
the leader block's shared memory) while the mask fits one block's shared
memory (:func:`smem_bytes`, k <= :data:`SMEM_MAX_K`), ``"l2"`` (a mask
kernel and a sweep kernel through a scratch in L2) beyond.
:func:`cluster_size` gives the smem route's blocks per image.

:data:`LAUNCHES` counts the calls of :func:`nms_alive` that launched on the
card (one per call, whichever route) and :data:`LAUNCHES_BY_ROUTE` the same
by route. Both move together under one lock, since serving replicas launch
from several threads; :func:`reset_launches` sets them to 0.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .. import devspec
from ..base import MXNetError, note_kernel, shape_only
from ..context import raw_stream

#: calls that launched the kernel on the card (one per call, either route)
LAUNCHES = 0

#: the same by route
LAUNCHES_BY_ROUTE = {"smem": 0, "l2": 0}

#: calls on fake or meta CUDA tensors (memcheck's dry run), which took the
#: shape-only route: no kernel, no launch counted
SHAPE_ONLY_CALLS = 0

_COUNT_LOCK = threading.Lock()

#: largest k the kernel takes (the l2 route's mask grid has k/64 tiles a
#: side, at most 1024)
MAX_K = 65536

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448

#: streaming multiprocessors of an H100 SXM
H100_SMS = 132

#: largest cluster the smem route launches (the portable cluster size)
MAX_CLUSTER = 8


def smem_bytes(k):
    """Dynamic shared memory of the smem route's blocks at ``k`` boxes: the
    image's boxes, areas and classes in k + 64 slots (24 bytes a slot), the
    mask (ceil(k/64) words of each row, word-major, k rounded up to even
    rows a word), the ceil(k/64) alive words and 64 words of slack, 8
    bytes a word."""
    nwords = (k + 63) // 64
    return 24 * (k + 64) + 8 * (nwords * (k + (k & 1)) + nwords + 64)


#: largest k whose smem route fits :data:`SMEM_LIMIT` (1250)
SMEM_MAX_K = max(k for k in range(1, 2049) if smem_bytes(k) <= SMEM_LIMIT)


def kernel_route(b, k):
    """``"smem"`` for k up to :data:`SMEM_MAX_K`, else ``"l2"``. The route
    depends on k alone (b images share it); both must be in the kernel's
    range."""
    if b < 0 or not 0 <= k <= MAX_K:
        raise MXNetError("nms_alive: no kernel route for B=%d, k=%d (k at "
                         "most %d)" % (b, k, MAX_K))
    return "smem" if k <= SMEM_MAX_K else "l2"


def cluster_size(b, sms=H100_SMS):
    """Blocks per image on the smem route: as many as keep B times that
    within the ``sms`` SMs (one block per SM, one wave), 1 to
    :data:`MAX_CLUSTER`."""
    return max(1, min(MAX_CLUSTER, sms // max(b, 1)))


_FN = None


def _iou(a, b):
    """a: (..., A, 4), b: (..., B, 4) corners -> (..., A, B); 0 where the
    union is not positive (ref: mxnet_tpu ops/contrib.py:_iou)."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    iw = torch.clamp_min(ix2 - ix1, 0.0)
    ih = torch.clamp_min(iy2 - iy1, 0.0)
    inter = iw * ih
    area_a = torch.clamp_min((ax2 - ax1) * (ay2 - ay1), 0.0)
    area_b = torch.clamp_min((bx2 - bx1) * (by2 - by1), 0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _f32_thresh(thresh):
    # JAX compares the f32 IoU with the threshold rounded to f32
    return float(np.float32(thresh))


def nms_alive_reference(sboxes, sscore, scls, thresh, force=False):
    """Plain PyTorch greedy class-aware NMS: ``sboxes`` (B, k, 4) corners,
    ``sscore`` (B, k), ``scls`` (B, k), sorted by score per image ->
    float32 (B, k) survival mask, 1.0/0.0."""
    k = sboxes.shape[1]
    sup = _iou(sboxes, sboxes) > _f32_thresh(thresh)
    if not force:
        sup &= scls[:, :, None] == scls[:, None, :]
    later = torch.arange(k, device=sboxes.device)
    alive = sscore > 0
    for i in range(k):
        row = sup[:, i] & alive[:, i:i + 1] & (later > i)
        alive = alive & ~row
    return alive.to(torch.float32)


def _kernel():
    global _FN
    if _FN is None:
        from .. import cuda_build
        lib = cuda_build.load("multibox_nms")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        smem = lib.multibox_nms_alive_smem
        smem.argtypes = [vp] * 4 + [ci, ci, cf, ci, ci, ci, ci, vp]
        l2 = lib.multibox_nms_alive_l2
        l2.argtypes = [vp] * 5 + [ci, ci, cf, ci, ci, vp]
        for fn in (smem, l2):
            fn.restype = ci
        lib.multibox_nms_error_string.argtypes = [ci]
        lib.multibox_nms_error_string.restype = ctypes.c_char_p
        _FN = {"smem": smem, "l2": l2,
               "error": lib.multibox_nms_error_string}
    return _FN


_SMS = {}


def _sm_count(index):
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def launch_cost(b, k):
    """``(operations, bytes)`` of one launch over B images of k boxes:
    some 15 FP32 operations for each of the k(k-1)/2 pairs of an image
    (the IoU test), the corners (16 bytes a box), scores and classes read
    once and the float32 mask written once."""
    return 15.0 * b * k * (k - 1) / 2, b * k * (16 + 4 + 4) + b * k * 4


def bound_seconds(b, k, kind="NVIDIA H100"):
    """``(seconds, "bytes" or "operations")``: the least time one launch
    can take on a device kind, the larger of :func:`launch_cost`'s bytes
    over its memory rate and its operations over its FP32 peak
    (``devspec``)."""
    ops, nbytes = launch_cost(b, k)
    t_bytes = nbytes / devspec.kind_spec(kind)[0].hbm_bytes_per_s
    t_ops = ops / devspec.compute_peak(kind, "float32")
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def _check(sboxes, sscore, scls):
    if sboxes.dim() != 3 or sboxes.shape[2] != 4:
        raise MXNetError("nms_alive: sboxes must be (B, k, 4), got %s"
                         % (tuple(sboxes.shape),))
    bk = tuple(sboxes.shape[:2])
    for name, t in (("sscore", sscore), ("scls", scls)):
        if tuple(t.shape) != bk:
            raise MXNetError("nms_alive: %s must be %s, got %s"
                             % (name, bk, tuple(t.shape)))


def nms_alive(sboxes, sscore, scls, thresh, force=False):
    """Greedy class-aware NMS survival mask, batched: ``sboxes`` (B, k, 4)
    corners, ``sscore`` (B, k), ``scls`` (B, k) class ids, each image
    sorted by score -> float32 (B, k) mask, 1.0/0.0.

    CPU tensors take :func:`nms_alive_reference`. CUDA tensors launch the
    kernel on :func:`kernel_route`'s route; it takes float32, contiguous
    tensors on one device with a 16-byte-aligned ``sboxes`` and k <=
    :data:`MAX_K`; anything else raises."""
    _check(sboxes, sscore, scls)
    if sboxes.device.type == "cpu":
        return nms_alive_reference(sboxes, sscore, scls, thresh, force)
    if shape_only(sboxes):
        return _shape_only(sboxes, sscore, scls)
    return _launch(sboxes, sscore, scls, thresh, force)


def _shape_only(sboxes, sscore, scls):
    """What a launch returns, shapes only: the float32 (B, k) mask,
    uninitialized; the ``l2`` route's scratch is made and dropped as the
    launch makes it."""
    global SHAPE_ONLY_CALLS
    _check_operands(sboxes, sscore, scls)
    with _COUNT_LOCK:
        SHAPE_ONLY_CALLS += 1
    b, k = sboxes.shape[:2]
    if b and k:
        note_kernel("multibox_nms[%s]" % kernel_route(b, k),
                    *launch_cost(b, k), "float32",
                    inputs=(sboxes, sscore, scls))
    out = torch.empty(sscore.shape, dtype=torch.float32,
                      device=sscore.device)
    if b and k and kernel_route(b, k) == "l2":
        torch.empty((b * k * ((k + 63) // 64),), dtype=torch.int64,
                    device=sboxes.device)
    return out


def _check_operands(sboxes, sscore, scls):
    """What a launch requires beyond :func:`_check`: one device, float32,
    contiguous, k within :data:`MAX_K`. The shape-only route checks it
    too, so a dry run refuses what the launch would."""
    dev = sboxes.device
    for name, t in (("sboxes", sboxes), ("sscore", sscore), ("scls", scls)):
        if t.device != dev:
            raise MXNetError("nms_alive: %s is on %s, sboxes on %s"
                             % (name, t.device, dev))
        if t.dtype != torch.float32:
            raise MXNetError("nms_alive: %s must be float32, got %s"
                             % (name, t.dtype))
        if not t.is_contiguous():
            raise MXNetError("nms_alive: %s must be contiguous" % name)
    k = sboxes.shape[1]
    if k > MAX_K:
        raise MXNetError("nms_alive: k=%d exceeds the kernel's %d"
                         % (k, MAX_K))


def _launch(sboxes, sscore, scls, thresh, force, route=None):
    """Launch the kernel on ``route`` (by default :func:`kernel_route`'s;
    ``chip_smoke.py`` times both routes on the same tensors)."""
    dev = sboxes.device
    if dev.type != "cuda":
        raise MXNetError("nms_alive: no kernel for device %s" % dev)
    _check_operands(sboxes, sscore, scls)
    if sboxes.data_ptr() % 16:
        raise MXNetError("nms_alive: sboxes must be 16-byte aligned")
    b, k = sboxes.shape[:2]
    route = route or kernel_route(b, k)
    if route not in LAUNCHES_BY_ROUTE:
        raise MXNetError("nms_alive: no route %r" % (route,))
    if route == "smem" and k > SMEM_MAX_K:
        raise MXNetError("nms_alive: k=%d needs %d bytes of shared memory "
                         "on the smem route, past %d" % (
                             k, smem_bytes(k), SMEM_LIMIT))
    out = torch.empty_like(sscore)         # (B, k) float32, contiguous
    if b == 0 or k == 0:
        return out
    fns = _kernel()
    index = dev.index
    stream = raw_stream(index)
    ptrs = (sboxes.data_ptr(), sscore.data_ptr(), scls.data_ptr())
    thresh, force = _f32_thresh(thresh), int(bool(force))
    if route == "smem":
        err = fns["smem"](*ptrs, out.data_ptr(), b, k, thresh, force,
                          cluster_size(b, _sm_count(index)), smem_bytes(k),
                          index, stream)
    else:
        scratch = torch.empty((b * k * ((k + 63) // 64),),
                              dtype=torch.int64, device=dev)
        err = fns["l2"](*ptrs, scratch.data_ptr(), out.data_ptr(), b, k,
                        thresh, force, index, stream)
    if err:
        raise MXNetError("nms_alive: %s route launch failed: %s (cudaError "
                         "%d)" % (route, fns["error"](err).decode(), err))
    _count_launch(route)
    return out


def _count_launch(route):
    """Count one launch on ``route`` (a read-modify-write of two counters
    that threads share, so under the lock)."""
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1
        LAUNCHES_BY_ROUTE[route] += 1


def reset_launches():
    """Set :data:`LAUNCHES`, :data:`LAUNCHES_BY_ROUTE` and
    :data:`SHAPE_ONLY_CALLS` to 0."""
    global LAUNCHES, SHAPE_ONLY_CALLS
    with _COUNT_LOCK:
        LAUNCHES = SHAPE_ONLY_CALLS = 0
        for route in LAUNCHES_BY_ROUTE:
            LAUNCHES_BY_ROUTE[route] = 0
