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

:data:`LAUNCHES` counts the kernel launches of :func:`nms_alive` (one per
call on the card, each running the mask and the sweep kernel).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..base import MXNetError

#: kernel launches by :func:`nms_alive` (one per call that ran on the card)
LAUNCHES = 0

#: largest k the kernel takes (the mask grid's tile count is capped at 1024)
MAX_K = 65536

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
        fn = lib.multibox_nms_alive
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.multibox_nms_error_string.argtypes = [ctypes.c_int]
        lib.multibox_nms_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.multibox_nms_error_string)
    return _FN


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
    kernel, which takes float32, contiguous tensors on one device with a
    16-byte-aligned ``sboxes`` and k <= :data:`MAX_K`; anything else
    raises."""
    global LAUNCHES
    _check(sboxes, sscore, scls)
    dev = sboxes.device
    if dev.type == "cpu":
        return nms_alive_reference(sboxes, sscore, scls, thresh, force)
    if dev.type != "cuda":
        raise MXNetError("nms_alive: no kernel for device %s" % dev)
    for name, t in (("sboxes", sboxes), ("sscore", sscore), ("scls", scls)):
        if t.device != dev:
            raise MXNetError("nms_alive: %s is on %s, sboxes on %s"
                             % (name, t.device, dev))
        if t.dtype != torch.float32:
            raise MXNetError("nms_alive: %s must be float32, got %s"
                             % (name, t.dtype))
        if not t.is_contiguous():
            raise MXNetError("nms_alive: %s must be contiguous" % name)
    if sboxes.data_ptr() % 16:
        raise MXNetError("nms_alive: sboxes must be 16-byte aligned")
    b, k = sboxes.shape[:2]
    if k > MAX_K:
        raise MXNetError("nms_alive: k=%d exceeds the kernel's %d"
                         % (k, MAX_K))
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b == 0 or k == 0:
        return out
    nwords = (k + 63) // 64
    scratch = torch.empty((b * k * nwords,), dtype=torch.int64, device=dev)
    fn, err_str = _kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(sboxes.data_ptr(), sscore.data_ptr(), scls.data_ptr(),
             scratch.data_ptr(), out.data_ptr(), b, k,
             _f32_thresh(thresh), int(bool(force)), dev.index or 0, stream)
    if err:
        raise MXNetError("nms_alive: kernel launch failed: %s (cudaError %d)"
                         % (err_str(err).decode(), err))
    LAUNCHES += 1
    return out
