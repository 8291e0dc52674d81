"""SSD MultiBox operators of the serving slice: MultiBoxPrior and
MultiBoxDetection (counterparts of ``mxnet_tpu/ops/contrib.py``; ref:
src/operator/contrib/multibox_prior.cc, multibox_detection.cc).

MultiBoxDetection decodes, scores and sorts in plain PyTorch on the
device, as the JAX package does outside Pallas, and always takes its
greedy NMS step through :func:`multibox_nms.nms_alive`: on the card that
is the hand-written kernel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import attr_bool, attr_float, attr_int, attr_tuple, MXNetError
from .registry import register
from . import multibox_nms


def _f32(x):
    # JAX applies a Python float to f32 arrays rounded to f32; rounding it
    # here keeps every product and comparison the same in PyTorch
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# MultiBoxPrior (ref: contrib/multibox_prior.cc)
# ---------------------------------------------------------------------------

def _mbp_attrs(attrs):
    sizes = attr_tuple(attrs.get("sizes", (1.0,)), (1.0,), typ=float)
    ratios = attr_tuple(attrs.get("ratios", (1.0,)), (1.0,), typ=float)
    clip = attr_bool(attrs.get("clip", False), False)
    steps = attr_tuple(attrs.get("steps", (-1.0, -1.0)), (-1.0, -1.0),
                       typ=float)
    offsets = attr_tuple(attrs.get("offsets", (0.5, 0.5)), (0.5, 0.5),
                         typ=float)
    return sizes, ratios, clip, steps, offsets


def _mbp_infer(attrs, in_shapes):
    sizes, ratios, _, _, _ = _mbp_attrs(attrs)
    data = in_shapes[0]
    if data is None:
        raise MXNetError("MultiBoxPrior: data shape required")
    na = len(sizes) + len(ratios) - 1
    return [tuple(data)], [(1, data[2] * data[3] * na, 4)], []


@register("MultiBoxPrior", inputs=("data",), infer_shape=_mbp_infer,
          aliases=("_contrib_MultiBoxPrior",))
def _multibox_prior(op_ctx, attrs, inputs, aux):
    sizes, ratios, clip, steps, offsets = _mbp_attrs(attrs)
    x = inputs[0]
    h, w = x.shape[2], x.shape[3]
    dev = x.device
    f32 = torch.float32
    step_y = _f32(steps[0] if steps[0] > 0 else 1.0 / h)
    step_x = _f32(steps[1] if steps[1] > 0 else 1.0 / w)
    cy = (torch.arange(h, device=dev, dtype=f32) + _f32(offsets[0])) * step_y
    cx = (torch.arange(w, device=dev, dtype=f32) + _f32(offsets[1])) * step_x
    # anchor list: (size_i, ratio_0) for all i, then (size_0, ratio_j) j>0
    whs = [(s * math.sqrt(ratios[0]), s / math.sqrt(ratios[0]))
           for s in sizes]
    whs += [(sizes[0] * math.sqrt(r), sizes[0] / math.sqrt(r))
            for r in ratios[1:]]
    ws = torch.tensor([wh[0] for wh in whs], dtype=f32, device=dev) / 2.0
    hs = torch.tensor([wh[1] for wh in whs], dtype=f32, device=dev) / 2.0
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")      # (H, W)
    gy = gy[..., None]
    gx = gx[..., None]
    boxes = torch.stack([gx - ws, gy - hs, gx + ws, gy + hs], dim=-1)
    boxes = boxes.reshape(1, -1, 4)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return (boxes.to(x.dtype),)


# ---------------------------------------------------------------------------
# MultiBoxDetection (ref: contrib/multibox_detection.cc)
# ---------------------------------------------------------------------------

def _mbd_infer(attrs, in_shapes):
    cls_prob, loc_pred, anchor = in_shapes
    if cls_prob is None or anchor is None:
        raise MXNetError("MultiBoxDetection: shapes required")
    n = cls_prob[0]
    a = anchor[1]
    return [tuple(cls_prob), tuple(loc_pred), tuple(anchor)], \
        [(n, a, 6)], []


def multibox_detection(cls_prob, loc_pred, anchors, threshold=0.01,
                       nms_threshold=0.5, variances=(0.1, 0.1, 0.2, 0.2),
                       force_suppress=False, nms_topk=-1, nms=None):
    """Decode + per-anchor best class + score sort + greedy NMS ->
    (B, A, 6) rows ``[class, score, x1, y1, x2, y2]``; suppressed or
    below-threshold rows have class -1, rows past ``nms_topk`` are all -1.
    ``nms`` is the NMS function (default :func:`multibox_nms.nms_alive`;
    a check passes :func:`multibox_nms.nms_alive_reference`)."""
    nms = nms or multibox_nms.nms_alive
    variances = [_f32(v) for v in variances]
    anc = anchors[0]
    A = anc.shape[0]
    B = cls_prob.shape[0]
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    lp = loc_pred.reshape(B, A, 4)
    # same operation order as the JAX package (ops/contrib.py:211-216)
    cx = lp[..., 0] * variances[0] * aw + acx
    cy = lp[..., 1] * variances[1] * ah + acy
    w = torch.exp(lp[..., 2] * variances[2]) * aw / 2
    h = torch.exp(lp[..., 3] * variances[3]) * ah / 2
    boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=2)
    boxes = torch.clamp(boxes, 0.0, 1.0)
    # per anchor best non-background class; argmax takes the first maximum
    score, cls = torch.max(cls_prob[:, 1:], dim=1)      # (B, A)
    score = torch.where(score > _f32(threshold), score,
                        torch.zeros_like(score))
    k = A if nms_topk <= 0 else min(nms_topk, A)
    # stable: anchors below threshold all score 0 and keep index order
    order = torch.sort(-score, dim=1, stable=True).indices[:, :k]
    sboxes = torch.gather(boxes, 1, order[..., None].expand(B, k, 4))
    sscore = torch.gather(score, 1, order)
    scls = torch.gather(cls, 1, order).to(cls_prob.dtype)
    alive = nms(sboxes.contiguous(), sscore.contiguous(), scls.contiguous(),
                nms_threshold, force_suppress) > 0
    out_cls = torch.where(alive, scls, torch.full_like(scls, -1.0))
    out_score = torch.where(alive, sscore, torch.zeros_like(sscore))
    det = torch.cat([out_cls[..., None], out_score[..., None], sboxes],
                    dim=2)
    if k < A:
        pad = torch.full((B, A - k, 6), -1.0, dtype=det.dtype,
                         device=det.device)
        det = torch.cat([det, pad], dim=1)
    return det


def _mbd_attrs(attrs):
    return dict(
        threshold=attr_float(attrs.get("threshold", 0.01), 0.01),
        nms_threshold=attr_float(attrs.get("nms_threshold", 0.5), 0.5),
        variances=attr_tuple(attrs.get("variances", (0.1, 0.1, 0.2, 0.2)),
                             (0.1, 0.1, 0.2, 0.2), typ=float),
        force_suppress=attr_bool(attrs.get("force_suppress", False), False),
        nms_topk=attr_int(attrs.get("nms_topk", -1), -1))


@register("MultiBoxDetection", inputs=("cls_prob", "loc_pred", "anchor"),
          infer_shape=_mbd_infer, aliases=("_contrib_MultiBoxDetection",))
def _multibox_detection(op_ctx, attrs, inputs, aux):
    return (multibox_detection(*inputs, **_mbd_attrs(attrs)),)
