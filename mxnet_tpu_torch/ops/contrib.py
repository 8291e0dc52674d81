"""Contrib operators (counterparts of ``mxnet_tpu/ops/contrib.py``): the
SSD MultiBox ops MultiBoxPrior, MultiBoxTarget and MultiBoxDetection (ref:
src/operator/contrib/multibox_prior.cc, multibox_target.cc,
multibox_detection.cc), and CTCLoss, fft, ifft, count_sketch, quantize and
dequantize (ref: contrib/ctc_loss*, fft*, count_sketch*, quantize*), each
with its ``_contrib_`` alias.

MultiBoxTarget matches anchors to ground truth and mines hard negatives
for the whole batch at once, in plain PyTorch as the JAX package writes it
in ``jnp``; its outputs carry no gradient. MultiBoxDetection decodes,
scores and sorts in plain PyTorch on the device, as the JAX package does
outside Pallas, and always takes its greedy NMS step through
:func:`multibox_nms.nms_alive` on detached inputs: on the card that is the
hand-written kernel.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

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
# MultiBoxTarget (ref: contrib/multibox_target.cc)
# ---------------------------------------------------------------------------

def _mbt_infer(attrs, in_shapes):
    anchors, labels, cls_preds = in_shapes
    if anchors is None or labels is None:
        raise MXNetError("MultiBoxTarget: anchor/label shapes required")
    a = anchors[1]
    n = labels[0]
    return [tuple(anchors), tuple(labels), tuple(cls_preds)], \
        [(n, a * 4), (n, a * 4), (n, a)], []


@torch.no_grad()
def multibox_target(anchors, labels, cls_preds, overlap_threshold=0.5,
                    variances=(0.1, 0.1, 0.2, 0.2),
                    negative_mining_ratio=-1.0):
    """Anchor matching and target encoding for a batch: ``anchors`` (1, A,
    4) corners, ``labels`` (B, O, 5) rows ``[class, x1, y1, x2, y2]`` (class
    -1 pads), ``cls_preds`` (B, C, A) -> ``(loc_target (B, 4A), loc_mask
    (B, 4A), cls_target (B, A))``. An anchor is positive at IoU >=
    ``overlap_threshold`` with its best ground truth, or as the best anchor
    of some ground truth; ``cls_target`` is its class + 1, 0 for
    background and, with ``negative_mining_ratio`` > 0, -1 for the
    negatives mined away (all but the ``ratio * positives`` hardest by
    background probability, at least one). Same operations in the same
    order as the JAX package's ``vmap`` over samples."""
    anc = anchors[0]                                    # (A, 4)
    A = anc.shape[0]
    B = labels.shape[0]
    dt = anc.dtype
    valid = labels[..., 0] >= 0                          # (B, O)
    gt = labels[..., 1:5]                                # (B, O, 4)
    ious = multibox_nms._iou(anc[None], gt) * valid[:, None, :].to(dt)
    # argmax takes the first maximum, as jnp.argmax
    best_gt = torch.argmax(ious, dim=2)                  # (B, A)
    best_iou = torch.amax(ious, dim=2)
    best_anchor_per_gt = torch.argmax(ious, dim=1)       # (B, O)
    # a max-scatter: padded labels all point at anchor 0, and a duplicate
    # index must not overwrite a real ground truth's forced match
    forced = torch.zeros((B, A), dtype=dt, device=anc.device).scatter_reduce(
        1, best_anchor_per_gt, valid.to(dt), "amax") > 0
    pos = (best_iou >= _f32(overlap_threshold)) | forced
    matched_gt = torch.gather(gt, 1, best_gt[..., None].expand(B, A, 4))
    matched_cls = torch.gather(labels[..., 0], 1, best_gt)
    # encode offsets (center form, variance-scaled)
    v = variances
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    gw = torch.clamp_min(matched_gt[..., 2] - matched_gt[..., 0], 1e-8)
    gh = torch.clamp_min(matched_gt[..., 3] - matched_gt[..., 1], 1e-8)
    gcx = (matched_gt[..., 0] + matched_gt[..., 2]) / 2
    gcy = (matched_gt[..., 1] + matched_gt[..., 3]) / 2
    tx = (gcx - acx) / torch.clamp_min(aw, 1e-8) / _f32(v[0])
    ty = (gcy - acy) / torch.clamp_min(ah, 1e-8) / _f32(v[1])
    tw = torch.log(gw / torch.clamp_min(aw, 1e-8)) / _f32(v[2])
    th = torch.log(gh / torch.clamp_min(ah, 1e-8)) / _f32(v[3])
    posf = pos.to(dt)
    loc_t = torch.stack([tx, ty, tw, th], dim=2) * posf[..., None]
    loc_m = posf[..., None].expand(B, A, 4)
    cls_t = torch.where(pos, matched_cls + 1.0, torch.zeros_like(matched_cls))
    if negative_mining_ratio > 0:
        # hard negative mining: keep the ratio * npos negatives with the
        # lowest background probability (softmax written out as jax.nn's)
        cp = cls_preds.detach()
        e = torch.exp(cp - torch.amax(cp, dim=1, keepdim=True))
        bg = (e / torch.sum(e, dim=1, keepdim=True))[:, 0]    # (B, A)
        neg_cand = ~pos
        difficulty = torch.where(neg_cand, 1.0 - bg,
                                 torch.full_like(bg, -math.inf))
        # stable, as jnp.argsort: equal difficulties keep anchor order
        order = torch.sort(-difficulty, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(A, device=anc.device).expand(B, A))
        npos = pos.sum(dim=1, dtype=torch.int32)
        keep_n = torch.clamp_min(
            (_f32(negative_mining_ratio) * npos.to(torch.float32)).to(
                torch.int32), 1)
        keep_neg = neg_cand & (rank < keep_n[:, None])
        cls_t = torch.where(pos, cls_t, torch.where(
            keep_neg, torch.zeros_like(cls_t), torch.full_like(cls_t, -1.0)))
    return loc_t.reshape(B, -1), loc_m.reshape(B, -1), cls_t


@register("MultiBoxTarget", inputs=("anchor", "label", "cls_pred"),
          outputs=("loc_target", "loc_mask", "cls_target"),
          infer_shape=_mbt_infer, aliases=("_contrib_MultiBoxTarget",))
def _multibox_target(op_ctx, attrs, inputs, aux):
    return multibox_target(
        *inputs,
        overlap_threshold=attr_float(attrs.get("overlap_threshold", 0.5),
                                     0.5),
        variances=attr_tuple(attrs.get("variances", (0.1, 0.1, 0.2, 0.2)),
                             (0.1, 0.1, 0.2, 0.2), typ=float),
        negative_mining_ratio=attr_float(
            attrs.get("negative_mining_ratio", -1.0), -1.0))


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
    # the mask has no gradient: the kernel gets detached inputs
    alive = nms(sboxes.detach().contiguous(), sscore.detach().contiguous(),
                scls.detach().contiguous(), nms_threshold,
                force_suppress) > 0
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


# ---------------------------------------------------------------------------
# CTCLoss (ref: contrib/ctc_loss*; warp-ctc semantics: blank 0, label 0 pads)
# ---------------------------------------------------------------------------

#: the log of an unreachable state, as the JAX package's
_CTC_NEG = -1e9


def _ctc_infer(attrs, in_shapes):
    data, label = in_shapes
    if data is None or label is None:
        raise MXNetError("CTCLoss: data and label shapes required")
    return [tuple(data), tuple(label)], [(data[1],)], []


def _lse(a, b):
    """log(exp(a) + exp(b)) with the gap clamped to [0, 60], as the JAX
    package's: past 60 the smaller term has no gradient."""
    d = torch.clamp(torch.abs(a - b), 0.0, 60.0)
    return torch.maximum(a, b) + torch.log1p(torch.exp(-d))


def ctc_loss(data, label):
    """Negative log-likelihood of each label row under the activations
    ``data`` (T, N, V): the forward (alpha) recursion over T in log space,
    one step a time step, all on ``data``'s device. Rows of ``label``
    (N, L) end at their first 0; an empty row scores the all-blank path."""
    T, N, _ = data.shape
    S = 2 * label.shape[1] + 1
    logp = torch.log_softmax(data, dim=-1)
    lab = label.to(torch.int64)
    # the extended sequence: blank, l1, blank, l2, ..., blank
    ext = torch.zeros((N, S), dtype=torch.int64, device=data.device)
    ext[:, 1::2] = lab
    lab_len = (lab > 0).sum(dim=1)
    ext_len = 2 * lab_len + 1
    # s may follow s - 2 where ext[s] is a label unlike ext[s - 2]
    can_skip = (ext != 0) & (ext != F.pad(ext, (2, 0))[:, :S])
    emit = torch.gather(logp, 2, ext[None].expand(T, N, S))   # (T, N, S)
    neg = torch.full((N, S), _CTC_NEG, dtype=data.dtype, device=data.device)
    alpha = torch.cat([emit[0, :, :1],
                       torch.where(lab_len[:, None] > 0, emit[0, :, 1:2],
                                   neg[:, :1]),
                       neg[:, 2:]], dim=1)[:, :S]
    for t in range(1, T):
        prev1 = F.pad(alpha, (1, 0), value=_CTC_NEG)[:, :S]
        prev2 = F.pad(alpha, (2, 0), value=_CTC_NEG)[:, :S]
        a = _lse(alpha, prev1)
        a = torch.where(can_skip, _lse(a, prev2), a)
        alpha = a + emit[t]
    last = torch.gather(alpha, 1, (ext_len - 1).clamp(0, S - 1)[:, None])[:, 0]
    prev = torch.gather(alpha, 1, (ext_len - 2).clamp(0, S - 1)[:, None])[:, 0]
    # an empty row has one final state: lse(last, last) would count the
    # all-blank path twice
    return -torch.where(ext_len >= 2, _lse(last, prev), last)


@register("CTCLoss", inputs=("data", "label"), infer_shape=_ctc_infer,
          aliases=("ctc_loss", "_contrib_CTCLoss"), mesh_split=True,
          mesh_unsplit=lambda attrs, ndims: [(0, 0), (0, 2), (1, 1)])
def _ctc_loss(op_ctx, attrs, inputs, aux):
    return (ctc_loss(inputs[0], inputs[1]),)


# ---------------------------------------------------------------------------
# fft / ifft (ref: contrib/fft*): complex values as [re, im] pairs
# interleaved along the last dimension, which doubles it; ifft unnormalised
# ---------------------------------------------------------------------------

def _complex_dtype(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _last_dim(attrs, ndims):
    return [(0, ndims[0] - 1)]


@register("fft", inputs=("data",), aliases=("_contrib_fft",), mesh_split=True,
          mesh_unsplit=_last_dim)
def _fft(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    y = torch.fft.fft(x.to(_complex_dtype(x.dtype)), dim=-1)
    out = torch.stack([y.real, y.imag], dim=-1)
    return (out.reshape(x.shape[:-1] + (2 * x.shape[-1],)).to(x.dtype),)


@register("ifft", inputs=("data",), aliases=("_contrib_ifft",),
          mesh_split=True, mesh_unsplit=_last_dim)
def _ifft(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    n = x.shape[-1] // 2
    pairs = x.reshape(x.shape[:-1] + (n, 2))
    z = torch.complex(pairs[..., 0], pairs[..., 1])
    return ((torch.fft.ifft(z, dim=-1) * n).real.to(x.dtype),)


# ---------------------------------------------------------------------------
# count_sketch (ref: contrib/count_sketch*, compact bilinear pooling)
# ---------------------------------------------------------------------------

def _cs_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        raise MXNetError("count_sketch: data shape required")
    return ([tuple(data), (data[1],), (data[1],)],
            [(data[0], attr_int(attrs["out_dim"]))], [])


@register("count_sketch", inputs=("data", "h", "s"), infer_shape=_cs_infer,
          aliases=("_contrib_count_sketch",), mesh_split=True,
          mesh_unsplit=lambda attrs, ndims: [(0, 1), (1, 0), (2, 0)])
def _count_sketch(op_ctx, attrs, inputs, aux):
    data, h, s = inputs
    out_dim = attr_int(attrs["out_dim"])
    idx = h.to(torch.int64) % out_dim
    out = torch.zeros((data.shape[0], out_dim), dtype=data.dtype,
                      device=data.device)
    return (out.index_add(1, idx, data * s[None, :]),)


# ---------------------------------------------------------------------------
# quantize / dequantize (ref: contrib/quantize*): uint8 over [min, max]
# ---------------------------------------------------------------------------

@register("quantize", inputs=("data", "min_range", "max_range"),
          outputs=("output", "min_range", "max_range"),
          aliases=("_contrib_quantize",), mesh_split=True)
def _quantize(op_ctx, attrs, inputs, aux):
    data, lo, hi = inputs
    scale = 255.0 / torch.clamp_min(hi - lo, 1e-8)
    # torch.round, as jnp.round, rounds half to even
    q = torch.clamp(torch.round((data - lo) * scale), 0, 255).to(torch.uint8)
    return (q, lo.clone(), hi.clone())


@register("dequantize", inputs=("data", "min_range", "max_range"),
          aliases=("_contrib_dequantize",), mesh_split=True)
def _dequantize(op_ctx, attrs, inputs, aux):
    data, lo, hi = inputs
    scale = torch.clamp_min(hi - lo, 1e-8) / 255.0
    return (data.to(torch.float32) * scale + lo,)
