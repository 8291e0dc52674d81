"""ImageRecordIter's per-pixel stage on the card: a hand-written CUDA kernel
and its plain PyTorch version.

It replaces no TPU kernel. The JAX package does this work on the host, in
``ProcessOne`` of ``src/io/image_decode.cc:131-208`` (after libjpeg's
decode): resize-short, crop, resize, mirror and normalize into the float32
NCHW batch. On the card the JPEGs are decoded by nvJPEG
(:mod:`~mxnet_tpu_torch.jpeg_decode`) at full size into one uint8 buffer,
and one launch of ``csrc/image_augment.cu`` per batch does the rest:

(a) libjpeg's DCT downscale. ``DecodeRGB`` (``image_decode.cc:68-74``)
    decodes at ``1/denom`` whenever a resize-short follows and the short
    edge allows it, at ``ceil(W/denom) x ceil(H/denom)``. nvJPEG decodes at
    full size, so the stage takes libjpeg's scaled dimensions exactly and
    reaches them by averaging ``denom x denom`` boxes, clipped at the
    ragged edge and rounded to the nearest integer. Every later size and
    random draw is then the JAX package's; the pixels differ from libjpeg's
    scaled IDCT within the decoder's tolerance.
(b) Resize-short to ``nw x nh`` (``lroundf``), ``Resize``'s bilinear with
    each value rounded to uint8 by ``(uint8)(v + 0.5f)``.
(c) The crop window ``x0, y0, cw, ch``.
(d) The second ``Resize`` where the crop is smaller than the output, from
    the stage-(b) values rounded to uint8.
(e) Mirror and ``(p - m) * s``, ``s = 1/std`` taken in float32 on the
    host.

Every float operation is the C++'s, in its order and rounded as it rounds
(the kernel spells them ``__fmul_rn``/``__fadd_rn``/``__fsub_rn`` so that
nvcc contracts nothing into a fused multiply-add), so given the same
decoded pixels the kernel equals :func:`image_augment_reference` bit for
bit, and both equal the host C++ (g++ on x86-64 contracts nothing).

- :func:`plan` computes each image's geometry and random draws on the host
  from the JPEG header's dimensions alone: ``image_decode.cc:162-188``'s
  ``std::mt19937_64(seed * 0x9e3779b97f4a7c15 + index)``, written here in
  numpy (:func:`mt19937_64_first`), gives ``x0`` only when ``w > cw``,
  then ``y0`` only when ``h > ch``, then the mirror bit ``rng() & 1``.
- :func:`image_augment` launches the kernel for CUDA tensors and takes
  :func:`image_augment_reference` for CPU tensors; on the card it launches
  or raises, with no fallback. The kernel cuts the output into
  ``TILE x TILE`` tiles, one image each, and stages for each tile, in
  shared memory, the scaled pixels and resize-short values its taps reach
  (each tap's pair listed where resize-short shrinks past 2x). An image
  whose descriptor :func:`plan` cannot make, or whose pixels reach outside
  ``pixels``, comes out as NaN: the kernel reads nothing outside
  ``pixels`` and cannot raise without a wait.
- :data:`LAUNCHES` counts the launches (one a batch), under a lock, since
  decode workers launch from several threads; :func:`reset_launches` sets
  it to 0.
- :func:`bound_seconds`: the stage moves few operations for its bytes, so
  the card's memory rate bounds it: the float32 batch written once and the
  source pixels the bilinear taps read, counted image by image from the
  descriptors (:func:`launch_bytes`).

The descriptor table is int64 ``(n, NDESC)``, one row an image, columns
named by the ``D_*`` constants.
"""
from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from .. import devspec
from ..base import MXNetError
from ..context import raw_stream

#: launches of the kernel on the card (one a batch)
LAUNCHES = 0

_COUNT_LOCK = threading.Lock()

#: descriptor columns: byte offset of the image in the pixel buffer, its
#: full-size width, height and row pitch (bytes), the DCT scale's denom and
#: the scaled size, the size after resize-short, the crop window and the
#: mirror flag
(D_OFFSET, D_W, D_H, D_PITCH, D_DENOM, D_W1, D_H1, D_NW, D_NH, D_X0, D_Y0,
 D_CW, D_CH, D_MIRROR) = range(14)
NDESC = 14

#: the kernel's output tile edge
TILE = 32
#: output sizes the kernel takes: below 2^23 (its windows' bound holds)
OUT_MAX = 1 << 23

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9e3779b97f4a7c15


# ---------------------------------------------------------------------------
# the host-side plan: sizes and random draws
# ---------------------------------------------------------------------------

def mt19937_64_first(seeds):
    """The first 3 outputs of ``std::mt19937_64`` seeded with each of
    ``seeds`` (uint64), as many as ``ProcessOne`` draws: ``(len(seeds),
    3)`` uint64. Only the state words they read are made: the seeding
    recurrence up to word 159 and one twist an output."""
    count = 3
    s = np.asarray(seeds, dtype=np.uint64).reshape(-1)
    n_words = 157 + count
    mt = np.empty((n_words, s.size), np.uint64)
    mt[0] = s
    f = np.uint64(6364136223846793005)
    with np.errstate(over="ignore"):
        for i in range(1, n_words):
            p = mt[i - 1]
            mt[i] = f * (p ^ (p >> np.uint64(62))) + np.uint64(i)
    upper, lower = np.uint64(0xFFFFFFFF80000000), np.uint64(0x7FFFFFFF)
    matrix_a = np.uint64(0xB5026F5AA96619E9)
    one = np.uint64(1)
    out = np.empty((s.size, count), np.uint64)
    for i in range(count):
        x = (mt[i] & upper) | (mt[i + 1] & lower)
        xa = (x >> one) ^ np.where(x & one, matrix_a, np.uint64(0))
        y = mt[i + 156] ^ xa
        y ^= (y >> np.uint64(29)) & np.uint64(0x5555555555555555)
        y ^= (y << np.uint64(17)) & np.uint64(0x71D67FFFEDA60000)
        y ^= (y << np.uint64(37)) & np.uint64(0xFFF7EEE000000000)
        y ^= y >> np.uint64(43)
        out[:, i] = y
    return out


def scale_denom(width, height, min_short):
    """libjpeg's ``scale_denom`` as ``DecodeRGB`` picks it
    (``image_decode.cc:68-74``): the largest of 1, 2, 4, 8 that keeps the
    short edge at least ``min_short`` (1 where ``min_short`` is 0)."""
    if min_short <= 0:
        return 1
    short = min(width, height)
    denom = 1
    while denom < 8 and short // (denom * 2) >= min_short:
        denom *= 2
    return denom


def scaled_size(width, height, denom):
    """libjpeg's output size at ``1/denom``: ``ceil(W/denom) x
    ceil(H/denom)`` (``jdiv_round_up``)."""
    return -(-width // denom), -(-height // denom)


def _lroundf(x):
    """C's ``lroundf`` of a float32 value: half away from zero."""
    x = float(x)
    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))


def short_edge_size(w, h, resize):
    """``(nw, nh)`` after resize-short (``image_decode.cc:144-151``), in
    float32 as the C++ computes it."""
    if w < h:
        nw = resize
        nh = max(1, _lroundf(np.float32(h) * np.float32(nw) / np.float32(w)))
    else:
        nh = resize
        nw = max(1, _lroundf(np.float32(w) * np.float32(nh) / np.float32(h)))
    return nw, nh


def plan(widths, heights, resize, out_hw, rand_crop, rand_mirror, seed):
    """The descriptor table of one batch: int64 ``(n, NDESC)`` with each
    image's full size (``widths``/``heights``, from its JPEG header), the
    DCT scale and every later size, the crop window and the mirror flag,
    drawn as ``ProcessOne`` draws them for batch seed ``seed`` and image
    index ``i``. ``D_OFFSET`` and ``D_PITCH`` are left 0 for the caller,
    who knows where the pixels land."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    n = len(widths)
    desc = np.zeros((n, NDESC), np.int64)
    seeds = [((int(seed) * _GOLDEN) + i) & _MASK64 for i in range(n)]
    draws = (mt19937_64_first(np.array(seeds, np.uint64))
             if n and (rand_crop or rand_mirror) else None)
    for i in range(n):
        W, H = int(widths[i]), int(heights[i])
        denom = scale_denom(W, H, resize if resize > 0 else 0)
        w1, h1 = scaled_size(W, H, denom)
        w, h = w1, h1
        if resize > 0:
            w, h = short_edge_size(w1, h1, resize)
        cw, ch = min(out_w, w), min(out_h, h)
        k = 0
        if rand_crop:
            x0 = 0
            if w > cw:
                x0 = int(draws[i, k] % np.uint64(w - cw + 1))
                k += 1
            y0 = 0
            if h > ch:
                y0 = int(draws[i, k] % np.uint64(h - ch + 1))
                k += 1
        else:
            x0, y0 = (w - cw) // 2, (h - ch) // 2
        mirror = bool(rand_mirror) and bool(int(draws[i, k]) & 1)
        desc[i, D_W:] = (W, H, 0, denom, w1, h1, w, h, x0, y0, cw, ch,
                         int(mirror))
    return desc


def normalization(mean, std, use_mean, use_std):
    """``(m, s)``: float32 (3,) mean and ``1/std`` as ``ProcessOne`` takes
    them (0 and 1 where the iterator passes none)."""
    m = (np.asarray(mean, np.float32) if use_mean
         else np.zeros(3, np.float32))
    s = (np.float32(1.0) / np.asarray(std, np.float32) if use_std
         else np.ones(3, np.float32))
    return m.astype(np.float32), s.astype(np.float32)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _box_average(img, denom, w1, h1):
    """Stage (a): ``denom x denom`` box means of uint8 HWC ``img``, the
    boxes clipped at the ragged edge, rounded to nearest (integer
    arithmetic)."""
    H, W = img.shape[:2]
    pad = torch.zeros((h1 * denom, w1 * denom, 3), dtype=torch.int32,
                      device=img.device)
    pad[:H, :W] = img.to(torch.int32)
    sums = pad.view(h1, denom, w1, denom, 3).sum(dim=(1, 3))
    ys = torch.arange(h1, device=img.device)
    xs = torch.arange(w1, device=img.device)
    cy = torch.clamp(H - ys * denom, max=denom)
    cx = torch.clamp(W - xs * denom, max=denom)
    cnt = (cy[:, None] * cx[None, :])[:, :, None].to(torch.int32)
    return torch.div(sums + cnt // 2, cnt, rounding_mode="floor").to(
        torch.uint8)


def _resize(src, dw, dh):
    """``Resize`` (``image_decode.cc:91-118``) of uint8 HWC ``src`` to
    ``dh x dw`` in float32, each operation in the C++'s order."""
    sh, sw = src.shape[:2]
    dev = src.device
    f32 = torch.float32
    sx = torch.tensor(sw, dtype=f32) / torch.tensor(dw, dtype=f32)
    sy = torch.tensor(sh, dtype=f32) / torch.tensor(dh, dtype=f32)
    fy = (torch.arange(dh, dtype=f32, device=dev) + 0.5) * sy.to(dev) - 0.5
    fx = (torch.arange(dw, dtype=f32, device=dev) + 0.5) * sx.to(dev) - 0.5
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), min=0)
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), min=0)
    y1 = torch.clamp(y0 + 1, max=sh - 1)
    x1 = torch.clamp(x0 + 1, max=sw - 1)
    wy = fy - y0.to(f32)
    wy = torch.where(wy < 0, torch.zeros_like(wy), wy)[:, None, None]
    wx = fx - x0.to(f32)
    wx = torch.where(wx < 0, torch.zeros_like(wx), wx)[None, :, None]
    s = src.to(f32)
    v00 = s[y0][:, x0]
    v01 = s[y0][:, x1]
    v10 = s[y1][:, x0]
    v11 = s[y1][:, x1]
    v = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
         + v10 * wy * (1 - wx) + v11 * wy * wx)
    return (v + 0.5).to(torch.int32).to(torch.uint8)


def image_augment_reference(pixels, desc, out_h, out_w, mean, scale):
    """Plain PyTorch version: uint8 ``pixels`` (one flat buffer of HWC
    images at the descriptors' offsets and pitches), int64 ``desc``
    ``(n, NDESC)``, float32 ``mean``/``scale`` (3,) -> float32
    ``(n, 3, out_h, out_w)``."""
    dev = pixels.device
    d = desc.cpu().tolist()
    out = torch.empty((len(d), 3, out_h, out_w), dtype=torch.float32,
                      device=dev)
    m = mean.to(device=dev, dtype=torch.float32).view(3, 1, 1)
    s = scale.to(device=dev, dtype=torch.float32).view(3, 1, 1)
    for i, r in enumerate(d):
        W, H, pitch = r[D_W], r[D_H], r[D_PITCH]
        img = pixels[r[D_OFFSET]:r[D_OFFSET] + H * pitch].view(H, pitch)
        img = img[:, :W * 3].reshape(H, W, 3)
        w1, h1 = r[D_W1], r[D_H1]
        if r[D_DENOM] > 1:
            img = _box_average(img, r[D_DENOM], w1, h1)
        if (r[D_NW], r[D_NH]) != (w1, h1):
            img = _resize(img, r[D_NW], r[D_NH])
        x0, y0, cw, ch = r[D_X0], r[D_Y0], r[D_CW], r[D_CH]
        img = img[y0:y0 + ch, x0:x0 + cw]
        if (cw, ch) != (out_w, out_h):
            img = _resize(img, out_w, out_h)
        if r[D_MIRROR]:
            img = torch.flip(img, dims=(1,))
        out[i] = (img.permute(2, 0, 1).to(torch.float32) - m) * s
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        from .. import cuda_build
        lib = cuda_build.load("image_augment")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.image_augment_launch
        fn.argtypes = [vp, ctypes.c_longlong, vp, ci, ci, ci, cf, cf, cf,
                       cf, cf, cf, ci, vp, vp, vp]
        fn.restype = ci
        lib.image_augment_error_string.argtypes = [ci]
        lib.image_augment_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.image_augment_error_string)
    return _FN


def _check(pixels, desc, out_h, out_w, mean, scale):
    if pixels.dtype != torch.uint8 or pixels.dim() != 1:
        raise MXNetError("image_augment: pixels must be a flat uint8 "
                         "tensor, got %s %s" % (pixels.dtype,
                                                tuple(pixels.shape)))
    if desc.dtype != torch.int64 or desc.dim() != 2 \
            or desc.shape[1] != NDESC:
        raise MXNetError("image_augment: desc must be int64 (n, %d), got "
                         "%s %s" % (NDESC, desc.dtype, tuple(desc.shape)))
    if out_h < 1 or out_w < 1:
        raise MXNetError("image_augment: output size %dx%d"
                         % (out_h, out_w))
    for name, t in (("mean", mean), ("scale", scale)):
        if tuple(t.shape) != (3,):
            raise MXNetError("image_augment: %s must have 3 values" % name)


def image_augment(pixels, desc, out_h, out_w, mean, scale):
    """The float32 ``(n, 3, out_h, out_w)`` batch from the decoded pixels
    (see :func:`image_augment_reference` for the arguments; ``mean`` and
    ``scale`` may be host tensors or arrays).

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream: ``pixels`` and ``desc`` on one device, ``desc``
    contiguous; anything else raises."""
    mean = torch.as_tensor(np.asarray(mean, np.float32))
    scale = torch.as_tensor(np.asarray(scale, np.float32))
    _check(pixels, desc, out_h, out_w, mean, scale)
    if pixels.device.type == "cpu":
        return image_augment_reference(pixels, desc, out_h, out_w, mean,
                                       scale)
    return _launch(pixels, desc, out_h, out_w, mean, scale)


def _launch(pixels, desc, out_h, out_w, mean, scale, listed=None):
    """The kernel's launch; ``listed``, None or an int32 tensor of one
    element on the card, gains the number of tiles whose resize-short
    window the kernel listed (a shrink past 2x)."""
    dev = pixels.device
    if dev.type != "cuda":
        raise MXNetError("image_augment: no kernel for device %s" % dev)
    if desc.device != dev:
        raise MXNetError("image_augment: desc is on %s, pixels on %s"
                         % (desc.device, dev))
    if not desc.is_contiguous():
        raise MXNetError("image_augment: desc must be contiguous")
    if listed is not None and (listed.device != dev or listed.numel() != 1
                               or listed.dtype != torch.int32):
        raise MXNetError("image_augment: listed must be one int32 on %s"
                         % dev)
    if out_h >= OUT_MAX or out_w >= OUT_MAX:
        raise MXNetError("image_augment: output size %dx%d, past %d"
                         % (out_h, out_w, OUT_MAX - 1))
    n = desc.shape[0]
    blocks = n * -(-out_h // TILE) * -(-out_w // TILE)
    if blocks >= 1 << 31:
        raise MXNetError("image_augment: %d images of %dx%d are %d tiles "
                         "in one launch, past 2^31 - 1"
                         % (n, out_h, out_w, blocks))
    out = torch.empty((n, 3, out_h, out_w), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn, err_str = _kernel()
    m, s = mean.tolist(), scale.tolist()
    err = fn(pixels.data_ptr(), pixels.numel(), desc.data_ptr(), n, out_h,
             out_w, m[0], m[1], m[2], s[0], s[1], s[2], dev.index,
             out.data_ptr(), raw_stream(dev.index),
             None if listed is None else listed.data_ptr())
    if err:
        raise MXNetError("image_augment: launch failed: %s (cudaError %d)"
                         % (err_str(err).decode(), err))
    _count_launch()
    return out


def _count_launch():
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


def reset_launches():
    """Set :data:`LAUNCHES` to 0."""
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES = 0


# ---------------------------------------------------------------------------
# cost
# ---------------------------------------------------------------------------

def _taps(src, dst):
    """Source rows (or columns) that ``Resize``'s taps touch when a
    ``src``-long edge is resized to ``dst``: every one when shrinking by
    at most 2, else two of every output."""
    return src if src <= 2 * dst else min(src, 2 * dst)


def launch_bytes(desc, out_h, out_w):
    """Bytes one launch must move for these descriptors: the float32 batch
    written once, and per image the full-size source pixels behind the
    crop window that the taps read (3 bytes a pixel), each counted once."""
    total = 4 * 3 * out_h * out_w * len(desc)
    for r in np.asarray(desc).tolist():
        denom, w1, h1, nw, nh = (r[D_DENOM], r[D_W1], r[D_H1], r[D_NW],
                                 r[D_NH])
        cw, ch = r[D_CW], r[D_CH]
        # the crop window in the scaled image's pixels, then the taps of
        # the second resize within it
        sw = min(w1, math.ceil(cw * w1 / nw) + 1)
        sh = min(h1, math.ceil(ch * h1 / nh) + 1)
        if (cw, ch) != (out_w, out_h):
            sw = min(sw, _taps(sw, out_w) + 1)
            sh = min(sh, _taps(sh, out_h) + 1)
        if (nw, nh) != (w1, h1):
            sw, sh = min(sw, _taps(w1, nw)), min(sh, _taps(h1, nh))
        total += 3 * min(r[D_W], sw * denom) * min(r[D_H], sh * denom)
    return total


def bound_seconds(desc, out_h, out_w, kind="NVIDIA H100"):
    """``(seconds, "bytes")``: the least time one launch can take on a
    device kind, :func:`launch_bytes` over its memory rate (the stage does
    some 30 operations a byte it writes, far below the card's ridge)."""
    nbytes = launch_bytes(desc, out_h, out_w)
    return nbytes / devspec.kind_spec(kind)[0].hbm_bytes_per_s, "bytes"
