"""ImageRecordIter's card route on a GPU machine: nvJPEG and the
``image_augment`` kernel.

- ``image_augment`` against its plain version on the same CUDA tensors,
  exact, over random images at several sizes with every stage switched on
  and off (libjpeg's DCT scale emulated at denom 1, 2, 4 and 8, a
  resize-short shrink past 2x, resize-short, crops larger and smaller than
  the output, outputs of no multiple of 4, odd pitches from an unaligned
  buffer whose last image ends flush with it, images one pixel wide or
  high, mirror, mean/std); the tiles the kernel counts as listed (a
  resize-short shrink past 2x) are those :func:`tile_window`, a model of
  its windows, lists; a launch on a side stream waits for a write to
  ``pixels`` queued there; a descriptor reaching past ``pixels`` or one
  that ``plan`` cannot make gives NaN; more than 65,535 images in a
  launch.
- nvJPEG's pixels against Pillow's decode of the same bytes, within
  ``chip_smoke.NVJPEG_BOUNDS`` (mean and largest absolute difference, share
  of values more than 2 levels apart), by route: baseline 4:2:0 JPEGs
  (the hardware route where the card has JPEG engines), progressive and
  grayscale ones.
- The worker pool on the card gives the same batches bit for bit for 1 and
  4 workers, and four threads decoding beside a busy card give one
  thread's pixels; a record whose header is cut raises the corrupt-image
  error.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_image_decode_card.py -q

Without CUDA each test skips, with its reason.
"""
import io as _bio
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import jpeg_decode
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import image_augment as ia


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: nvJPEG and the image_augment "
                    "kernel run only on the card (chip_smoke.py phase 28 "
                    "runs them there)")


def _jpeg(rng, w, h, **opts):
    """chip_smoke.py's record images (a smooth random field with noise)."""
    import chip_smoke as cs
    from PIL import Image
    im = Image.fromarray(cs.smooth_field(rng, w, h))
    if opts.pop("gray", False):
        im = im.convert("L")
    buf = _bio.BytesIO()
    im.save(buf, format="JPEG", quality=90, **opts)
    return buf.getvalue()


def _rec(path, jpegs):
    w = mt.recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                      path, "w")
    for i, jpg in enumerate(jpegs):
        w.write_idx(i, mt.recordio.pack(
            mt.recordio.IRHeader(0, float(i % 3), i, 0), jpg))
    w.close()
    return path


#: a tile's windows hold at most ``RCAP`` resize-short values and ``SCAP``
#: scaled pixels an axis (the kernel's constants of the same names)
RCAP = ia.TILE + 2
SCAP = 2 * RCAP


def _tap(o, src_len, dst_len):
    """The two source indices of ``Resize``'s output coordinate ``o``, in
    float32 as the kernel's ``tap`` rounds them: ``(i0, i1)``."""
    f32 = np.float32
    f = (f32(o) + f32(0.5)) * (f32(src_len) / f32(dst_len)) - f32(0.5)
    i0 = max(0, int(np.floor(f)))
    return i0, min(src_len - 1, i0 + 1)


def tile_window(r, out_h, out_w, ty, tx):
    """A model, in Python, of the windows the kernel stages for output
    tile ``(ty, tx)`` (in tiles) of the image whose descriptor row is
    ``r``: for x, then y, a dict with ``nC``, the resize-short values of
    the crop that the second resize reads (the tile's own outputs where
    there is none), ``sidx``, the scaled image's columns (rows) staged for
    them, and ``contiguous``, whether ``sidx`` is one span (else it lists
    each value's two taps). Mirror reads column ``out_w - 1 - x`` of the
    final image. The CPU tests hold it to the plain version's taps, and
    the card test below holds the kernel's count of listed tiles to it."""
    r = [int(v) for v in r]
    stage_d = (r[ia.D_CW], r[ia.D_CH]) != (out_w, out_h)
    stage_b = (r[ia.D_NW], r[ia.D_NH]) != (r[ia.D_W1], r[ia.D_H1])
    axes = []
    for t, out_len, c_len, off, s_len, r_len, mirror in (
            (tx, out_w, r[ia.D_CW], r[ia.D_X0], r[ia.D_W1], r[ia.D_NW],
             r[ia.D_MIRROR]),
            (ty, out_h, r[ia.D_CH], r[ia.D_Y0], r[ia.D_H1], r[ia.D_NH], 0)):
        t0 = t * ia.TILE
        n_f = min(ia.TILE, out_len - t0)
        f_lo = out_len - t0 - n_f if mirror else t0
        c_lo, n_c = f_lo, n_f
        if stage_d:
            first = _tap(f_lo, c_len, out_len)
            last = _tap(f_lo + n_f - 1, c_len, out_len)
            c_lo, n_c = first[0], last[1] - first[0] + 1
        contiguous = True
        if stage_b:
            taps = [_tap(off + c_lo + k, s_len, r_len) for k in range(n_c)]
            lo, hi = taps[0][0], taps[-1][1]
            contiguous = hi - lo + 1 <= SCAP
            sidx = (list(range(lo, hi + 1)) if contiguous
                    else [i for pair in taps for i in pair])
        else:
            sidx = list(range(off + c_lo, off + c_lo + n_c))
        axes.append({"nC": n_c, "sidx": sidx, "contiguous": contiguous})
    return axes


def listed_tiles(desc, out_h, out_w):
    """The tiles of the batch ``desc`` with a listed window, by
    :func:`tile_window`."""
    return sum(not all(w["contiguous"]
                       for w in tile_window(r, out_h, out_w, ty, tx))
               for r in desc for ty in range(-(-out_h // ia.TILE))
               for tx in range(-(-out_w // ia.TILE)))


def _case(resize, out_hw, crop, mirror, norm, sizes=None, id=None):
    return pytest.param(resize, out_hw, crop, mirror, norm, sizes, id=id)


#: the images of a case that names none, cycled over 12
SIZES = [(48, 40), (37, 61), (90, 83), (170, 130), (64, 64), (33, 95)]


@pytest.mark.gpu
@pytest.mark.parametrize("resize,out_hw,crop,mirror,norm,sizes", [
    _case(0, (32, 32), False, False, False, id="0-out_hw0-False-False-False"),
    _case(36, (32, 32), True, True, True, id="36-out_hw1-True-True-True"),
    # DCT scale 1/2 and 1/4
    _case(20, (24, 28), True, False, True, id="20-out_hw2-True-False-True"),
    # crops smaller than the output
    _case(0, (96, 96), True, True, False, id="0-out_hw3-True-True-False"),
    _case(50, (48, 40), False, True, True, id="50-out_hw4-False-True-True"),
    # the cases below pack their images after 5 bytes, so no row starts
    # aligned, and the last image ends flush with the end of `pixels`
    _case(10, (9, 10), True, True, True, sizes=((170, 130),) * 3 + (
        (48, 40), (33, 95)), id="denom8"),
    # resize-short shrinks 3.1x at libjpeg's 1/8 cap: listed windows
    _case(40, (40, 36), True, True, True, sizes=(
        (1200, 1000), (1000, 1300), (170, 130)), id="denom8_shrink3x"),
    # crops smaller than an output of no multiple of 4 or of the tile
    _case(0, (227, 227), True, True, True, sizes=tuple(SIZES), id="up227"),
    _case(100, (227, 227), True, False, True, sizes=tuple(SIZES),
          id="resize_up227"),
    # odd widths (pitch 3 * W odd), an image one pixel wide and one high
    _case(256, (224, 224), True, True, True, sizes=(
        (501, 375), (375, 501), (333, 251), (255, 257), (1, 7), (7, 1)),
        id="odd_pitch224"),
])
def test_kernel_equals_its_plain_version(resize, out_hw, crop, mirror, norm,
                                         sizes):
    _need_card()
    rng = np.random.default_rng(resize + out_hw[0])
    imgs = SIZES if sizes is None else sizes
    n = 12 if sizes is None else len(sizes)
    dims = [imgs[i % len(imgs)] for i in range(n)]
    lead = 0 if sizes is None else 5
    desc = ia.plan([d[0] for d in dims], [d[1] for d in dims], resize,
                   out_hw, crop, mirror, 77)
    chunks, off = [np.zeros(lead, np.uint8)], 0
    for i, (w, h) in enumerate(dims):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        desc[i, ia.D_OFFSET], desc[i, ia.D_PITCH] = off, 3 * w
        chunks.append(img.reshape(-1))
        off += img.size
    dev = torch.device("cuda", 0)
    pixels = torch.from_numpy(np.concatenate(chunks)).to(dev)[lead:]
    assert pixels.numel() == off
    d = torch.from_numpy(desc).to(dev)
    m, s = ia.normalization((123.68, 116.78, 103.94), (58.4, 57.1, 57.4),
                            norm, norm)
    before = ia.LAUNCHES
    got = ia.image_augment(pixels, d, out_hw[0], out_hw[1], m, s)
    want = ia.image_augment_reference(pixels, d, out_hw[0], out_hw[1],
                                      torch.as_tensor(m), torch.as_tensor(s))
    torch.cuda.synchronize()
    assert ia.LAUNCHES == before + 1
    assert got.shape == (n, 3) + tuple(out_hw)
    assert torch.equal(got, want)
    if resize and sizes is None:
        assert set(desc[:, ia.D_DENOM]) - {1}    # the DCT scale was emulated
    if resize in (10, 40):                        # libjpeg's 1/8 cap
        assert 8 in set(desc[:, ia.D_DENOM])
    # a second launch counts the tiles the kernel lists: those the model
    # lists, some where resize-short shrinks past 2x
    listed = torch.zeros(1, dtype=torch.int32, device=dev)
    again = ia._launch(pixels, d, out_hw[0], out_hw[1], torch.as_tensor(m),
                       torch.as_tensor(s), listed=listed)
    torch.cuda.synchronize()
    assert torch.equal(again, want)
    assert int(listed) == listed_tiles(desc, *out_hw)
    if resize == 40:
        assert int(listed) > 0


def _packed(rng, dims):
    chunks, offs, off = [], [], 0
    for w, h in dims:
        chunks.append(rng.integers(0, 256, 3 * w * h, dtype=np.uint8))
        offs.append(off)
        off += 3 * w * h
    return np.concatenate(chunks), offs


@pytest.mark.gpu
def test_kernel_runs_on_the_current_stream():
    # ImageRecordIter launches on its decoder's stream: the kernel must be
    # queued behind a write to `pixels` on that stream, not beside it
    _need_card()
    rng = np.random.default_rng(41)
    dims = [(375, 500), (500, 375), (333, 251), (170, 130)]
    desc = ia.plan([d[0] for d in dims], [d[1] for d in dims], 256,
                   (224, 224), True, True, 3)
    host, offs = _packed(rng, dims)
    desc[:, ia.D_OFFSET] = offs
    desc[:, ia.D_PITCH] = [3 * d[0] for d in dims]
    dev = torch.device("cuda", 0)
    src = torch.from_numpy(host).to(dev)
    pixels = torch.zeros_like(src)
    d = torch.from_numpy(desc).to(dev)
    m, s = ia.normalization((123.68, 116.78, 103.94), (58.4, 57.1, 57.4),
                            True, True)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)        # the write lands late
        pixels.copy_(src)
        got = ia.image_augment(pixels, d, 224, 224, m, s)
    torch.cuda.synchronize()
    want = ia.image_augment_reference(pixels, d, 224, 224,
                                      torch.as_tensor(m), torch.as_tensor(s))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_writes_nan_for_a_descriptor_it_cannot_take():
    _need_card()
    rng = np.random.default_rng(31)
    dims = [(40, 30), (33, 21), (50, 20), (41, 29)]
    desc = ia.plan([d[0] for d in dims], [d[1] for d in dims], 0, (24, 24),
                   True, True, 5)
    host, offs = _packed(rng, dims)
    desc[:, ia.D_OFFSET] = offs
    desc[:, ia.D_PITCH] = [3 * d[0] for d in dims]
    desc[1, ia.D_OFFSET] = host.size - 3 * 33 * 21 + 1   # 1 byte past the end
    desc[2, ia.D_CW] = 25                                # wider than the output
    dev = torch.device("cuda", 0)
    pixels = torch.from_numpy(host).to(dev)
    d = torch.from_numpy(desc).to(dev)
    m, s = np.zeros(3, np.float32), np.ones(3, np.float32)
    got = ia.image_augment(pixels, d, 24, 24, m, s)
    keep = torch.tensor([0, 3], device=dev)
    want = ia.image_augment_reference(pixels, d[keep], 24, 24,
                                      torch.as_tensor(m), torch.as_tensor(s))
    torch.cuda.synchronize()
    assert torch.isnan(got[1]).all() and torch.isnan(got[2]).all()
    assert torch.equal(got[keep], want)


@pytest.mark.gpu
def test_kernel_takes_more_than_65535_images():
    _need_card()
    rng = np.random.default_rng(37)
    n = 65536 + 7
    dims = [(5, 4), (3, 6), (7, 7)] * (n // 3) + [(5, 4)] * (n % 3)
    desc = ia.plan([d[0] for d in dims], [d[1] for d in dims], 0, (6, 6),
                   True, True, 9)
    host, offs = _packed(rng, dims)
    desc[:, ia.D_OFFSET] = offs
    desc[:, ia.D_PITCH] = [3 * d[0] for d in dims]
    dev = torch.device("cuda", 0)
    pixels = torch.from_numpy(host).to(dev)
    d = torch.from_numpy(desc).to(dev)
    m, s = np.zeros(3, np.float32), np.ones(3, np.float32)
    got = ia.image_augment(pixels, d, 6, 6, m, s)
    idx = torch.tensor(sorted({0, 1, 2, 65534, 65535, 65536, n - 1}
                              | set(range(0, n, 4099))), device=dev)
    want = ia.image_augment_reference(pixels, d[idx], 6, 6,
                                      torch.as_tensor(m), torch.as_tensor(s))
    torch.cuda.synchronize()
    assert got.shape == (n, 3, 6, 6) and torch.equal(got[idx], want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["baseline", "progressive", "gray"])
def test_nvjpeg_against_pillow(kind):
    _need_card()
    import chip_smoke as cs
    from PIL import Image
    rng = np.random.default_rng(5)
    opts = {"baseline": {"subsampling": 2},
            "progressive": {"subsampling": 2, "progressive": True},
            "gray": {"gray": True}}[kind]
    bufs = [_jpeg(rng, 500 - 25 * i, 375 + 5 * i, **dict(opts))
            for i in range(4)]
    dec = jpeg_decode.acquire(torch.device("cuda", 0))
    try:
        w, h, routes, st = dec.info(bufs)
        assert not np.count_nonzero(st)
        pixels, offs, st = dec.decode(bufs, w, h, routes)
        dec.finish()
    finally:
        jpeg_decode.release(dec)
    assert not np.count_nonzero(st)
    host = pixels.cpu().numpy()
    for i, b in enumerate(bufs):
        ref = np.asarray(Image.open(_bio.BytesIO(b)).convert("RGB"))
        assert ref.shape == (h[i], w[i], 3)
        nv = host[offs[i]:offs[i] + ref.size].reshape(ref.shape)
        diff = np.abs(nv.astype(np.int16) - ref)
        mean, top, over = cs.NVJPEG_BOUNDS[jpeg_decode.ROUTES[routes[i]]]
        assert diff.mean() <= mean and diff.max() <= top
        assert np.mean(diff > 2) <= over


@pytest.mark.gpu
def test_pool_batches_equal_across_worker_counts(tmp_path):
    _need_card()
    rng = np.random.default_rng(9)
    jpegs = [_jpeg(rng, 60 + 3 * i, 50 + 2 * i, subsampling=2,
                   progressive=(i % 5 == 0)) for i in range(24)]
    rec = _rec(str(tmp_path / "p.rec"), jpegs)
    out = {}
    for nw in (1, 4):
        it = mt.image.ImageRecordIter(
            path_imgrec=rec, data_shape=(3, 40, 40), batch_size=6,
            shuffle=True, rand_crop=True, rand_mirror=True, resize=48,
            mean_r=120.0, std_r=60.0, num_workers=nw, seed=3)
        out[nw] = []
        for _ in range(2):
            for b in it:
                assert b.data[0].context == mt.gpu(0)
                out[nw].append((b.data[0].data.clone(),
                                b.label[0].data.clone()))
            it.reset()
        it.close()
    assert len(out[1]) == len(out[4]) == 8
    for (a, la), (b, lb) in zip(out[1], out[4]):
        assert torch.equal(a, b) and torch.equal(la, lb)


@pytest.mark.gpu
def test_threads_beside_a_busy_card_decode_as_one_thread():
    _need_card()
    import threading
    rng = np.random.default_rng(13)
    bufs = [_jpeg(rng, 500, 375, subsampling=2) for _ in range(32)]
    dev = torch.device("cuda", 0)

    def decode():
        dec = jpeg_decode.acquire(dev)
        try:
            w, h, r, _ = dec.info(bufs)
            px, offs, st = dec.decode(bufs, w, h, r)
            dec.finish()
        finally:
            jpeg_decode.release(dec)
        assert not np.count_nonzero(st)
        # the images alone: the buffer's alignment gaps are not written
        return torch.cat([px[o:o + 3 * int(a) * int(b)]
                          for o, a, b in zip(offs, w, h)])
    ref = decode()
    stop, got = threading.Event(), []

    def load():
        a = torch.randn(4096, 4096, device=dev)
        while not stop.is_set():
            a = (a @ a).clamp_(-1, 1)
            torch.cuda.synchronize()
    loader = threading.Thread(target=load)
    loader.start()
    try:
        threads = [threading.Thread(target=lambda: got.extend(
            decode() for _ in range(3))) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        stop.set()
        loader.join()
    assert len(got) == 12 and all(torch.equal(g, ref) for g in got)


@pytest.mark.gpu
def test_corrupt_record_raises(tmp_path):
    _need_card()
    rng = np.random.default_rng(11)
    jpegs = [_jpeg(rng, 64, 48) for _ in range(4)]
    jpegs[2] = jpegs[2][:100]            # cut inside the header
    rec = _rec(str(tmp_path / "c.rec"), jpegs)
    it = mt.image.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                                  batch_size=4)
    with pytest.raises(MXNetError, match="1 corrupt image\\(s\\) in batch"):
        it.next()
    it.close()
