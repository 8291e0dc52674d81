"""ImageRecordIter's card route on a GPU machine: nvJPEG and the
``image_augment`` kernel.

- ``image_augment`` against its plain version on the same CUDA tensors,
  exact, over random images at several sizes with every stage switched on
  and off (libjpeg's DCT scale emulated at denom 1, 2 and 4, resize-short,
  crops larger and smaller than the output, mirror, mean/std).
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


@pytest.mark.gpu
@pytest.mark.parametrize("resize,out_hw,crop,mirror,norm", [
    (0, (32, 32), False, False, False),
    (36, (32, 32), True, True, True),
    (20, (24, 28), True, False, True),      # DCT scale 1/2 and 1/4
    (0, (96, 96), True, True, False),       # crops smaller than the output
    (50, (48, 40), False, True, True),
])
def test_kernel_equals_its_plain_version(resize, out_hw, crop, mirror, norm):
    _need_card()
    rng = np.random.default_rng(resize + out_hw[0])
    sizes = [(48, 40), (37, 61), (90, 83), (170, 130), (64, 64), (33, 95)]
    n = 12
    dims = [sizes[i % len(sizes)] for i in range(n)]
    desc = ia.plan([d[0] for d in dims], [d[1] for d in dims], resize,
                   out_hw, crop, mirror, 77)
    chunks, off = [], 0
    for i, (w, h) in enumerate(dims):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        desc[i, ia.D_OFFSET], desc[i, ia.D_PITCH] = off, 3 * w
        chunks.append(img.reshape(-1))
        off += img.size
    dev = torch.device("cuda", 0)
    pixels = torch.from_numpy(np.concatenate(chunks)).to(dev)
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
    if resize:
        assert set(desc[:, ia.D_DENOM]) - {1}    # the DCT scale was emulated


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
