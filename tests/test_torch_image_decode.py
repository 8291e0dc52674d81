"""ImageRecordIter's card route, held against the JAX package on the CPU.

The card route decodes JPEGs with nvJPEG and runs the per-pixel stage in
``ops/image_augment.py``'s kernel; neither runs here. What runs here is
everything around them:

- The kernel's plain version, fed the port's own libjpeg decode
  (``mxtpu_img_decode_one`` with ``min_short = resize``, the decode the host
  route makes) and the descriptors ``image_augment.plan`` draws from the
  JPEG headers, equals the JAX package's ``ImageRecordIter`` batches bit
  for bit (exact: the same libjpeg, the same float operations in the same
  order), over center and random crops, mirror, mean/std, ``resize`` 0 and
  > 0, images smaller than the crop (the second resize), short edges at 2x
  and 4x the resize (libjpeg's DCT scale at 1/2 and 1/4) and grayscale, on
  the legacy path and through ``num_workers=2``.
- The card route's own code (``ImageRecordIter._decode_records_card``:
  header sizes, ``plan``, one decode buffer with offsets and pitches, the
  ``image_augment`` call) with nvJPEG's decoder replaced by a full-size
  libjpeg decode, where libjpeg decodes at full size too: exact.
- The numpy mt19937_64 draws equal the crop windows and mirror flags found
  in the JAX package's batches; ``plan``'s DCT-scaled sizes equal
  ``mxtpu_img_decode_one``'s over a sweep; stage (a)'s box average equals
  a numpy one.
- Without CUDA, ``ImageRecordIter()`` with no ``device`` raises naming
  ``device="cpu"``; the reader library links no libjpeg and
  ``NativeRecordIOReader`` loads only it, even where the decoder library
  cannot be built.
"""
import ctypes
import io as _bio
import os
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import jpeg_decode, native_build
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import image_augment as ia

PIL = pytest.importorskip("PIL.Image")

MEAN = dict(mean_r=123.68, mean_g=116.78, mean_b=103.94)
STD = dict(std_r=58.395, std_g=57.12, std_b=57.375)

#: name -> (image sizes (h, w) cycled over the records, grayscale,
#: iterator arguments)
CASES = {
    "center": ([(40, 48), (37, 52)], False,
               dict(data_shape=(3, 32, 32))),
    "crop_mirror_norm": ([(40, 48), (52, 37), (45, 45)], False,
                         dict(data_shape=(3, 32, 32), rand_crop=True,
                              rand_mirror=True, resize=36, **MEAN, **STD)),
    "mirror_std": ([(40, 48)], False,
                   dict(data_shape=(3, 28, 30), rand_mirror=True, resize=33,
                        std_r=50.0, std_g=60.0, std_b=70.0)),
    "mean_only_crop": ([(41, 47), (50, 35)], False,
                       dict(data_shape=(3, 30, 30), rand_crop=True, **MEAN)),
    "smaller_than_crop": ([(20, 24), (26, 18)], False,
                          dict(data_shape=(3, 32, 32), rand_crop=True,
                               rand_mirror=True)),
    "denom2": ([(64, 80), (90, 66)], False,
               dict(data_shape=(3, 28, 28), rand_crop=True, resize=30,
                    **MEAN, **STD)),
    "denom4": ([(128, 140), (150, 124)], False,
               dict(data_shape=(3, 28, 28), rand_crop=True, rand_mirror=True,
                    resize=30)),
    "grayscale": ([(40, 48), (50, 42)], True,
                  dict(data_shape=(3, 32, 32), rand_crop=True,
                       rand_mirror=True, resize=36, **MEAN, **STD)),
}


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _jpeg(rng, h, w, gray=False, quality=90):
    img = (rng.normal(120, 40, (h, w, 3))).clip(0, 255).astype(np.uint8)
    im = PIL.fromarray(img)
    if gray:
        im = im.convert("L")
    buf = _bio.BytesIO()
    im.save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _make_rec(path, sizes, gray, n=14, name="rec"):
    rng = _rng(name)
    w_ = mt.recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                       path, "w")
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        w_.write_idx(i, mt.recordio.pack(
            mt.recordio.IRHeader(0, float(i % 5), i, 0),
            _jpeg(rng, h, w, gray)))
    w_.close()
    return path


def _header_size(buf):
    return PIL.open(_bio.BytesIO(buf)).size      # (W, H), from the header


def _decode_one(buf, min_short):
    """The port's libjpeg decode: HWC uint8 at ``1/denom``."""
    lib = native_build.load("decoder")
    raw = np.frombuffer(buf, np.uint8)
    cap = 3 * 2048 * 2048
    dst = np.empty(cap, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.mxtpu_img_decode_one(raw.ctypes.data_as(u8p), len(buf),
                                  min_short, dst.ctypes.data_as(u8p), cap,
                                  ctypes.byref(w), ctypes.byref(h))
    assert rc == 1
    return dst[:w.value * h.value * 3].reshape(h.value, w.value, 3)


def _emulated_card(it, recs, batch_seed):
    """The card route with libjpeg's decode in nvJPEG's place: sizes from
    the headers, ``plan``'s draws, then the plain ``image_augment`` over
    libjpeg's DCT-scaled pixels (so the descriptors say denom 1 at the
    scaled size)."""
    bufs = [bytes(img) for _, img in recs]
    sizes = [_header_size(b) for b in bufs]
    _, h, w = it.data_shape
    desc = ia.plan([s[0] for s in sizes], [s[1] for s in sizes], it.resize,
                   (h, w), it.rand_crop, it.rand_mirror, batch_seed)
    parts, off = [], 0
    for i, b in enumerate(bufs):
        img = _decode_one(b, it.resize if it.resize > 0 else 0)
        assert img.shape[:2] == (desc[i, ia.D_H1], desc[i, ia.D_W1])
        desc[i, ia.D_OFFSET] = off
        desc[i, ia.D_W], desc[i, ia.D_H] = img.shape[1], img.shape[0]
        desc[i, ia.D_PITCH] = 3 * img.shape[1]
        desc[i, ia.D_DENOM] = 1
        parts.append(img.reshape(-1))
        off += img.size
    m, s = ia.normalization(it._mean, it._std, it._use_mean, it._use_std)
    out = ia.image_augment(torch.from_numpy(np.concatenate(parts)),
                           torch.from_numpy(desc), h, w, m, s)
    assert out.device.type == "cpu"
    return out.numpy(), it._labels(recs)


def _batches(it, epochs=1):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [lab.asnumpy() for lab in b.label], b.pad))
        it.reset()
    return out


def _assert_same(got, want):
    assert len(got) == len(want) and got
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for u, v in zip(gd + gl, wd + wl):
            assert u.shape == v.shape and u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


def _pair(tmp_path, case, nw):
    sizes, gray, kw = CASES[case]
    rec = _make_rec(str(tmp_path / "r.rec"), sizes, gray,
                    name="%s/%d" % (case, nw))
    kw = dict(kw, path_imgrec=rec, batch_size=4, shuffle=True, seed=5,
              num_workers=nw)
    return mx.image.ImageRecordIter(**kw), \
        mt.image.ImageRecordIter(device="cpu", **kw)


@pytest.mark.parametrize("nw", [0, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_stage_on_libjpeg_pixels_matches_jax(case, nw, tmp_path):
    jit, tit = _pair(tmp_path, case, nw)
    tit._decode_records = lambda recs, seed: _emulated_card(tit, recs, seed)
    got, want = _batches(tit), _batches(jit)
    tit.close()
    jit.close()
    _assert_same(got, want)


class _LibjpegDecoder(object):
    """nvJPEG's place in the card route, filled by a full-size libjpeg
    decode into one CPU buffer at the same offsets and pitches."""
    stream = None

    def info(self, bufs):
        n = len(bufs)
        w = np.array([_header_size(b)[0] for b in bufs], np.int32)
        h = np.array([_header_size(b)[1] for b in bufs], np.int32)
        return w, h, np.ones(n, np.int32), np.zeros(n, np.int32)

    def decode(self, bufs, widths, heights, routes):
        sizes = 3 * widths.astype(np.int64) * heights
        padded = (sizes + jpeg_decode.ALIGN - 1) // jpeg_decode.ALIGN \
            * jpeg_decode.ALIGN
        offsets = np.concatenate([[0], np.cumsum(padded)[:-1]])
        pixels = np.zeros(int(padded.sum()), np.uint8)
        for b, o, sz in zip(bufs, offsets, sizes):
            pixels[o:o + sz] = _decode_one(b, 0).reshape(-1)
        return (torch.from_numpy(pixels), offsets.astype(np.int64),
                np.zeros(len(bufs), np.int32))

    def finish(self):
        pass


@pytest.mark.parametrize("nw", [0, 2])
@pytest.mark.parametrize("case", ["crop_mirror_norm", "center",
                                  "smaller_than_crop", "grayscale"])
def test_card_route_code_with_a_full_size_decoder_matches_jax(
        case, nw, tmp_path, monkeypatch):
    jit, tit = _pair(tmp_path, case, nw)
    released = []
    monkeypatch.setattr(jpeg_decode, "acquire", lambda dev: _LibjpegDecoder())
    monkeypatch.setattr(jpeg_decode, "release", released.append)
    tit._card = True            # the card route's code, on CPU tensors
    got, want = _batches(tit), _batches(jit)
    tit.close()
    jit.close()
    _assert_same(got, want)
    assert len(released) == len(got)


def test_corrupt_record_raises_on_the_card_route(tmp_path, monkeypatch):
    rec = str(tmp_path / "c.rec")
    rng = _rng("corrupt")
    w_ = mt.recordio.MXIndexedRecordIO(str(tmp_path / "c.idx"), rec, "w")
    for i in range(4):
        jpg = _jpeg(rng, 40, 48)
        w_.write_idx(i, mt.recordio.pack(
            mt.recordio.IRHeader(0, 0.0, i, 0), jpg[:60] if i == 2 else jpg))
    w_.close()

    class Rejecting(_LibjpegDecoder):
        """Rejects the header nvJPEG would: the 60-byte record has none."""
        def info(self, bufs):
            ok = [len(b) > 60 for b in bufs]
            n = len(bufs)
            w = np.array([_header_size(b)[0] if k else 0
                          for b, k in zip(bufs, ok)], np.int32)
            h = np.array([_header_size(b)[1] if k else 0
                          for b, k in zip(bufs, ok)], np.int32)
            return w, h, np.ones(n, np.int32), \
                np.array([0 if k else 3 for k in ok], np.int32)
    monkeypatch.setattr(jpeg_decode, "acquire", lambda dev: Rejecting())
    monkeypatch.setattr(jpeg_decode, "release", lambda d: None)
    for card in (True, False):
        it = mt.image.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                                      batch_size=4, device="cpu")
        it._card = card
        with pytest.raises(MXNetError,
                           match="1 corrupt image\\(s\\) in batch"):
            it.next()
        it.close()


def _jax_geometry(batch_img, decoded, out_hw):
    """The (x0, y0, mirror) whose crop of ``decoded`` is ``batch_img``
    (CHW float32, no mean/std): the unique exact match."""
    oh, ow = out_hw
    want = batch_img.transpose(1, 2, 0)
    hits = []
    H, W = decoded.shape[:2]
    for y0 in range(H - oh + 1):
        for x0 in range(W - ow + 1):
            win = decoded[y0:y0 + oh, x0:x0 + ow].astype(np.float32)
            for mirror in (0, 1):
                cand = win[:, ::-1] if mirror else win
                if np.array_equal(cand, want):
                    hits.append((x0, y0, mirror))
    assert len(hits) == 1, hits
    return hits[0]


def test_python_draws_equal_the_jax_batches_geometry(tmp_path):
    sizes = [(40, 48), (45, 41), (38, 60)]
    rec = _make_rec(str(tmp_path / "g.rec"), sizes, False, n=12, name="geo")
    kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=4,
              rand_crop=True, rand_mirror=True, seed=9)
    jit = mx.image.ImageRecordIter(**kw)
    tit = mt.image.ImageRecordIter(device="cpu", **kw)
    r = mt.recordio.MXIndexedRecordIO(os.path.splitext(rec)[0] + ".idx",
                                      rec, "r")
    checked = 0
    for b in range(3):
        keys, seed, _ = tit._next_keys()
        batch = jit.next().data[0].asnumpy()
        bufs = [mt.recordio.unpack(r.read_idx(k))[1] for k in keys]
        dims = [_header_size(x) for x in bufs]
        desc = ia.plan([d[0] for d in dims], [d[1] for d in dims], 0,
                       (32, 32), True, True, seed)
        for i, buf in enumerate(bufs):
            got = _jax_geometry(batch[i], _decode_one(buf, 0), (32, 32))
            assert got == (desc[i, ia.D_X0], desc[i, ia.D_Y0],
                           desc[i, ia.D_MIRROR])
            checked += 1
    r.close()
    jit.close()
    tit.close()
    assert checked == 12


def test_mt19937_64_first_outputs():
    # std::mt19937_64's first outputs for these seeds (g++ 13, libstdc++)
    seeds = np.array([0, 1, (1 << 64) - 1], np.uint64)
    want = [[2947667278772165694, 18301848765998365067, 729919693006235833],
            [2469588189546311528, 2516265689700432462, 8323445853463659930],
            [478026398904862820, 13243134898385798468, 709236020254955927]]
    assert ia.mt19937_64_first(seeds).tolist() == want


@pytest.mark.parametrize("resize", [0, 16, 30, 60, 100])
def test_scaled_sizes_equal_libjpeg(resize):
    rng = _rng("sweep/%d" % resize)
    for h, w in [(33, 47), (64, 64), (65, 130), (127, 255), (257, 129),
                 (300, 511), (769, 1023)]:
        buf = _jpeg(rng, h, w)
        denom = ia.scale_denom(w, h, resize)
        w1, h1 = ia.scaled_size(w, h, denom)
        img = _decode_one(buf, resize)
        assert img.shape[:2] == (h1, w1), (w, h, resize, denom)


def test_box_average_equals_numpy():
    rng = np.random.default_rng(3)
    for (H, W), denom in [((37, 50), 2), ((64, 31), 4), ((17, 9), 8)]:
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        w1, h1 = ia.scaled_size(W, H, denom)
        want = np.zeros((h1, w1, 3), np.uint8)
        for y in range(h1):
            for x in range(w1):
                box = img[y * denom:(y + 1) * denom,
                          x * denom:(x + 1) * denom].astype(np.int64)
                cnt = box.shape[0] * box.shape[1]
                want[y, x] = (box.sum(axis=(0, 1)) + cnt // 2) // cnt
        got = ia._box_average(torch.from_numpy(img), denom, w1, h1)
        np.testing.assert_array_equal(got.numpy(), want)


def test_plain_stage_with_dct_scale_matches_box_then_resize():
    # stage (a) then (b): the plain version equals resizing the box means
    rng = np.random.default_rng(4)
    H, W = 70, 90
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    desc = ia.plan([W], [H], 20, (16, 16), False, False, 0)
    assert desc[0, ia.D_DENOM] == 2
    desc[0, ia.D_PITCH] = 3 * W
    out = ia.image_augment(torch.from_numpy(img.reshape(-1)),
                           torch.from_numpy(desc), 16, 16,
                           np.zeros(3, np.float32), np.ones(3, np.float32))
    box = ia._box_average(torch.from_numpy(img), 2, 45, 35)
    short = ia._resize(box, int(desc[0, ia.D_NW]), int(desc[0, ia.D_NH]))
    x0, y0 = desc[0, ia.D_X0], desc[0, ia.D_Y0]
    want = short[y0:y0 + 16, x0:x0 + 16].permute(2, 0, 1).float()
    np.testing.assert_array_equal(out[0].numpy(), want.numpy())


def test_image_record_iter_without_device_raises_here(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: ImageRecordIter() runs on the card")
    rec = _make_rec(str(tmp_path / "d.rec"), [(40, 48)], False, n=4)
    with pytest.raises(MXNetError, match="device='cpu'"):
        mt.image.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                                 batch_size=2)


def test_reader_library_links_no_libjpeg(tmp_path, monkeypatch):
    assert native_build.LIBRARIES["reader"][1] == ()
    assert native_build.LIBRARIES["decoder"][1] == ("-ljpeg",)
    rec = _make_rec(str(tmp_path / "n.rec"), [(30, 30)], False, n=3)
    # a host without libjpeg: the decoder library fails to link, the
    # reader still builds and reads
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_build, "_LIB", {})
    monkeypatch.setattr(native_build, "_ERROR", {})
    monkeypatch.setitem(native_build.LIBRARIES, "decoder",
                        (("image_decode.cc",), ("-lno_such_jpeg_library",)))
    built = []
    real = native_build.build

    def build(name="decoder"):
        built.append(name)
        return real(name)
    monkeypatch.setattr(native_build, "build", build)
    r = mt.recordio.NativeRecordIOReader(rec)
    got = [r.read() for _ in range(3)]
    want = mt.recordio.MXRecordIO(rec, "r")
    assert got == [want.read() for _ in range(3)]
    want.close()
    assert built == ["reader"]
    with pytest.raises(MXNetError, match="g\\+\\+ failed building the "
                                         "native IO decoder library"):
        native_build.load("decoder")
    assert native_build.load("reader") is r._lib
