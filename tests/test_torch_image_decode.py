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
from test_torch_image_decode_card import RCAP, SCAP, tile_window

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


def _reference_taps(src_len, dst_len):
    """The source indices ``_resize`` reads for each output: its own index
    arithmetic (float32 tensors), ``(i0, i1)`` lists."""
    f32 = torch.float32
    s = torch.tensor(src_len, dtype=f32) / torch.tensor(dst_len, dtype=f32)
    f = (torch.arange(dst_len, dtype=f32) + 0.5) * s - 0.5
    i0 = torch.clamp(torch.floor(f).to(torch.int64), min=0)
    i1 = torch.clamp(i0 + 1, max=src_len - 1)
    return i0.tolist(), i1.tolist()


def _window_descriptors():
    """Descriptors from ``plan`` over denom 1 to 8, mirror, upscales,
    extreme aspect ratios and a 2.9x resize-short shrink at libjpeg's 1/8
    cap: ``(desc row, out_h, out_w)``."""
    rng = np.random.default_rng(25)
    groups = [
        ([(500, 375), (375, 500), (1024, 768)], 256, (224, 224)),
        ([(8000, 6000)], 256, (224, 224)),          # denom 8, 2.93x
        ([(1200, 1000), (170, 130)], 40, (32, 32)),  # denom 8, 3.1x
        ([(170, 130), (33, 95)], 10, (27, 29)),      # denom 8 and 2
        ([(48, 40), (37, 61), (1, 40), (40, 1)], 0, (227, 227)),  # upscale
        ([(3000, 2), (2, 3000), (4000, 90)], 24, (20, 36)),       # aspect
        ([(90, 83), (64, 64)], 50, (48, 40)),
        ([(700, 520), (640, 480)], 0, (96, 100)),    # no resize, crops
    ]
    for i in range(12):                               # random sizes
        w, h = (int(v) for v in rng.integers(1, 2500, 2))
        groups.append(([(w, h)], int(rng.choice([0, 16, 37, 120, 256])),
                       tuple(int(v) for v in rng.integers(1, 260, 2))))
    out = []
    for k, (sizes, resize, (oh, ow)) in enumerate(groups):
        desc = ia.plan([s[0] for s in sizes], [s[1] for s in sizes], resize,
                       (oh, ow), True, True, 100 + k)
        out += [(r, oh, ow) for r in desc]
    return out


def test_tile_windows_cover_the_plain_versions_taps():
    # tile_window models the kernel's windows (the card test holds the
    # kernel's count of listed tiles to it): they reach every row and
    # column the plain version's taps read, within the kernel's caps
    seen = {"denoms": set(), "upscale": 0, "listed": 0, "mirror": 0}
    for r, oh, ow in _window_descriptors():
        d = [int(v) for v in r]
        stage_d = (d[ia.D_CW], d[ia.D_CH]) != (ow, oh)
        stage_b = (d[ia.D_NW], d[ia.D_NH]) != (d[ia.D_W1], d[ia.D_H1])
        seen["denoms"].add(d[ia.D_DENOM])
        seen["upscale"] += stage_d
        seen["mirror"] += d[ia.D_MIRROR]
        # per axis: the plain version's taps of each stage
        taps = []
        for out_len, c_len, off, s_len, r_len in (
                (ow, d[ia.D_CW], d[ia.D_X0], d[ia.D_W1], d[ia.D_NW]),
                (oh, d[ia.D_CH], d[ia.D_Y0], d[ia.D_H1], d[ia.D_NH])):
            taps.append((_reference_taps(c_len, out_len) if stage_d
                         else None,
                         _reference_taps(s_len, r_len) if stage_b
                         else None, off, s_len))
        for ty in range(-(-oh // ia.TILE)):
            for tx in range(-(-ow // ia.TILE)):
                win = tile_window(r, oh, ow, ty, tx)
                for axis, (t0, out_len) in enumerate(((tx, ow), (ty, oh))):
                    dt, bt, off, s_len = taps[axis]
                    outs = range(t0 * ia.TILE,
                                 min(out_len, (t0 + 1) * ia.TILE))
                    if axis == 0 and d[ia.D_MIRROR]:
                        outs = [out_len - 1 - x for x in outs]
                    crop = ({i for o in outs for i in (dt[0][o], dt[1][o])}
                            if dt else set(outs))
                    short = {c + off for c in crop}
                    scaled = ({i for v in short for i in (bt[0][v], bt[1][v])}
                              if bt else short)
                    w = win[axis]
                    assert w["nC"] <= RCAP and len(w["sidx"]) <= SCAP
                    assert scaled <= set(w["sidx"]), (d, oh, ow, ty, tx)
                    assert min(w["sidx"]) >= 0 and max(w["sidx"]) < s_len
                    seen["listed"] += not w["contiguous"]
                    if dt:
                        assert len(crop) <= w["nC"]
    assert seen["denoms"] == {1, 2, 4, 8}
    assert seen["upscale"] and seen["listed"] and seen["mirror"]


def test_wrapper_refuses_what_the_kernel_cannot_take():
    from mxnet_tpu_torch.memcheck import fake_mode
    m, s = np.zeros(3, np.float32), np.ones(3, np.float32)
    i64 = torch.int64
    px = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(MXNetError, match="int64 \\(n, 14\\)"):
        ia.image_augment(px, torch.zeros((2, 14), dtype=torch.int32), 8, 8,
                         m, s)
    with fake_mode():
        px = torch.empty(64, dtype=torch.uint8, device="cuda")
        desc = torch.zeros((2, ia.NDESC), dtype=i64, device="cuda")
        with pytest.raises(MXNetError, match="int64 \\(n, 14\\)"):
            ia.image_augment(px, desc.to(torch.int32), 8, 8, m, s)
        with pytest.raises(MXNetError, match="int64 \\(n, 14\\)"):
            ia.image_augment(px, torch.zeros((2, 13), dtype=i64,
                                             device="cuda"), 8, 8, m, s)
        with pytest.raises(MXNetError, match="contiguous"):
            ia.image_augment(px, torch.empty_strided(
                (2, ia.NDESC), (1, 2), dtype=i64, device="cuda"), 8, 8, m, s)
        with pytest.raises(MXNetError, match="past 8388607"):
            ia.image_augment(px, desc, ia.OUT_MAX, 8, m, s)
        many = torch.zeros((1 << 21, ia.NDESC), dtype=i64, device="cuda")
        with pytest.raises(MXNetError, match="past 2\\^31 - 1"):
            ia.image_augment(px, many, 1024, 1024, m, s)
