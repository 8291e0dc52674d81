"""The port's image pipeline against the JAX package's, on the CPU.

Both packages read the same indexed ``.rec`` files, made in ``tmp_path``
from a numpy seed with small JPEGs (Pillow), and must give the same
batches:

- ``imdecode``: the port's native libjpeg output equals the JAX package's
  and Pillow's (exact: the same libjpeg decodes);
- ``ImageRecordIter`` over two epochs with shuffle, random crop, mirror,
  resize and mean/std, for ``num_workers`` 0, 1 and 3, with
  ``part_index``/``num_parts``, ``sub_index``/``sub_parts`` and
  ``round_batch``: data, labels and pad exact (the fused native stage is
  the same C++ with the same per-batch seeds), also under ``io.record_read``
  transient faults, with equal ``DataHealth`` counts;
- ``ImageIter`` (RecordIO and an image list, with the Python augmenters in
  the worker pool, whose draws are scoped to each batch's seed) and
  ``ImageDetIter`` (mirror and IoU-constrained crop): exact;
- ``det_flip_boxes``, ``det_crop_boxes`` and the augmenter functions:
  exact.
"""
import io as _bio
import os
import zlib

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import faults as jfaults
from mxnet_tpu_torch import faults as tfaults

PIL = pytest.importorskip("PIL.Image")


@pytest.fixture(autouse=True)
def _clean_faults():
    tfaults.clear()
    jfaults.clear()
    yield
    tfaults.clear()
    jfaults.clear()


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _jpeg(rng, h, w, quality=90):
    img = (rng.normal(120, 40, (h, w, 3))).clip(0, 255).astype(np.uint8)
    buf = _bio.BytesIO()
    PIL.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _make_rec(path, n=26, h=40, w=48, classes=5, name="rec", det=False):
    """An indexed .rec of ``n`` JPEGs (labels: class ids, or detection rows
    [2, 5, (cls, x1, y1, x2, y2) * objects])."""
    rng = _rng(name)
    idx = os.path.splitext(path)[0] + ".idx"
    w_ = mt.recordio.MXIndexedRecordIO(idx, path, "w")
    for i in range(n):
        if det:
            rows = []
            for _ in range(int(rng.integers(1, 4))):
                x1, y1 = rng.uniform(0, 0.6, 2)
                bw, bh = rng.uniform(0.15, 0.4, 2)
                rows += [float(rng.integers(0, classes)), x1, y1,
                         x1 + bw, y1 + bh]
            label = np.array([2, 5] + rows, np.float32)
        else:
            label = float(i % classes)
        w_.write_idx(i, mt.recordio.pack(
            mt.recordio.IRHeader(0, label, i, 0), _jpeg(rng, h, w)))
    w_.close()
    return path


def _batches(it, epochs=2):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [l.asnumpy() for l in b.label], b.pad))
        it.reset()
    return out


def _assert_same(got, want):
    assert len(got) == len(want) and got
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for u, v in zip(gd + gl, wd + wl):
            assert u.shape == v.shape and u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("size", [(32, 32), (45, 61)])
def test_imdecode_native_matches_reference_and_pillow(size):
    buf = _jpeg(_rng("dec/%d" % size[0]), *size)
    with mt.cpu():
        got = mt.image.imdecode(buf).asnumpy()
    want = mx.image.imdecode(buf).asnumpy()
    pil = np.asarray(PIL.open(_bio.BytesIO(buf)).convert("RGB"))
    assert got.shape == size + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(mt.image._decode_numpy(buf), got)


def test_imdecode_pillow_paths_match_reference():
    rng = _rng("dec/pillow")
    img = rng.integers(0, 256, (20, 28, 3), dtype=np.uint8)
    png = _bio.BytesIO()
    PIL.fromarray(img).save(png, format="PNG")
    png = png.getvalue()
    jpg = _jpeg(rng, 20, 28)
    for buf, kw in ((png, {}), (jpg, {"flag": 0}), (jpg, {"to_rgb": False})):
        with mt.cpu():
            got = mt.image.imdecode(buf, **kw).asnumpy()
        np.testing.assert_array_equal(got, mx.image.imdecode(buf,
                                                             **kw).asnumpy())
    with mt.cpu():
        out = mt.nd.zeros((1,), dtype=np.uint8)
        assert mt.image.imdecode(png, out=out) is out
    np.testing.assert_array_equal(out.asnumpy(), img)


def test_augmenters_match_reference():
    img = _rng("aug").integers(0, 256, (30, 44, 3), dtype=np.uint8)
    np.testing.assert_array_equal(mt.image.resize_short(img, 20),
                                  mx.image.resize_short(img, 20))
    np.testing.assert_array_equal(mt.image.center_crop(img, (16, 12))[0],
                                  mx.image.center_crop(img, (16, 12))[0])
    np.testing.assert_array_equal(
        mt.image.fixed_crop(img, 3, 4, 10, 12, size=(8, 8)),
        mx.image.fixed_crop(img, 3, 4, 10, 12, size=(8, 8)))
    mean, std = np.array([120.0, 110.0, 100.0]), np.array([50.0, 60.0, 70.0])
    np.testing.assert_array_equal(mt.image.color_normalize(img, mean, std),
                                  mx.image.color_normalize(img, mean, std))
    # a random crop under one scoped generator draws the same window
    for pkg in (mx, mt):
        with pkg.random.scoped_np_rng(np.random.default_rng(7)):
            out, win = pkg.image.random_crop(img, (16, 16))
        if pkg is mx:
            want = (out, win)
    assert win == want[1]
    np.testing.assert_array_equal(out, want[0])


RECORD_CASES = [
    # (num_workers, extra kwargs)
    (0, {}),
    (1, {}),
    (3, {}),
    (3, {"round_batch": False}),
    (0, {"round_batch": False}),
    (2, {"part_index": 1, "num_parts": 2}),
    (0, {"part_index": 0, "num_parts": 2}),
    (2, {"sub_index": 1, "sub_parts": 2}),
]


@pytest.mark.parametrize("nw,extra", RECORD_CASES)
def test_image_record_iter_matches_reference(nw, extra, tmp_path):
    rec = _make_rec(str(tmp_path / "a.rec"), name="rec/%d%s" % (nw, extra))
    kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=6,
              shuffle=True, rand_crop=True, rand_mirror=True, resize=36,
              mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395,
              std_g=57.12, std_b=57.375, seed=11, num_workers=nw, **extra)
    jit = mx.image.ImageRecordIter(**kw)
    tit = mt.image.ImageRecordIter(device="cpu", **kw)
    assert [tuple(d) for d in tit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    assert [tuple(d) for d in tit.provide_label] == \
        [tuple(d) for d in jit.provide_label]
    got, want = _batches(tit), _batches(jit)
    tit.close()
    jit.close()
    _assert_same(got, want)
    if extra.get("round_batch", True) and "num_parts" not in extra \
            and "sub_parts" not in extra:
        assert got[4][2] == 4          # 26 records: the tail wraps 4


def test_image_record_iter_batches_stay_on_the_host(tmp_path):
    rec = _make_rec(str(tmp_path / "h.rec"), n=12, name="host")
    it = mt.image.ImageRecordIter(path_imgrec=rec, data_shape=(3, 24, 24),
                                  batch_size=4, num_workers=2, device="cpu")
    b = it.next()
    assert b.data[0].context == mt.cpu() and b.label[0].context == mt.cpu()
    h = it.next_host()
    assert isinstance(h.data[0], np.ndarray)
    assert h.data[0].shape == (4, 3, 24, 24)
    it.close()


@pytest.mark.faults
def test_image_record_iter_transient_faults_match_reference(tmp_path):
    rec = _make_rec(str(tmp_path / "f.rec"), name="faults")
    kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=6,
              shuffle=True, rand_crop=True, seed=2, num_workers=2)
    clean = mt.image.ImageRecordIter(device="cpu", **kw)
    want = _batches(clean, epochs=1)
    clean.close()
    out = {}
    for pkg, f in ((mx, jfaults), (mt, tfaults)):
        pkg.io.DATA_HEALTH.reset()
        f.clear()       # call numbers count from here in both packages
        f.inject("io.record_read", nth=3, kind="transient", times=2)
        f.inject("io.record_read", nth=17, kind="transient")
        it = pkg.image.ImageRecordIter(
            retry_policy=pkg.io.RetryPolicy(base_delay=0.0),
            **dict(kw, device="cpu") if pkg is mt else kw)
        out[pkg] = (_batches(it, epochs=1), it.data_health.report(),
                    pkg.io.DATA_HEALTH.report())
        it.close()
        f.clear()
    _assert_same(out[mt][0], out[mx][0])
    _assert_same(out[mt][0], want)
    assert out[mt][1] == out[mx][1]
    assert out[mt][2] == out[mx][2]
    assert out[mt][1]["retries"] == 3 and out[mt][1]["failures"] == 0


@pytest.mark.parametrize("nw", [0, 2])
def test_image_iter_over_records_matches_reference(nw, tmp_path):
    rec = _make_rec(str(tmp_path / "i.rec"), n=20, name="iter/%d" % nw)
    out = {}
    for pkg in (mx, mt):
        # the legacy path draws its shuffle and augmentations from each
        # package's own global stream: it runs unshuffled, with no
        # random augmentation; the pool path scopes every draw to the
        # batch's seed
        augs = pkg.image.CreateAugmenter(
            (3, 24, 24), resize=28, rand_crop=nw > 0, rand_mirror=nw > 0,
            mean=True, std=True)
        it = pkg.image.ImageIter(4, (3, 24, 24), path_imgrec=rec,
                                 aug_list=augs, shuffle=nw > 0,
                                 num_workers=nw, seed=5)
        out[pkg] = _batches(it)
        it.close()
    _assert_same(out[mt], out[mx])


def test_image_iter_over_an_image_list_matches_reference(tmp_path):
    rng = _rng("imglist")
    items = []
    for i in range(12):
        fname = "img%02d.jpg" % i
        with open(str(tmp_path / fname), "wb") as f:
            f.write(_jpeg(rng, 30, 30))
        items.append(([float(i % 3), float(i)], fname))
    out = {}
    for pkg in (mx, mt):
        augs = pkg.image.CreateAugmenter((3, 20, 20), rand_crop=True,
                                         rand_mirror=True)
        it = pkg.image.ImageIter(4, (3, 20, 20), label_width=2,
                                 imglist=items, path_root=str(tmp_path),
                                 aug_list=augs, shuffle=True, num_workers=2,
                                 seed=1)
        out[pkg] = _batches(it)
        it.close()
    _assert_same(out[mt], out[mx])


@pytest.mark.parametrize("kw", [
    {"rand_mirror": True},
    {"rand_mirror": True, "rand_crop": 0.8, "shuffle": True,
     "mean_pixels": [120, 110, 100], "std_pixels": [60, 60, 60]},
    {"label_shape": (6, 5)},
])
def test_image_det_iter_matches_reference(kw, tmp_path):
    rec = _make_rec(str(tmp_path / "d.rec"), n=16, h=36, w=36, name="det",
                    det=True)
    out = {}
    for pkg in (mx, mt):
        it = pkg.image.ImageDetIter(4, (3, 36, 36), rec, seed=3, **kw)
        assert it.provide_label[0].shape == (
            4, kw.get("label_shape", (3, 5))[0], 5)
        out[pkg] = _batches(it)
    _assert_same(out[mt], out[mx])
    labels = np.concatenate([b[1][0] for b in out[mt]])
    assert (labels[:, 0, 0] >= 0).all()      # every image keeps an object


def test_det_flip_and_crop_boxes_match_reference():
    rng = _rng("boxes")
    boxes = np.full((6, 5), -1.0, np.float32)
    for i in range(4):
        x1, y1 = rng.uniform(0, 0.7, 2)
        boxes[i] = [i % 3, x1, y1, x1 + 0.25, y1 + 0.2]
    np.testing.assert_array_equal(mt.image.det_flip_boxes(boxes),
                                  mx.image.det_flip_boxes(boxes))
    for win in ((0.0, 0.0, 1.0, 1.0), (0.1, 0.2, 0.5, 0.6),
                (0.6, 0.6, 0.4, 0.4)):
        for ov in (0.3, 0.5, 0.9):
            np.testing.assert_array_equal(
                mt.image.det_crop_boxes(boxes, *win, min_overlap=ov),
                mx.image.det_crop_boxes(boxes, *win, min_overlap=ov))
