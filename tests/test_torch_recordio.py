"""The port's RecordIO layer against the JAX package's, on the CPU.

The same ``.rec``/``.idx`` files, made in ``tmp_path`` from a numpy seed
with small JPEGs (Pillow), are written by one package and read by the
other: record bytes, ``IRHeader`` fields, labels and index keys exact
(nothing is computed). ``pack``/``unpack``/``pack_img``/``unpack_img`` give
the same bytes and arrays (exact). The port's native reader
(``src/io/recordio_reader.cc`` built by ``native_build`` with ``g++`` and
libjpeg) reads the records ``MXRecordIO`` reads, sequentially, through its
prefetch thread and by offset (exact). A failed native build raises
``MXNetError`` with the compiler's output, and ``ImageRecordIter`` then
raises the same.
"""
import io as _bio
import os
import zlib

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import native_build
from mxnet_tpu_torch.base import MXNetError

PIL = pytest.importorskip("PIL.Image")


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _jpeg(rng, h=32, w=40, quality=90):
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    buf = _bio.BytesIO()
    PIL.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _records(name, n=12):
    """[(header tuple, payload)] with scalar and array labels."""
    rng = _rng(name)
    out = []
    for i in range(n):
        if i % 3 == 2:
            label = rng.random(7).astype(np.float32)
        else:
            label = float(rng.integers(0, 10))
        out.append(((0, label, i, 1000 + i), _jpeg(rng)))
    return out


def _write(pkg, path, records):
    idx = os.path.splitext(path)[0] + ".idx"
    w = pkg.recordio.MXIndexedRecordIO(idx, path, "w")
    for hdr, payload in records:
        w.write_idx(hdr[2], pkg.recordio.pack(pkg.recordio.IRHeader(*hdr),
                                              payload))
    w.close()
    return path, idx


def _read_all(pkg, path, idx):
    r = pkg.recordio.MXIndexedRecordIO(idx, path, "r")
    out = []
    for k in r.keys:
        h, payload = pkg.recordio.unpack(r.read_idx(k))
        out.append((k, h.flag, np.asarray(h.label, np.float32).tolist(),
                    h.id, h.id2, payload))
    r.close()
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rec_files_cross_read(writer, tmp_path):
    recs = _records("cross")
    wpkg, rpkg = (mx, mt) if writer == "jax" else (mt, mx)
    path, idx = _write(wpkg, str(tmp_path / "a.rec"), recs)
    # both packages read the file identically, and as written
    got, want = _read_all(rpkg, path, idx), _read_all(wpkg, path, idx)
    assert got == want
    assert [g[0] for g in got] == list(range(len(recs)))
    for g, (hdr, payload) in zip(got, recs):
        assert g[3:] == (hdr[2], hdr[3], payload)
    with open(idx) as f:
        text = f.read()
    other = str(tmp_path / "b.rec")
    _write(rpkg, other, recs)
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()
    with open(os.path.splitext(other)[0] + ".idx") as f:
        assert f.read() == text


@pytest.mark.parametrize("label", ["scalar", "array", "list"])
def test_pack_unpack_match_reference(label):
    rng = _rng("pack/" + label)
    lab = {"scalar": 3.0, "array": rng.random(5).astype(np.float32),
           "list": [1.0, 0.25, 0.5, 0.75, 1.0]}[label]
    payload = bytes(rng.integers(0, 256, 37, dtype=np.uint8))
    jb = mx.recordio.pack(mx.recordio.IRHeader(0, lab, 7, 9), payload)
    tb = mt.recordio.pack(mt.recordio.IRHeader(0, lab, 7, 9), payload)
    assert jb == tb
    # a plain tuple header packs the same
    assert mt.recordio.pack((0, lab, 7, 9), payload) == tb
    jh, jp = mx.recordio.unpack(tb)
    th, tp = mt.recordio.unpack(jb)
    assert jp == tp == payload
    assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    np.testing.assert_array_equal(np.asarray(th.label), np.asarray(jh.label))


def test_pack_img_unpack_img_match_reference():
    img = _rng("img").integers(0, 256, (24, 30, 3), dtype=np.uint8)
    hdr = (0, 2.0, 1, 0)
    for fmt in (".jpg", ".png"):
        jb = mx.recordio.pack_img(mx.recordio.IRHeader(*hdr), img,
                                  quality=85, img_fmt=fmt)
        tb = mt.recordio.pack_img(mt.recordio.IRHeader(*hdr), img,
                                  quality=85, img_fmt=fmt)
        assert jb == tb
        jh, jimg = mx.recordio.unpack_img(tb)
        th, timg = mt.recordio.unpack_img(jb)
        np.testing.assert_array_equal(timg, jimg)
        assert th.label == jh.label == 2.0
    np.testing.assert_array_equal(timg, img)    # PNG is lossless


@pytest.mark.parametrize("prefetch", [False, True])
def test_native_reader_matches_mxrecordio(prefetch, tmp_path):
    recs = _records("native", n=9)
    path, idx = _write(mx, str(tmp_path / "n.rec"), recs)
    seq = mt.recordio.MXRecordIO(path, "r")
    want = []
    while True:
        s = seq.read()
        if s is None:
            break
        want.append(s)
    seq.close()
    r = mt.recordio.NativeRecordIOReader(path, prefetch=prefetch,
                                         queue_size=4)
    got = []
    while True:
        s = r.read()
        if s is None:
            break
        got.append(s)
    assert got == want and len(got) == len(recs)
    if not prefetch:
        assert r.build_index() == len(recs)
        assert [r.read_at(i) for i in range(len(recs))] == want
        r.reset()
        assert r.read() == want[0]
    r.close()


def test_damaged_files_raise_in_both(tmp_path):
    recs = _records("damaged", n=4)
    path, idx = _write(mt, str(tmp_path / "d.rec"), recs)
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[:-10])              # the last record loses its tail
    for pkg in (mx, mt):
        r = pkg.recordio.MXIndexedRecordIO(idx, path, "r")
        r.read_idx(0)
        with pytest.raises(pkg.base.MXNetError, match="truncated record"):
            r.read_idx(3)
        with pytest.raises(pkg.base.MXNetError, match="not present"):
            r.read_idx(99)
        r.close()
    with open(path, "wb") as f:
        f.write(b"\0" * 8 + raw[8:])    # bad magic at offset 0
    for pkg in (mx, mt):
        r = pkg.recordio.MXRecordIO(path, "r")
        with pytest.raises(pkg.base.MXNetError, match="magic"):
            r.read()
        assert r.handle.tell() == 0     # the handle stays at the record
        r.close()


def test_native_library_is_built_into_the_port(tmp_path):
    lib = native_build.load()
    path = native_build.build()
    assert os.path.dirname(path) == native_build.BUILD_DIR
    assert os.path.basename(path).startswith("libmxtpu_io-")
    assert hasattr(lib, "mxtpu_img_decode_batch")
    root = os.path.dirname(os.path.dirname(native_build.__file__))
    assert not path.startswith(os.path.join(root, "lib") + os.sep)


def test_failed_native_build_raises_with_the_compiler_output(
        tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    for name in native_build.SOURCES:
        (src / name).write_text("this is not C++ (%s)\n" % name)
    monkeypatch.setattr(native_build, "SRC_DIR", str(src))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_build, "_LIB", {})
    monkeypatch.setattr(native_build, "_ERROR", {})
    with pytest.raises(MXNetError, match="g\\+\\+ failed") as e:
        native_build.load()
    assert "this is not C++" in str(e.value) or "error" in str(e.value)
    # the failure is kept: every later caller gets the same error
    with pytest.raises(MXNetError, match="g\\+\\+ failed"):
        mt.recordio.NativeRecordIOReader(str(tmp_path / "x.rec"))
    recs = _records("nobuild", n=4)
    path, _ = _write(mt, str(tmp_path / "a.rec"), recs)
    with pytest.raises(MXNetError, match="g\\+\\+ failed"):
        mt.image.ImageRecordIter(path_imgrec=path, data_shape=(3, 16, 16),
                                 batch_size=2, device="cpu")
    assert not os.listdir(str(tmp_path / "build"))  # no half-written .so
