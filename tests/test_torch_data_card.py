"""The data tier on a GPU machine: the native build there, and host batches
landing on ``cuda:0`` from pinned memory.

- The native libraries (``src/io``): the reader (no libjpeg) builds
  everywhere; where ``native_build.probe`` finds libjpeg's header and
  library the decoder (``-ljpeg``) builds and decodes a JPEG exactly as
  Pillow does; where it does not, ``native_build.load("decoder")`` raises
  ``MXNetError`` carrying the compiler's message.
- One superbatch of ``ImageRecordIter`` (host route) or ``ImageIter``
  (Pillow decode) through the ``DevicePrefetcher``: every slot is stacked
  into a pinned host buffer, lands on ``cuda:0`` and equals the iterator's
  host batches (exact: a copy).

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_data_card.py -q

Without CUDA each test skips, with its reason.
"""
import io as _bio
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import data as tdata, native_build
from mxnet_tpu_torch.base import MXNetError


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the data tier landing batches on "
                    "cuda:0 (chip_smoke.py phase 15 runs it there)")


def _need_pillow():
    try:
        import PIL  # noqa: F401
    except ImportError:
        pytest.skip("needs Pillow to write the JPEG records")


def _jpegs(n, size=40, seed=0):
    from PIL import Image
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        buf = _bio.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def _rec(path, jpegs):
    w = mt.recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                      path, "w")
    for i, jpg in enumerate(jpegs):
        w.write_idx(i, mt.recordio.pack(
            mt.recordio.IRHeader(0, float(i % 3), i, 0), jpg))
    w.close()
    return path


@pytest.mark.gpu
def test_native_build_follows_the_probe():
    _need_card()
    _need_pillow()
    probe = native_build.probe()
    jpg = _jpegs(1)[0]
    assert hasattr(native_build.load("reader"), "mxtpu_rio_open")
    if probe["native"]:
        lib = native_build.load("decoder")
        assert hasattr(lib, "mxtpu_img_decode_batch")
        from PIL import Image
        want = np.asarray(Image.open(_bio.BytesIO(jpg)).convert("RGB"))
        np.testing.assert_array_equal(mt.image._decode_numpy(jpg), want)
    else:
        with pytest.raises(MXNetError, match="g\\+\\+ failed") as e:
            native_build.load("decoder")
        assert "jpeg" in str(e.value)


@pytest.mark.gpu
def test_superbatch_lands_on_the_card_from_pinned_memory(tmp_path,
                                                         monkeypatch):
    _need_card()
    _need_pillow()
    rec = _rec(str(tmp_path / "a.rec"), _jpegs(16))
    if native_build.probe()["native"]:
        def make():
            return mt.image.ImageRecordIter(
                path_imgrec=rec, data_shape=(3, 32, 32), batch_size=4,
                shuffle=True, rand_crop=True, num_workers=2, seed=1,
                device="cpu")
    else:
        def make():
            augs = mt.image.CreateAugmenter((3, 32, 32), rand_crop=True)
            return mt.image.ImageIter(4, (3, 32, 32), path_imgrec=rec,
                                      aug_list=augs, shuffle=True,
                                      num_workers=2, seed=1)
    pinned = []
    real = mt.io.SuperBatchIter._host_buffer

    def host_buffer(self, shape, dtype):
        buf = real(self, shape, dtype)
        pinned.append(buf.is_pinned())
        return buf
    monkeypatch.setattr(mt.io.SuperBatchIter, "_host_buffer", host_buffer)
    it = make()
    pf = tdata.DevicePrefetcher(it, 2, depth=1)
    sb = pf.next()
    torch.cuda.synchronize()
    pf.close()
    it.close()
    # every slot of every superbatch the producer assembled was pinned
    assert len(pinned) >= 2 and all(pinned)
    assert all(a.data.device == torch.device("cuda", 0)
               for a in sb.data + sb.label)
    ref = make()
    parts = [ref.next_host() for _ in range(2)]
    ref.close()
    np.testing.assert_array_equal(sb.data[0].asnumpy(),
                                  np.stack([p.data[0] for p in parts]))
    np.testing.assert_array_equal(sb.label[0].asnumpy(),
                                  np.stack([p.label[0] for p in parts]))
