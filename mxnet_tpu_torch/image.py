"""The image pipeline (ref: python/mxnet/image.py; the C++ iterators of
src/io/iter_image_recordio*.cc and iter_image_det_recordio.cc).

Counterpart of ``mxnet_tpu/image.py``. :func:`imdecode` decodes JPEGs with
the native libjpeg path (``src/io/image_decode.cc``, the decoder library
:mod:`native_build` builds) and anything else with Pillow; the augmenters
are numpy transforms on the host. :class:`ImageRecordIter` decodes,
augments and batches a whole batch at once: on the card by default
(nvJPEG, :mod:`jpeg_decode`, then one launch of the
:mod:`~mxnet_tpu_torch.ops.image_augment` kernel), or with
``device="cpu"`` in one native libjpeg call on the host; :class:`ImageIter`
runs the augmenter list in Python; :class:`ImageDetIter` carries detection
labels through mirror and crop. ``ImageIter``, ``ImageDetIter`` and
``imdecode`` decode on the host on every machine.

``num_workers=`` on :class:`ImageIter` and :class:`ImageRecordIter` routes
decoding through the :mod:`~mxnet_tpu_torch.data` worker pool: N
decode/augment workers over a shard-aware reader with pure-function epoch
shuffling and batch order, so the sample stream is the same for any worker
count, which keeps resume bit for bit. Host batches are host arrays
(``next_host()`` gives numpy, ``next()`` CPU NDArrays) that the module or
the superbatch prefetcher copies to the card; the card route's batches are
already there.
"""
from __future__ import annotations

import io as _io
import os
import time

import numpy as np

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array
from . import io as mxio
from . import random as _random
from . import recordio


def _native_lib():
    from . import native_build
    return native_build.load("decoder")


def _open_sharded_record(path_imgrec, part_index=0, num_parts=1):
    """Open an indexed .rec and return (record, keys) with host-level
    sharding applied (ref: part_index/num_parts in every RecordIO iter)."""
    idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
    rec = recordio.MXIndexedRecordIO(idx_path, path_imgrec, "r")
    seq = list(rec.keys)
    if not seq:
        # an un-indexed .rec otherwise iterates as zero batches — silent
        raise MXNetError(
            "no records indexed for %r: missing or empty %s (pack with "
            "MXIndexedRecordIO / tools/im2rec.py)" % (path_imgrec, idx_path))
    if num_parts > 1:
        n = len(seq) // num_parts
        if n == 0:
            raise MXNetError(
                "%r has %d records, fewer than num_parts=%d: every shard "
                "would be empty" % (path_imgrec, len(seq), num_parts))
        seq = seq[part_index * n:(part_index + 1) * n]
    return rec, seq


_NATIVE_WARNED = []


def _decode_lib():
    """The native library for :func:`imdecode`, or None where it cannot be
    built: the compiler's message is logged once and Pillow decodes, as the
    reference falls back to it. :class:`ImageRecordIter` needs the library
    and raises instead."""
    try:
        return _native_lib()
    except MXNetError as e:
        if not _NATIVE_WARNED:
            _NATIVE_WARNED.append(True)
            import logging
            logging.warning("imdecode: the native JPEG decoder is "
                            "unavailable, decoding with Pillow: %s", e)
        return None


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode an image byte buffer to an HWC uint8 NDArray (ref:
    mx.image.imdecode) on the current context, or into ``out``."""
    arr = _decode_numpy(buf, flag, to_rgb)
    if out is not None:
        out._set_data(array(arr, ctx=cpu()).data)
        return out
    return array(arr)


def _decode_numpy(buf, flag=1, to_rgb=True):
    """:func:`imdecode` as a host numpy array, for the iterators: JPEG
    color decodes ride the native libjpeg path
    (``src/io/image_decode.cc``); everything else, or a JPEG libjpeg
    rejects, decodes with Pillow."""
    lib = _decode_lib()
    if (lib is not None and flag == 1 and to_rgb and len(buf) > 3
            and buf[:2] == b"\xff\xd8"):
        import ctypes
        raw = np.frombuffer(buf, np.uint8)
        cap = max(1 << 22, len(buf) * 24)
        while True:
            dst = np.empty(cap, np.uint8)
            w = ctypes.c_int()
            h = ctypes.c_int()
            rc = lib.mxtpu_img_decode_one(
                raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(buf), 0,
                dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                cap, ctypes.byref(w), ctypes.byref(h))
            if rc == -1:
                # the decoder reports the true dims even on overflow:
                # one exact-size retry, not a blind doubling loop
                cap = w.value * h.value * 3
                continue
            if rc == 1:
                return dst[:w.value * h.value * 3].reshape(
                    h.value, w.value, 3)
            break  # corrupt per libjpeg: let Pillow try (or raise)
    try:
        from PIL import Image
    except ImportError:
        raise MXNetError("imdecode requires Pillow")
    img = Image.open(_io.BytesIO(buf))
    if flag == 0:
        img = img.convert("L")
    else:
        img = img.convert("RGB" if to_rgb else "RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if flag == 1 and not to_rgb:
        arr = arr[:, :, ::-1]  # BGR like the OpenCV path
    return arr.astype(np.uint8)


def _resize(img, w, h):
    if img.shape[1] == w and img.shape[0] == h:
        # Pillow's resize to the same size is a copy: the same pixels
        # without Pillow
        return np.array(img, dtype=np.uint8)
    from PIL import Image
    return np.asarray(Image.fromarray(img.astype(np.uint8)).resize(
        (w, h), Image.BILINEAR))


def resize_short(img, size):
    """Resize shorter edge to size (ref: image.py resize_short)."""
    h, w = img.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return _resize(img, new_w, new_h)


def fixed_crop(src, x0, y0, w, h, size=None):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = _resize(out, size[0], size[1])
    return out


def random_crop(src, size):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    rng = _random.np_rng()
    x0 = int(rng.integers(0, w - new_w + 1))
    y0 = int(rng.integers(0, h - new_h + 1))
    out = fixed_crop(src, x0, y0, new_w, new_h, size)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    src = src.astype(np.float32) - mean
    if std is not None:
        src = src / std
    return src


# -- augmenter factories (ref: image.py CreateAugmenter) --------------------

def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, **kwargs):
    auglist = []
    size = (data_shape[2], data_shape[1])
    if resize > 0:
        auglist.append(lambda img: resize_short(img, resize))
    if rand_crop:
        auglist.append(lambda img: random_crop(img, size)[0])
    else:
        auglist.append(lambda img: center_crop(img, size)[0])
    if rand_mirror:
        def mirror(img):
            if _random.np_rng().random() < 0.5:
                return img[:, ::-1]
            return img
        auglist.append(mirror)
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None:
        auglist.append(lambda img: color_normalize(img.astype(np.float32),
                                                   mean, std))
    return auglist


class _PoolRunner(object):
    """Per-iterator runner of :class:`~mxnet_tpu_torch.data.DecodeWorkerPool`:
    owns the absolute-epoch cursor, builds each epoch's batch task list
    (keys + pure-function batch seed + pad), and hands batches back in
    deterministic order. One pool instance per epoch pass — a mid-epoch
    reset can never leak half-decoded batches forward."""

    def __init__(self, make_tasks, batch_fn, num_workers, stats, name):
        self._make_tasks = make_tasks   # epoch -> (tasks, pads)
        self._batch_fn = batch_fn
        self.num_workers = int(num_workers)
        self.stats = stats
        self._name = name
        self._pool = None
        self._pads = []
        self._emit = 0
        self.epoch = -1

    def start_epoch(self, epoch):
        """Position on ``epoch``. LAZY: the pool (worker threads + decode
        -ahead) spawns on the first :meth:`next`, so constructing or
        re-positioning an iterator costs nothing — a resumed launch's
        ``set_epoch(E)`` never throws away eagerly-decoded epoch-0
        batches, and fit's final-epoch reset leaves no live threads or
        pinned batches behind."""
        self.close()
        self.epoch = int(epoch)
        self._emit = 0

    def _ensure_pool(self):
        if self._pool is None:
            from . import data as _data
            tasks, self._pads = self._make_tasks(self.epoch)
            self._pool = _data.DecodeWorkerPool(
                self._batch_fn, tasks, self.num_workers, stats=self.stats,
                name=self._name)

    @property
    def consumed(self):
        return self._emit

    def next(self):
        """((data, labels), pad) for the next batch in order; raises
        StopIteration at epoch end, MXNetError on a dead worker."""
        if self.epoch < 0:
            raise MXNetError("%s: reset() before iterating" % self._name)
        self._ensure_pool()
        payload = self._pool.next_batch()
        pad = self._pads[self._emit] if self._emit < len(self._pads) else 0
        self._emit += 1
        return payload, pad

    def close(self):
        if self._pool is not None:
            self._pool.close()
            self._pool = None


def _pure_batch_seed(seed, epoch, batch_index):
    """Per-batch augmentation seed as a PURE function of (iterator seed,
    absolute epoch, batch index): which worker decodes a batch — and in
    what order batches complete — can never perturb the augmentation
    stream, and a resumed run re-derives epoch E's exact stream."""
    return (int(seed) * 1000003 + (int(epoch) + 1) * 10007
            + int(batch_index) + 1) % (1 << 62)


class ImageIter(mxio.DataIter):
    """Image iterator over RecordIO or an image list
    (ref: image.py ImageIter; C++ ImageRecordIter at
    src/io/iter_image_recordio_2.cc). Supports part_index/num_parts sharding
    for data-parallel hosts.

    ``num_workers >= 1`` (default: env ``MXTPU_DATA_WORKERS``, 0 = the
    legacy in-line path) decodes through the ``mxnet_tpu_torch.data`` worker
    pool: deterministic pure-function epoch shuffling (seeded by
    ``seed``), per-batch augmentation RNG scoped to (seed, epoch, batch),
    and batch reassembly in strict order — the sample stream is identical
    for every worker count. With ``skip_corrupt`` the pool path keeps
    batch boundaries FIXED (corrupt slots are backfilled with the nearest
    good sample in the batch and counted in DataHealth) where the legacy
    path shifts subsequent batches; corruption-free epochs are identical
    across both paths for ``shuffle=False``."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="softmax_label",
                 retry_policy=None, skip_corrupt=False, data_health=None,
                 num_workers=None, seed=0, **kwargs):
        super().__init__(batch_size)
        assert len(data_shape) == 3
        # fault tolerance: transient read failures are
        # retried with bounded backoff; corrupt records are skipped with a
        # DataHealth counter when skip_corrupt=True, else raise
        self.retry_policy = retry_policy or mxio.RetryPolicy()
        self.skip_corrupt = bool(skip_corrupt)
        self.data_health = (data_health if data_health is not None
                            else mxio.DataHealth(parent=mxio.DATA_HEALTH))
        self.data_shape = tuple(data_shape)
        self.batch_size = batch_size
        self.label_width = label_width
        self.path_root = path_root
        self.record = None
        self.imglist = None
        self._orig_part = (part_index, num_parts)
        if path_imgrec is not None:
            self.record, self.seq = _open_sharded_record(
                path_imgrec, part_index, num_parts)
            part_index, num_parts = 0, 1  # sharding already applied
        elif path_imglist is not None:
            self.imglist = {}
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    label = np.array(parts[1:-1], dtype=np.float32)
                    self.imglist[int(parts[0])] = (label, parts[-1])
            self.seq = list(self.imglist.keys())
        elif imglist is not None:
            self.imglist = {}
            for i, rec in enumerate(imglist):
                self.imglist[i] = (np.array(rec[0], dtype=np.float32)
                                   if not np.isscalar(rec[0])
                                   else np.array([rec[0]], dtype=np.float32),
                                   rec[1])
            self.seq = list(self.imglist.keys())
        else:
            raise MXNetError("ImageIter needs path_imgrec, path_imglist or imglist")
        # host-level sharding (ref: part_index/num_parts)
        if num_parts > 1:
            n = len(self.seq) // num_parts
            self.seq = self.seq[part_index * n:(part_index + 1) * n]
        self.shuffle = shuffle
        self.aug_list = aug_list if aug_list is not None else []
        self.data_name = data_name
        self.label_name = label_name
        self.cur = 0
        # the data tier's worker pool
        from . import data as _data
        self.seed = int(seed)
        self.data_stats = _data.PipelineStats(parent=_data.PIPELINE_STATS)
        self.num_workers = int(num_workers if num_workers is not None
                               else _data.default_num_workers())
        self._runner = None
        self._reader = None
        self._abs_epoch = -1
        if self.num_workers > 0:
            self._base_seq = list(self.seq)  # pristine pre-shuffle order
            if self.record is not None:
                # thread-safe shard-aware reads + pure epoch shuffling
                self._reader = _data.ShardedRecordReader(
                    path_imgrec, part_index=self._orig_part[0],
                    num_parts=self._orig_part[1], shuffle=shuffle,
                    seed=self.seed, retry_policy=self.retry_policy,
                    data_health=self.data_health)
            self._runner = _PoolRunner(
                self._make_epoch_tasks, self._pool_batch_fn,
                self.num_workers, self.data_stats, "ImageIter")
        self.reset()

    @property
    def provide_data(self):
        return [mxio.DataDesc(self.data_name,
                              (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self.label_width == 1
                 else (self.batch_size, self.label_width))
        return [mxio.DataDesc(self.label_name, shape)]

    def reset(self):
        if self._runner is not None:
            self._abs_epoch += 1
            self._runner.start_epoch(self._abs_epoch)
            return
        if self.shuffle:
            _random.np_rng().shuffle(self.seq)
        self.cur = 0

    @property
    def data_epoch(self):
        """Absolute epoch the pool path currently sits on (None on the
        legacy path) — DevicePrefetcher.set_epoch's no-op check."""
        return self._abs_epoch if self._runner is not None else None

    def set_epoch(self, epoch):
        """Pin the iterator to absolute epoch ``epoch`` (pure-function
        shuffle order + augmentation seeds): a resumed or rolled-back run
        re-derives exactly the order the original run trained.
        ``Module.fit`` calls this; no-op on the legacy (num_workers=0)
        path, whose in-place shuffle has no epoch addressing."""
        if self._runner is None:
            return
        if self._runner.epoch == int(epoch) and self._runner.consumed == 0:
            return  # already positioned; keep the decoded-ahead batches
        self._abs_epoch = int(epoch)
        self._runner.start_epoch(self._abs_epoch)

    def close(self):
        """Stop the decode workers and release reader handles."""
        if self._runner is not None:
            self._runner.close()
        if self._reader is not None:
            self._reader.close()

    # -- worker-pool path (mxnet_tpu_torch.data) ------------------------
    def _epoch_order(self, epoch):
        if self._reader is not None:
            return self._reader.epoch_order(epoch)
        if not self.shuffle:
            return list(self._base_seq)
        # imglist mode: the reader's exact shuffle recipe over the same
        # shard (one pure function for the whole tier)
        from .data.reader import epoch_permutation
        return epoch_permutation(self.seed, epoch, self._base_seq)

    def _make_epoch_tasks(self, epoch):
        order = self._epoch_order(epoch)
        bs = self.batch_size
        tasks = [(order[b * bs:(b + 1) * bs],
                  _pure_batch_seed(self.seed, epoch, b))
                 for b in range(len(order) // bs)]
        return tasks, [0] * len(tasks)  # partial tail dropped (legacy)

    def _pool_read_raw(self, key):
        """(label, img bytes) for the pool path — reads ride the reader's
        thread-local handles (RecordIO) or per-read file opens (imglist),
        both under the ``io.record_read`` retry policy."""
        if self._reader is not None:
            header, img = self._reader.read(key)
            return header.label, img
        label, fname = self.imglist[key]

        def rd():
            from . import faults as _faults
            _faults.fire("io.record_read")
            with open(os.path.join(self.path_root, fname), "rb") as f:
                return f.read()

        return label, mxio.retry_call(rd, "io.record_read",
                                      self.retry_policy, self.data_health)

    def _pool_batch_fn(self, keys, batch_seed):
        """Decode one batch task on a worker thread. Augmentation draws
        come from a Generator scoped to this batch's pure seed, so the
        stream is identical for every worker count. With ``skip_corrupt``,
        corrupt slots backfill from the nearest good sample in the SAME
        batch (boundaries never shift); a fully-corrupt batch raises."""
        bs = len(keys)
        data = np.zeros((bs,) + self.data_shape, np.float32)
        labels = np.zeros((bs, self.label_width), np.float32)
        good = []
        bad = []
        with _random.scoped_np_rng(np.random.default_rng(
                np.random.SeedSequence(batch_seed))):
            for i, key in enumerate(keys):
                try:
                    t0 = time.perf_counter()
                    label, img_bytes = self._pool_read_raw(key)
                    self.data_stats.add("read", time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    img = self._decode_aug(key, img_bytes)
                    self.data_stats.add("decode",
                                        time.perf_counter() - t0)
                except mxio.CorruptRecordError as e:
                    if not self.skip_corrupt:
                        raise
                    self.data_health.record_skip("io.record_read", e)
                    import logging
                    logging.warning("ImageIter: skipping %s", e)
                    bad.append(i)
                    continue
                data[i] = img
                labels[i] = np.asarray(
                    label, np.float32).reshape(-1)[:self.label_width]
                good.append(i)
        if bad:
            if not good:
                raise mxio.CorruptRecordError(
                    "ImageIter: every record in batch is corrupt "
                    "(keys %r...)" % (keys[:4],))
            for i in bad:
                j = max((g for g in good if g < i), default=good[0])
                data[i] = data[j]
                labels[i] = labels[j]
        return data, labels

    def _read_raw(self, key):
        """The IO phase: record/file bytes + label. Transient failures here
        (OSError, injected transients at site ``io.record_read``) are
        retried by :meth:`_read_one`; exhaustion raises with the site name
        and attempt count."""
        from . import faults as _faults
        _faults.fire("io.record_read")
        if self.record is not None:
            try:
                s = self.record.read_idx(key)
                header, img_bytes = recordio.unpack(s)
            except OSError:
                raise  # transient IO: retried by the policy
            except Exception as e:
                # record-level damage (truncated record, bad magic, header
                # unpack) is as permanent as a bad JPEG: same skip path
                raise mxio.CorruptRecordError(
                    "corrupt record %r: %s: %s"
                    % (key, type(e).__name__, e))
            return header.label, img_bytes
        label, fname = self.imglist[key]
        with open(os.path.join(self.path_root, fname), "rb") as f:
            return label, f.read()

    def _decode_aug(self, key, img_bytes):
        """Decode + augment + HWC->CHW for one record's bytes; undecodable
        bytes classify as :class:`~mxnet_tpu_torch.io.CorruptRecordError`
        (permanent — retrying cannot help)."""
        try:
            img = _decode_numpy(img_bytes)
        except Exception as e:
            raise mxio.CorruptRecordError(
                "corrupt image record %r: %s: %s"
                % (key, type(e).__name__, e))
        for aug in self.aug_list:
            img = aug(img)
        return np.transpose(img.astype(np.float32), (2, 0, 1))

    def _read_one(self, key):
        label, img_bytes = mxio.retry_call(
            lambda: self._read_raw(key), "io.record_read",
            self.retry_policy, self.data_health)
        return self._decode_aug(key, img_bytes), label

    def next_host(self):
        """One batch as host numpy (no device transfer). This is the
        superbatch hook: ``io.SuperBatchIter`` stacks K of these on its
        prefetch thread and lands the whole (k, batch, ...) stack on device
        as ONE H2D transfer."""
        if self._runner is not None:
            (data, labels), _pad = self._runner.next()
            label_arr = labels[:, 0] if self.label_width == 1 else labels
            return mxio.DataBatch(data=[data], label=[label_arr],
                                  pad=0, index=None)
        if self.cur + self.batch_size > len(self.seq):
            raise StopIteration
        data = np.zeros((self.batch_size,) + self.data_shape, np.float32)
        labels = np.zeros((self.batch_size, self.label_width), np.float32)
        i = 0
        while i < self.batch_size:
            if self.cur >= len(self.seq):
                # corrupt-skips ate into the final batch: drop the partial
                raise StopIteration
            key = self.seq[self.cur]
            self.cur += 1
            try:
                img, label = self._read_one(key)
            except mxio.CorruptRecordError as e:
                if not self.skip_corrupt:
                    raise
                self.data_health.record_skip("io.record_read", e)
                import logging
                logging.warning("ImageIter: skipping %s", e)
                continue
            data[i] = img
            labels[i] = np.asarray(label,
                                   np.float32).reshape(-1)[:self.label_width]
            i += 1
        label_arr = labels[:, 0] if self.label_width == 1 else labels
        return mxio.DataBatch(data=[data], label=[label_arr],
                              pad=0, index=None)

    def next(self):
        batch = self.next_host()
        return mxio.DataBatch(data=[array(a, ctx=cpu()) for a in batch.data],
                              label=[array(a, ctx=cpu())
                                     for a in batch.label],
                              pad=batch.pad, index=None)


# ---------------------------------------------------------------------------
# High-throughput native iterator (ref: ImageRecordIter,
# src/io/iter_image_recordio_2.cc:595 — fused decode/augment/batch on a
# worker-thread pool, double-buffered so decode overlaps training)
# ---------------------------------------------------------------------------

class ImageRecordIter(mxio.DataIter):
    """ImageNet-rate RecordIO image iterator.

    On the card (the default, ``device=None`` -> ``cuda:0``) each batch's
    JPEGs are decoded by nvJPEG (:mod:`~mxnet_tpu_torch.jpeg_decode`: the
    card's JPEG engines where an image's header allows, else nvJPEG's
    hybrid backend) and one launch of the
    :mod:`~mxnet_tpu_torch.ops.image_augment` kernel applies resize-short
    -> crop -> resize -> mirror and writes the float32 NCHW batch with
    mean/std folded in, on the card; sizes and random draws are computed on
    the host from the JPEG headers exactly as the native stage draws them.
    With ``device="cpu"`` one native call per batch decodes every JPEG on a
    C++ thread pool (libjpeg, GIL released) and does the same on the host.
    Without CUDA a missing ``device`` raises. Both routes give the same
    sizes, crops and mirror flags; the card's pixels differ from libjpeg's
    by the decoders' rounding. A background Python thread keeps one batch
    in flight so decode overlaps the training step (the iter_prefetcher.h
    role).

    Parameters mirror the reference's ImageRecordIter: path_imgrec,
    data_shape (C,H,W), batch_size, shuffle, rand_crop, rand_mirror,
    resize (short edge), mean_r/g/b, std_r/g/b, label_width,
    part_index/num_parts (host sharding), preprocess_threads, seed.

    ``num_workers >= 1`` (default: env ``MXTPU_DATA_WORKERS``, 0 = the
    legacy single-prefetch path) is the data tier: N decode workers over the
    ``mxnet_tpu_torch.data`` pool, shard-aware reads with thread-local handles,
    PURE-function epoch shuffling (epoch order and per-batch augmentation
    seeds depend only on (seed, epoch, batch index) — resumable and
    identical for every worker count), batches via ``next_host()`` (host
    numpy on the host route, which the superbatch prefetcher lands with one
    copy a slot; tensors already on the card on the card route, which it
    stacks there), and per-stage ``PipelineStats`` in ``data_stats``.
    ``sub_index/sub_parts`` sub-shard within the host shard (per-device
    loading for a data mesh).
    """

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, rand_crop=False, rand_mirror=False, resize=0,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0,
                 part_index=0, num_parts=1, preprocess_threads=None,
                 prefetch=True, seed=0, round_batch=True,
                 data_name="data", label_name="softmax_label",
                 num_workers=None, sub_index=0, sub_parts=1,
                 retry_policy=None, data_health=None, device=None,
                 **kwargs):
        super().__init__(batch_size)
        from .context import resolve_device
        self.device = resolve_device(device, "ImageRecordIter")
        if self.device.type not in ("cpu", "cuda"):
            raise MXNetError("ImageRecordIter: no decode route for device "
                             "%s (cuda or cpu)" % self.device)
        self._card = self.device.type == "cuda"
        # the host route needs the native decoder: a failed build raises
        # with the compiler's output; the card route decodes with nvJPEG
        self._lib = None if self._card else _native_lib()
        assert len(data_shape) == 3 and data_shape[0] == 3, \
            "data_shape must be (3, H, W)"
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._rec, self.seq = _open_sharded_record(path_imgrec, part_index,
                                                   num_parts)
        if sub_parts > 1:
            # per-device sub-shard within the host shard — the pool path's
            # validated arithmetic, so an out-of-range sub_index raises
            # instead of silently training on an empty shard
            from .data.reader import _shard
            self.seq = _shard(self.seq, sub_index, sub_parts,
                              "%r sub_parts" % path_imgrec)
        self.round_batch = round_batch
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.resize = resize
        self._mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self._std = np.array([std_r, std_g, std_b], np.float32)
        self._use_mean = any(v != 0.0 for v in (mean_r, mean_g, mean_b))
        self._use_std = any(v != 1.0 for v in (std_r, std_g, std_b))
        from . import data as _data
        self.num_workers = int(num_workers if num_workers is not None
                               else _data.default_num_workers())
        if preprocess_threads is None:
            # the native decoder threads multiply with the pool workers:
            # split the cores instead of oversubscribing num_workers-fold
            cores = os.cpu_count() or 1
            preprocess_threads = (max(1, cores // self.num_workers)
                                  if self.num_workers > 0
                                  else min(16, cores))
        self.preprocess_threads = preprocess_threads
        self._seed = seed
        self._epoch = 0
        self._batch_counter = 0
        self.data_name = data_name
        self.label_name = label_name
        self._prefetch = prefetch
        self._pending = None  # in-flight decode future
        self._pool = None
        self.data_stats = _data.PipelineStats(parent=_data.PIPELINE_STATS)
        self.data_health = (data_health if data_health is not None
                            else mxio.DataHealth(parent=mxio.DATA_HEALTH))
        self._runner = None
        self._reader = None
        self._abs_epoch = -1
        if self.num_workers > 0:
            self._reader = _data.ShardedRecordReader(
                path_imgrec, part_index=part_index, num_parts=num_parts,
                sub_index=sub_index, sub_parts=sub_parts, shuffle=shuffle,
                seed=seed, retry_policy=retry_policy,
                data_health=self.data_health)
            self._runner = _PoolRunner(
                self._make_epoch_tasks, self._pool_batch_fn,
                self.num_workers, self.data_stats, "ImageRecordIter")
        elif prefetch:
            import concurrent.futures
            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self.reset()

    @property
    def provide_data(self):
        return [mxio.DataDesc(self.data_name,
                              (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self.label_width == 1
                 else (self.batch_size, self.label_width))
        return [mxio.DataDesc(self.label_name, shape)]

    def reset(self):
        self._epoch += 1
        if self._runner is not None:
            self._abs_epoch += 1
            self._runner.start_epoch(self._abs_epoch)
            return
        if self.shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            rng.shuffle(self.seq)
        self.cur = 0
        self._pending = None

    @property
    def data_epoch(self):
        """Absolute epoch the pool path currently sits on (None on the
        legacy path) — DevicePrefetcher.set_epoch's no-op check."""
        return self._abs_epoch if self._runner is not None else None

    def set_epoch(self, epoch):
        """Pin the iterator to absolute epoch ``epoch``: the pool path
        re-derives that epoch's pure-function shuffle order and
        augmentation seeds, making mid-schedule resume (and divergence
        rollback) bitwise-reproducible. No-op on the legacy path, whose
        cumulative in-place shuffle has no epoch addressing."""
        if self._runner is None:
            return
        if self._runner.epoch == int(epoch) and self._runner.consumed == 0:
            return  # already positioned; keep the decoded-ahead batches
        self._abs_epoch = int(epoch)
        self._runner.start_epoch(self._abs_epoch)

    def close(self):
        """Stop decode workers and release reader handles (idempotent)."""
        if self._runner is not None:
            self._runner.close()
        if self._reader is not None:
            self._reader.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
            self._pending = None

    # -- worker-pool path (mxnet_tpu_torch.data) ------------------------
    def _make_epoch_tasks(self, epoch):
        order = self._reader.epoch_order(epoch)
        bs = self.batch_size
        tasks, pads = [], []
        nfull = len(order) // bs
        for b in range(nfull):
            tasks.append((order[b * bs:(b + 1) * bs],
                          _pure_batch_seed(self._seed, epoch, b)))
            pads.append(0)
        rem = len(order) - nfull * bs
        if rem and self.round_batch:
            # wrap the tail with records from the epoch start, reported as
            # pad (ref: ImageRecordIter round_batch) — same rule as the
            # legacy path's _next_keys
            keys = order[nfull * bs:] + order[:bs - rem]
            tasks.append((keys, _pure_batch_seed(self._seed, epoch, nfull)))
            pads.append(bs - rem)
        return tasks, pads

    def _pool_batch_fn(self, keys, batch_seed):
        t0 = time.perf_counter()
        recs = [self._reader.read(k) for k in keys]
        self.data_stats.add("read", time.perf_counter() - t0, n=len(keys))
        return self._decode_records(recs, batch_seed)

    # -- decode ---------------------------------------------------------
    def decode_batch_numpy(self, keys, batch_seed):
        """Read + fused decode/augment for the given record keys; returns
        (data, labels): host numpy on the host route, tensors on the card
        on the card route. This is the stage that scales with cores — the
        unit the input-pipeline benchmark measures."""
        return self._decode_batch_np(keys, batch_seed)

    def _decode_batch(self, keys, batch_seed):
        out, labels = self._decode_batch_np(keys, batch_seed)
        # the NDArrays are made here, so with prefetch=True it runs on the
        # background thread, overlapped with the training step (the
        # iter_prefetcher.h role); the module copies host ones to the device
        label_arr = labels[:, 0] if self.label_width == 1 else labels
        if self._card:
            return NDArray(out), NDArray(label_arr)
        return array(out, ctx=cpu()), array(label_arr, ctx=cpu())

    def _decode_batch_np(self, keys, batch_seed):
        t0 = time.perf_counter()
        raws = [self._rec.read_idx(k) for k in keys]
        recs = [recordio.unpack(s) for s in raws]
        self.data_stats.add("read", time.perf_counter() - t0, n=len(keys))
        return self._decode_records(recs, batch_seed)

    def _labels(self, recs):
        labels = np.zeros((len(recs), self.label_width), np.float32)
        for i, (header, _) in enumerate(recs):
            lab = np.asarray(header.label, np.float32).reshape(-1)
            labels[i, :] = lab[:self.label_width]
        return labels

    def _decode_records(self, recs, batch_seed):
        """Fused decode/augment over already-read (header, bytes) pairs —
        the shared decode stage for the legacy path (which reads through
        the iterator's own handle) and the worker pool (which reads through
        the shard reader's thread-local handles): on the card where the
        iterator's device is, else in one native call on the host."""
        if self._card:
            return self._decode_records_card(recs, batch_seed)
        import ctypes
        t_dec = time.perf_counter()
        n = len(recs)
        labels = self._labels(recs)
        bufs = (ctypes.POINTER(ctypes.c_uint8) * n)()
        sizes = (ctypes.c_uint64 * n)()
        holders = []
        for i, (header, img) in enumerate(recs):
            holder = np.frombuffer(img, np.uint8)
            holders.append(holder)  # keep alive through the C call
            bufs[i] = holder.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            sizes[i] = len(img)
        _, h, w = self.data_shape
        out = np.empty((n, 3, h, w), np.float32)
        status = np.zeros(n, np.int8)
        f32p = ctypes.POINTER(ctypes.c_float)
        ok = self._lib.mxtpu_img_decode_batch(
            bufs, sizes, n, self.resize, h, w,
            1 if self.rand_crop else 0, 1 if self.rand_mirror else 0,
            batch_seed,
            self._mean.ctypes.data_as(f32p) if self._use_mean else None,
            self._std.ctypes.data_as(f32p) if self._use_std else None,
            out.ctypes.data_as(f32p),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            self.preprocess_threads)
        if ok != n:
            bad = int(np.sum(status == 0))
            raise MXNetError("ImageRecordIter: %d corrupt image(s) in batch"
                             % bad)
        self.data_stats.add("decode", time.perf_counter() - t_dec, n=n)
        return out, labels

    def _decode_records_card(self, recs, batch_seed):
        """The card route of :meth:`_decode_records`: the JPEG headers give
        each image's size, the host draws its geometry (``image_augment.
        plan``), nvJPEG decodes the batch into one buffer on a decoder's
        own stream, and one ``image_augment`` launch writes the float32
        batch there. The stream is synchronized before the batch is
        returned: (data, labels) on the card."""
        import torch
        from . import jpeg_decode
        from .ops import image_augment as ia
        t_dec = time.perf_counter()
        labels = self._labels(recs)
        bufs = [bytes(img) for _, img in recs]
        _, h, w = self.data_shape
        m, sc = ia.normalization(self._mean, self._std, self._use_mean,
                                 self._use_std)
        dec = jpeg_decode.acquire(self.device)
        try:
            widths, heights, routes, status = dec.info(bufs)
            bad = int(np.count_nonzero(status))
            if not bad:
                desc = ia.plan(widths, heights, self.resize, (h, w),
                               self.rand_crop, self.rand_mirror, batch_seed)
                pixels, offsets, status = dec.decode(bufs, widths, heights,
                                                     routes)
                bad = int(np.count_nonzero(status))
            if bad:
                raise MXNetError("ImageRecordIter: %d corrupt image(s) in "
                                 "batch" % bad)
            desc[:, ia.D_OFFSET] = offsets
            desc[:, ia.D_PITCH] = 3 * widths.astype(np.int64)
            with torch.cuda.stream(dec.stream):
                out = ia.image_augment(
                    pixels, torch.from_numpy(desc).to(self.device), h, w,
                    m, sc)
                lab = torch.from_numpy(labels).to(self.device)
            dec.finish()
        finally:
            jpeg_decode.release(dec)
        self.data_stats.add("decode", time.perf_counter() - t_dec,
                            n=len(recs))
        return out, lab

    def _adopt(self, tensors):
        """Hand card batches to the caller's current stream: they were made
        on a decoder's stream, so the allocator must not reuse their memory
        there while the caller's stream still reads it."""
        for t in tensors:
            t = t.data if isinstance(t, NDArray) else t
            if getattr(getattr(t, "device", None), "type", None) == "cuda":
                import torch
                t.record_stream(torch.cuda.current_stream(t.device))

    def _next_keys(self):
        """Advance the legacy cursor one batch: (keys, batch_seed, pad) or
        None at epoch end."""
        remaining = len(self.seq) - self.cur
        if remaining <= 0 or (remaining < self.batch_size
                              and not self.round_batch):
            return None
        keys = self.seq[self.cur:self.cur + self.batch_size]
        pad = 0
        if len(keys) < self.batch_size:
            # round_batch: wrap the tail with records from the epoch start,
            # reporting them as pad (ref: ImageRecordIter round_batch)
            pad = self.batch_size - len(keys)
            keys = keys + self.seq[:pad]
        self.cur += self.batch_size
        self._batch_counter += 1
        batch_seed = (self._seed * 1000003 + self._epoch * 10007
                      + self._batch_counter)
        return keys, batch_seed, pad

    def _submit(self):
        task = self._next_keys()
        if task is None:
            return None
        keys, batch_seed, pad = task
        if self._pool is not None:
            return (self._pool.submit(self._decode_batch, keys, batch_seed),
                    pad)
        return (keys, batch_seed, pad)

    def next_host(self):
        """One batch with no device transfer — the superbatch hook:
        ``DevicePrefetcher``/``SuperBatchIter`` stacks K of these on the
        producer thread. Host numpy on the host route, landed as one copy a
        slot; tensors on the card on the card route, stacked there."""
        if self._runner is not None:
            (out, labels), pad = self._runner.next()
            label_arr = labels[:, 0] if self.label_width == 1 else labels
            self._adopt((out, label_arr))
            return mxio.DataBatch(data=[out], label=[label_arr],
                                  pad=pad, index=None)
        if self._pending is not None:
            raise MXNetError(
                "ImageRecordIter: cannot mix next() and next_host() — a "
                "device-prefetched batch is already in flight")
        task = self._next_keys()
        if task is None:
            raise StopIteration
        keys, batch_seed, pad = task
        out, labels = self._decode_batch_np(keys, batch_seed)
        label_arr = labels[:, 0] if self.label_width == 1 else labels
        self._adopt((out, label_arr))
        return mxio.DataBatch(data=[out], label=[label_arr],
                              pad=pad, index=None)

    def next(self):
        if self._runner is not None:
            batch = self.next_host()
            wrap = (NDArray if self._card
                    else (lambda a: array(a, ctx=cpu())))
            return mxio.DataBatch(
                data=[wrap(a) for a in batch.data],
                label=[wrap(a) for a in batch.label],
                pad=batch.pad, index=None)
        if self._pending is None:
            self._pending = self._submit()
        if self._pending is None:
            raise StopIteration
        task = self._pending
        if self._pool is not None:
            fut, pad = task
            data_nd, label_nd = fut.result()
        else:
            keys, batch_seed, pad = task
            data_nd, label_nd = self._decode_batch(keys, batch_seed)
        # keep the next batch decoding while the consumer trains
        self._pending = self._submit()
        self._adopt((data_nd, label_nd))
        return mxio.DataBatch(data=[data_nd], label=[label_nd],
                              pad=pad, index=None)


# ---------------------------------------------------------------------------
# Detection pipeline (ref: ImageDetIter in python/mxnet/image.py;
# src/io/iter_image_det_recordio.cc:578, image_det_aug_default.cc:667).
# Labels ride the record header as [header_width, obj_width,
# (extra...), (id, xmin, ymin, xmax, ymax) * nobj] with corner coords
# normalized to [0, 1], so whole-image resize never touches them.
# ---------------------------------------------------------------------------

def det_flip_boxes(boxes):
    """Horizontal flip for normalized corner boxes (id,x1,y1,x2,y2)."""
    out = boxes.copy()
    valid = out[:, 0] >= 0
    out[valid, 1] = 1.0 - boxes[valid, 3]
    out[valid, 3] = 1.0 - boxes[valid, 1]
    return out


def det_crop_boxes(boxes, x0, y0, w, h, min_overlap=0.5):
    """Re-express boxes in a normalized crop window; drop objects whose
    overlap with the window falls below min_overlap of their own area
    (ref: image_det_aug_default.cc crop emit rule)."""
    out = np.full_like(boxes, -1.0)
    j = 0
    for b in boxes:
        if b[0] < 0:
            continue
        ix1, iy1 = max(b[1], x0), max(b[2], y0)
        ix2, iy2 = min(b[3], x0 + w), min(b[4], y0 + h)
        iw, ih = max(0.0, ix2 - ix1), max(0.0, iy2 - iy1)
        area = max(1e-12, (b[3] - b[1]) * (b[4] - b[2]))
        if iw * ih / area < min_overlap:
            continue
        out[j, 0] = b[0]
        out[j, 1] = np.clip((ix1 - x0) / w, 0.0, 1.0)
        out[j, 2] = np.clip((iy1 - y0) / h, 0.0, 1.0)
        out[j, 3] = np.clip((ix2 - x0) / w, 0.0, 1.0)
        out[j, 4] = np.clip((iy2 - y0) / h, 0.0, 1.0)
        j += 1
    return out


class ImageDetIter(mxio.DataIter):
    """Detection iterator over RecordIO with box-aware augmentation
    (ref: ImageDetIter; the C++ det stack at iter_image_det_recordio.cc).

    Geometry runs in numpy (cheap); pixel decode rides the native libjpeg
    path when available. Labels come out (batch, max_objs, 5) padded -1.
    """

    def __init__(self, batch_size, data_shape, path_imgrec, shuffle=False,
                 rand_mirror=False, rand_crop=0.0, min_object_covered=0.5,
                 max_attempts=10, mean_pixels=None, std_pixels=None,
                 part_index=0, num_parts=1, seed=0, label_shape=None,
                 data_name="data", label_name="label", **kwargs):
        super().__init__(batch_size)
        assert len(data_shape) == 3 and data_shape[0] == 3
        self.data_shape = tuple(data_shape)
        self._rec, self.seq = _open_sharded_record(path_imgrec, part_index,
                                                   num_parts)
        self.shuffle = shuffle
        self.rand_mirror = rand_mirror
        self.rand_crop = rand_crop          # probability of attempting a crop
        self.min_object_covered = min_object_covered
        self.max_attempts = max_attempts
        self.mean_pixels = (np.asarray(mean_pixels, np.float32)
                            if mean_pixels is not None else None)
        self.std_pixels = (np.asarray(std_pixels, np.float32)
                           if std_pixels is not None else None)
        self._rng = np.random.default_rng(seed)
        self.data_name = data_name
        self.label_name = label_name
        if label_shape is not None:
            # (max_objs, 5) given up front (ref: ImageDetIter label_shape):
            # skips the dataset scan — pass it for big .rec files
            self.max_objs = int(label_shape[0])
        else:
            # one pass over record headers: max objects for the padded
            # label tensor
            self.max_objs = 1
            for k in self.seq:
                hdr, _ = recordio.unpack(self._rec.read_idx(k))
                lab = np.asarray(hdr.label, np.float32).reshape(-1)
                if lab.size >= 2:
                    obj_w = int(lab[1]) if lab[1] > 0 else 5
                    hdr_w = int(lab[0]) if lab[0] > 0 else 2
                    self.max_objs = max(self.max_objs,
                                        (lab.size - hdr_w) // obj_w)
        self.reset()

    @property
    def provide_data(self):
        return [mxio.DataDesc(self.data_name,
                              (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [mxio.DataDesc(self.label_name,
                              (self.batch_size, self.max_objs, 5))]

    def reset(self):
        if self.shuffle:
            self._rng.shuffle(self.seq)
        self.cur = 0

    def _parse_label(self, raw):
        lab = np.asarray(raw, np.float32).reshape(-1)
        if lab.size < 7:  # plain classification header: no objects
            return np.full((self.max_objs, 5), -1.0, np.float32)
        hdr_w = int(lab[0]) if lab[0] > 0 else 2
        obj_w = int(lab[1]) if lab[1] > 0 else 5
        body = lab[hdr_w:]
        n = body.size // obj_w
        out = np.full((self.max_objs, 5), -1.0, np.float32)
        for i in range(min(n, self.max_objs)):
            o = body[i * obj_w:(i + 1) * obj_w]
            out[i, :] = o[:5]
        return out

    def _augment(self, img, boxes):
        h, w = img.shape[:2]
        # IoU-constrained random crop (pixel crop is a numpy view)
        if self.rand_crop > 0 and self._rng.random() < self.rand_crop:
            for _ in range(self.max_attempts):
                cw = self._rng.uniform(0.5, 1.0)
                ch = self._rng.uniform(0.5, 1.0)
                cx = self._rng.uniform(0, 1.0 - cw)
                cy = self._rng.uniform(0, 1.0 - ch)
                nb = det_crop_boxes(boxes, cx, cy, cw, ch,
                                    self.min_object_covered)
                if (nb[:, 0] >= 0).any() or not (boxes[:, 0] >= 0).any():
                    x0, y0 = int(cx * w), int(cy * h)
                    x1, y1 = int((cx + cw) * w), int((cy + ch) * h)
                    img = img[y0:y1, x0:x1]
                    boxes = nb
                    break
        img = _resize(img, self.data_shape[2], self.data_shape[1])
        if self.rand_mirror and self._rng.random() < 0.5:
            img = img[:, ::-1]
            boxes = det_flip_boxes(boxes)
        return img, boxes

    def next(self):
        if self.cur + self.batch_size > len(self.seq):
            raise StopIteration
        _, h, w = self.data_shape
        data = np.zeros((self.batch_size, 3, h, w), np.float32)
        labels = np.zeros((self.batch_size, self.max_objs, 5), np.float32)
        for i in range(self.batch_size):
            s = self._rec.read_idx(self.seq[self.cur + i])
            hdr, img_bytes = recordio.unpack(s)
            boxes = self._parse_label(hdr.label)
            img = _decode_numpy(img_bytes)
            img, boxes = self._augment(img, boxes)
            img = img.astype(np.float32)
            if self.mean_pixels is not None:
                img = img - self.mean_pixels
            if self.std_pixels is not None:
                img = img / self.std_pixels
            data[i] = img.transpose(2, 0, 1)
            labels[i] = boxes
        self.cur += self.batch_size
        return mxio.DataBatch(data=[array(data, ctx=cpu())],
                              label=[array(labels, ctx=cpu())],
                              pad=0, index=None)
