"""Shard-aware indexed RecordIO reading for the data tier.

Counterpart of ``mxnet_tpu/data/reader.py``. :class:`ShardedRecordReader`
shards a ``.rec`` at two levels: the host's ``part_index``/``num_parts``
(the reference's sharding in every RecordIO iterator) and a sub-shard
within it (``sub_index``/``sub_parts``, the per-device slice a data mesh
reads). It also owns what the worker pool and resume depend on:

- **Deterministic epoch shuffling.** :meth:`epoch_order` is a pure
  function of ``(seed, epoch)`` over the shard's keys, never an in-place
  shuffle whose result depends on reset history: a relaunched run asking
  for epoch E gets the order the original run trained, for any worker
  count.
- **Thread-safe reads.** Each reading thread has its own file handle
  (``MXIndexedRecordIO``'s seek and read are stateful); the parsed index
  is shared.
- **Fault tolerance.** Reads retry transient IO per
  :class:`~mxnet_tpu_torch.io.RetryPolicy` at the ``io.record_read`` fault
  site; record-level damage is a :class:`~mxnet_tpu_torch.io.
  CorruptRecordError` (skip or raise, never retry), all counted in
  ``DataHealth``.
"""
from __future__ import annotations

import os
import threading

import numpy as np

from ..base import MXNetError
from .. import io as mxio
from .. import recordio


def _shard(seq, index, parts, what):
    """One contiguous 1/parts slice of ``seq`` (the reference's
    part_index/num_parts arithmetic, shared by both shard levels)."""
    if parts <= 1:
        return list(seq)
    if not 0 <= index < parts:
        raise MXNetError("%s: index %d out of range for %d parts"
                         % (what, index, parts))
    n = len(seq) // parts
    if n == 0:
        raise MXNetError("%s: %d records, fewer than %d parts — every "
                         "shard would be empty" % (what, len(seq), parts))
    return list(seq[index * n:(index + 1) * n])


def epoch_permutation(seed, epoch, seq):
    """Seeded permutation of ``seq`` as a PURE function of (seed, epoch) —
    the single shuffle recipe for the whole input tier (reader and the
    imglist-mode ImageIter must never drift apart, or resume through one
    of them silently breaks)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed), int(epoch)]))
    order = list(seq)
    rng.shuffle(order)
    return order


class ShardedRecordReader(object):
    """Indexed .rec reader with two-level sharding and pure-function epoch
    ordering, safe to read from N decode workers concurrently.

    ``part_index/num_parts`` is the host-level shard (dist workers);
    ``sub_index/sub_parts`` sub-shards within it (per-device loading for a
    data mesh: each device's feeder reads only its slice of every batch).
    ``shuffle=True`` makes :meth:`epoch_order` the seeded permutation for
    that epoch; ``False`` returns the index order.
    """

    def __init__(self, path_imgrec, part_index=0, num_parts=1,
                 sub_index=0, sub_parts=1, shuffle=False, seed=0,
                 retry_policy=None, data_health=None):
        self.uri = path_imgrec
        self.idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.retry_policy = retry_policy or mxio.RetryPolicy()
        self.data_health = (data_health if data_health is not None
                            else mxio.DataHealth(parent=mxio.DATA_HEALTH))
        # parse the index ONCE (shared, read-only): per-thread handles are
        # plain sequential MXRecordIO readers seeked by these offsets —
        # re-parsing the .idx per worker thread would be wasted work and
        # the keys must be identical anyway
        probe = recordio.MXIndexedRecordIO(self.idx_path, path_imgrec, "r")
        try:
            if not probe.keys:
                raise MXNetError(
                    "no records indexed for %r: missing or empty %s (pack "
                    "with MXIndexedRecordIO / tools/im2rec.py)"
                    % (path_imgrec, self.idx_path))
            all_keys = list(probe.keys)
            self.idx = dict(probe.idx)  # key -> byte offset, shared
        finally:
            probe.close()
        self._all_keys = all_keys   # full key list: reshard_workers re-cuts
        host_keys = _shard(all_keys, part_index, num_parts,
                           "%r num_parts" % path_imgrec)
        self.keys = _shard(host_keys, sub_index, sub_parts,
                           "%r sub_parts" % path_imgrec)
        self.part_index, self.num_parts = part_index, num_parts
        self.sub_index, self.sub_parts = sub_index, sub_parts
        self._tls = threading.local()
        self._handles = []          # every per-thread handle, for close()
        self._handles_lock = threading.Lock()
        self._closed = False

    # -- ordering ------------------------------------------------------
    def epoch_order(self, epoch):
        """The shard's key order for ``epoch`` — a pure function of
        ``(seed, epoch)``: identical for a fresh process resuming at epoch
        E and for the original run that trained through it, and identical
        for every worker count (workers change who DECODES a batch, never
        which samples are in it)."""
        if not self.shuffle:
            return list(self.keys)
        return epoch_permutation(self.seed, epoch, self.keys)

    def reshard_workers(self, part_index, num_parts):
        """Re-cut the host-level shard from the retained full key list —
        the elastic-membership hook: after a ring re-form every survivor
        re-derives its shard from its NEW (index, size) so the dead
        worker's samples are redistributed instead of dropped. The
        sub-shard level is re-applied unchanged. Readers stay open; only
        the key set changes, taking effect at the next epoch_order()."""
        host_keys = _shard(self._all_keys, part_index, num_parts,
                           "%r num_parts" % self.uri)
        self.keys = _shard(host_keys, self.sub_index, self.sub_parts,
                           "%r sub_parts" % self.uri)
        self.part_index, self.num_parts = part_index, num_parts

    # -- reading -------------------------------------------------------
    def _rec(self):
        """This thread's sequential reader (one FD, no index re-parse —
        offsets come from the shared ``self.idx``). Handles of DEAD
        threads are reaped on each new-thread registration: the worker
        pool spawns fresh threads every epoch, so without reaping a long
        run would accumulate one open FD per worker per epoch."""
        if self._closed:
            raise MXNetError("ShardedRecordReader: reader closed")
        rec = getattr(self._tls, "rec", None)
        if rec is None:
            rec = recordio.MXRecordIO(self.uri, "r")
            self._tls.rec = rec
            me = threading.current_thread()
            with self._handles_lock:
                dead = [(t, r) for t, r in self._handles
                        if not t.is_alive()]
                self._handles = [(t, r) for t, r in self._handles
                                 if t.is_alive()]
                self._handles.append((me, rec))
            for _t, r in dead:
                try:
                    r.close()
                except Exception:
                    pass
        return rec

    def _read_raw(self, key):
        from .. import faults as _faults
        _faults.fire("io.record_read")
        if key not in self.idx:
            raise MXNetError("key %r not present in index %r (of %r)"
                             % (key, self.idx_path, self.uri))
        try:
            rec = self._rec()
            rec.handle.seek(self.idx[key])
            s = rec.read()
            if s is None:
                raise MXNetError("record %r at offset %d in %r reads as "
                                 "end-of-file"
                                 % (key, self.idx[key], self.uri))
            header, payload = recordio.unpack(s)
        except OSError:
            raise  # transient IO: retried by the policy
        except MXNetError as e:
            # framing damage (truncated record, bad magic) is as permanent
            # as a bad JPEG: the skip path, not the retry path
            raise mxio.CorruptRecordError(
                "corrupt record %r in %r: %s" % (key, self.uri, e))
        except Exception as e:
            raise mxio.CorruptRecordError(
                "corrupt record %r in %r: %s: %s"
                % (key, self.uri, type(e).__name__, e))
        return header, payload

    def read(self, key):
        """(IRHeader, payload bytes) for one key, with transient failures
        retried per the policy. :class:`~mxnet_tpu_torch.io.CorruptRecordError`
        (record-level damage) propagates for the caller's skip policy."""
        return mxio.retry_call(lambda: self._read_raw(key),
                               "io.record_read", self.retry_policy,
                               self.data_health)

    def close(self):
        self._closed = True
        with self._handles_lock:
            handles, self._handles = self._handles, []
        for _t, rec in handles:
            try:
                rec.close()
            except Exception:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        return len(self.keys)
