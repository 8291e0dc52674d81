"""Data iterators (ref: python/mxnet/io.py).

Counterpart of ``mxnet_tpu/io.py``: the ``DataDesc``/``DataBatch``/
``DataIter`` contract, ``ResizeIter``, the threaded ``PrefetchingIter``,
``NDArrayIter`` (with its ``shuffle`` and ``last_batch_handle`` rules), and
``SuperBatchIter``, which stacks K batches into one ``(k, batch, ...)``
superbatch for ``Module.fit(steps_per_dispatch=k)``.

Where batches live: ``NDArrayIter`` over numpy arrays yields host (CPU)
NDArrays, and the module that trains on them copies each to its device;
over NDArrays it slices them where they lie. ``SuperBatchIter`` stacks host
batches into pinned memory on its producer thread and makes one
``non_blocking`` copy to the card per array of the superbatch (batches
already on the card are stacked there). Where the base iterator has
``next_host()`` (the image iterators), its numpy batches are stacked on the
host straight into that pinned buffer.

The data plane's fault tolerance: :class:`RetryPolicy` and
:func:`retry_call` (bounded backoff on transient read failures),
:class:`CorruptRecordError` (a record that cannot be parsed: skipped or
raised, never retried) and :class:`DataHealth` counting both, mirrored into
the process-global :data:`DATA_HEALTH`. ``CSVIter`` and ``MNISTIter`` read
their files on the host. The RecordIO image iterators live in
:mod:`~mxnet_tpu_torch.image`.
"""
from __future__ import annotations

import hashlib
import os
import queue as _queue
import threading
import time
import weakref
from collections import namedtuple

import numpy as np
import torch

from .base import MXNetError, torch_dtype
from .context import cpu, resolve_device
from .ndarray import NDArray, array
from .obs import trace as _obs


# ---------------------------------------------------------------------------
# fault tolerance for the data plane: a bounded exponential-backoff retry
# for transient read failures, a skip-with-counter path for corrupt
# records, and a DataHealth stat surfacing both.
# ---------------------------------------------------------------------------

class CorruptRecordError(MXNetError):
    """A record that decoded/parsed as garbage (NOT transient: retrying the
    same bytes cannot help; iterators either skip it or raise)."""


class DataHealth(object):
    """Thread-safe counters for data-pipeline degradation.

    Every retry, skipped corrupt record and hard failure is recorded here
    (and mirrored into the process-global ``io.DATA_HEALTH`` aggregate), so
    a training run can report "healthy" vs "limping on retries" instead of
    silently eating IO errors.
    """

    def __init__(self, parent=None):
        self._lock = threading.Lock()
        self._parent = parent
        self.retries = 0
        self.skipped_records = 0
        self.failures = 0
        self.last_error = None

    def record_retry(self, site, exc):
        with self._lock:
            self.retries += 1
            self.last_error = "%s: %s" % (site, exc)
        if self._parent is not None:
            self._parent.record_retry(site, exc)

    def record_skip(self, site, exc):
        with self._lock:
            self.skipped_records += 1
            self.last_error = "%s: %s" % (site, exc)
        if self._parent is not None:
            self._parent.record_skip(site, exc)

    def record_failure(self, site, exc):
        with self._lock:
            self.failures += 1
            self.last_error = "%s: %s" % (site, exc)
        if self._parent is not None:
            self._parent.record_failure(site, exc)

    def report(self):
        with self._lock:
            return {"retries": self.retries,
                    "skipped_records": self.skipped_records,
                    "failures": self.failures,
                    "last_error": self.last_error}

    def reset(self):
        with self._lock:
            self.retries = 0
            self.skipped_records = 0
            self.failures = 0
            self.last_error = None

    def __repr__(self):
        return "DataHealth(%r)" % (self.report(),)


#: process-global aggregate every per-iterator DataHealth mirrors into
DATA_HEALTH = DataHealth()


class RetryPolicy(object):
    """Bounded exponential backoff with deterministic jitter.

    ``delay(attempt, site)``: ``base_delay * 2**(attempt-1)`` capped at
    ``max_delay``, plus up to ``jitter`` fraction derived from a hash of
    (worker rank, site, attempt) — repeatable run-to-run for a given rank
    layout, yet de-correlated across sites AND workers (N workers retrying
    the same site don't thundering-herd a recovering filesystem).
    """

    def __init__(self, max_retries=3, base_delay=0.01, max_delay=0.5,
                 jitter=0.5):
        self.max_retries = int(max_retries)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self._worker_salt = os.environ.get("MXTPU_RANK", "0")

    def delay(self, attempt, site=""):
        d = min(self.base_delay * (2.0 ** max(0, attempt - 1)),
                self.max_delay)
        if self.jitter and d > 0:
            h = hashlib.sha256(("%s/%s#%d" % (self._worker_salt, site,
                                              attempt)).encode())
            frac = int.from_bytes(h.digest()[:4], "big") / float(1 << 32)
            d *= 1.0 + self.jitter * frac
        return d


#: OSError subclasses that retrying cannot fix — surface them immediately
#: with their real cause instead of burning the budget
_PERMANENT_OSERRORS = (FileNotFoundError, PermissionError, IsADirectoryError,
                       NotADirectoryError)


def _transient_types():
    from . import faults as _faults
    return (_faults.InjectedTransientFault, OSError)


def retry_call(fn, site, policy=None, health=None):
    """Call ``fn`` with the policy's bounded retry on transient errors
    (OSError and injected transient faults). Exhausting the budget raises
    :class:`MXNetError` naming the site and attempt count; non-transient
    errors — including permanent OSErrors like FileNotFoundError —
    propagate untouched."""
    policy = policy or RetryPolicy()
    health = health or DATA_HEALTH
    transient = _transient_types()
    attempt = 0
    while True:
        try:
            return fn()
        except _PERMANENT_OSERRORS:
            raise
        except transient as e:
            attempt += 1
            if attempt > policy.max_retries:
                health.record_failure(site, e)
                raise MXNetError(
                    "%s: giving up after %d attempts (retry budget %d "
                    "exhausted): %s" % (site, attempt, policy.max_retries,
                                        e)) from e
            health.record_retry(site, e)
            d = policy.delay(attempt, site)
            if d > 0:
                time.sleep(d)


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Data description: name, shape, dtype, layout (ref: io.py DataDesc)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch(object):
    """A mini-batch (ref: io.py DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter(object):
    """Base data iterator (ref: io.py DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def superbatch(self, k, prefetch=True, **kwargs):
        """A :class:`SuperBatchIter` stacking K consecutive batches of this
        iterator into one ``(k, batch, ...)`` superbatch (``device``: where
        it lands, ``cuda:0`` by default)."""
        return SuperBatchIter(self, k, prefetch=prefetch, **kwargs)

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


class ResizeIter(DataIter):
    """Resize an iterator to a fixed number of batches per epoch
    (ref: io.py ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Producer threads, one per iterator, each fetching the next batch
    while the current one trains (ref: io.py PrefetchingIter)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        if self.n_iter == 0:
            raise MXNetError("PrefetchingIter: needs at least one iterator")
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]

        def prefetch_func(self, i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i])
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.daemon = True
            thread.start()

    def close(self):
        """Stop the producer threads (also done when the iterator is
        collected)."""
        self.started = False
        for e in self.data_taken:
            e.set()
        for thread in self.prefetch_threads:
            thread.join(timeout=1.0)

    def __del__(self):
        self.close()

    def _renamed(self, descs_of, renames):
        if renames is None:
            return sum([descs_of(i) for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(r[x[0]], x[1])
                     for x in descs_of(i)]
                    for r, i in zip(renames, self.iters)], [])

    @property
    def provide_data(self):
        return self._renamed(lambda i: i.provide_data, self.rename_data)

    @property
    def provide_label(self):
        return self._renamed(lambda i: i.provide_label, self.rename_label)

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        if self.next_batch[0] is None:
            if any(b is not None for b in self.next_batch):
                raise MXNetError("PrefetchingIter: the iterators yield "
                                 "different numbers of batches")
            return False
        if any(b.pad != self.next_batch[0].pad for b in self.next_batch):
            raise MXNetError("PrefetchingIter: different pad within the "
                             "inner iterators")
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], []),
            self.next_batch[0].pad,
            self.next_batch[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class SuperDataBatch(DataBatch):
    """K stacked mini-batches: every array carries a leading ``(k,)`` step
    axis. ``num_steps`` is below the configured K for the epoch tail;
    :meth:`unstack` gives the per-step batches."""

    def __init__(self, data, label=None, pads=None, num_steps=1,
                 provide_data=None, provide_label=None, bucket_key=None,
                 step_provide_data=None, step_provide_label=None):
        pads = list(pads) if pads is not None else [0] * num_steps
        super().__init__(data, label=label, pad=pads[-1] if pads else 0,
                         bucket_key=bucket_key,
                         provide_data=provide_data,
                         provide_label=provide_label)
        self.num_steps = num_steps
        self.pads = pads
        self.step_provide_data = step_provide_data
        self.step_provide_label = step_provide_label

    def unstack(self):
        """Per-step DataBatch views (slices along the step axis); a
        superbatch split over a mesh is gathered whole first."""
        def whole(a):
            return NDArray(a.gather()) if hasattr(a, "gather") else a
        data = [whole(a) for a in self.data]
        label = [whole(a) for a in (self.label or [])]
        out = []
        for i in range(self.num_steps):
            out.append(DataBatch(
                data=[a[i] for a in data],
                label=[a[i] for a in label],
                pad=self.pads[i] if i < len(self.pads) else 0,
                bucket_key=self.bucket_key,
                provide_data=self.step_provide_data,
                provide_label=self.step_provide_label))
        return out


_NP_NARROW = {np.dtype(np.float64): np.dtype(np.float32),
              np.dtype(np.int64): np.dtype(np.int32),
              np.dtype(np.uint64): np.dtype(np.uint32)}


def _tensor_of(x):
    if isinstance(x, NDArray):
        return x.data
    if isinstance(x, torch.Tensor):
        return x
    return array(x, ctx=cpu()).data


class SuperBatchIter(DataIter):
    """Stacks K consecutive batches of ``base`` into one ``(k, batch, ...)``
    superbatch for multi-step dispatch, on a producer thread with
    ``queue_depth`` superbatches in flight.

    Host batches are stacked straight into pinned memory and land on
    ``device`` (``cuda:0`` by default; ``"cpu"`` stacks and stays) as one
    ``non_blocking`` copy per array of the superbatch. Where ``base`` has
    ``next_host()``, its numpy batches are stacked on the host with one
    ``np.stack`` into that pinned buffer. Batches already on a device are
    stacked there. A batch pull (fault site ``io.batch_read``) and a copy
    (``io.h2d``) that fail transiently are retried per ``retry_policy``,
    counted in ``data_health``. The copy is queued on the producer thread's
    current stream, so it is ordered after the work already queued there.
    The epoch tail (fewer than K batches) comes as a partial superbatch
    with ``num_steps < k``, or is dropped with
    ``last_group_handle='discard'``; a change of ``bucket_key`` cuts a
    group early.

    ``sharding`` (``parallel.mesh.superbatch_sharding(mesh)``) splits every
    stacked array along its batch axis on the producer thread, one shard on
    each replica's device (replica 0's device is where it lands), so the
    slots come as :class:`~mxnet_tpu_torch.parallel.mesh.MeshArray`s the
    step over that mesh takes as they are.
    """

    def __init__(self, base, k, prefetch=True, queue_depth=None,
                 last_group_handle="partial", retry_policy=None,
                 data_health=None, device=None, sharding=None):
        super().__init__(getattr(base, "batch_size", 0))
        if queue_depth is None:
            from . import engine as _engine
            queue_depth = max(2, _engine.dispatch_pipeline() + 1)
        if k < 1:
            raise MXNetError("superbatch: k must be >= 1, got %r" % (k,))
        if last_group_handle not in ("partial", "discard"):
            raise MXNetError("superbatch: last_group_handle must be "
                             "'partial' or 'discard'")
        self.base = base
        self.k = int(k)
        self.sharding = sharding
        if sharding is not None:
            device = sharding.mesh.replica_devices()[0]
        self.device = resolve_device(device, "SuperBatchIter")
        self.last_group_handle = last_group_handle
        self.retry_policy = retry_policy or RetryPolicy()
        self.data_health = (data_health if data_health is not None
                            else DataHealth(parent=DATA_HEALTH))
        self._prefetch = prefetch
        self._depth = max(1, int(queue_depth))
        self._queue = None
        self._thread = None
        self._stop = None
        self._done = False
        self._held = None  # first batch of the next bucket run
        # superbatch sequence number: the correlation index of the
        # dispatch, readback and data-wait spans
        self._sb_seq = 0
        self._cur_sb = None
        if prefetch:
            self._start_producer()

    def _stacked_descs(self, descs):
        out = []
        for d in descs:
            if hasattr(d, "name"):
                out.append(DataDesc(d.name, (self.k,) + tuple(d.shape),
                                    d.dtype))
            else:
                out.append(DataDesc(d[0], (self.k,) + tuple(d[1])))
        return out

    @property
    def provide_data(self):
        return self._stacked_descs(self.base.provide_data)

    @property
    def provide_label(self):
        return self._stacked_descs(self.base.provide_label)

    # -- assembly ------------------------------------------------------
    def _pull_one(self):
        """One batch of the base iterator (host numpy through
        ``next_host()`` where it has one), with transient failures retried
        per the policy (fault site ``io.batch_read``)."""
        from . import faults as _faults
        next_host = getattr(self.base, "next_host", None)

        def pull():
            _faults.fire("io.batch_read")
            return next_host() if next_host is not None else self.base.next()

        return retry_call(pull, "io.batch_read", self.retry_policy,
                          self.data_health)

    def _pull_group(self):
        """Up to K consecutive batches, cut early where the bucket key
        changes (the first batch of the next run is held for the next
        group)."""
        while True:
            group = [self._held] if self._held is not None else []
            self._held = None
            while len(group) < self.k:
                try:
                    b = self._pull_one()
                except StopIteration:
                    break
                if group and (getattr(b, "bucket_key", None)
                              != getattr(group[0], "bucket_key", None)):
                    self._held = b
                    break
                group.append(b)
            if not group:
                return None
            if len(group) < self.k and self.last_group_handle == "discard":
                if self._held is not None:
                    continue   # a bucket cut, not the epoch tail
                return None
            return group

    def _note_stage(self, stage, seconds, n=1):
        """Per-stage timing hook (stack, h2d); the DevicePrefetcher
        charges its PipelineStats here."""

    def _stack(self, parts):
        """One stacked NDArray on :attr:`device` from the K parts. Host
        parts are stacked into one (pinned, for a CUDA device) buffer and
        land with one copy, retried on transient failure (fault site
        ``io.h2d``)."""
        from . import faults as _faults
        raw = [p.data if isinstance(p, NDArray) else p for p in parts]
        t0 = time.perf_counter()
        if all(isinstance(r, np.ndarray) for r in raw):
            buf = self._host_buffer((len(raw),) + raw[0].shape, raw[0].dtype)
            # numpy batches (next_host): one np.stack into the buffer,
            # 64-bit narrowed to 32 as nd.array does
            np.stack(raw, out=buf.numpy())
        elif all(isinstance(r, torch.Tensor) and r.device.type == "cpu"
                 for r in raw):
            buf = self._host_buffer((len(raw),) + tuple(raw[0].shape),
                                    raw[0].dtype)
            torch.stack(raw, out=buf)
        else:
            out = torch.stack([_tensor_of(r).to(self.device) for r in raw])
            dt = time.perf_counter() - t0
            self._note_stage("h2d", dt, n=len(parts))
            _obs.complete("h2d", dt, dispatch=self._cur_sb)
            return NDArray(out)
        dt = time.perf_counter() - t0
        self._note_stage("stack", dt)
        _obs.complete("stack", dt, dispatch=self._cur_sb)

        def land():
            _faults.fire("io.h2d")
            if self.device.type == "cpu":
                return buf
            return buf.to(self.device, non_blocking=True)

        t0 = time.perf_counter()
        try:
            return NDArray(retry_call(land, "io.h2d", self.retry_policy,
                                      self.data_health))
        finally:
            dt = time.perf_counter() - t0
            self._note_stage("h2d", dt, n=len(parts))
            _obs.complete("h2d", dt, dispatch=self._cur_sb)

    def _split(self, stacked, desc):
        """Under ``sharding``: the stacked ``(k, batch, ...)`` NDArray split
        along its batch axis across the replicas (a view for a replica on
        the landing device): the 'N' of ``desc``'s layout (a ``"TN"``
        batch splits along dim 1), else the axis of the batch's size."""
        if self.sharding is None:
            return stacked
        from .parallel import mesh as _mesh
        t = stacked.data
        axis = _mesh.layout_axes([desc]).get(desc[0]) if desc else None
        ax = _mesh.batch_axis(tuple(t.shape[1:]),
                              self.batch_size or t.shape[1], axis)
        if ax is None:
            return _mesh.replicate(t, self.sharding.mesh)
        return _mesh.split(t, self.sharding.mesh, ax + 1)

    def _host_buffer(self, shape, dtype):
        """An empty host tensor for a stacked slot: pinned when it lands on
        a CUDA device; numpy dtypes take nd.array's 64-to-32-bit rule."""
        if isinstance(dtype, np.dtype):
            dtype = _NP_NARROW.get(dtype, dtype)
            dtype = torch_dtype(dtype)
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def _assemble(self, group):
        self._cur_sb = self._sb_seq
        self._sb_seq += 1
        n_data = len(group[0].data)
        n_label = len(group[0].label or [])
        step_pd = group[0].provide_data
        step_pl = group[0].provide_label
        pd = list(step_pd if step_pd is not None
                  else self.base.provide_data or [])
        pl = list(step_pl if step_pl is not None
                  else self.base.provide_label or [])
        with _obs.span("superbatch_assemble", dispatch=self._cur_sb,
                       k=len(group)):
            data = [self._split(self._stack([b.data[i] for b in group]),
                                pd[i] if i < len(pd) else None)
                    for i in range(n_data)]
            label = [self._split(self._stack([b.label[i] for b in group]),
                                 pl[i] if i < len(pl) else None)
                     for i in range(n_label)]
        sb = SuperDataBatch(
            data=data, label=label, pads=[b.pad or 0 for b in group],
            num_steps=len(group),
            provide_data=(self._stacked_descs(step_pd)
                          if step_pd is not None else self.provide_data),
            provide_label=(self._stacked_descs(step_pl)
                           if step_pl is not None else self.provide_label),
            bucket_key=getattr(group[0], "bucket_key", None),
            step_provide_data=step_pd, step_provide_label=step_pl)
        sb.sb_seq = self._cur_sb
        return sb

    # -- producer thread -----------------------------------------------
    def _start_producer(self):
        self._queue = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._done = False
        # no strong reference to self in the thread: an abandoned iterator
        # is collected and its producer ends
        wr = weakref.ref(self)

        def produce(stop, q):
            from . import faults as _faults
            while not stop.is_set():
                if _faults.fire("superbatch.producer") == "die":
                    return  # an abrupt thread death: no end marker
                it = wr()
                if it is None:
                    return
                try:
                    group = it._pull_group()
                    item = it._assemble(group) if group else None
                except Exception as exc:  # raised again in the consumer
                    item = exc
                it = group = None
                while not stop.is_set() and wr() is not None:
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except _queue.Full:
                        continue
                if item is None or isinstance(item, Exception):
                    return

        self._thread = threading.Thread(target=produce,
                                        args=(self._stop, self._queue),
                                        name="mxtpu-superbatch")
        self._thread.daemon = True
        self._thread.start()

    def _shutdown_producer(self):
        if self._thread is None:
            return
        self._stop.set()
        while self._thread.is_alive():
            try:  # unblock a producer waiting on a full queue
                self._queue.get_nowait()
            except _queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        self._thread = None

    def __del__(self):
        try:
            self._shutdown_producer()
        except Exception:
            pass

    def _queue_get_checked(self):
        """Blocking get that notices a producer that died without
        delivering its end marker, instead of waiting forever."""
        while True:
            try:
                return self._queue.get(timeout=0.1)
            except _queue.Empty:
                t = self._thread
                if t is None or not t.is_alive():
                    self._done = True
                    raise MXNetError(
                        "superbatch.producer: the prefetch thread died "
                        "without delivering a batch (DataHealth=%r)"
                        % (self.data_health.report(),))

    # -- DataIter interface --------------------------------------------
    def reset(self):
        if self._prefetch:
            self._shutdown_producer()
        self.base.reset()
        self._done = False
        self._held = None
        if self._prefetch:
            self._start_producer()

    def close(self):
        """Stop the producer and drop the superbatches in flight, without
        resetting the base iterator."""
        if self._prefetch:
            self._shutdown_producer()
        self._queue = None
        self._done = True
        self._held = None

    def next(self):
        if self._done:
            raise StopIteration
        if self._prefetch:
            item = self._queue_get_checked()
        else:
            group = self._pull_group()
            item = self._assemble(group) if group else None
        if item is None:
            self._done = True
            raise StopIteration
        if isinstance(item, Exception):
            self._done = True
            raise item
        return item


def _init_data(data, allow_empty, default_name):
    """Normalize data into a sorted list of (name, array): NDArrays stay
    tensors where they lie, anything else becomes a numpy array."""
    if data is None:
        if not allow_empty:
            raise MXNetError("NDArrayIter: data is required")
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise MXNetError("NDArrayIter: data is empty")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    out = {}
    for k, v in data.items():
        out[k] = v.data if isinstance(v, NDArray) else np.asarray(v)
    return list(sorted(out.items()))


def _dtype_of(v):
    return v.dtype if isinstance(v, np.ndarray) else NDArray(v[:0]).dtype


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (ref: io.py NDArrayIter), with
    ``shuffle`` and ``last_batch_handle`` ``pad`` (the last batch wraps
    around to the start, ``pad`` counting the wrapped rows), ``discard``
    and ``roll_over``. The shuffle draws from ``random.np_rng()``, so its
    order differs from the JAX package's for the same seed."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        if shuffle:
            from . import random as _random
            idx = _random.np_rng().permutation(self.num_data)
            self.data = [(k, _take(v, idx)) for k, v in self.data]
            self.label = [(k, _take(v, idx)) for k, v in self.label]
        if last_batch_handle == "discard":
            new_n = self.num_data - self.num_data % batch_size
            self.data = [(k, v[:new_n]) for k, v in self.data]
            self.label = [(k, v[:new_n]) for k, v in self.label]
            self.num_data = new_n
        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        if self.num_data < batch_size:
            raise MXNetError("NDArrayIter: batch_size needs to be smaller "
                             "than data size")
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         _dtype_of(v)) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         _dtype_of(v)) for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if (self.last_batch_handle == "roll_over"
                and self.cursor > self.num_data):
            self.cursor = -self.batch_size + (self.cursor % self.num_data) \
                % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        if self.cursor >= self.num_data:
            raise MXNetError("NDArrayIter: the iterator needs reset()")
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            return [_batch_array(x[1][self.cursor:end]) for x in data_source]
        # the last batch wraps around to the start
        pad = self.batch_size - self.num_data + self.cursor

        def cat(v):
            if isinstance(v, np.ndarray):
                return np.concatenate((v[self.cursor:], v[:pad]), axis=0)
            return torch.cat((v[self.cursor:], v[:pad]), dim=0)

        return [_batch_array(cat(x[1])) for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if (self.last_batch_handle == "pad"
                and self.cursor + self.batch_size > self.num_data):
            return self.cursor + self.batch_size - self.num_data
        return 0


def _take(v, idx):
    if isinstance(v, np.ndarray):
        return v[idx]
    return v[torch.from_numpy(idx).to(v.device)]


def _batch_array(v):
    """A batch NDArray: a numpy slice on the host (64-bit narrowed to 32, as
    ``nd.array`` does), a tensor slice where it lies."""
    if isinstance(v, np.ndarray):
        return array(v, ctx=cpu())
    return NDArray(v.clone())


class CSVIter(DataIter):
    """CSV file iterator (ref: src/io/iter_csv.cc:213; host-side numpy here)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        self._inner = NDArrayIter(
            data, label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            label_name="label")
        super().__init__(batch_size)

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class MNISTIter(DataIter):
    """MNIST idx-format file iterator (ref: src/io/iter_mnist.cc:254)."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 seed=0, silent=False, num_parts=1, part_index=0, **kwargs):
        import gzip
        import struct

        def read_idx(path):
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rb") as f:
                magic = struct.unpack(">HBB", f.read(4))
                ndim = magic[2]
                dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
                return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)

        img = read_idx(image).astype(np.float32) / 255.0
        lab = read_idx(label).astype(np.float32)
        # distributed sharding (ref: part_index/num_parts in image_iter_common.h)
        if num_parts > 1:
            n = img.shape[0] // num_parts
            img = img[part_index * n:(part_index + 1) * n]
            lab = lab[part_index * n:(part_index + 1) * n]
        if flat:
            img = img.reshape(img.shape[0], -1)
        else:
            img = img.reshape(img.shape[0], 1, img.shape[1], img.shape[2])
        self._inner = NDArrayIter(img, lab, batch_size=batch_size,
                                  shuffle=shuffle)
        super().__init__(batch_size)

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()
