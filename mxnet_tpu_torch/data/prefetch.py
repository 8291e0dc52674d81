"""Prefetch to the device: the superbatch iterator ``Module.fit`` wraps
around ``train_data`` when it trains K steps a dispatch.

Counterpart of ``mxnet_tpu/data/prefetch.py``. :class:`DevicePrefetcher`
is :class:`~mxnet_tpu_torch.io.SuperBatchIter` with its queue sized to the
dispatch pipeline (``depth`` D holds D+1 superbatches: one per dispatch in
flight plus the one training) and per-stage timing in a
:class:`PipelineStats`: stack and copy seconds on the producer thread, and
the seconds the training loop waited for data (``stall``) with the queue's
depth at each wait, which the ``Speedometer`` prints.
"""
from __future__ import annotations

import threading
import time

from .. import io as mxio
from ..obs import trace as _obs


class PipelineStats(object):
    """Thread-safe seconds and counts by stage (``stack``, ``h2d``,
    ``stall``) and queue-depth samples of one input pipeline (the fields of
    the JAX package's ``data.stats.PipelineStats`` that ``fit`` reads)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stages = {}       # name -> [seconds, count]
        self._qdepth_sum = 0
        self._qdepth_n = 0

    def add(self, stage, seconds, n=1):
        with self._lock:
            acc = self._stages.setdefault(stage, [0.0, 0])
            acc[0] += seconds
            acc[1] += n

    def note_queue_depth(self, depth):
        with self._lock:
            self._qdepth_sum += int(depth)
            self._qdepth_n += 1

    def stage_seconds(self, stage):
        with self._lock:
            return self._stages.get(stage, [0.0, 0])[0]

    def report(self):
        """``{"<stage>_s": seconds, "<stage>_n": count, ...,
        "queue_depth_avg": mean depth}``."""
        with self._lock:
            out = {}
            for name, (sec, cnt) in sorted(self._stages.items()):
                out["%s_s" % name] = sec
                out["%s_n" % name] = cnt
            if self._qdepth_n:
                out["queue_depth_avg"] = self._qdepth_sum / self._qdepth_n
            return out


class DevicePrefetcher(mxio.SuperBatchIter):
    """SuperBatchIter with the dispatch pipeline's depth, PipelineStats,
    and ``set_epoch`` (a no-op for base iterators without an
    epoch-addressable order, such as NDArrayIter)."""

    def __init__(self, base, k, depth=None, stats=None, **kwargs):
        self.stats = stats if stats is not None else PipelineStats()
        if depth is not None and "queue_depth" not in kwargs:
            kwargs["queue_depth"] = max(2, int(depth) + 1)
        self._emitted = 0
        super().__init__(base, k, **kwargs)

    def _note_stage(self, stage, seconds, n=1):
        self.stats.add(stage, seconds, n)

    def _queue_get_checked(self):
        """The training loop's wait for the next superbatch: charged to
        ``stall``, with a queue-depth sample and a ``data_wait`` span."""
        self.stats.note_queue_depth(self._queue.qsize())
        t0 = time.perf_counter()
        item = None
        try:
            item = super()._queue_get_checked()
            return item
        finally:
            dt = time.perf_counter() - t0
            self.stats.add("stall", dt)
            _obs.complete("data_wait", dt,
                          dispatch=getattr(item, "sb_seq", None))

    def set_epoch(self, epoch):
        """Pin the base iterator to ``epoch``'s order and restart the
        producer on it, where the base has ``set_epoch``."""
        base_set = getattr(self.base, "set_epoch", None)
        if base_set is None:
            return
        if (self._emitted == 0
                and getattr(self.base, "data_epoch", None) == int(epoch)):
            return
        if self._prefetch:
            self._shutdown_producer()
        base_set(epoch)
        self._done = False
        self._emitted = 0
        if self._prefetch:
            self._start_producer()

    def next(self):
        out = super().next()
        self._emitted += 1
        return out

    def reset(self):
        super().reset()
        self._emitted = 0
