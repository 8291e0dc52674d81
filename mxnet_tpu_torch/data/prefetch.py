"""Prefetch to the device: the superbatch iterator ``Module.fit`` wraps
around ``train_data`` when it trains K steps a dispatch.

Counterpart of ``mxnet_tpu/data/prefetch.py``. :class:`DevicePrefetcher`
is :class:`~mxnet_tpu_torch.io.SuperBatchIter` with its queue sized to the
dispatch pipeline (``depth`` D holds D+1 superbatches: one per dispatch in
flight plus the one training) and per-stage timing in a
:class:`~.stats.PipelineStats`: stack and copy seconds on the producer
thread, and the seconds the training loop waited for data (``stall``) with
the queue's depth at each wait, which the ``Speedometer`` prints. Over an
image iterator it charges the iterator's own ``data_stats`` (where the
decode workers charge read and decode), so one report covers the tier.
"""
from __future__ import annotations

import time

from .. import io as mxio
from ..obs import trace as _obs
from .stats import PipelineStats, PIPELINE_STATS


class DevicePrefetcher(mxio.SuperBatchIter):
    """SuperBatchIter with the dispatch pipeline's depth, PipelineStats,
    and ``set_epoch`` (a no-op for base iterators without an
    epoch-addressable order, such as NDArrayIter)."""

    def __init__(self, base, k, depth=None, stats=None, **kwargs):
        # one stats object for the whole tier: the base iterator's where it
        # has one, else a fresh one mirrored into PIPELINE_STATS
        self.stats = (stats if stats is not None
                      else getattr(base, "data_stats", None))
        if self.stats is None:
            self.stats = PipelineStats(parent=PIPELINE_STATS)
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
