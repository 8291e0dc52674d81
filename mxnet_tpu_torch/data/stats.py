"""Per-stage instrumentation for the data tier.

Counterpart of ``mxnet_tpu/data/stats.py``. :class:`PipelineStats` makes
every stage of the input pipeline measurable: read, decode, stack and
host-to-device seconds, output-queue depth samples, and the seconds the
training loop waited on data (``stall``), so "input-bound or
compute-bound" is a number (``stall_frac``), not a guess. Every
per-pipeline instance chains into the process-global
:data:`PIPELINE_STATS` aggregate, as ``io.DataHealth`` chains into
``io.DATA_HEALTH``.
"""
from __future__ import annotations

import threading
import time


class PipelineStats(object):
    """Thread-safe per-stage timing/counters for one input pipeline.

    Stages (by convention — ``add`` accepts any name):

    - ``read``    record bytes off storage (reader / record IO)
    - ``decode``  JPEG decode + augment into a host batch (worker pool)
    - ``stack``   K host batches -> one (k, batch, ...) numpy stack
    - ``h2d``     the copy landing the stacked superbatch on the device
    - ``wait``    pool-consumer wait (the prefetcher's PRODUCER thread
                  when the tier is fully wired — hidden from training)
    - ``stall``   the TRAINING LOOP blocked on data (DevicePrefetcher);
                  the only stage ``stall_frac`` counts

    ``stall_frac`` in :meth:`report` is stall seconds over wall-clock
    seconds since construction/:meth:`reset` — the single number that says
    whether the run is input-bound (≈1: the device waits on data) or
    compute-bound (≈0: data is always ready).
    """

    def __init__(self, parent=None):
        self._lock = threading.Lock()
        self._parent = parent
        self._stages = {}       # name -> [seconds, count]
        self._qdepth_sum = 0
        self._qdepth_n = 0
        self._qdepth_max = 0
        self._began = time.perf_counter()

    # -- recording -----------------------------------------------------
    def add(self, stage, seconds, n=1):
        """Accumulate ``seconds`` (and ``n`` units of work) into a stage."""
        with self._lock:
            acc = self._stages.setdefault(stage, [0.0, 0])
            acc[0] += seconds
            acc[1] += n
        if self._parent is not None:
            self._parent.add(stage, seconds, n)

    def timed(self, stage, fn, n=1):
        """Run ``fn()`` and charge its wall time to ``stage``."""
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            self.add(stage, time.perf_counter() - t0, n)

    def note_queue_depth(self, depth):
        """Sample the output-queue depth (taken at each consumer pull: a
        persistently empty queue with a nonzero stall fraction is the
        input-bound signature; a persistently full one means the producer
        is ahead and the consumer is the bottleneck)."""
        with self._lock:
            self._qdepth_sum += int(depth)
            self._qdepth_n += 1
            if depth > self._qdepth_max:
                self._qdepth_max = int(depth)
        if self._parent is not None:
            self._parent.note_queue_depth(depth)

    # -- reading -------------------------------------------------------
    def stage_seconds(self, stage):
        with self._lock:
            return self._stages.get(stage, [0.0, 0])[0]

    def report(self):
        """One flat dict (the Speedometer line, chip_smoke, tests)."""
        with self._lock:
            elapsed = max(1e-9, time.perf_counter() - self._began)
            out = {}
            for name, (sec, cnt) in sorted(self._stages.items()):
                out["%s_s" % name] = round(sec, 4)
                out["%s_n" % name] = cnt
            stall = self._stages.get("stall", [0.0, 0])[0]
            out["stall_frac"] = round(stall / elapsed, 4)
            out["elapsed_s"] = round(elapsed, 3)
            if self._qdepth_n:
                out["queue_depth_avg"] = round(
                    self._qdepth_sum / self._qdepth_n, 2)
                out["queue_depth_max"] = self._qdepth_max
            return out

    def reset(self):
        with self._lock:
            self._stages.clear()
            self._qdepth_sum = 0
            self._qdepth_n = 0
            self._qdepth_max = 0
            self._began = time.perf_counter()

    def __repr__(self):
        return "PipelineStats(%r)" % (self.report(),)


#: process-global aggregate every per-pipeline PipelineStats mirrors into
#: (the io.DATA_HEALTH convention: per-instance numbers for the run that
#: owns them, one global roll-up for ops/debugging)
PIPELINE_STATS = PipelineStats()
