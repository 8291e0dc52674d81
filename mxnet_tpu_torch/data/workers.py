"""Parallel decode/augment worker pool for the data tier.

Counterpart of ``mxnet_tpu/data/workers.py``. N Python worker threads
(JPEG decode runs in native code or Pillow with the GIL released, so
threads scale) pull *batch tasks* off one epoch's work list and push
finished host batches into a bounded output queue; the consumer
reassembles them in strict batch order.

- **Determinism.** Batch b always holds the keys the epoch order gave it,
  and the consumer emits b = 0, 1, 2, ... whatever the completion order,
  so resume and bitwise training parity hold for any ``num_workers``.
  Augmentation draws derive from ``(seed, epoch, batch index)``, not from
  the thread that decoded the batch.
- **Bounded memory.** The output queue holds at most ``queue_depth``
  batches (``MXTPU_DATA_QUEUE``); workers claim no batch more than
  ``queue_depth + workers`` ahead of the consumer.
- **Dead workers fail the consumer.** A worker that dies holding a batch
  (fault site ``data.worker_die``, or a real crash) is seen by the
  consumer's bounded-wait poll, which raises
  :class:`~mxnet_tpu_torch.base.MXNetError` naming the site: a prompt
  error, never a hang.

``data.decode_delay`` fires per batch task before the decode; a ``delay``
rule there makes a worker slow, which shows in the
:class:`~mxnet_tpu_torch.data.stats.PipelineStats` (``wait``, then the
training loop's ``stall``) without changing the batch order.
"""
from __future__ import annotations

import os
import queue as _queue
import threading
import time

from ..base import MXNetError
from .stats import PipelineStats, PIPELINE_STATS


def default_num_workers():
    """Env default for decode/augment parallelism: ``MXTPU_DATA_WORKERS``
    (0 = the legacy in-line decode path)."""
    v = os.environ.get("MXTPU_DATA_WORKERS")
    if v is None or v.strip() == "":
        return 0
    try:
        return max(0, int(v))
    except ValueError:
        raise MXNetError("MXTPU_DATA_WORKERS must be an integer, got %r"
                         % v)


def default_queue_depth(num_workers):
    """Env default for the pool's bounded output queue
    (``MXTPU_DATA_QUEUE``; default ``2 * num_workers`` — enough for every
    worker to stay busy while the consumer drains one batch)."""
    v = os.environ.get("MXTPU_DATA_QUEUE")
    if v is None or v.strip() == "":
        return max(2, 2 * int(num_workers))
    try:
        return max(1, int(v))
    except ValueError:
        raise MXNetError("MXTPU_DATA_QUEUE must be an integer, got %r" % v)


class _WorkerDie(Exception):
    """Internal: simulated abrupt worker death (``data.worker_die`` with
    kind ``"die"``) — exits the thread without completing the claimed task
    and without pushing any sentinel, exactly like a real crash."""


class DecodeWorkerPool(object):
    """Run one epoch's batch tasks across N decode workers, emitting host
    batches in deterministic batch order.

    ``batch_fn(keys, batch_seed)`` is the decode/augment stage supplied by
    the iterator (native fused JPEG decode for ``ImageRecordIter``, the
    Pillow path for ``ImageIter``); it must be thread-safe and pure given
    its arguments. ``tasks`` is the epoch's full work list of
    ``(keys, batch_seed)`` tuples — batch index is the list position.

    One pool instance covers one epoch pass; the owning iterator builds a
    fresh pool per reset (cheap: N thread spawns) so a mid-epoch reset can
    never leak half-decoded batches into the next epoch.
    """

    def __init__(self, batch_fn, tasks, num_workers, queue_depth=None,
                 stats=None, name="data"):
        self._batch_fn = batch_fn
        self._tasks = list(tasks)
        self.num_workers = max(1, int(num_workers))
        self._depth = (queue_depth if queue_depth is not None
                       else default_queue_depth(self.num_workers))
        self.stats = stats if stats is not None \
            else PipelineStats(parent=PIPELINE_STATS)
        self.name = name
        self._out = _queue.Queue(maxsize=max(1, int(self._depth)))
        self._claim_lock = threading.Lock()
        self._next_task = 0
        # claim pacing window: workers never claim a batch more than this
        # far ahead of the consumer's emit cursor, which bounds the reorder
        # buffer at `window` entries (one slow batch can never trigger
        # unbounded decode-ahead) while keeping the drain path live — the
        # consumer always empties the queue, so the slow batch's own put
        # can never deadlock against co-workers' output
        self._window = max(1, int(self._depth)) + self.num_workers
        # per-worker claimed-but-uncompleted batch index: the consumer's
        # dead-worker detector reads this — a dead thread with a non-None
        # slot means its batch can never arrive
        self._current = [None] * self.num_workers
        self._stop = threading.Event()
        self._buffer = {}      # reorder: batch index -> payload
        self._next_emit = 0
        self._threads = [
            threading.Thread(target=self._run, args=(w,), daemon=True,
                             name="mxtpu-data-worker-%d" % w)
            for w in range(self.num_workers)]
        for t in self._threads:
            t.start()

    # -- worker side ---------------------------------------------------
    def _claim(self, wid):
        while not self._stop.is_set():
            with self._claim_lock:
                if self._next_task >= len(self._tasks):
                    return None
                if self._next_task < self._next_emit + self._window:
                    idx = self._next_task
                    self._next_task += 1
                    self._current[wid] = idx
                    return idx, self._tasks[idx]
            time.sleep(0.02)  # window full: the consumer is behind
        return None

    def _run(self, wid):
        from .. import faults as _faults
        try:
            while not self._stop.is_set():
                claimed = self._claim(wid)
                if claimed is None:
                    return
                idx, (keys, batch_seed) = claimed
                if _faults.fire("data.worker_die") == "die":
                    raise _WorkerDie()
                try:
                    # a "delay" rule here is the slow-worker fault: the
                    # batch arrives late (consumer wait rises) but intact
                    # and in order. Stage accounting (read/decode) is the
                    # batch_fn's own job — charging its whole wall time
                    # here would double-count the stages it already
                    # charges into the same stats object
                    _faults.fire("data.decode_delay")
                    payload = self._batch_fn(keys, batch_seed)
                except _WorkerDie:
                    raise
                except Exception as exc:
                    payload = exc   # surfaced at the consumer, in order
                while not self._stop.is_set():
                    try:
                        self._out.put((idx, payload), timeout=0.1)
                        break
                    except _queue.Full:
                        continue
                self._current[wid] = None
        except _WorkerDie:
            return  # abrupt: claimed slot stays set — the detector's signal

    # -- consumer side -------------------------------------------------
    def _check_dead_workers(self):
        for wid, t in enumerate(self._threads):
            if not t.is_alive() and self._current[wid] is not None:
                raise MXNetError(
                    "data.worker_die: decode worker %d died holding batch "
                    "%d — the pipeline cannot complete this epoch "
                    "(workers=%d, emitted=%d/%d)"
                    % (wid, self._current[wid], self.num_workers,
                       self._next_emit, len(self._tasks)))
        if (not any(t.is_alive() for t in self._threads)
                and self._next_emit < len(self._tasks)
                and not self._buffer and self._out.empty()):
            raise MXNetError(
                "data.worker_die: every decode worker exited with %d/%d "
                "batches undelivered"
                % (len(self._tasks) - self._next_emit, len(self._tasks)))

    def next_batch(self):
        """The next batch IN ORDER (blocking). Raises ``StopIteration``
        after the last task; re-raises a worker-side decode exception at
        the batch position it occurred; raises ``MXNetError`` promptly when
        a worker died holding an undelivered batch."""
        if self._next_emit >= len(self._tasks):
            raise StopIteration
        t0 = time.perf_counter()
        stalled = False
        while self._next_emit not in self._buffer:
            self.stats.note_queue_depth(self._out.qsize())
            try:
                idx, payload = self._out.get(timeout=0.1)
            except _queue.Empty:
                stalled = True
                self._check_dead_workers()
                continue
            self._buffer[idx] = payload
            if self._next_emit not in self._buffer:
                stalled = True
        if stalled:
            # charged as "wait", NOT "stall": under the prefetcher this
            # consumer is the producer THREAD, whose waiting is hidden
            # from training — "stall" is reserved for the training loop's
            # own wait (DevicePrefetcher), the stall_frac verdict stage
            self.stats.add("wait", time.perf_counter() - t0)
        payload = self._buffer.pop(self._next_emit)
        self._next_emit += 1
        if isinstance(payload, Exception):
            self.close()
            raise payload
        return payload

    def close(self):
        """Stop the workers and drop buffered batches (idempotent)."""
        self._stop.set()
        for t in self._threads:
            while t.is_alive():
                try:  # unblock a worker stuck on a full output queue
                    self._out.get_nowait()
                except _queue.Empty:
                    pass
                t.join(timeout=0.05)
        self._buffer.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
