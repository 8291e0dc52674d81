"""Dynamic request batcher: coalesce concurrent ``infer`` calls into
shape-bucketed engine dispatches.

The port's copy of ``mxnet_tpu/serving/batcher.py`` over the port's
:class:`~mxnet_tpu_torch.serving.engine.ServingEngine`. A fixed cost every
dispatch pays (the host's walk of the graph, the launches, the copies in
and out) is amortised by bulking K *requests* into one padded bucket. A
single batching thread drains a bounded queue, coalesces requests until
the smallest covering bucket is full or ``max_latency`` has elapsed since
the oldest queued request, pads, dispatches through the engine, and
splits the result rows back per request.

Knobs (constructor arg > ``MXTPU_SERVE_*`` env > the engine's tuning-DB
entry, for ``max_latency_ms`` > default):

===========================  =============================================
``MXTPU_SERVE_MAX_BATCH``    request-coalescing ceiling (default: the
                             engine's largest bucket)
``MXTPU_SERVE_MAX_LATENCY_MS`` how long a dispatch may wait for co-riders
                             once a request is queued (default 5 ms)
``MXTPU_SERVE_QUEUE``        bounded queue depth — back-pressure surfaces
                             as :class:`ServingOverloadedError` instead of
                             unbounded memory growth (default 256)
``MXTPU_SERVE_DEADLINE_MS``  default per-request deadline; a request that
                             cannot be dispatched in time fails with
                             :class:`ServingDeadlineError` (default 1000)
===========================  =============================================

Fault sites (:mod:`mxnet_tpu_torch.faults`): ``serve.enqueue_drop`` fires
per submission — the ``drop`` kind rejects the request with a clear error
(and ``raise``/``transient`` kinds propagate); a per-batch site
(``fault_site=``; the fleet arms ``fleet.replica_die``) kills the thread
with ``die``. A batch-thread death sheds every in-flight request with
:class:`ServingClosedError` instead of hanging callers, and dumps the
flight recorder.
"""
from __future__ import annotations

import itertools
import logging
import queue
import threading
import time

import numpy as np

from ..base import MXNetError, env_float, env_int, env_str
from ..obs import trace as _obs
from .health import ServingHealth, SERVING_HEALTH

#: process-wide serving request-id sequence: the correlation key threaded
#: through submit -> queue -> coalesce -> dispatch -> split host spans —
#: shared with the fleet router so one id never names two requests
REQUEST_IDS = itertools.count(1)

#: how often a blocked ``wait()``/drain re-checks batching-thread liveness
#: while sleeping toward the request's actual deadline (a dead thread is
#: rare; the deadline is the contract — so the wait is event-driven and
#: only wakes at this cadence for the liveness probe)
_LIVENESS_RECHECK_S = 0.2


class ServingError(MXNetError):
    """Base class for serving-tier request failures."""


class ServingDeadlineError(ServingError):
    """The request's deadline passed before it could be served."""


class ServingOverloadedError(ServingError):
    """The bounded request queue is full (back-pressure: shed at the edge
    rather than queue without bound)."""


class ServingClosedError(ServingError):
    """The batcher/loop is closed (or died) — the request was shed."""


class Settleable(object):
    """Once-only request settle protocol shared by the batcher's
    :class:`_Request` and the fleet's
    :class:`~mxnet_tpu_torch.serving.fleet.FleetRequest`: first settle wins (the
    serving thread fulfilling vs. a waiter expiring the deadline race on
    the same request), the event is set before the ``on_done`` callback
    runs, and a callback exception can never kill the settling thread."""

    __slots__ = ("event", "value", "error", "on_done", "_settle_lock")

    def __init__(self, on_done=None):
        self.event = threading.Event()
        self.value = None
        self.error = None
        #: optional callback fired exactly once, after the request
        #: settles, from whichever thread settles it
        self.on_done = on_done
        self._settle_lock = threading.Lock()

    def _settle(self, result, error):
        """Returns whether THIS call settled the request."""
        with self._settle_lock:
            if self.event.is_set():
                return False
            self.value = result
            self.error = error
            self.event.set()
        cb = self.on_done
        if cb is not None:
            try:
                cb(self)
            except Exception:
                # a completion callback must never kill the settling thread
                logging.exception("serving: request on_done callback failed")
        return True

    def fail(self, exc):
        return self._settle(None, exc)

    def fulfill(self, outs):
        return self._settle(outs, None)

    def done(self):
        return self.event.is_set()


class _Request(Settleable):
    __slots__ = ("inputs", "n", "deadline", "dispatched", "rid",
                 "t_submit")

    def __init__(self, inputs, n, deadline, on_done=None, rid=None):
        super().__init__(on_done=on_done)
        self.inputs = inputs
        self.n = n
        self.deadline = deadline
        #: serving correlation id; every host span of this request's
        #: lifecycle carries it as ``req=``
        self.rid = rid if rid is not None else next(REQUEST_IDS)
        self.t_submit = time.perf_counter()
        #: True once the batching thread has started executing this
        #: request's engine dispatch — the fleet router uses it to tell a
        #: safely-retryable request (never ran) from one that may have
        #: side-effected
        self.dispatched = False


class Batcher(object):
    """Request-coalescing front end over a :class:`ServingEngine`.

    ``infer(inputs)`` blocks the calling thread until its rows come back
    (or its deadline passes); concurrent callers ride the same padded
    bucket dispatch. ``start=False`` builds the batcher with the batching
    thread parked — tests enqueue a deterministic backlog, then
    :meth:`start` coalesces it into one dispatch.
    """

    def __init__(self, engine, max_batch=None, max_latency_ms=None,
                 queue_size=None, deadline_ms=None, health=None, start=True,
                 fault_site=None):
        self.engine = engine
        # knob precedence: ctor arg > env >
        # the engine's tuning-DB entry (stashed at load as ``_autotuned``)
        # > built-in default. Only knobs the tuner actually searches are
        # resolved, and an unusable DB value falls back instead of
        # raising into the deploy it configures.
        _tuned = getattr(engine, "_autotuned", None) or {}
        if max_latency_ms is None \
                and not env_str("MXTPU_SERVE_MAX_LATENCY_MS") \
                and "max_latency_ms" in _tuned:
            try:
                max_latency_ms = float(_tuned["max_latency_ms"])
            except (TypeError, ValueError):
                logging.warning(
                    "autotune: tuning-DB max_latency_ms %r is unusable — "
                    "built-in default applies",
                    _tuned["max_latency_ms"])
        self.max_batch = int(max_batch if max_batch is not None
                             else env_float("MXTPU_SERVE_MAX_BATCH",
                                            engine.max_batch))
        if self.max_batch < 1 or self.max_batch > engine.max_batch:
            raise MXNetError(
                "Batcher: max_batch %d outside the engine's buckets "
                "(largest %d)" % (self.max_batch, engine.max_batch))
        self.max_latency = (max_latency_ms if max_latency_ms is not None
                            else env_float("MXTPU_SERVE_MAX_LATENCY_MS",
                                           5.0)) / 1e3
        self.default_deadline = (
            deadline_ms if deadline_ms is not None
            else env_float("MXTPU_SERVE_DEADLINE_MS", 1000.0)) / 1e3
        qsize = int(queue_size if queue_size is not None
                    else env_int("MXTPU_SERVE_QUEUE", 256))
        self._queue = queue.Queue(maxsize=qsize)
        self._carry = None      # request popped but not fitting the batch
        self._closed = False
        #: serializes submit-enqueue against close-shed: a submit that
        #: passed the _closed check can no longer slip its request into the
        #: queue AFTER close() drained it (the request would never resolve)
        self._lock = threading.Lock()
        self._inflight = ()     # requests popped into the batch being built
        self.dead = None        # the exception that killed the thread
        #: optional faults.py site fired once per collected batch (the
        #: fleet router arms ``fleet.replica_die`` here)
        self._fault_site = fault_site
        self.health = health or ServingHealth(parent=SERVING_HEALTH)
        self._thread = None
        if start:
            self.start()

    # ------------------------------------------------------------------
    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._closed = False
            self.dead = None
            self._thread = threading.Thread(target=self._run,
                                            name="mxtpu-serve-batcher",
                                            daemon=True)
            self._thread.start()
        return self

    def close(self):
        """Stop the batching thread and shed everything still queued."""
        with self._lock:
            self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        # re-shed AFTER the join, atomically against submit: any request
        # that won the enqueue race is in the queue by now and is failed
        # here; any later submit fails fast on the _closed check
        self._shed(ServingClosedError("batcher closed"))

    def take_queued(self):
        """Atomically remove and return every queued-but-undispatched
        request (queue + carry) WITHOUT failing them — the fleet router's
        drain/death path re-queues these onto surviving replicas instead
        of shedding them."""
        with self._lock:
            taken = []
            if self._carry is not None:
                taken.append(self._carry)
                self._carry = None
            while True:
                try:
                    taken.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            return taken

    def backlog(self):
        """Queued-but-undispatched request count (queue + carry) — the
        least-loaded dispatch signal and the drain-completion probe."""
        return self._queue.qsize() + (1 if self._carry is not None else 0)

    def _shed(self, exc):
        # collect under the lock, fail OUTSIDE it: request on_done
        # callbacks (the fleet router's completion hook) take their own
        # locks and must never run under ours
        taken = self.take_queued()
        for r in taken:
            r.fail(exc)
        if taken:
            self.health.record_shed(len(taken), exc)

    # ------------------------------------------------------------------
    def infer(self, inputs, deadline_ms=None):
        """Blocking inference: dict name -> (n, ...) array; returns the
        engine's output list sliced to this request's n rows."""
        req = self.submit(inputs, deadline_ms=deadline_ms)
        return self.wait(req)

    def submit(self, inputs, deadline_ms=None, on_done=None, rid=None):
        """Enqueue without blocking on the result; returns the request
        handle for :meth:`wait`. ``on_done`` (if given) is called with the
        request exactly once, after it settles — fulfilled, failed, or
        shed — from whichever thread settles it. ``rid`` carries an
        EXISTING correlation id (the fleet router threads its request's id
        through every replica assignment); default is a fresh one."""
        from .. import faults as _faults
        if self._closed:
            raise ServingClosedError("batcher is closed")
        if self._thread is not None and not self._thread.is_alive():
            raise ServingClosedError(
                "batching thread died" if self.dead is None
                else "batching thread died: %r" % (self.dead,))
        n = None
        host = {}
        for name in self.engine._input_names:
            if name not in inputs:
                raise MXNetError("submit: missing input %r (need %s)"
                                 % (name, self.engine._input_names))
            v = np.asarray(inputs[name], self.engine._input_dtypes[name])
            # reject a malformed request HERE, alone — once coalesced, a bad
            # shape would fail every innocent co-rider in its batch
            if tuple(v.shape[1:]) != self.engine._input_shapes[name]:
                raise MXNetError(
                    "submit: input %r per-example shape %s != %s"
                    % (name, tuple(v.shape[1:]),
                       self.engine._input_shapes[name]))
            if n is None:
                n = v.shape[0]
            elif v.shape[0] != n:
                raise MXNetError("submit: inputs disagree on batch size")
            host[name] = v
        if n == 0:
            raise MXNetError("submit: empty request")
        if n > self.max_batch:
            raise MXNetError(
                "submit: request of %d rows exceeds max_batch %d (chunk "
                "it, or call engine.infer directly)" % (n, self.max_batch))
        act = _faults.fire("serve.enqueue_drop")
        if act == "drop":
            err = ServingOverloadedError(
                "request dropped at enqueue (injected serve.enqueue_drop)")
            self.health.record_dropped(err)
            raise err
        deadline = time.monotonic() + (
            (deadline_ms / 1e3) if deadline_ms is not None
            else self.default_deadline)
        req = _Request(host, n, deadline, on_done=on_done, rid=rid)
        # the _closed re-check and the enqueue are ATOMIC against
        # close()'s final shed: without the lock a submit could pass the
        # check, lose the CPU, and enqueue after close() drained the
        # queue — a request nothing would ever resolve
        with self._lock:
            if self._closed:
                raise ServingClosedError("batcher is closed")
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                err = ServingOverloadedError(
                    "request queue full (%d waiting) — the serving tier is "
                    "saturated; shed at the edge" % self._queue.maxsize)
                self.health.record_dropped(err)
                raise err
        _obs.instant("serve_submit", req=req.rid, n=req.n)
        self.health.record_request()
        return req

    def wait(self, req):
        """Block until ``req`` resolves; raises its error if it failed.

        The wait is event-driven against the request's ACTUAL remaining
        deadline (not a fixed poll quantum — a 50 ms poll step would both
        quantize every caller's deadline handling and wake 20x/s for
        nothing), with a bounded-cadence liveness re-check so a dead
        batching thread still fails the caller promptly."""
        while not req.event.is_set():
            remaining = req.deadline - time.monotonic()
            if remaining <= 0:
                # the batcher also expires queued requests; this covers a
                # request stuck behind a long-running dispatch
                if req.fail(ServingDeadlineError(
                        "deadline passed while waiting for dispatch")):
                    self.health.record_expired(req.error)
                break
            if req.event.wait(min(remaining, _LIVENESS_RECHECK_S)):
                break
            if self._thread is not None and not self._thread.is_alive():
                req.fail(ServingClosedError(
                    "batching thread died with the request in flight"))
                break
        if req.error is not None:
            raise req.error
        return req.value

    # ------------------------------------------------------------------
    def _next_request(self, timeout):
        if self._carry is not None:
            req, self._carry = self._carry, None
            return req
        try:
            return self._queue.get(timeout=max(0.0, timeout))
        except queue.Empty:
            return None

    def _run(self):
        try:
            while not self._closed:
                req = self._next_request(0.05)
                if req is None:
                    continue
                now = time.monotonic()
                if now > req.deadline:
                    req.fail(ServingDeadlineError("expired in queue"))
                    self.health.record_expired(req.error)
                    continue
                # "serve_queue": submit -> joined a dispatchable batch
                # (the carry path counts its full wait, once)
                _obs.async_complete("serve_queue",
                                    time.perf_counter() - req.t_submit,
                                    id=req.rid, req=req.rid)
                batch = [req]
                self._inflight = batch
                total = req.n
                t_coalesce = time.perf_counter()
                flush_at = now + self.max_latency
                while total < self.max_batch and not self._closed:
                    remaining = flush_at - time.monotonic()
                    if remaining <= 0:
                        break
                    nxt = self._next_request(remaining)
                    if nxt is None:
                        break
                    if time.monotonic() > nxt.deadline:
                        nxt.fail(ServingDeadlineError("expired in queue"))
                        self.health.record_expired(nxt.error)
                        continue
                    if total + nxt.n > self.max_batch:
                        self._carry = nxt
                        break
                    _obs.async_complete(
                        "serve_queue",
                        time.perf_counter() - nxt.t_submit,
                        id=nxt.rid, req=nxt.rid)
                    batch.append(nxt)
                    total += nxt.n
                _obs.complete("serve_coalesce",
                              time.perf_counter() - t_coalesce,
                              reqs=[r.rid for r in batch], n=total)
                if self._fault_site is not None:
                    from .. import faults as _faults
                    act = _faults.fire(self._fault_site)
                    if act == "die":
                        raise MXNetError("injected replica death (%s)"
                                         % self._fault_site)
                self._dispatch(batch, total)
                self._inflight = ()
            # closing: anything still queued is shed by close()
        except BaseException as e:
            # the thread dies VISIBLY: record why, and settle the popped
            # batch so no caller blocks on a request nothing owns. Popped
            # requests that never started their engine dispatch keep
            # dispatched=False — the fleet router's on_done hook re-queues
            # those onto surviving replicas instead of failing the caller.
            self.dead = e
            inflight, self._inflight = self._inflight, ()
            for r in inflight:
                r.fail(ServingClosedError(
                    "batching thread died: %r — request shed" % (e,)))
            if inflight:
                self.health.record_shed(len(inflight), e)
            # post-mortem: the recent request spans + serving counters
            # land on disk before the thread exits; dump() never raises
            # into this failure path
            from ..obs import flight as _flight
            _flight.dump(
                "serving batcher thread died: %r" % (e,),
                extra={"health": self.health.report(),
                       "inflight": [r.rid for r in inflight]})

    def _dispatch(self, batch, total):
        names = self.engine._input_names
        try:
            if len(batch) == 1:
                stacked = batch[0].inputs
            else:
                stacked = {n: np.concatenate([r.inputs[n] for r in batch])
                           for n in names}
            # past this point the requests may have side-effected: a fleet
            # death must FAIL them, not silently retry them elsewhere
            for r in batch:
                r.dispatched = True
            with _obs.span("serve_dispatch", reqs=[r.rid for r in batch],
                           n=total):
                outs = self.engine.infer(stacked)
        except Exception as e:
            for r in batch:
                r.fail(e)
            self.health.record_error(e)
            return
        # split result rows back per request (outputs may carry a
        # rows-per-example factor, e.g. the LM's (batch*seq, vocab) head)
        t_split = time.perf_counter()
        offset = 0
        for r in batch:
            rows = []
            for o, f in zip(outs, self.engine._out_row_factor):
                if f:
                    rows.append(o[offset * f:(offset + r.n) * f])
                else:
                    rows.append(o)
            r.fulfill(rows)
            offset += r.n
        _obs.complete("serve_split", time.perf_counter() - t_split,
                      reqs=[r.rid for r in batch])
