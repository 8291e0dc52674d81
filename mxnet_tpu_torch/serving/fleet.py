"""Fleet tier: serving replicas behind a priority-aware router.

The port's copy of ``mxnet_tpu/serving/fleet.py``. One
:class:`~mxnet_tpu_torch.serving.engine.ServingEngine` is ONE replica with
one queue; the fleet is N of them behind a router. On one card, N
replicas are N engines on ``cuda:0``, each with its own batching thread;
their dispatches share the card. A replica may be a model-parallel engine
(``ServingEngine(contexts=)``) beside single-device ones; each replica's
report names the mesh positions its engine spans (``model_devices``).

* **least-loaded dispatch** — every request goes to the ACTIVE replica
  with the fewest requests in flight (assigned minus resolved: queued at
  the replica plus being dispatched), so one slow replica never builds a
  private convoy while others idle;
* **priority classes** — ``interactive`` and ``batch``, each with its own
  default deadline (``MXTPU_FLEET_INTERACTIVE_DEADLINE_MS`` /
  ``MXTPU_FLEET_BATCH_DEADLINE_MS``) and its own bounded router queue;
  dispatch order is STRICT priority: the batch queue only drains while
  the interactive queue is empty, and an expired batch request is failed
  at pop — it never occupies a dispatch an interactive request wanted;
* **elastic membership** — :meth:`FleetRouter.drain` stops assigning to a
  replica, flushes what it already owns, and retires it;
  :meth:`FleetRouter.join` builds (the engine's load-time warm-up) and
  warms a NEW replica off the serving path, then enters it into rotation
  — capacity moves without a failed request;
* **death is not shed** — a replica whose batching thread dies (the
  ``fleet.replica_die`` fault site, or any real crash) has its
  queued-but-undispatched requests RE-QUEUED onto the survivors; only
  requests whose engine dispatch had already started fail (they may have
  side-effected — retrying those silently is how double-serves happen);
* **hot reload** — :meth:`FleetRouter.update_params` swaps a checkpoint
  into every live replica's engine, each swap atomic.

Per-class and per-replica :class:`~mxnet_tpu_torch.serving.health.ServingHealth`
rollups hang off the router (``class_health`` / ``replica_report``), all
mirroring up into the fleet-level ``health`` and the process-global
``serving.SERVING_HEALTH``. :meth:`FleetRouter.check` runs the static
audits of every in-rotation replica's engine (``tracecheck``, and with
``memory=``/``comms=`` the memory and communication lints).
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque

import numpy as np

from ..base import MXNetError, env_float, env_int
from ..obs import trace as _obs
from .batcher import (Batcher, REQUEST_IDS, Settleable, ServingClosedError,
                      ServingDeadlineError, ServingOverloadedError)
from .health import ServingHealth, SERVING_HEALTH

#: priority classes, highest first — dispatch order is strict priority
CLASSES = ("interactive", "batch")

#: replica lifecycle states
JOINING = "joining"
ACTIVE = "active"
DRAINING = "draining"
RETIRED = "retired"
DEAD = "dead"

#: faults.py site fired once per collected batch on every fleet-managed
#: replica's batching thread — the ``die`` kind kills that replica
_REPLICA_DIE_SITE = "fleet.replica_die"


def _class_deadline_s(priority):
    if priority == "interactive":
        return env_float("MXTPU_FLEET_INTERACTIVE_DEADLINE_MS", 1000.0) / 1e3
    return env_float("MXTPU_FLEET_BATCH_DEADLINE_MS", 10000.0) / 1e3


class FleetRequest(Settleable):
    """Handle for one request riding the fleet; :meth:`result` blocks.

    A request is re-assignable until the moment a replica's batching
    thread starts its engine dispatch — ``requeues`` counts how many times
    it moved (death/drain of its assigned replica). The once-only settle
    protocol (first settle wins, ``on_done`` fires exactly once) is shared
    with the batcher's request via :class:`~.batcher.Settleable`."""

    __slots__ = ("inputs", "n", "priority", "deadline", "requeues",
                 "_health", "rid")

    def __init__(self, inputs, n, priority, deadline, on_done=None,
                 health=None):
        super().__init__(on_done=on_done)
        self.inputs = inputs
        self.n = n
        self.priority = priority
        self.deadline = deadline
        self.requeues = 0
        self._health = health    # this request's class ServingHealth
        #: serving correlation id — threaded into every replica assignment, so one request's spans share one id
        #: across the router and whichever batcher(s) it rides
        self.rid = next(REQUEST_IDS)

    def result(self, timeout=None):
        """Block until served (or failed); returns the engine output list
        sliced to this request's rows. Self-expires on the request's
        deadline like :meth:`Batcher.wait` — never a hang."""
        limit = None if timeout is None else time.monotonic() + timeout
        while not self.event.is_set():
            now = time.monotonic()
            remaining = self.deadline - now
            if remaining <= 0:
                if self.fail(ServingDeadlineError(
                        "deadline passed while waiting for the fleet")) \
                        and self._health is not None:
                    # self-expiry is still a class-attributed expiry: the
                    # dispatcher will silently skip the settled request
                    self._health.record_expired(self.error)
                break
            if limit is not None and now > limit:
                raise MXNetError("FleetRequest.result: timed out after "
                                 "%.1fs" % timeout)
            slice_s = min(remaining, 0.2)
            if limit is not None:
                slice_s = min(slice_s, max(0.0, limit - now))
            if self.event.wait(slice_s):
                break
        if self.error is not None:
            raise self.error
        return self.value


class _Replica(object):
    __slots__ = ("name", "batcher", "state", "assigned", "resolved",
                 "requeued_from", "died")

    def __init__(self, name, batcher, state=ACTIVE):
        self.name = name
        self.batcher = batcher
        self.state = state
        self.assigned = 0       # requests handed to this replica's batcher
        self.resolved = 0       # of those, settled (served/failed/requeued)
        self.requeued_from = 0  # moved off this replica instead of shed
        self.died = None        # the exception that killed it

    @property
    def in_flight(self):
        return self.assigned - self.resolved

    def report(self):
        return {"state": self.state, "assigned": self.assigned,
                "resolved": self.resolved, "in_flight": self.in_flight,
                "requeued_from": self.requeued_from,
                "died": None if self.died is None else repr(self.died),
                # engine identity: a warm rejoin shares its predecessor's
                # engine, and engine-level counters must not be
                # double-counted across such replicas
                "engine": self.batcher.engine.name,
                # mesh positions one replica's engine spans
                "model_devices": int(self.batcher.engine.model_devices),
                "health": self.batcher.health.report(),
                "engine_health": self.batcher.engine.health.report()}


class FleetRouter(object):
    """Priority-aware router over N serving replicas.

    ``replicas`` is a dict ``{name: Batcher}`` (or a list of
    :class:`Batcher`, auto-named ``r0, r1, ...``); each replica is its own
    engine + batching thread. All replica engines must agree on the
    input/output signature.

    ``infer(inputs, priority=...)`` blocks; ``submit`` returns a
    :class:`FleetRequest`. Knobs (ctor > ``MXTPU_FLEET_*`` env > default):
    per-class router queue bound ``MXTPU_FLEET_QUEUE`` (1024), class
    default deadlines ``MXTPU_FLEET_INTERACTIVE_DEADLINE_MS`` (1000) /
    ``MXTPU_FLEET_BATCH_DEADLINE_MS`` (10000), dispatcher liveness tick
    ``MXTPU_FLEET_TICK_MS`` (20).
    """

    def __init__(self, replicas=None, queue_size=None, tick_ms=None,
                 health=None, name="fleet"):
        self.name = name
        self.queue_size = int(queue_size if queue_size is not None
                              else env_int("MXTPU_FLEET_QUEUE", 1024))
        if self.queue_size < 1:
            raise MXNetError("FleetRouter: queue_size must be positive, "
                             "got %d" % self.queue_size)
        self.tick = (tick_ms if tick_ms is not None
                     else env_float("MXTPU_FLEET_TICK_MS", 20.0)) / 1e3
        self.health = health or ServingHealth(parent=SERVING_HEALTH)
        #: per-class rollups; every class event mirrors into ``health``
        self.class_health = {c: ServingHealth(parent=self.health)
                             for c in CLASSES}
        self._lock = threading.RLock()
        self._queues = {c: deque() for c in CLASSES}
        self._replicas = {}
        self._spec = None       # (input_names, shapes, dtypes, row_factor)
        self._closed = False
        self._work = threading.Event()
        self._join_errors = []
        if replicas is not None:
            if not isinstance(replicas, dict):
                replicas = {"r%d" % i: b for i, b in enumerate(replicas)}
            for rname, b in replicas.items():
                self.add_replica(rname, b)
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="mxtpu-fleet-router",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------
    def _engine_spec(self, engine):
        return (tuple(engine._input_names),
                {n: tuple(s) for n, s in engine._input_shapes.items()},
                {n: np.dtype(d) for n, d in engine._input_dtypes.items()},
                tuple(engine._out_row_factor))

    def add_replica(self, name, batcher):
        """Enter a ready (already-warmed) replica into rotation."""
        if not isinstance(batcher, Batcher):
            batcher = Batcher(batcher)   # bare engine: wrap it
        spec = self._engine_spec(batcher.engine)
        with self._lock:
            if self._closed:
                raise ServingClosedError("fleet router is closed")
            if name in self._replicas \
                    and self._replicas[name].state not in (RETIRED, DEAD):
                raise MXNetError("FleetRouter: replica %r already in "
                                 "rotation" % name)
            if self._spec is None:
                self._spec = spec
            elif spec != self._spec:
                raise MXNetError(
                    "FleetRouter: replica %r input/output signature does "
                    "not match the fleet's — every replica must serve the "
                    "same model surface" % name)
            # arm the fleet fault site on the replica's batching thread
            # (inert until a faults.py rule targets it)
            if batcher._fault_site is None:
                batcher._fault_site = _REPLICA_DIE_SITE
            self._replicas[name] = _Replica(name, batcher)
        self._work.set()
        return self

    def join(self, name, factory, warmup=True, block=True):
        """Build + warm a NEW replica off the serving path, then enter it
        into rotation.

        ``factory()`` runs on the joining thread (this caller with
        ``block=True``, a background thread otherwise) and returns a
        :class:`Batcher` or a bare ``ServingEngine`` — typically it
        constructs the engine, paying its load and warm-up WHILE the fleet
        keeps serving. ``warmup=True`` additionally runs one zero-filled
        request through every bucket before rotation (these count in the
        engine's health), so the first real request on the new replica
        never pays a first-dispatch cost."""
        def build():
            b = factory()
            if not isinstance(b, Batcher):
                b = Batcher(b)
            if warmup:
                eng = b.engine
                for bucket in eng.buckets:
                    zeros = {n: np.zeros((bucket,) + eng._input_shapes[n],
                                         eng._input_dtypes[n])
                             for n in eng._input_names}
                    eng.infer(zeros)
            self.add_replica(name, b)

        if block:
            build()
            return self
        def run():
            try:
                build()
            except Exception as e:   # surfaced via join_errors + log
                logging.exception("FleetRouter: background join of "
                                  "replica %r failed", name)
                with self._lock:
                    self._join_errors.append((name, e))
        threading.Thread(target=run, name="mxtpu-fleet-join-%s" % name,
                         daemon=True).start()
        return self

    def drain(self, name, timeout=30.0):
        """Gracefully retire a replica: stop assigning, let it flush every
        request it already owns, close it, remove it from rotation.
        Returns the replica's final report. Zero requests are shed —
        that is the point."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                raise MXNetError("FleetRouter: no replica %r" % name)
            if rep.state not in (ACTIVE, DRAINING):
                raise MXNetError("FleetRouter: replica %r is %s, not "
                                 "drainable" % (name, rep.state))
            rep.state = DRAINING
        limit = time.monotonic() + timeout
        while True:
            with self._lock:
                if rep.state == DEAD:
                    raise MXNetError(
                        "FleetRouter: replica %r died while draining "
                        "(%r); its undispatched requests were re-queued"
                        % (name, rep.died))
                if rep.in_flight == 0 and rep.batcher.backlog() == 0:
                    break
            if time.monotonic() > limit:
                raise MXNetError(
                    "FleetRouter: drain of %r timed out after %.1fs with "
                    "%d request(s) still in flight" % (name, timeout,
                                                       rep.in_flight))
            time.sleep(min(self.tick, 0.05))
        rep.batcher.close()   # queue verified empty: nothing to shed
        with self._lock:
            rep.state = RETIRED
        return rep.report()

    def update_params(self, arg_params, aux_params=None):
        """Hot-reload parameters into EVERY in-rotation replica's engine
        (:meth:`ServingEngine.update_params` fanned out) — the fleet half
        of the train-to-serve handoff. Replicas
        sharing one engine (a warm rejoin) reload once; retired/dead
        replicas are skipped. Each engine's swap is atomic, so a request
        in flight during the rollout serves from either the old or the
        new set, never a mix — the fleet is briefly mixed-version, which
        is the standard rolling-update semantics. Returns the engine
        names reloaded."""
        with self._lock:
            if self._closed:
                raise ServingClosedError("fleet router is closed")
            engines, seen = [], set()
            for r in self._replicas.values():
                if r.state in (DEAD, RETIRED):
                    continue
                eng = r.batcher.engine
                if id(eng) not in seen:
                    seen.add(id(eng))
                    engines.append(eng)
        if not engines:
            raise MXNetError("FleetRouter.update_params: no live replicas "
                             "to reload")
        for eng in engines:
            eng.update_params(arg_params, aux_params)
        _obs.instant("fleet_param_reload", engines=len(engines))
        return [eng.name for eng in engines]

    # ------------------------------------------------------------------
    # request path
    # ------------------------------------------------------------------
    def submit(self, inputs, priority="interactive", deadline_ms=None,
               on_done=None):
        """Enqueue one request; returns a :class:`FleetRequest`."""
        if priority not in CLASSES:
            raise MXNetError("FleetRouter: priority must be one of %s, "
                             "got %r" % (CLASSES, priority))
        ch = self.class_health[priority]
        with self._lock:
            if self._closed:
                raise ServingClosedError("fleet router is closed")
            if self._spec is None:
                raise MXNetError("FleetRouter: no replicas — add_replica/"
                                 "join one before submitting")
            names, shapes, dtypes, _ = self._spec
        # validate HERE, once, against the fleet signature — a malformed
        # request fails its caller alone, never a co-rider or a replica
        n = None
        host = {}
        for nm in names:
            if nm not in inputs:
                raise MXNetError("submit: missing input %r (need %s)"
                                 % (nm, list(names)))
            v = np.asarray(inputs[nm], dtypes[nm])
            if tuple(v.shape[1:]) != shapes[nm]:
                raise MXNetError("submit: input %r per-example shape %s "
                                 "!= %s" % (nm, tuple(v.shape[1:]),
                                            shapes[nm]))
            if n is None:
                n = v.shape[0]
            elif v.shape[0] != n:
                raise MXNetError("submit: inputs disagree on batch size")
            host[nm] = v
        if n == 0:
            raise MXNetError("submit: empty request")
        deadline = time.monotonic() + (
            deadline_ms / 1e3 if deadline_ms is not None
            else _class_deadline_s(priority))
        freq = FleetRequest(host, n, priority, deadline, on_done=on_done,
                            health=ch)
        with self._lock:
            if self._closed:
                raise ServingClosedError("fleet router is closed")
            q = self._queues[priority]
            if len(q) >= self.queue_size:
                err = ServingOverloadedError(
                    "fleet %s queue full (%d waiting) — shed at the edge"
                    % (priority, len(q)))
                ch.record_dropped(err)
                raise err
            q.append(freq)
        _obs.instant("fleet_submit", req=freq.rid, priority=priority, n=n)
        ch.record_request()
        self._work.set()
        return freq

    def infer(self, inputs, priority="interactive", deadline_ms=None):
        """Blocking inference through the fleet."""
        return self.submit(inputs, priority=priority,
                           deadline_ms=deadline_ms).result()

    # ------------------------------------------------------------------
    # dispatcher
    # ------------------------------------------------------------------
    def _dispatch_loop(self):
        while True:
            self._work.wait(timeout=self.tick)
            self._work.clear()
            if self._closed:
                return
            try:
                self._check_replicas()
                self._assign_ready()
            except Exception:
                # the router thread must survive anything a replica does
                logging.exception("FleetRouter: dispatcher error")

    def _check_replicas(self):
        """Death detection: a replica whose batching thread is gone has
        its queued-but-undispatched requests re-queued onto survivors."""
        with self._lock:
            suspects = [r for r in self._replicas.values()
                        if r.state in (ACTIVE, DRAINING)
                        and r.batcher._thread is not None
                        and not r.batcher._thread.is_alive()]
        for rep in suspects:
            self._handle_death(rep)

    def _handle_death(self, rep):
        with self._lock:
            if rep.state not in (ACTIVE, DRAINING):
                return   # already handled, or retired on purpose
            b = rep.batcher
            # distinguish a CRASH from a deliberate close racing a
            # drain/close: a cleanly closed batcher (dead unset, _closed
            # set) is not a death — relabeling a drained replica DEAD
            # would be a false operational alarm
            crashed = b.dead is not None or (
                not b._closed and b._thread is not None
                and not b._thread.is_alive())
            if not crashed:
                return
            rep.state = DEAD
            rep.died = b.dead or MXNetError(
                "replica batching thread died")
        logging.warning("FleetRouter: replica %r died (%r) — re-queueing "
                        "its undispatched requests", rep.name, rep.died)
        # post-mortem: the replica's recent request spans + the fleet's
        # counters, on disk before recovery re-queues a single request;
        # dump() never raises
        from ..obs import flight as _flight
        _obs.instant("replica_death", replica=rep.name,
                     error=repr(rep.died))
        _flight.dump("fleet replica %r died: %r" % (rep.name, rep.died),
                     extra={"replica": rep.name,
                            "report": rep.report()})
        # queued-but-undispatched: safe to serve elsewhere (in-flight
        # dispatched requests were already failed by the dying thread,
        # or settle through on_done as shed — those may have side-effected
        # and are NOT retried). take_queued() is oldest-first and
        # _requeue pushes to the FRONT, so iterate newest-first to keep
        # the longest-waiting request first in the queue.
        for breq in reversed(rep.batcher.take_queued()):
            freq = getattr(breq, "on_done", None)
            freq = getattr(freq, "_freq", None) if freq else None
            if freq is not None:
                with self._lock:
                    rep.resolved += 1
                self._requeue(freq, rep)
            else:   # not a fleet request (direct submit to the batcher)
                breq.fail(ServingClosedError(
                    "replica %r died with the request queued" % rep.name))
        self._work.set()

    def _requeue(self, freq, rep):
        """Move a request off a dead replica back into its class queue —
        the no-silent-shed path. Requeues go to the FRONT (they have
        waited longest) unless the router is closing, where they fail."""
        if freq.done():
            return
        ch = self.class_health[freq.priority]
        with self._lock:
            rep.requeued_from += 1
            if not self._closed:
                freq.requeues += 1
                self._queues[freq.priority].appendleft(freq)
                requeued = True
            else:
                requeued = False
        if requeued:
            ch.record_requeued()
            self._work.set()
        else:
            if freq.fail(ServingClosedError("fleet router closed while "
                                            "re-queueing")):
                ch.record_shed(1)

    def _push_front(self, freq):
        """Return a popped-but-unassignable request to the front of its
        class queue — or, if the router closed while the dispatcher held
        it (close() has already drained and shed the queues), fail it NOW:
        re-inserting into an abandoned queue would strand the request
        unsettled until its deadline."""
        with self._lock:
            if not self._closed:
                self._queues[freq.priority].appendleft(freq)
                return
        if freq.fail(ServingClosedError("fleet router closed")):
            self.class_health[freq.priority].record_shed(1)

    def _on_settled(self, freq, rep, breq):
        """Completion hook run by the replica that settled the request."""
        with self._lock:
            rep.resolved += 1
        ch = self.class_health[freq.priority]
        err = breq.error
        if err is None:
            freq.fulfill(breq.value)
            self._work.set()   # capacity freed: assign the next request
            return
        if isinstance(err, ServingClosedError) and not breq.dispatched:
            # the replica went away with this request still queued —
            # serve it elsewhere instead of shedding it
            self._requeue(freq, rep)
            return
        if freq.fail(err):
            if isinstance(err, ServingDeadlineError):
                ch.record_expired(err)
            elif isinstance(err, ServingClosedError):
                ch.record_shed(1, err)
            else:
                ch.record_error(err)

    def _assign_ready(self):
        while True:
            expired = []
            with self._lock:
                freq = None
                # STRICT priority: batch drains only when interactive is
                # empty; an expired request is failed at pop so it never
                # occupies a dispatch a live request wanted (the fail —
                # which runs the caller's on_done — happens OUTSIDE the
                # lock, same invariant as Batcher._shed)
                for cls in CLASSES:
                    q = self._queues[cls]
                    while q:
                        cand = q.popleft()
                        if cand.done():
                            continue
                        if time.monotonic() > cand.deadline:
                            expired.append(cand)
                            continue
                        freq = cand
                        break
                    if freq is not None:
                        break
                # least-loaded ACTIVE replica (draining/joining/dead
                # replicas take no new work)
                active = sorted(
                    (r for r in self._replicas.values()
                     if r.state == ACTIVE),
                    key=lambda r: r.in_flight) if freq is not None else []
            for cand in expired:
                if cand.fail(ServingDeadlineError(
                        "expired in the fleet %s queue" % cand.priority)):
                    self.class_health[cand.priority].record_expired(
                        cand.error)
            if freq is None:
                return
            if not active:
                self._push_front(freq)
                return   # retry on the next tick / membership change
            assigned = False
            for rep in active:
                remaining_ms = (freq.deadline - time.monotonic()) * 1e3
                if remaining_ms <= 0:
                    if freq.fail(ServingDeadlineError(
                            "expired while assigning")):
                        self.class_health[freq.priority].record_expired(
                            freq.error)
                    assigned = True
                    break
                hook = _SettleHook(self, freq, rep)
                try:
                    with self._lock:
                        rep.assigned += 1
                    rep.batcher.submit(freq.inputs,
                                       deadline_ms=remaining_ms,
                                       on_done=hook, rid=freq.rid)
                    _obs.instant("fleet_assign", req=freq.rid,
                                 replica=rep.name)
                    assigned = True
                    break
                except ServingOverloadedError:
                    with self._lock:
                        rep.resolved += 1   # submit failed: not in flight
                    continue   # replica saturated — try the next one
                except ServingClosedError:
                    with self._lock:
                        rep.resolved += 1
                    self._handle_death(rep)
                    continue
                except Exception as e:
                    with self._lock:
                        rep.resolved += 1
                    if freq.fail(e):
                        self.class_health[freq.priority].record_error(e)
                    assigned = True
                    break
            if not assigned:
                # every active replica is saturated: requests stay in the
                # ROUTER queue (deadline-aware), not on a replica
                self._push_front(freq)
                return

    # ------------------------------------------------------------------
    def close(self):
        """Stop the router and every replica; queued requests are shed
        with :class:`ServingClosedError`."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = []
            for cls in CLASSES:
                while self._queues[cls]:
                    pending.append(self._queues[cls].popleft())
            reps = list(self._replicas.values())
        self._work.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        exc = ServingClosedError("fleet router closed")
        by_cls = {c: 0 for c in CLASSES}
        for freq in pending:
            if freq.fail(exc):
                by_cls[freq.priority] += 1
        for c, k in by_cls.items():
            if k:
                self.class_health[c].record_shed(k, exc)
        for rep in reps:
            if rep.state not in (RETIRED, DEAD):
                rep.batcher.close()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def replica_names(self, states=(ACTIVE, DRAINING, JOINING)):
        with self._lock:
            return [r.name for r in self._replicas.values()
                    if r.state in states]

    def replica_report(self):
        """Per-replica rollup: state, load, and the replica's batcher +
        engine :class:`ServingHealth` counters."""
        with self._lock:
            return {r.name: r.report() for r in self._replicas.values()}

    def report(self):
        """Fleet rollup: per-class and per-replica health."""
        with self._lock:
            queued = {c: len(self._queues[c]) for c in CLASSES}
            join_errors = [(n, repr(e)) for n, e in self._join_errors]
        return {"fleet": self.health.report(),
                "classes": {c: h.report()
                            for c, h in self.class_health.items()},
                "queued": queued,
                "replicas": self.replica_report(),
                "join_errors": join_errors}

    def weight_report(self):
        """Resident weight bytes across the fleet's engines, AS STORED
        (int8/bf16 after quantization, not f32 equivalents), with the
        share of one mesh position (the whole for a single-device engine).
        Replicas sharing one engine (warm rejoin) are counted once."""
        out = {}
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.state not in (DEAD, RETIRED)]
        seen = set()
        for r in reps:
            eng = r.batcher.engine
            if id(eng) in seen:
                continue
            seen.add(id(eng))
            total = int(eng.weight_bytes())
            ndev = int(eng.model_devices)
            out[eng.name] = {"weight_bytes": total,
                             "model_devices": ndev,
                             "bytes_per_chip": (int(eng.weight_bytes(0))
                                                if ndev > 1 else total),
                             "quantize": eng.quant_mode}
        return out

    def check(self, memory=False, comms=False):
        """Static-analyze every in-rotation replica's program set
        (``tracecheck``, plus the memory and communication lints):
        ``engine.check(memory=, comms=)`` of each. Replicas sharing one
        engine (a warm rejoin) are audited once, and retired or dead
        replicas are not. Returns the findings."""
        findings = []
        with self._lock:
            engines = []
            seen = set()
            for r in self._replicas.values():
                if r.state in (DEAD, RETIRED):
                    continue
                eng = r.batcher.engine
                if id(eng) not in seen:
                    seen.add(id(eng))
                    engines.append(eng)
        for eng in engines:
            findings += eng.check(memory=memory, comms=comms)
        return findings


class _SettleHook(object):
    """on_done callable carrying its FleetRequest visibly (the death path
    introspects ``_freq`` to re-queue without settling)."""

    __slots__ = ("_router", "_freq", "_rep")

    def __init__(self, router, freq, rep):
        self._router = router
        self._freq = freq
        self._rep = rep

    def __call__(self, breq):
        self._router._on_settled(self._freq, self._rep, breq)
