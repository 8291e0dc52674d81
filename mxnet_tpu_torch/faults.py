"""Deterministic fault injection.

The port's own copy of ``mxnet_tpu/faults.py`` (pure Python; the port
imports nothing of the JAX package). A named call site counts its
invocations and an armed rule fires on exactly the nth call, so every
recovery path is tested without sleeps, races or flaky timing.

Sites the port instruments (the static registry :data:`SITES`, the JAX
package's registry name for name):

===========================  ==============================================
site                         where it fires
===========================  ==============================================
``io.record_read``           per record read (``data.ShardedRecordReader``,
                             ``image.ImageIter``); transient failures are
                             retried per the ``io.RetryPolicy``
``io.batch_read``            per batch pull in ``io.SuperBatchIter``
``io.h2d``                   per stacked superbatch slot's copy to the
                             device
``superbatch.producer``      top of the ``SuperBatchIter`` producer loop —
                             ``"die"`` ends the thread without its end
                             marker; the consumer raises naming the site
``data.worker_die``          per claimed batch task in a
                             ``data.DecodeWorkerPool`` worker — ``"die"``
                             ends the worker holding its batch; the
                             consumer raises naming the site
``data.decode_delay``        per batch task before the decode — a slow
                             worker (``"delay"``)
``checkpoint.write``         before an atomic checkpoint file write
                             (``model.atomic_write_bytes``); ``"truncate"``
                             publishes half the payload (a torn write the
                             manifest's checksum catches at load)
``checkpoint.write.mid``     after half the payload is written
``ckpt.disk_full``           inside ``model.atomic_write_bytes`` after half
                             the payload — ENOSPC: the temp file is removed
                             and an :class:`MXNetError` names the path
``ckpt.async_write``         on the async checkpoint writer thread, before
                             a save's first byte (the save is dropped and
                             counted in the writer's ``errors``)
``ckpt.async_die``           top of an async save — ``"die"`` kills the
                             writer thread mid-job
``guard.grad_nan``           per train step of a GUARDED fused dispatch —
                             poisons the gradients with NaN on the device
                             (fired through :func:`fire_flag`)
``guard.loss_spike``         per guarded dispatch observation — inflates
                             the loss the divergence watcher sees
``guard.param_nan``          at checkpoint save — forces the manifest's
                             known-good bit off
``serve.enqueue_drop``       per ``serving.Batcher.submit`` — ``"drop"``
                             rejects the request with
                             ``ServingOverloadedError`` (back-pressure
                             shed at the edge)
``serve.decode_die``         top of every ``serving.DecodeLoop`` iteration
                             — ``"die"`` kills the loop
``serve.sample``             per decode step, before the sampled-token
                             dispatch
``serve.spec_verify``        per speculative round, between the draft
                             chain and the target's verify pass (no draft
                             token is emitted unverified); at any of the
                             three decode sites a raising kind kills the
                             loop thread, which sheds every sequence in
                             flight and queued with ``ServingClosedError``
``fleet.replica_die``        once per collected batch on every
                             fleet-managed replica's batching thread —
                             ``"die"`` (or any raising kind) kills that
                             replica; the ``serving.FleetRouter`` detects
                             the death and RE-QUEUES the replica's
                             queued-but-undispatched requests onto the
                             surviving replicas (no hang, no silent shed;
                             only requests whose engine dispatch had
                             already started fail)
``kvstore.push``             before a ``KVStore`` push (``"transient"`` and
                             ``"drop"`` are retried per the fault policy)
``kvstore.pull``             before a ``KVStore`` pull
``kvstore.barrier``          before a ``KVStore`` barrier
``kvstore.dead_node``        inside ``KVStore.check_health`` — ``"dead:N"``
                             reports N dead workers (a drill; the dist
                             chaos scenario kills real processes instead)
``kv.worker_die``            top of every ``dist_ring.Ring`` collective —
                             ``"die"`` SIGKILLs this process
``kv.push_delay``            before a dist push (sync and async) — makes
                             this worker a straggler
``kv.partition``             per peer-key poll inside a ring fetch —
                             ``"drop"`` requeues the read; a persistent
                             partition ends in ``KVStoreTimeoutError``
``kv.reform_delay``          before the re-form leader publishes a
                             membership proposal — a slow leader
===========================  ==============================================

Rule kinds:

- ``"raise"``      raise :class:`InjectedFault`
- ``"transient"``  raise :class:`InjectedTransientFault` (retry-eligible)
- ``"delay"``      ``time.sleep(delay)`` then continue (timeout testing)
- any other string is returned from :func:`fire` for the site to interpret
  (``"drop"`` at ``serve.enqueue_drop`` and ``kv.partition``, ``"die"``
  at ``fleet.replica_die`` and ``kv.worker_die``, ``"dead:N"`` at
  ``kvstore.dead_node``)

Arming is programmatic (``faults.inject(site, nth=3, kind="drop")``, the
:func:`scoped` context manager, or :func:`arm` with a list of rule dicts
checked against :data:`SITES`, which :class:`plan_scope` arms for a block
and clears after it; :func:`fired_counts` tells which rules fired) or
environment-driven for subprocess tests::

    MXTPU_FAULTS="serve.enqueue_drop@3=drop*2,fleet.replica_die@1=die"

meaning: calls 3 and 4 to ``serve.enqueue_drop`` drop their request, and
the first batch collected on a fleet replica kills it. Everything is
guarded by one lock, so threads count against the same clock.
"""
from __future__ import annotations

import os
import threading
import time

from .base import MXNetError


class InjectedFault(MXNetError):
    """A failure fired by the fault-injection registry."""

    def __init__(self, site, attempt, kind="raise"):
        self.site = site
        self.attempt = attempt
        self.kind = kind
        super().__init__("injected %s fault at %s (call #%d)"
                         % (kind, site, attempt))


class InjectedTransientFault(InjectedFault):
    """A retry-eligible injected failure (retry helpers treat this like a
    transient IO/network error)."""

    def __init__(self, site, attempt):
        super().__init__(site, attempt, kind="transient")


class _Rule(object):
    __slots__ = ("site", "nth", "times", "kind", "exc", "delay")

    def __init__(self, site, nth, times, kind, exc, delay):
        self.site = site
        self.nth = int(nth)
        self.times = int(times)
        self.kind = kind
        self.exc = exc
        self.delay = delay

    def covers(self, call_no):
        return self.nth <= call_no < self.nth + self.times


_lock = threading.RLock()
_rules = {}     # site -> [_Rule]
_counts = {}    # site -> total fire() calls
_fired = {}     # site -> calls where an armed rule actually matched
_env_loaded = False


class SiteInfo(object):
    """Static metadata for one registered fault site. ``kinds`` are the
    rule kinds that exercise a real recovery path at this site; ``flag``
    marks the :func:`fire_flag` data-poison sites; ``scenarios`` names the
    workloads that reach the site."""

    __slots__ = ("name", "kinds", "flag", "scenarios", "doc")

    def __init__(self, name, kinds, flag, scenarios, doc):
        self.name = name
        self.kinds = tuple(kinds)
        self.flag = bool(flag)
        self.scenarios = tuple(scenarios)
        self.doc = doc

    def describe(self):
        """The site's metadata as a JSON-ready dict."""
        return {"name": self.name, "kinds": list(self.kinds),
                "flag": self.flag, "scenarios": list(self.scenarios),
                "doc": self.doc}


SITES = {}


def _register(name, kinds, scenarios, doc, flag=False):
    SITES[name] = SiteInfo(name, kinds, flag, scenarios, doc)


# The static site registry: keep it in lockstep with the instrumented call
# sites of the port.
_register("io.record_read", ("transient", "raise"), ("data",),
          "per record read in image.ImageIter")
_register("io.batch_read", ("transient", "raise"), ("train", "data"),
          "per batch pull in io.SuperBatchIter")
_register("io.h2d", ("transient", "raise"), ("train", "data"),
          "per host->device superbatch slot transfer")
_register("superbatch.producer", ("transient", "die"), ("train", "data"),
          "top of the SuperBatchIter producer loop")
_register("checkpoint.write", ("raise", "transient", "truncate"), ("train",),
          "before an atomic checkpoint file write")
_register("checkpoint.write.mid", ("raise",), ("train",),
          "mid-stream, after half the checkpoint payload is written")
_register("ckpt.disk_full", ("enospc",), ("train",),
          "inside atomic_write_bytes — ENOSPC after half the payload; the "
          "tmp file is cleaned up and an actionable MXNetError names the "
          "path (the live file is untouched)")
_register("ckpt.async_write", ("raise", "transient", "delay"), ("train",),
          "async checkpoint writer thread, before a save's first byte")
_register("ckpt.async_die", ("die",), ("train",),
          "top of an async save — kills the writer thread mid-job")
_register("guard.grad_nan", ("poison",), ("train",),
          "per guarded train step — poisons gradients with NaN on device",
          flag=True)
_register("guard.loss_spike", ("poison",), ("train",),
          "per guarded dispatch observation — inflates the watched loss",
          flag=True)
_register("guard.param_nan", ("poison",), ("train",),
          "at checkpoint save — forces the known-good bit off", flag=True)
_register("kvstore.push", ("transient", "delay"), ("dist",),
          "before a KVStore push")
_register("kvstore.pull", ("transient", "delay"), ("dist",),
          "before a KVStore pull")
_register("kvstore.barrier", ("transient", "delay"), ("dist",),
          "before a KVStore barrier")
_register("kvstore.dead_node", ("dead:1",), (),
          "inside KVStore.check_health (simulated-dead-worker drill; not "
          "chaos-sampled — the dist scenario kills REAL processes via "
          "kv.worker_die instead)")
_register("kv.worker_die", ("die",), ("dist",),
          "top of every dist_ring.Ring collective — SIGKILLs this process")
_register("kv.push_delay", ("delay",), ("dist",),
          "before a dist push — makes this worker a straggler")
_register("kv.partition", ("drop",), ("dist",),
          "per peer-key poll inside a ring fetch — drops that poll")
_register("kv.reform_delay", ("delay",), ("dist",),
          "before the re-form leader publishes a membership proposal — a "
          "slow leader; survivors converge late or raise in bounded time")
_register("serve.enqueue_drop", ("drop",), ("serve",),
          "per serving.Batcher.submit — back-pressure shed at the edge")
_register("serve.decode_die", ("die",), ("serve",),
          "top of every serving.DecodeLoop iteration — kills the loop")
_register("serve.sample", ("raise",), ("serve",),
          "per decode step before the sampled-token dispatch — a raising "
          "kind sheds every in-flight sequence (ServingClosedError)")
_register("serve.spec_verify", ("raise",), ("serve",),
          "between the draft chain and the batched target verify pass of "
          "a speculative round — the loop dies mid-round; no draft token "
          "may have been emitted without verification")
_register("fleet.replica_die", ("die",), ("serve",),
          "per collected batch on a fleet replica — kills that replica")
_register("data.worker_die", ("die", "raise"), ("data",),
          "per claimed batch task in a data.DecodeWorkerPool worker")
_register("data.decode_delay", ("delay",), ("data",),
          "per batch task before the decode stage — a slow worker")


def sites(scenario=None):
    """The static site registry, optionally filtered to the sites a
    scenario's workload reaches. Returns ``{name: SiteInfo}``."""
    if scenario is None:
        return dict(SITES)
    return {n: s for n, s in SITES.items() if scenario in s.scenarios}


def _load_env_locked():
    """Parse MXTPU_FAULTS once (lazily, under _lock)."""
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get("MXTPU_FAULTS", "").strip()
    if not spec:
        return
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            site_at, kind_times = part.split("=", 1)
            site, nth = (site_at.split("@", 1) + ["1"])[:2] \
                if "@" in site_at else (site_at, "1")
            kind, times = (kind_times.split("*", 1) + ["1"])[:2] \
                if "*" in kind_times else (kind_times, "1")
            _rules.setdefault(site.strip(), []).append(
                _Rule(site.strip(), int(nth), int(times), kind.strip(),
                      None, 0.05))
        except (ValueError, TypeError):
            raise MXNetError(
                "MXTPU_FAULTS: cannot parse %r (expected "
                "'site@nth=kind*times', e.g. 'serve.enqueue_drop@3=drop*2')"
                % part)


def inject(site, nth=1, kind="raise", times=1, exc=None, delay=0.05):
    """Arm a fault: calls ``nth .. nth+times-1`` to ``fire(site)`` trigger
    ``kind``. ``nth`` counts from 1 relative to the site's current call
    count (an already-hot site fires ``nth`` calls from *now*)."""
    with _lock:
        _load_env_locked()
        base = _counts.get(site, 0)
        _rules.setdefault(site, []).append(
            _Rule(site, base + nth, times, kind, exc, delay))


def clear(site=None):
    """Disarm rules (one site, or all) and reset call counts."""
    with _lock:
        global _env_loaded
        _env_loaded = True  # an explicit clear() also discards env rules
        if site is None:
            _rules.clear()
            _counts.clear()
            _fired.clear()
        else:
            _rules.pop(site, None)
            _counts.pop(site, None)
            _fired.pop(site, None)


def count(site):
    """Total ``fire`` calls seen at a site (for assertions in tests)."""
    with _lock:
        return _counts.get(site, 0)


def fired(site):
    """How many calls at ``site`` actually matched an armed rule (a rule
    whose ``nth`` the workload never reached fired 0 times)."""
    with _lock:
        return _fired.get(site, 0)


def fired_counts():
    """Every site's fired count, ``{site: n}`` for the sites that fired."""
    with _lock:
        return {s: n for s, n in _fired.items() if n}


def arm(rules):
    """Arm a plan: a list of rule dicts (``{"site", "kind", "nth",
    "times", "delay"}``; ``times``/``delay`` optional). Unlike
    :func:`inject` this validates every site against the static registry
    — a plan naming an unregistered site is a bug in the plan, not a
    latent no-op."""
    for r in rules:
        site = r["site"]
        if site not in SITES:
            raise MXNetError(
                "fault plan names unregistered fault site %r (known: %s)"
                % (site, ", ".join(sorted(SITES))))
        inject(site, nth=int(r.get("nth", 1)), kind=r["kind"],
               times=int(r.get("times", 1)),
               delay=float(r.get("delay", 0.05)))


class plan_scope(object):
    """Context manager: arm a whole plan (a list of rule dicts, see
    :func:`arm`) for the duration of a block, then disarm and reset every
    site the plan touched."""

    def __init__(self, rules):
        self.rules = list(rules)

    def __enter__(self):
        arm(self.rules)
        return self

    def __exit__(self, *exc):
        for site in {r["site"] for r in self.rules}:
            clear(site)
        return False


def fire(site):
    """Hook called at an instrumented site.

    Returns ``None`` (no rule armed / not this call), or an action string
    the site interprets; raises for ``raise``/``transient`` kinds; sleeps
    for ``delay`` kind. Thread-safe; the sleep/raise happens outside the
    lock.
    """
    with _lock:
        _load_env_locked()
        call_no = _counts.get(site, 0) + 1
        _counts[site] = call_no
        hit = None
        for rule in _rules.get(site, ()):
            if rule.covers(call_no):
                hit = rule
                _fired[site] = _fired.get(site, 0) + 1
                break
    if hit is None:
        return None
    if hit.kind == "raise":
        if hit.exc is not None:
            try:
                raise hit.exc(site, call_no)
            except TypeError:
                raise hit.exc("injected fault at %s (call #%d)"
                              % (site, call_no))
        raise InjectedFault(site, call_no)
    if hit.kind == "transient":
        raise InjectedTransientFault(site, call_no)
    if hit.kind == "delay":
        time.sleep(hit.delay)
        return "delay"
    return hit.kind


def fire_flag(site):
    """Hook for sites that take a fault as DATA POISON rather than a
    control-flow exception: like :func:`fire` it counts the call and
    matches rules, but it never raises or sleeps; it returns True when any
    armed rule (of any kind) covers this call. The training guard's sites
    use it: ``guard.grad_nan`` poisons the step's gradients,
    ``guard.loss_spike`` inflates the observed loss, ``guard.param_nan``
    forces the checkpoint's known-good bit off, so the plain
    ``faults.inject(site, nth=N)`` arms each of them."""
    with _lock:
        _load_env_locked()
        call_no = _counts.get(site, 0) + 1
        _counts[site] = call_no
        for rule in _rules.get(site, ()):
            if rule.covers(call_no):
                _fired[site] = _fired.get(site, 0) + 1
                return True
    return False


class scoped(object):
    """Context manager: arm a fault for the duration of a block, then
    disarm that site and reset its count. Usage::

        with faults.scoped("serve.enqueue_drop", nth=2, kind="drop"):
            ...
    """

    def __init__(self, site, **kwargs):
        self.site = site
        self.kwargs = kwargs

    def __enter__(self):
        inject(self.site, **self.kwargs)
        return self

    def __exit__(self, *exc):
        clear(self.site)
        return False
