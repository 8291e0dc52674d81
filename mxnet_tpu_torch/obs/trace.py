"""Host-span tracer: one Chrome-trace-event timeline across train/data/serve.

The port's own copy of ``mxnet_tpu/obs/trace.py`` (pure Python; the port
imports nothing of the JAX package). The reference MXNet ships a
Chrome-trace engine profiler spanning compute/copy/IO
(src/engine/profiler.{h,cc}); ``torch.profiler`` covers the
DEVICE side of that story (CUPTI traces of the CUDA kernels) but says nothing
about the host threads that feed it — the data producer's stack/H2D, the
dispatch pipeline's deferred readbacks, the checkpoint writer, the serving
batcher's queue/coalesce/split. This module is the host half: a
low-overhead thread-safe span API emitting Chrome trace-event JSON
(``{"traceEvents": [...]}``) that opens in Perfetto BESIDE the device
trace, with correlation IDs (``dispatch=`` / ``req=``) threaded through
span args so one dispatch or one serving request reads as one timeline
(as in the JAX package).

Cost contract: with tracing AND the flight recorder off, :func:`span`
is one module-global flag check returning a shared no-op context manager —
no allocation, no clock read. ``MXTPU_TRACE=1`` arms it;
``MXTPU_TRACE_PATH`` names the output file (default
``mxtpu_trace.json``, written at interpreter exit and by :func:`save`).

Event model (Chrome trace-event format, the subset Perfetto renders):

- ``ph="X"`` complete events — one record per span, ``ts``+``dur`` in
  microseconds since the module epoch, ``pid``/``tid`` real process/thread
  ids with ``M`` thread-name metadata records so Perfetto labels tracks.
- ``ph="i"`` instant events (:func:`instant`) for point occurrences
  (divergence, rollback, replica death, request submit).
- ``ph="b"``/``"e"`` async pairs (:func:`async_complete`) for a region
  that begins on one thread and ends on another (a serving request's
  queue wait).
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time

from ..base import env_bool, env_str

__all__ = [
    "span", "instant", "complete", "async_complete", "enabled", "start",
    "stop", "save", "events", "clear", "trace_path", "set_sink",
]

#: hard bound on buffered events — a runaway span site degrades to a
#: dropped-events counter, never unbounded memory
_MAX_EVENTS = 200000

_lock = threading.Lock()
_events = []            # event dicts, append-only under _lock
_dropped = 0
_named_tids = set()     # tids that already emitted thread_name metadata
#: perf_counter_ns at module import — all ts are relative to this, so
#: spans from every thread share one monotonic clock
_EPOCH_NS = time.perf_counter_ns()

#: module-level fast-path flag: True when the tracer OR the flight
#: recorder needs span records. span()/instant() check ONLY this.
_ACTIVE = False
#: tracing specifically (the JSON file); flight recording may be on alone
_TRACING = False

#: optional extra consumer (the flight recorder's ring): called with the
#: finished event dict under no lock
_SINK = None


def _recompute_active():
    global _ACTIVE
    _ACTIVE = _TRACING or (_SINK is not None)


def set_sink(sink):
    """Attach/detach the secondary event consumer (the flight recorder).
    ``sink`` is ``fn(event_dict)`` or None."""
    global _SINK
    _SINK = sink
    _recompute_active()


def enabled():
    """True when spans are being recorded for the TRACE FILE (the flight
    recorder may keep span() live even when this is False)."""
    return _TRACING


def trace_path():
    return env_str("MXTPU_TRACE_PATH", "mxtpu_trace.json")


def start():
    """Arm the tracer (idempotent). ``MXTPU_TRACE=1`` does this at import."""
    global _TRACING
    _TRACING = True
    _recompute_active()


def stop():
    """Disarm the tracer; buffered events stay until :func:`clear`/
    :func:`save`."""
    global _TRACING
    _TRACING = False
    _recompute_active()


def clear():
    global _dropped
    with _lock:
        del _events[:]
        _named_tids.clear()
        _dropped = 0


def events():
    """Snapshot of the buffered trace events (tests / the CI gate)."""
    with _lock:
        return list(_events)


def _now_us():
    return (time.perf_counter_ns() - _EPOCH_NS) // 1000


def _record(ev):
    """Append one finished event: trace buffer (when tracing) + sink."""
    global _dropped
    if _TRACING:
        with _lock:
            tid = ev["tid"]
            if tid not in _named_tids:
                _named_tids.add(tid)
                _events.append({
                    "ph": "M", "name": "thread_name", "pid": ev["pid"],
                    "tid": tid,
                    "args": {"name": threading.current_thread().name}})
            if len(_events) < _MAX_EVENTS:
                _events.append(ev)
            else:
                _dropped += 1
    sink = _SINK
    if sink is not None:
        try:
            sink(ev)
        except Exception:
            pass  # the recorder must never break the traced path


class _NoopSpan(object):
    """Shared do-nothing context manager: the tracing-off fast path
    allocates nothing (one module-level instance, returned by value)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NOOP = _NoopSpan()


class _Span(object):
    __slots__ = ("name", "args", "_t0")

    def __init__(self, name, args):
        self.name = name
        self.args = args
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t0 = self._t0
        t1 = time.perf_counter_ns()
        args = self.args
        if exc_type is not None:
            args = dict(args)
            args["error"] = exc_type.__name__
        _record({"ph": "X", "name": self.name, "cat": "host",
                 "ts": (t0 - _EPOCH_NS) // 1000,
                 "dur": max(0, (t1 - t0) // 1000),
                 "pid": os.getpid(), "tid": threading.get_ident(),
                 "args": args})
        return False


def span(name, **args):
    """Context manager timing one host region as a Chrome complete event.

    ``args`` are the correlation payload (``dispatch=i``, ``req=rid``, …)
    and land in the event's ``args`` dict. When neither tracing nor the
    flight recorder is armed this returns a shared no-op instance —
    near-zero cost at every instrumented site."""
    if not _ACTIVE:
        return _NOOP
    return _Span(name, args)


def complete(name, dur_s, **args):
    """Record an ALREADY-measured region (duration in seconds) ending now.

    For sites that time themselves (SuperBatchIter's ``_note_stage``
    already wraps stack/H2D in perf_counter pairs) — the span is emitted
    after the fact with ``ts = now - dur``, which renders identically."""
    if not _ACTIVE:
        return
    now = _now_us()
    dur = max(0, int(dur_s * 1e6))
    _record({"ph": "X", "name": name, "cat": "host", "ts": now - dur,
             "dur": dur, "pid": os.getpid(),
             "tid": threading.get_ident(), "args": args})


def async_complete(name, dur_s, id, **args):
    """Record an ALREADY-measured ASYNC region (``ph="b"``/``"e"`` pair
    keyed by ``id``) ending now. For lifecycles that span threads — a
    serving request's queue wait begins on the caller thread and ends on
    the batcher thread — where a same-track complete event would overlap
    (not nest) the batcher's own spans. Perfetto renders each id as its
    own async track."""
    if not _ACTIVE:
        return
    now = _now_us()
    dur = max(0, int(dur_s * 1e6))
    pid = os.getpid()
    tid = threading.get_ident()
    _record({"ph": "b", "name": name, "cat": "async", "id": id,
             "ts": now - dur, "pid": pid, "tid": tid, "args": args})
    _record({"ph": "e", "name": name, "cat": "async", "id": id,
             "ts": now, "pid": pid, "tid": tid, "args": {}})


def instant(name, **args):
    """Record a point event (``ph="i"``, thread scope)."""
    if not _ACTIVE:
        return
    _record({"ph": "i", "name": name, "cat": "host", "s": "t",
             "ts": _now_us(), "pid": os.getpid(),
             "tid": threading.get_ident(), "args": args})


def save(path=None):
    """Write the buffered events as one Chrome-trace JSON (atomic: temp +
    rename via model.atomic_write_bytes). Returns the path written."""
    from ..model import atomic_write_bytes
    path = path or trace_path()
    with _lock:
        evs = list(_events)
        dropped = _dropped
    doc = {"traceEvents": evs, "displayTimeUnit": "ms",
           "otherData": {"producer": "mxnet_tpu_torch.obs",
                         "dropped_events": dropped}}
    atomic_write_bytes(path, json.dumps(doc).encode("utf-8"))
    return path


def _atexit_save():
    if _TRACING:
        try:
            with _lock:
                empty = not _events
            if not empty:
                save()
        except Exception:
            pass


atexit.register(_atexit_save)


def _parse_env():
    """Honor MXTPU_TRACE at import (mirrors MXTPU_GUARD's spelling rules
    via env_bool)."""
    if env_bool("MXTPU_TRACE"):
        start()


_parse_env()


def nest_check(evs):
    """Validate span nesting per (pid, tid): complete events on one thread
    must nest like a call stack (Perfetto renders overlap-but-not-nested
    spans as a corrupt track). Returns a list of violation strings, empty
    for a well-formed trace; tests and trace gates share this checker."""
    bad = []
    by_thread = {}
    for ev in evs:
        if ev.get("ph") != "X":
            continue
        by_thread.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    for key, track in by_thread.items():
        track.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for ev in track:
            end = ev["ts"] + ev["dur"]
            while stack and ev["ts"] >= stack[-1][1]:
                stack.pop()
            if stack and end > stack[-1][1]:
                bad.append(
                    "span %r [%d,%d) overlaps %r [%d,%d) on tid %s"
                    % (ev["name"], ev["ts"], end, stack[-1][0],
                       stack[-1][2], stack[-1][1], key[1]))
                continue
            stack.append((ev["name"], end, ev["ts"]))
    return bad
