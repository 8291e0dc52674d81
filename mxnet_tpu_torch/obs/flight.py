"""Flight recorder: a bounded ring of the recent host spans and a ring of
per-dispatch counter deltas.

The port's own copy of ``mxnet_tpu/obs/flight.py``: every finished span of
:mod:`.trace` lands in a bounded deque, and every :func:`note` (``fit``
notes each retired dispatch) appends a mark carrying the metrics
registry's counter delta since the previous note (read through a
:class:`~.registry.Window`, only the keys that moved), so the last
dispatches' timeline and what each moved are in memory when a run dies.
:func:`dump` writes them (``spans``, ``counter_deltas``) with the
registry's snapshot as a post-mortem JSON (a serving batcher's thread
death and a fleet replica's death dump). On by default, as in the JAX
package (``MXTPU_FLIGHT_RECORDER``, set ``0`` to turn it off and make
``obs.span`` a no-op when tracing is off too);
``MXTPU_FLIGHT_RECORDER_PATH`` names the dump (default
``mxtpu_flight.json``). The span ring holds the last 1024 events, the
mark ring the last 256.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque

from ..base import env_str
from . import trace as _trace
from .registry import REGISTRY

__all__ = ["FlightRecorder", "FLIGHT", "dump", "note", "enabled",
           "set_enabled"]

#: spans the ring keeps
_SPAN_RING = 1024


class FlightRecorder(object):
    """Bounded in-memory rings of spans and marks (``ring`` spans, at least
    16) over ``registry`` (the process registry by default)."""

    def __init__(self, ring=_SPAN_RING, registry=None):
        self._lock = threading.Lock()
        self._spans = deque(maxlen=max(16, int(ring)))
        self._marks = deque(maxlen=256)
        self._registry = registry or REGISTRY
        self._window = None     # the registry window the marks read
        self.dumps = 0          # dumps written
        self.last_dump_path = None
        self.last_dump = None   # the last dump document

    def on_event(self, ev):
        """Trace-sink hook: every finished span or instant lands here."""
        with self._lock:
            self._spans.append(ev)

    def note(self, marker, **ids):
        """Append one mark with the registry's counter delta since the
        previous note (``fit`` notes each retired dispatch with
        ``dispatch=i``); the first note starts the window with an empty
        delta. Never raises."""
        try:
            with self._lock:
                if self._window is None:
                    self._window = self._registry.window()
                    delta = {}
                else:
                    delta = {k: v for k, v in self._window.delta().items()
                             if isinstance(v, (int, float))
                             and not isinstance(v, bool) and v}
                self._marks.append({"marker": marker, "t": time.time(),
                                    **ids, "delta": delta})
        except Exception:
            logging.getLogger("mxnet_tpu_torch").exception(
                "obs: flight-recorder note failed (continuing)")

    def spans(self):
        with self._lock:
            return list(self._spans)

    def marks(self):
        with self._lock:
            return list(self._marks)

    def clear(self):
        """Empty both rings and restart the counter window."""
        with self._lock:
            self._spans.clear()
            self._marks.clear()
            self._window = None
            self.dumps = 0
            self.last_dump_path = None
            self.last_dump = None

    def dump(self, reason, path=None, extra=None):
        """Write the post-mortem JSON (spans, the marks as
        ``counter_deltas``, the registry's snapshot, ``extra``); returns the path, or None when disabled or
        the write failed (logged, never raised: this runs inside failure
        paths)."""
        if not enabled():
            return None
        try:
            with self._lock:
                spans = list(self._spans)
                marks = list(self._marks)
            doc = {"reason": str(reason), "time": time.time(),
                   "pid": os.getpid(), "spans": spans,
                   "counter_deltas": marks,
                   "counters": self._registry.snapshot()}
            if extra:
                try:
                    json.dumps(extra)
                    doc["extra"] = extra
                except (TypeError, ValueError):
                    doc["extra"] = {"unserializable": repr(extra)}
            from ..model import atomic_write_bytes
            path = path or env_str("MXTPU_FLIGHT_RECORDER_PATH",
                                   "mxtpu_flight.json")
            atomic_write_bytes(path, json.dumps(doc).encode("utf-8"))
            with self._lock:
                self.dumps += 1
                self.last_dump_path = path
                self.last_dump = doc
            logging.getLogger("mxnet_tpu_torch").warning(
                "obs: flight recorder dumped %d span(s) to %s (%s)",
                len(spans), path, reason)
            return path
        except Exception:
            logging.getLogger("mxnet_tpu_torch").exception(
                "obs: flight-recorder dump failed (continuing)")
            return None


#: the process flight recorder
FLIGHT = FlightRecorder()

_enabled = os.environ.get("MXTPU_FLIGHT_RECORDER", "1").strip().lower() \
    not in ("", "0", "false", "off", "no")


def enabled():
    return _enabled


def set_enabled(on):
    """Arm or disarm at run time; also attaches or detaches the trace sink,
    so ``obs.span`` is a no-op again when tracing and recording are off."""
    global _enabled
    _enabled = bool(on)
    _trace.set_sink(FLIGHT.on_event if _enabled else None)


def dump(reason, path=None, extra=None):
    """Module-level shorthand: ``FLIGHT.dump(...)``."""
    return FLIGHT.dump(reason, path=path, extra=extra)


def note(marker, **ids):
    if _enabled:
        FLIGHT.note(marker, **ids)


if _enabled:
    _trace.set_sink(FLIGHT.on_event)
