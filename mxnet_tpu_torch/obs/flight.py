"""Flight recorder: a bounded ring of the recent host spans and dispatch
marks.

The port's own copy of the ring of ``mxnet_tpu/obs/flight.py``: every
finished span of :mod:`.trace` and every :func:`note` (``fit`` notes each
retired dispatch) lands in a bounded deque, so the last dispatches'
timeline is in memory when a run dies. On by default, as in the JAX
package (``MXTPU_FLIGHT_RECORDER``, set ``0`` to turn it off and make
``obs.span`` a no-op when tracing is off too). The span ring holds the
last 1024 events. The counter-registry delta of each mark and the
post-mortem ``dump`` are not ported yet.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque

from . import trace as _trace

__all__ = ["FlightRecorder", "FLIGHT", "note", "enabled", "set_enabled"]

#: spans the ring keeps
_SPAN_RING = 1024


class FlightRecorder(object):
    """Bounded in-memory rings of spans and marks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans = deque(maxlen=_SPAN_RING)
        self._marks = deque(maxlen=256)

    def on_event(self, ev):
        """Trace-sink hook: every finished span or instant lands here."""
        with self._lock:
            self._spans.append(ev)

    def note(self, marker, **ids):
        """Append one mark (``fit`` notes each retired dispatch with
        ``dispatch=i``)."""
        with self._lock:
            self._marks.append({"marker": marker, "t": time.time(), **ids})

    def spans(self):
        with self._lock:
            return list(self._spans)

    def marks(self):
        with self._lock:
            return list(self._marks)


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


def note(marker, **ids):
    if _enabled:
        FLIGHT.note(marker, **ids)


if _enabled:
    _trace.set_sink(FLIGHT.on_event)
