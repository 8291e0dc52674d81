"""``mxnet_tpu_torch.obs``: the host-span tracer and the flight recorder.

The port's copies of two legs of ``mxnet_tpu/obs``: :mod:`.trace`
(``obs.span("h2d", dispatch=i)``, Chrome trace-event JSON, armed by
``MXTPU_TRACE=1``) and the ring of :mod:`.flight`. The metrics registry
and the flight recorder's dump are not ported yet.
"""
from __future__ import annotations

from . import flight, trace
from .flight import FLIGHT, FlightRecorder
from .trace import complete, enabled, events, instant, save, span, start, stop

__all__ = ["trace", "flight", "span", "instant", "complete", "enabled",
           "start", "stop", "save", "events", "FlightRecorder", "FLIGHT"]
