"""``mxnet_tpu_torch.obs``: the host-span tracer, the metrics registry and
the flight recorder.

The port's copies of the three legs of ``mxnet_tpu/obs``: :mod:`.trace`
(``obs.span("h2d", dispatch=i)``, Chrome trace-event JSON, armed by
``MXTPU_TRACE=1``), :mod:`.registry` (``REGISTRY`` with typed counters,
gauges and histograms, and a view over the serving tier's health)
and :mod:`.flight` (the ring of recent spans and its post-mortem dump).
"""
from __future__ import annotations

from . import flight, registry, trace
from .flight import FLIGHT, FlightRecorder
from .registry import (REGISTRY, Counter, Gauge, Histogram, Registry,
                       Window, register_default_views)
from .trace import (async_complete, complete, enabled, events, instant,
                    save, span, start, stop)

__all__ = ["trace", "registry", "flight", "span", "instant", "complete",
           "async_complete", "enabled", "start", "stop", "save", "events",
           "Registry", "REGISTRY", "Counter", "Gauge", "Histogram", "Window",
           "register_default_views", "FlightRecorder", "FLIGHT"]

# the process-global health objects become registry views at import,
# lazily bound, so importing obs alone does not pull the serving tier in
register_default_views()
