"""Serving tier of the port (counterpart of ``mxnet_tpu/serving``).

Three layers over the port's graph runner:

* :class:`ServingEngine` — the stripped-head forward over a fixed set of
  batch-size buckets, each warmed at load, with weight-only quantization
  (``quantize="bf16"|"int8"``) and hot reload (``update_params``).
* :class:`Batcher` — a request queue + batching thread coalescing
  concurrent ``infer()`` calls into the smallest covering bucket, with
  max-latency / max-batch / deadline / back-pressure knobs
  (``MXTPU_SERVE_*``).
* :class:`FleetRouter` — N replicas (each its own engine + batcher)
  behind priority-aware least-loaded dispatch with elastic drain/join and
  death re-queue (``MXTPU_FLEET_*``).

Degradation is counted in :class:`ServingHealth` (process-global aggregate
``serving.SERVING_HEALTH``).

:class:`DecodeLoop` serves the transformer LM by continuous batching
(in-graph sampling, int8/bf16 weights, the prefix cache, speculative
decoding); ``generate`` returns a :class:`GenerateFuture`.
"""
from .health import ServingHealth, SERVING_HEALTH
from .engine import ServingEngine, default_buckets
from .batcher import (Batcher, ServingError, ServingDeadlineError,
                      ServingOverloadedError, ServingClosedError)
from .fleet import FleetRouter, FleetRequest, CLASSES as FLEET_CLASSES
from .decode import DecodeLoop, GenerateFuture
from .quantize import (QUANT_MODES, check_quality, quality_report,
                       quantize_tree, tree_bytes)

__all__ = [
    "ServingEngine", "Batcher", "FleetRouter", "DecodeLoop",
    "GenerateFuture", "FleetRequest",
    "FLEET_CLASSES", "ServingHealth", "SERVING_HEALTH", "default_buckets",
    "ServingError", "ServingDeadlineError", "ServingOverloadedError",
    "ServingClosedError",
    "QUANT_MODES", "check_quality", "quality_report", "quantize_tree",
    "tree_bytes",
]
