"""Serving tier of the port (counterpart of ``mxnet_tpu/serving``): the
shape-bucketed :class:`ServingEngine` and its health counters."""
from .engine import ServingEngine, default_buckets
from .health import ServingHealth, SERVING_HEALTH

__all__ = ["ServingEngine", "default_buckets", "ServingHealth",
           "SERVING_HEALTH"]
