"""Default knob spaces per objective.

The port's copy of ``mxnet_tpu/autotune/space.py``.
The FIRST value of every knob is its built-in default — the search driver
relies on that to make trial #0 the default config, so every sweep's
winner is comparable against what an untuned run would have done.
"""
from __future__ import annotations

from .search import Knob


def train_space(spd_values=None, pipeline_values=None):
    """Training objectives: the steps per dispatch K and the
    deferred-readback pipeline depth."""
    return [
        Knob("steps_per_dispatch", tuple(spd_values or (1, 2, 4, 8))),
        Knob("dispatch_pipeline", tuple(pipeline_values or (1, 0, 2))),
    ]


def serve_space(bucket_values=None, latency_values=None):
    """Serving objectives: the engine's bucket set and the batcher's
    coalescing window."""
    return [
        Knob("buckets", tuple(bucket_values
                              or ("1,8,32", "1,8", "1,16,64"))),
        Knob("max_latency_ms", tuple(latency_values or (5.0, 2.0, 10.0))),
    ]


def decode_space(spec_k_values=None, prefix_values=None):
    """Decode objective: speculative draft depth (0 disables) and
    prefix-cache reuse. Both change the loop's program set."""
    return [
        Knob("spec_k", tuple(spec_k_values or (0, 2, 4))),
        Knob("prefix_cache", tuple(prefix_values or (1, 0))),
    ]


def space_for(objective, **overrides):
    if objective in ("img_per_sec", "tokens_per_sec"):
        return train_space(**overrides)
    if objective == "decode_tokens_per_sec":
        return decode_space(**overrides)
    return serve_space(**overrides)
