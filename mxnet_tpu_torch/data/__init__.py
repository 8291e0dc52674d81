"""``mxnet_tpu_torch.data``: the device prefetcher of the input tier.

Counterpart of the part of ``mxnet_tpu/data`` that ``Module.fit`` uses:
:class:`~.prefetch.DevicePrefetcher` and the per-stage
:class:`~.prefetch.PipelineStats` it charges. The RecordIO reader and the
decode workers are not ported yet.
"""
from . import prefetch
from .prefetch import DevicePrefetcher, PipelineStats

__all__ = ["prefetch", "DevicePrefetcher", "PipelineStats"]
