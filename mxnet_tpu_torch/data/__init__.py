"""``mxnet_tpu_torch.data``: the data tier.

Counterpart of ``mxnet_tpu/data``:

- :mod:`~.reader` — :class:`ShardedRecordReader`: indexed RecordIO with
  host and per-device sharding, pure-function epoch shuffling and
  thread-local handles, riding ``io.retry_call`` and ``io.DataHealth``;
- :mod:`~.workers` — :class:`DecodeWorkerPool`: N decode/augment workers,
  a bounded output queue, batches emitted in strict order, and a dead
  worker raising in the consumer instead of a hang
  (``MXTPU_DATA_WORKERS``, ``MXTPU_DATA_QUEUE``);
- :mod:`~.prefetch` — :class:`DevicePrefetcher`: the superbatch
  prefetcher ``Module.fit`` wraps around ``train_data`` for K-step
  dispatch;
- :mod:`~.stats` — :class:`PipelineStats` by stage (read, decode, stack,
  h2d, wait, stall), mirrored into :data:`PIPELINE_STATS`.

``image.ImageRecordIter(num_workers=)`` and ``image.ImageIter(
num_workers=)`` are the user-facing spellings.
"""
from . import stats
from . import reader
from . import workers
from . import prefetch
from .stats import PipelineStats, PIPELINE_STATS
from .reader import ShardedRecordReader
from .workers import DecodeWorkerPool, default_num_workers
from .prefetch import DevicePrefetcher

__all__ = ["stats", "reader", "workers", "prefetch", "PipelineStats",
           "PIPELINE_STATS", "ShardedRecordReader", "DecodeWorkerPool",
           "default_num_workers", "DevicePrefetcher"]
