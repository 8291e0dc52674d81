"""mxnet_tpu_torch: the PyTorch and CUDA port of mxnet_tpu.

A second package beside ``mxnet_tpu`` (the JAX reference, which stays as
it is). It uses the reference's module names, reads and writes the same
files (NNVM symbol JSON and dmlc ``.params``), and imports ``torch`` and
numpy only, never ``jax`` or ``mxnet_tpu``. Entry points run on the card
(``cuda:0``) unless the caller asks for the CPU.

Ported so far: the SSD detector served through
:class:`serving.ServingEngine`, with the MultiBox NMS sweep as a
hand-written CUDA kernel (``ops/multibox_nms.py``, ``csrc/``); ResNet
training through :class:`train_step.TrainStep` (SGD with momentum, f32
masters with bf16 compute), with the Conv1x1->BatchNorm fusion's
matmul-with-statistics as a hand-written CUDA kernel
(``ops/matmul_stats.py``, ``csrc/``); the imperative and bind API:
``nd`` with every tensor and update op, ``autograd``, ``Symbol.bind``/
``simple_bind`` and :class:`executor.Executor`, ``operator.CustomOp``,
``rtc`` (user kernels: Triton through ``TritonKernel``, CUDA source
through ``Rtc`` and NVRTC); and the Module API: ``mod.Module`` with
``fit`` (per-step and K-step dispatch through ``TrainStep``), ``score``,
``predict`` and checkpoints, with ``io`` (``NDArrayIter``,
``SuperBatchIter``), ``metric``, ``callback``, the ``local`` ``kv``store,
``model`` and ``engine``; and the serving tier: ``serving.Batcher``,
``serving.FleetRouter``, quantized weights and hot reload in
``ServingEngine``, :class:`Predictor`, with ``faults``, ``obs``'s metrics
registry and the tuning-DB knob resolution of ``autotune``; and the rest
of the training API: checkpoint and resume (``model.CheckpointManager``,
``model.AsyncCheckpointWriter``, ``fit(resume=, checkpoint_*=)``), the
training ``guard``, ``TrainStep``'s ``remat`` and ``MXTPU_BF16_STATS``,
``model.FeedForward``, and the AlexNet, VGG and Inception-BN ``models``
with ``Dropout`` and ``LRN``; and the data tier: ``recordio`` (with the
native reader and JPEG decoder built from ``src/io`` by ``native_build``),
``image`` (``ImageRecordIter``, ``ImageIter``, ``ImageDetIter``), ``data``'s
sharded reader, decode worker pool and pipeline statistics, and ``io``'s
``CSVIter``, ``MNISTIter``, ``DataHealth`` and retry policy; and variable
length: the ``RNN`` op, ``rnn``'s cells, ``BucketSentenceIter`` and RNN
checkpoints, ``mod.BucketingModule``, ``SequentialModule``,
``PythonModule`` and ``PythonLossModule``; and the single-process
observability: :class:`Monitor`, ``profiler`` (a Chrome trace from
``torch.profiler``), ``obs``'s windowed deltas and Prometheus export.
"""
from .base import MXNetError, TrainingPreemptedError, __version__
from . import base
from . import engine
from .context import Context, cpu, gpu, cpu_pinned, current_context
from . import ndarray
from . import ndarray as nd
from . import ops
from . import symbol
from . import symbol as sym
from .symbol import Symbol, Variable, Group, AttrScope
from .ndarray import NDArray
from . import autograd
from . import executor
from . import parallel
from .executor import Executor
from . import executor_manager
from . import random
from . import initializer
from . import lr_scheduler
from . import optimizer
from . import metric
from . import io
from . import data
from . import kvstore
from . import kvstore as kv
from . import callback
from . import model
from .model import FeedForward
from . import module
from . import module as mod
from . import monitor
from .monitor import Monitor
from . import rnn
from . import profiler
from . import train_step
from .train_step import TrainStep
from . import predictor
from .predictor import Predictor
from . import faults
from . import guard
from .guard import TrainingGuard, TrainingHealth, TrainingDivergedError
from . import autotune
from . import serving
from . import models
from . import recordio
from . import image
from . import convert
from . import operator   # registers the Custom op type
from . import rtc

# refresh the op namespaces so late registrations (Custom) appear
ndarray._init_ndarray_module()
symbol._init_symbol_module()
