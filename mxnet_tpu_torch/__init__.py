"""mxnet_tpu_torch: the PyTorch and CUDA port of mxnet_tpu.

A second package beside ``mxnet_tpu`` (the JAX reference, which stays as
it is). It uses the reference's module names, reads and writes the same
files (NNVM symbol JSON and dmlc ``.params``), and imports ``torch`` and
numpy only, never ``jax`` or ``mxnet_tpu``. Entry points run on the card
(``cuda:0``) unless the caller asks for the CPU.

Ported so far: the SSD detector served through
:class:`serving.ServingEngine`, with the MultiBox NMS sweep as a
hand-written CUDA kernel (``ops/multibox_nms.py``, ``csrc/``); and ResNet
training through :class:`train_step.TrainStep` (SGD with momentum, f32
masters with bf16 compute), with the Conv1x1->BatchNorm fusion's
matmul-with-statistics as a hand-written CUDA kernel
(``ops/matmul_stats.py``, ``csrc/``).
"""
from .base import MXNetError, __version__
from . import base
from .context import Context, cpu, gpu, cpu_pinned, current_context
from . import ndarray
from . import ndarray as nd
from . import ops
from . import symbol
from . import symbol as sym
from .symbol import Symbol, Variable, Group
from .ndarray import NDArray
from . import executor
from . import random
from . import initializer
from . import lr_scheduler
from . import optimizer
from . import train_step
from .train_step import TrainStep
from . import predictor
from . import serving
from . import models
from . import convert
