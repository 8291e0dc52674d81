"""The module API (ref: python/mxnet/module): :class:`Module` over one
device, with :class:`BaseModule`'s ``fit``, ``score`` and ``predict``;
:class:`BucketingModule` for variable-length data; and the chain
:class:`SequentialModule` with :class:`PythonModule` and
:class:`PythonLossModule`."""
from ..model import BatchEndParam
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule

__all__ = ["BaseModule", "BatchEndParam", "DataParallelExecutorGroup", "Module",
           "BucketingModule", "SequentialModule", "PythonModule",
           "PythonLossModule"]
