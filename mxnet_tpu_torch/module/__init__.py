"""The module API (ref: python/mxnet/module): :class:`Module` over one
device, with :class:`BaseModule`'s ``fit``, ``score`` and ``predict``."""
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "DataParallelExecutorGroup", "Module"]
