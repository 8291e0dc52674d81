"""The error type of the JAX package's retrace checker.

Counterpart of ``mxnet_tpu/tracecheck.py``, of which the port holds only
:class:`RetraceError`, the name ``Module`` catches around a dispatch. The
checker itself walks XLA programs and is not ported; nothing in the port
raises this error yet.
"""
from __future__ import annotations

from .base import MXNetError


class RetraceError(MXNetError):
    """A dispatch recompiled where it should not have. ``result`` holds
    the dispatch's own result, which the caller adopts before it re-raises
    (the state was already updated)."""

    def __init__(self, msg, result=None):
        super().__init__(msg)
        self.result = result
