"""The error type of the JAX package's retrace checker, and its
process-unique program names.

Counterpart of ``mxnet_tpu/tracecheck.py``, of which the port holds
:class:`RetraceError`, the name ``Module`` catches around a dispatch, and
:func:`unique_name`, which names serving engines. The checker itself
walks XLA programs and is not ported; nothing in the port raises this
error yet.
"""
from __future__ import annotations

import threading

from .base import MXNetError

_NAME_SEQ = {}
_NAME_LOCK = threading.Lock()


def unique_name(base):
    """Process-unique name: the first caller gets ``base`` verbatim, later
    callers get ``base#2``, ``base#3``, ... (engines built on several
    threads at once, as a fleet's joins are, take a lock)."""
    with _NAME_LOCK:
        n = _NAME_SEQ.get(base, 0) + 1
        _NAME_SEQ[base] = n
    return base if n == 1 else "%s#%d" % (base, n)


class RetraceError(MXNetError):
    """A dispatch recompiled where it should not have. ``result`` holds
    the dispatch's own result, which the caller adopts before it re-raises
    (the state was already updated)."""

    def __init__(self, msg, result=None):
        super().__init__(msg)
        self.result = result
