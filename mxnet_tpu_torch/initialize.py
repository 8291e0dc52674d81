"""Process initialization: the crash backtrace dump.

Counterpart of ``mxnet_tpu/initialize.py`` (ref: src/initialize.cc, the
SIGSEGV backtrace handler): a native crash in PyTorch's or CUDA's
libraries dumps every thread's Python stack through ``faulthandler``. Set
``MXNET_USE_SIGNAL_HANDLER=0`` to opt out (embedding hosts that install
their own handlers). Imported once at package import.
"""
from __future__ import annotations

import os
import sys


def install():
    if os.environ.get("MXNET_USE_SIGNAL_HANDLER", "1") == "0":
        return
    try:
        import faulthandler
        # stderr may be closed or replaced in an embedded interpreter
        if getattr(sys.stderr, "fileno", None) is not None:
            faulthandler.enable(file=sys.stderr, all_threads=True)
    except Exception:
        pass


install()
