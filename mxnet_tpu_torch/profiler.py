"""Profiler (ref: python/mxnet/profiler.py; the engine profiler of
src/engine/profiler.{h,cc} writes Chrome trace-event JSON).

Counterpart of ``mxnet_tpu/profiler.py``, over ``torch.profiler``: the
reference's API (``profiler_set_config``, ``profiler_set_state``,
``dump_profile``) records the host's operators and, on the card, the CUDA
kernels and copies, and writes them as one Chrome trace (JSON) to the
configured file when the profiler stops.

``MXNET_PROFILER_AUTOSTART=1`` (ref: src/initialize.cc) is taken as in the
JAX package: deferred to the first dispatch (an executor's forward, a
module's fused step), through :func:`maybe_autostart`, so that a
``profiler_set_config`` made after the import still decides where the
trace goes. A profile still running when the process exits is written
then.

:class:`Scope` names a region of user code on both timelines: a
``torch.profiler.record_function`` in the profiler's trace and an
``obs.span`` in the host trace.
"""
from __future__ import annotations

import atexit
import logging
import os

import torch

from .base import MXNetError
from .obs import trace as _obs_trace

_state = {"running": False, "filename": "profile.json", "mode": "symbolic",
          "prof": None, "atexit": False}

#: MXNET_PROFILER_AUTOSTART seen at import: the profile starts at the first
#: dispatch, after any profiler_set_config, never at import
_autostart_pending = (
    os.environ.get("MXNET_PROFILER_AUTOSTART", "0") == "1")


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """Where the Chrome trace goes (ref: MXSetProfilerConfig); ``mode`` is
    kept for the reference's signature (``symbolic`` or ``all``)."""
    _state["mode"] = mode
    _state["filename"] = filename


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def profiler_set_state(state="stop"):
    """``"run"`` starts the profiler; ``"stop"`` stops it and writes the
    Chrome trace to the configured file (ref: MXSetProfilerState)."""
    global _autostart_pending
    if state not in ("run", "stop"):
        raise MXNetError("profiler state must be 'run' or 'stop'")
    if state == "run" and not _state["running"]:
        _autostart_pending = False   # an explicit start supersedes it
        prof = torch.profiler.profile(activities=_activities())
        prof.start()
        _state["prof"] = prof
        _state["running"] = True
        if not _state["atexit"]:
            atexit.register(_dump_at_exit)
            _state["atexit"] = True
    elif state == "stop" and _state["running"]:
        prof = _state["prof"]
        _state["running"] = False
        _state["prof"] = None
        prof.stop()
        path = _state["filename"]
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        prof.export_chrome_trace(path)


def maybe_autostart():
    """First-dispatch hook: start the deferred ``MXNET_PROFILER_AUTOSTART``
    profile, after any ``profiler_set_config``. One boolean check once it
    has resolved."""
    global _autostart_pending
    if _autostart_pending:
        _autostart_pending = False
        profiler_set_state("run")


def dump_profile():
    """Finish the profile and write its trace (ref: MXDumpProfile)."""
    if _state["running"]:
        profiler_set_state("stop")


def _dump_at_exit():
    try:
        dump_profile()
    except Exception:   # exit must not fail on a diagnostic
        logging.getLogger("mxnet_tpu_torch").exception(
            "profiler: writing the trace at exit failed")


class Scope(object):
    """A named region on both timelines: ``torch.profiler.record_function``
    puts it in the profiler's trace, an ``obs.span`` in the host trace."""

    def __init__(self, name, **args):
        self._name = name
        self._args = args
        self._rf = None
        self._span = None

    def __enter__(self):
        self._span = _obs_trace.span(self._name, **self._args)
        self._span.__enter__()
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        return self

    def __exit__(self, *a):
        try:
            self._rf.__exit__(*a)
        finally:
            self._span.__exit__(*a)
            self._rf = None
            self._span = None
