"""Engine facade: the control surface of the reference's dependency engine.

Counterpart of ``mxnet_tpu/engine.py``. PyTorch queues CUDA work on a
stream and returns, as XLA's async dispatch does, so what remains is the
control surface ``Module.fit`` reads:

- ``bulk(k)`` / ``set_bulk_size``: the default ``steps_per_dispatch`` of
  ``fit`` (env ``MXTPU_BULK_STEPS``, default 1);
- ``dispatch_pipeline``: the default depth of ``fit``'s deferred metric
  readback (env ``MXTPU_DISPATCH_PIPELINE``, default 1);
- ``wait_all``: ``torch.cuda.synchronize`` on the current device;
  ``wait_for_var(arr)`` for one array's device; ``push(fn)`` runs a host
  callback after the queued work;
- the synchronous debug mode ``MXNET_ENGINE_TYPE=NaiveEngine`` (or
  ``set_engine_type("NaiveEngine")``): ``maybe_sync``, called after each
  imperative op, waits for that op's device before it returns.

``*_configured`` tell an explicit setting from the default, for the log
line that names where each of ``fit``'s knobs came from. ``dp_devices``
reads ``MXTPU_DP_DEVICES``, the replica count of a ``Module`` built
without a context. ``tracecheck_mode``/``set_tracecheck`` (env
``MXTPU_TRACECHECK``, default ``"warn"``) set what ``TrainStep``'s retrace
watch does with a dispatch whose argument signature changed under an
already-seen key; ``memcheck_mode``/``set_memcheck`` (env
``MXTPU_MEMCHECK``) arm the serving tier's load-time memory audit;
``flopcheck_mode``/``set_flopcheck`` (env ``MXTPU_FLOPCHECK``, default
``"off"``) arm ``TrainStep``'s one-time roofline audit of each dispatch
key's program; ``commscheck_mode``/``set_commscheck`` (env
``MXTPU_COMMSCHECK``, default ``"off"``) arm the one-time communication
audit of a mesh ``TrainStep``'s dispatch keys and of a sharded serving
engine or decode loop at load.
"""
from __future__ import annotations

import contextlib
import os

import torch

from .base import MXNetError, env_int

_naive = os.environ.get("MXNET_ENGINE_TYPE", "") == "NaiveEngine"
_bulk_steps = max(1, env_int("MXTPU_BULK_STEPS", 1))
# whether set_bulk_size was called: an explicit bulk(1) reads as "asked
# for 1", not "unset"
_bulk_explicit = False
_pipeline_override = None


def set_engine_type(name):
    """``"NaiveEngine"``: wait for the device after every imperative op;
    ``"ThreadedEngine"``/``"ThreadedEnginePerDevice"``: queue and return
    (the default)."""
    global _naive
    _naive = (name == "NaiveEngine")


def is_naive():
    return _naive


def set_bulk_size(size):
    """Set the default steps-per-dispatch of training loops; returns the
    previous value."""
    global _bulk_steps, _bulk_explicit
    prev = _bulk_steps
    _bulk_steps = max(1, int(size))
    _bulk_explicit = True
    return prev


def bulk_size():
    """The default steps-per-dispatch ``Module.fit`` uses."""
    return _bulk_steps


def bulk_configured():
    """Whether the bulk size was set (``MXTPU_BULK_STEPS``, ``bulk`` or
    ``set_bulk_size``, an explicit 1 included) rather than defaulted."""
    if _bulk_explicit or _bulk_steps != 1:
        return True
    return bool(os.environ.get("MXTPU_BULK_STEPS", "").strip())


@contextlib.contextmanager
def bulk(size):
    """Scoped bulking: ``with mt.engine.bulk(8): mod.fit(...)`` trains 8
    steps per dispatch. Exit restores the previous size and whether it was
    set."""
    global _bulk_steps, _bulk_explicit
    prev, prev_flag = _bulk_steps, _bulk_explicit
    set_bulk_size(size)
    try:
        yield
    finally:
        _bulk_steps, _bulk_explicit = prev, prev_flag


def dispatch_pipeline():
    """Default deferred-readback depth of K-step dispatch: ``fit`` queues
    dispatch N+depth before it reads dispatch N's metric sums back; 0 reads
    each back at once. Env ``MXTPU_DISPATCH_PIPELINE`` (default 1)."""
    if _pipeline_override is not None:
        return _pipeline_override
    return max(0, env_int("MXTPU_DISPATCH_PIPELINE", 1))


def dispatch_pipeline_configured():
    """Whether the pipeline depth was set (env or
    :func:`set_dispatch_pipeline`) rather than defaulted."""
    if _pipeline_override is not None:
        return True
    return bool(os.environ.get("MXTPU_DISPATCH_PIPELINE", "").strip())


def set_dispatch_pipeline(depth):
    """Override the default pipeline depth (None: back to env/default);
    returns the previous effective value."""
    global _pipeline_override
    prev = dispatch_pipeline()
    _pipeline_override = None if depth is None else max(0, int(depth))
    return prev


def dp_devices():
    """``MXTPU_DP_DEVICES=N`` (0 when unset): a ``Module`` built without a
    ``context=`` spreads over the first N devices of the current context's
    type, the environment's spelling of ``context=[gpu(i) for i in
    range(N)]``."""
    v = os.environ.get("MXTPU_DP_DEVICES")
    if v is None or v.strip() == "":
        return 0
    try:
        return max(0, int(v))
    except ValueError:
        raise MXNetError("MXTPU_DP_DEVICES must be an integer, got %r" % v)


def _mode_from_env(env_name, default):
    """Shared warn|error|off parser for the analyzers' runtime-policy env
    knobs; ``default`` is the meaning of unset/empty."""
    v = os.environ.get(env_name)
    v = v.strip().lower() if v else ""
    if v == "":
        return default
    if v in ("1", "on", "true", "warn", "warning"):
        return "warn"
    if v in ("0", "off", "false", "no"):
        return "off"
    if v in ("error", "raise"):
        return "error"
    raise MXNetError("%s must be warn|error|off, got %r" % (env_name, v))


def _validate_mode(mode, who):
    if mode is not None and mode not in ("warn", "error", "off"):
        raise MXNetError("%s: mode must be warn|error|off or None, got %r"
                         % (who, mode))


_tracecheck_override = None


def tracecheck_mode():
    """Retrace-policy mode of the analyzer's runtime hook: ``"warn"``
    (default) logs the argument diff when a watched dispatch key is
    dispatched with a new signature, ``"error"`` raises
    :class:`~mxnet_tpu_torch.tracecheck.RetraceError`, ``"off"`` skips
    signature capture. Env default: ``MXTPU_TRACECHECK``."""
    if _tracecheck_override is not None:
        return _tracecheck_override
    return _mode_from_env("MXTPU_TRACECHECK", "warn")


def set_tracecheck(mode):
    """Override the tracecheck mode (None: back to the env/default);
    returns the previous effective value."""
    global _tracecheck_override
    prev = tracecheck_mode()
    _validate_mode(mode, "set_tracecheck")
    _tracecheck_override = mode
    return prev


_memcheck_override = None


def memcheck_mode():
    """Memory-audit policy of the serving tier at load: ``"off"``
    (default) skips the audit, ``"warn"`` logs unsuppressed memory
    findings when a ``ServingEngine`` or ``DecodeLoop`` is built (priced
    by :mod:`mxnet_tpu_torch.memcheck`'s shape-only dry run, before any
    bucket or step runs), ``"error"`` raises :class:`MXNetError`: a deploy
    that cannot fit its budget fails at load, not at the first full-batch
    request. Env default: ``MXTPU_MEMCHECK``."""
    if _memcheck_override is not None:
        return _memcheck_override
    return _mode_from_env("MXTPU_MEMCHECK", "off")


def set_memcheck(mode):
    """Override the memcheck mode (None: back to the env/default); returns
    the previous effective value."""
    global _memcheck_override
    prev = memcheck_mode()
    _validate_mode(mode, "set_memcheck")
    _memcheck_override = mode
    return prev


_commscheck_override = None


def commscheck_mode():
    """Collective-communication audit policy of the mesh programs:
    ``"off"`` (default) skips the audit; ``"warn"`` makes a ``TrainStep``
    over a mesh run the communication lints of
    :mod:`mxnet_tpu_torch.commscheck` ONCE per dispatch key's program at
    its first dispatch (one shape-only dry run, the arguments faked first),
    and a ``ServingEngine`` or ``DecodeLoop`` over a 'model' mesh at load,
    and log unsuppressed findings; ``"error"`` raises
    :class:`~mxnet_tpu_torch.base.MXNetError`, as it does when the dry run
    fails: a gather in the K-step loop fails at the first dispatch, not
    after a slow run over several cards. Env default:
    ``MXTPU_COMMSCHECK``."""
    if _commscheck_override is not None:
        return _commscheck_override
    return _mode_from_env("MXTPU_COMMSCHECK", "off")


def set_commscheck(mode):
    """Override the commscheck mode (None: back to the env/default);
    returns the previous effective value."""
    global _commscheck_override
    prev = commscheck_mode()
    _validate_mode(mode, "set_commscheck")
    _commscheck_override = mode
    return prev


_flopcheck_override = None


def flopcheck_mode():
    """Roofline-audit policy of the dispatch programs: ``"off"`` (default)
    skips the audit; ``"warn"`` makes ``TrainStep`` run the roofline lints
    of :mod:`mxnet_tpu_torch.flopcheck` ONCE per dispatch key's program at
    its first dispatch (one shape-only dry run, the arguments faked first)
    and log unsuppressed findings; ``"error"`` raises
    :class:`~mxnet_tpu_torch.base.MXNetError`: a step shattered into tiny
    launches fails at the first dispatch, not after a slow profiling
    session. Env default: ``MXTPU_FLOPCHECK``."""
    if _flopcheck_override is not None:
        return _flopcheck_override
    return _mode_from_env("MXTPU_FLOPCHECK", "off")


def set_flopcheck(mode):
    """Override the flopcheck mode (None: back to the env/default); returns
    the previous effective value."""
    global _flopcheck_override
    prev = flopcheck_mode()
    _validate_mode(mode, "set_flopcheck")
    _flopcheck_override = mode
    return prev


def wait_all():
    """Block until the queued work of the current CUDA device is done (no-op
    without CUDA)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def maybe_sync(t):
    """Called after each imperative op with its result tensor: in naive
    mode a CUDA tensor's device is synchronized (a CPU tensor is already
    done)."""
    if _naive and t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
    return t


def wait_for_var(arr):
    """Block until ``arr`` (an NDArray or a tensor) is computed."""
    t = getattr(arr, "data", arr)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def push(fn):
    """Run a host callback after all queued work."""
    wait_all()
    fn()
