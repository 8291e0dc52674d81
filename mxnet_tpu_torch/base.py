"""Base types and helpers for mxnet_tpu_torch.

The port's own copy of ``mxnet_tpu/base.py``: the error type, the attribute
coercion that lets symbol JSON round-trip (op attrs arrive either as native
Python values or as their string forms), and the environment-knob readers.
"""
from __future__ import annotations

import os

import numpy as np
import torch

__version__ = "0.1.0"

MXNET_TPU_MAJOR = 0
MXNET_TPU_MINOR = 1
MXNET_TPU_PATCH = 0


class MXNetError(Exception):
    """Error raised by mxnet_tpu_torch (parity: dmlc error -> Python)."""


class TrainingPreemptedError(MXNetError):
    """``Module.fit`` received SIGTERM (a scheduler's preemption notice)
    and shut down gracefully: the dispatch pipeline drained, an emergency
    checkpoint sealed with the async writer drained, within
    ``MXTPU_SIGTERM_DEADLINE`` seconds. Re-launch with ``resume='auto'``
    to continue from that checkpoint."""

    def __init__(self, msg, epoch=None, batches_done=None, tag=None):
        self.epoch = epoch
        self.batches_done = batches_done
        self.tag = tag
        super().__init__(msg)


class NotImplementedForTPU(MXNetError):
    """A reference feature intentionally absent from the package (the JAX
    package's name, kept so that code catching it works with either):
    raised rather than silently skipped, so users discover documented
    gaps."""


_NULL = object()  # sentinel for "unset" attr values


def string_types():
    """The string types (parity: ``mxnet_tpu.base.string_types``)."""
    return (str,)


def attr_bool(v, default=None):
    if v is _NULL or v is None:
        return default
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    s = str(v).strip().lower()
    if s in ("true", "1"):
        return True
    if s in ("false", "0"):
        return False
    raise MXNetError("cannot parse bool attr: %r" % (v,))


def attr_int(v, default=None):
    if v is _NULL or v is None:
        return default
    if isinstance(v, bool):
        return int(v)
    return int(v)


def attr_float(v, default=None):
    if v is _NULL or v is None:
        return default
    return float(v)


def attr_str(v, default=None):
    if v is _NULL or v is None:
        return default
    return str(v)


def attr_tuple(v, default=None, typ=int):
    """Parse '(2, 2)' / '[2,2]' / (2, 2) / 2 into a tuple."""
    if v is _NULL or v is None:
        return default
    if isinstance(v, (tuple, list)):
        return tuple(typ(x) for x in v)
    if isinstance(v, (int, float)):
        return (typ(v),)
    s = str(v).strip()
    if s.startswith(("(", "[")):
        s = s[1:-1]
    s = s.strip()
    if not s:
        return ()
    return tuple(typ(float(x)) if typ is int and ("." in x) else typ(x)
                 for x in (p.strip() for p in s.split(",")) if x)


def env_float(name, default):
    """Parse an env var as a float knob; unset or blank means ``default``."""
    v = os.environ.get(name)
    if v is None or v.strip() == "":
        return default
    try:
        return float(v)
    except ValueError:
        raise MXNetError("%s must be a number, got %r" % (name, v))


def env_int(name, default):
    """Parse an env var as an integer knob; unset or blank means
    ``default``. Non-integer spellings raise an :class:`MXNetError` naming
    the variable instead of silently truncating."""
    v = os.environ.get(name)
    if v is None or v.strip() == "":
        return default
    try:
        return int(v.strip())
    except ValueError:
        raise MXNetError("%s must be an integer, got %r" % (name, v))


def env_bool(name):
    """Parse an env var as an on/off switch: unset, blank, and the usual
    "off" spellings are False, anything else True."""
    return os.environ.get(name, "").strip().lower() \
        not in ("", "0", "false", "off", "no")


def env_str(name, default=""):
    """Read an env var as a stripped string knob; unset or blank means
    ``default``."""
    v = os.environ.get(name)
    if v is None or v.strip() == "":
        return default
    return v.strip()


_BF16_NAMES = ("bfloat16",)


def shape_only(t):
    """Whether tensor ``t`` carries a shape but no data: a meta tensor, or
    a fake one (``FakeTensorMode``, the dry run by which
    :mod:`mxnet_tpu_torch.memcheck` prices a program). The hand-written
    kernels' wrappers give such a tensor outputs of the right shape, dtype
    and device that compute nothing, and count no launch."""
    if t.is_meta:
        return True
    # a plain tensor that no functionalization or functorch transform wraps
    # is never fake: answered here, since is_fake costs microseconds a call
    # on every launch
    if (type(t) is torch.Tensor and not torch._is_functional_tensor(t)
            and not torch._C._functorch.is_functorch_wrapped_tensor(t)):
        return False
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


def note_kernel(name, flops, nbytes, compute, passes=1, inputs=()):
    """Called by a hand-written kernel's shape-only route in place of a
    launch: every dispatch mode running that has a ``hand_kernel`` method
    (``memcheck``'s dry run, recording the kernels ``flopcheck`` prices)
    gets the launch it stands for: ``flops`` operations issued ``passes``
    times at the peak of ``compute`` (a ``devspec.PEAK_BY_DTYPE`` key) and
    ``nbytes`` moved, with the shapes and dtypes of its ``inputs``, from the
    kernel module's own cost formula."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in _get_current_dispatch_mode_stack():
        hook = getattr(mode, "hand_kernel", None)
        if hook is not None:
            hook(name, flops, nbytes, compute, passes, inputs)


def note_collective(kind, nbytes, group_size, axes, operands=(),
                    op_path=None):
    """Called by each collective of ``parallel/mesh.py``: every dispatch
    mode running that has a ``collective`` method (``memcheck``'s dry run,
    whose records ``commscheck`` reads) gets the collective as it would
    run over separate cards: its ``kind`` (the JAX package's names:
    ``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``, ``collective-broadcast``), its payload
    ``nbytes`` by the JAX package's conventions (an all-gather's gathered
    result, a reduce-scatter's scattered one, every other kind one
    position's tensor), its ``group_size``, the mesh ``axes`` it runs over
    and the tensors it reads (``operands``). ``op_path`` names it
    (``mesh.collective_name``) in place of the executor node that issued
    it. Returns a callable that records the collective's transpose
    (``kind``, ``nbytes``) with the same op path and provenance to the
    same modes, for the backward; None outside a dry run, where nothing is
    recorded."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    modes = [m for m in _get_current_dispatch_mode_stack()
             if getattr(m, "collective", None) is not None]
    if not modes:
        return None
    from .memcheck import _collective_where
    where = _collective_where(op_path)
    axes = None if axes is None else tuple(axes)
    for m in modes:
        m.collective(kind, nbytes, group_size, axes, operands, where)

    def transpose(tkind, tbytes):
        for m in modes:
            m.collective(tkind, tbytes, group_size, axes, (), where,
                         transpose=True)
    return transpose


def torch_dtype(dtype):
    """A dtype given as a ``torch.dtype``, a name, a numpy dtype or a
    numpy type -> the ``torch.dtype`` (``bfloat16`` by name, or as the
    dmlc record dtype whose field is named so)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype in _BF16_NAMES:
        return torch.bfloat16
    try:
        dt = np.dtype(dtype)
    except TypeError:
        raise MXNetError("unsupported dtype %r" % (dtype,))
    if dt.name in _BF16_NAMES or (dt.names or ()) == _BF16_NAMES:
        return torch.bfloat16
    try:
        return torch.from_numpy(np.empty(0, dt)).dtype
    except TypeError:
        raise MXNetError("unsupported dtype %r" % (dtype,))


def numpy_dtype(dtype):
    """The numpy dtype of a ``torch.dtype`` (bfloat16 has none: it maps to
    :data:`dmlc_serial.BF16`, the raw-bits record the ``.params`` files
    use)."""
    if dtype == torch.bfloat16:
        from .dmlc_serial import BF16
        return BF16
    return np.dtype(str(dtype).replace("torch.", ""))


def shape_str(shape):
    return "(" + ",".join(str(int(x)) for x in shape) + ")"
