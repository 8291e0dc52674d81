"""Device context for mxnet_tpu_torch.

Counterpart of ``mxnet_tpu/context.py``. A :class:`Context` names a device
the reference's way (``cpu(0)``, ``gpu(1)``) and resolves to a
``torch.device``: ``gpu(i)`` is ``cuda:i``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError


class Context(object):
    """A device context.

    Parameters
    ----------
    device_type : {'cpu', 'gpu', 'cpu_pinned'} or Context
    device_id : int
    """

    # parity: base.h devtype ids (1 cpu, 2 gpu, 3 cpu_pinned)
    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in self.devstr2type:
                raise MXNetError("unknown device type %r" % (device_type,))
            self.device_typeid = self.devstr2type[device_type]
            self.device_id = device_id

    @property
    def device_type(self):
        return self.devtype2str[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = current_context()
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx

    def to_device(self):
        """The ``torch.device`` this context names (``gpu(i)`` ->
        ``cuda:i``; CPU contexts share the one host device)."""
        if self.device_type == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")


def cpu(device_id=0):
    """Return a CPU context."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """Return a GPU context (``cuda:device_id``)."""
    return Context("gpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def current_context():
    """The thread-local default context: gpu(0) unless a ``with cpu():``
    (or another context) block is open. There is no quiet CPU default
    without CUDA: the CPU is used only where a caller asks for it."""
    if not hasattr(Context._default_ctx, "value"):
        Context._default_ctx.value = Context("gpu", 0)
    return Context._default_ctx.value


def resolve_device(device, who):
    """An entry point's device: ``None`` -> ``cuda:0``; a Context,
    ``torch.device`` or string as given. A CUDA device without CUDA raises
    naming ``who``: entry points never fall back to the CPU."""
    if isinstance(device, Context):
        device = device.to_device()
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "%s: CUDA is not available, so %s cannot be used; pass "
                "device='cpu' to run on the CPU" % (who, dev))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
