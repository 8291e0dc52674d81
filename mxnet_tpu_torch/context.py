"""Device context for mxnet_tpu_torch.

Counterpart of ``mxnet_tpu/context.py``. A :class:`Context` names a device
the reference's way (``cpu(0)``, ``gpu(1)``) and resolves to a
``torch.device``: ``gpu(i)`` is ``cuda:i``. ``tpu(i)``, the JAX package's
name for its accelerator, is taken as an alias of it and is ``cuda:i`` too,
so scripts written for the JAX package run unchanged.
"""
from __future__ import annotations

import os
import threading

import torch

from .base import MXNetError


class Context(object):
    """A device context.

    Parameters
    ----------
    device_type : {'cpu', 'gpu', 'tpu', 'cpu_pinned'} or Context
        'tpu' is an alias of the accelerator ('gpu'), as the JAX package
        takes 'gpu' for its own.
    device_id : int
    """

    # parity: base.h devtype ids (1 cpu, 2 gpu, 3 cpu_pinned); tpu gets 4,
    # as in the JAX package
    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 4: "tpu"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "tpu": 4}

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
        """The ``torch.device`` this context names (``gpu(i)`` and
        ``tpu(i)`` -> ``cuda:i``; CPU contexts share the one host device)."""
        if self.device_type in ("gpu", "tpu"):
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")


def cpu(device_id=0):
    """Return a CPU context."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """Return a GPU context (``cuda:device_id``)."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """The JAX package's accelerator context, here ``cuda:device_id``."""
    return Context("tpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def num_devices(device_type=None):
    """Number of devices of ``device_type`` visible: CUDA cards for
    ``"gpu"`` (and its alias ``"tpu"``); for ``"cpu"`` one per host core
    (CPU replicas share the host device). By default the cards, or the
    CPU's count without CUDA."""
    if device_type is None:
        device_type = "gpu" if torch.cuda.is_available() else "cpu"
    if device_type in ("gpu", "tpu"):
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return os.cpu_count() or 1


def current_context():
    """The thread-local default context: gpu(0) unless a ``with cpu():``
    (or another context) block is open. There is no quiet CPU default
    without CUDA: the CPU is used only where a caller asks for it."""
    if not hasattr(Context._default_ctx, "value"):
        Context._default_ctx.value = Context("gpu", 0)
    return Context._default_ctx.value


def default_context():
    """The current context (parity: ``mxnet_tpu.context.default_context``)."""
    return current_context()


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


def raw_stream(index):
    """PyTorch's current stream on CUDA device ``index`` as a raw
    ``cudaStream_t`` (an int) for a kernel launch: the capture stream inside
    ``torch.cuda.graph``. Read through ``torch.accelerator``, the cheapest
    public way (``chip_smoke.py`` phase 7 times it beside
    ``torch.cuda.current_stream(i).cuda_stream``)."""
    return torch.accelerator.current_stream(index).native_handle
