"""NDArray: a thin wrapper around a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray.py``, kept to what serving needs: the
array type (``shape``, ``dtype``, ``context``, ``asnumpy``) and ``save`` /
``load`` of the reference's dmlc ``.params`` layout, so a checkpoint written
by either package opens in the other. The imperative op namespace comes in
a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import Context, current_context, resolve_device
from . import dmlc_serial


def _to_tensor(value):
    """numpy (incl. :data:`dmlc_serial.BF16` bits) or tensor -> tensor."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if dmlc_serial.is_bf16(arr.dtype):
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def _to_numpy(t):
    """tensor -> numpy; bfloat16 comes back as :data:`dmlc_serial.BF16`."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(dmlc_serial.BF16)
    return t.numpy()


class NDArray(object):
    """An n-dimensional array on a device, backed by a ``torch.Tensor``."""

    __slots__ = ("_data",)

    def __init__(self, data, ctx=None):
        t = _to_tensor(data)
        if ctx is not None:
            t = t.to(resolve_device(ctx, "NDArray"))
        self._data = t

    @property
    def data(self):
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        if self._data.dtype == torch.bfloat16:
            return dmlc_serial.BF16
        return np.dtype(str(self._data.dtype).replace("torch.", ""))

    @property
    def context(self):
        dev = self._data.device
        if dev.type == "cuda":
            return Context("gpu", dev.index or 0)
        return Context("cpu", 0)

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)

    def asnumpy(self):
        """Copy to a host numpy array (blocking)."""
        return _to_numpy(self._data)

def array(source, ctx=None, dtype=None):
    """Create an NDArray from a numpy array, list or tensor."""
    t = _to_tensor(source if dtype is None
                   else np.asarray(source, dtype=dtype))
    return NDArray(t, ctx=ctx or current_context())


# ---------------------------------------------------------------------------
# serialization (ref: MXNDArraySave/Load) in the dmlc .params layout
# ---------------------------------------------------------------------------

def save(fname, data):
    """Save an NDArray, a list of them, or a ``{name: NDArray}`` dict."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrs = [data[k].asnumpy() for k in names]
    elif isinstance(data, (list, tuple)):
        names = []
        arrs = [v.asnumpy() for v in data]
    else:
        raise MXNetError("save: data must be NDArray, list, or dict")
    with open(fname, "wb") as f:
        dmlc_serial.dump(f, arrs, names)


def load(fname, ctx=None):
    """Load a ``.params`` file: a dict when it carries names, else a list.
    Arrays land on ``ctx`` (default: the CPU)."""
    with open(fname, "rb") as f:
        buf = f.read()
    if not dmlc_serial.sniff(buf):
        raise MXNetError("load: %s is not a .params file" % fname)
    arrs, names = dmlc_serial.loads(buf)
    ctx = ctx or Context("cpu", 0)
    if names:
        return {k: NDArray(v, ctx=ctx) for k, v in zip(names, arrs)}
    return [NDArray(v, ctx=ctx) for v in arrs]
