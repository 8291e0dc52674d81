"""NDArray: the imperative array API.

Counterpart of ``mxnet_tpu/ndarray.py`` (ref: python/mxnet/ndarray.py). An
:class:`NDArray` holds a ``torch.Tensor`` on a device. Every registered
operator is a module function here (``nd.sum``, ``nd.FullyConnected``,
...), generated at import as the reference does, and the Python operators
route through the same registry so the ``autograd`` tape sees one stream
of ops.

Mutation follows the JAX package, whose arrays are immutable: assigning
into an NDArray (``x[:] = v``, ``x += 1``, ``out=``) rebinds its tensor
instead of writing into it, so a tensor that the autograd tape or an
executor holds never changes under it. A view made by an ``int`` key or a
step-1 slice of the first axis (``x[2:5]``) is a real torch view with a
write-back link: assigning into it writes that part of the parent, and a
user kernel (``rtc``) writing into its memory writes the parent's. Every
other key gives a copy, so ``y = x[::2]; y[:] = 0`` leaves ``x`` as it is,
as in the JAX package.

Arrays land on ``ctx`` or :func:`~context.current_context`, so on the card
unless the caller asks for the CPU. Outside ``autograd`` recording no op
builds a torch autograd graph.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .base import MXNetError, numpy_dtype, torch_dtype
from .context import Context, current_context, resolve_device
from . import dmlc_serial
from . import engine as _engine
from . import random as _random
from .ops import registry as _reg

# the op namespace below shadows builtins such as slice, sum and max
_py_slice = slice


def _to_tensor(value):
    """numpy (incl. :data:`dmlc_serial.BF16` bits) or tensor -> tensor."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if dmlc_serial.is_bf16(arr.dtype):
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if not arr.flags.c_contiguous:   # (ascontiguousarray makes 0-d 1-d)
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


def _device_of(ctx):
    return resolve_device(ctx if ctx is not None else current_context(),
                          "NDArray")


def _as_tensor(value, device=None):
    """An NDArray's tensor as it is, or a tensor made from numpy or a
    scalar (on ``device`` when given)."""
    if isinstance(value, NDArray):
        return value.data
    t = _to_tensor(value)
    return t if device is None else t.to(device)


def _wb_key(key):
    """Whether ``key`` makes a write-back view: an int or a step-1 slice
    of the first axis (the JAX package's rule)."""
    return isinstance(key, int) or (isinstance(key, _py_slice)
                                    and key.step in (None, 1))


def _index(key):
    if isinstance(key, tuple):
        return tuple(_index(k) for k in key)
    return key.data if isinstance(key, NDArray) else key


class NDArray(object):
    """An n-dimensional array on a device, backed by a ``torch.Tensor``."""

    __slots__ = ("_data", "_wb_parent", "_wb_index")

    def __init__(self, data, ctx=None, _wb=None):
        t = _as_tensor(data)
        if ctx is not None:
            t = t.to(resolve_device(ctx, "NDArray"))
        self._data = t
        self._wb_parent, self._wb_index = _wb if _wb else (None, None)

    # -- core properties ------------------------------------------------
    @property
    def data(self):
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        dev = self._data.device
        if dev.type == "cuda":
            return Context("gpu", dev.index or 0)
        return Context("cpu", 0)

    ctx = context

    @property
    def T(self):
        return NDArray(self._data.permute(*range(self.ndim - 1, -1, -1)))

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)

    # -- host interop ---------------------------------------------------
    def asnumpy(self):
        """Copy to a host numpy array (blocking)."""
        return _to_numpy(self._data)

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    # -- mutation -------------------------------------------------------
    def _set_data(self, new):
        """Rebind to ``new`` (cast to this array's dtype, moved to its
        device); a write-back view also writes its part of the parent and
        stays a view of the parent's new tensor."""
        new = new.detach().to(device=self._data.device,
                              dtype=self._data.dtype)
        p = self._wb_parent
        if p is None:
            self._data = new
            _engine.maybe_sync(new)
            return
        with torch.no_grad():
            whole = p._data.clone()
            whole[self._wb_index] = new
        p._set_data(whole)
        self._data = p._data[self._wb_index]

    def __setitem__(self, key, value):
        key = _index(key)
        v = _as_tensor(value, self._data.device)
        if key is None or (isinstance(key, _py_slice)
                           and key == _py_slice(None)):
            # a copy: the array never shares the value's tensor
            self._set_data(v.expand(self.shape).clone(
                memory_format=torch.contiguous_format))
            return
        with torch.no_grad():
            new = self._data.clone()
            new[key] = v.to(self._data.dtype)
        self._set_data(new)

    def __getitem__(self, key):
        key = _index(key)
        if _wb_key(key):
            return NDArray(self._data[key], _wb=(self, key))
        r = self._data[key]
        return NDArray(r.clone() if r._is_view() else r)

    # -- shape and copy ---------------------------------------------------
    def reshape(self, shape):
        return NDArray(self._data.reshape(
            (shape,) if isinstance(shape, int) else tuple(shape)))

    def broadcast_to(self, shape):
        return NDArray(self._data.expand(*shape))

    def astype(self, dtype):
        return NDArray(self._data.to(torch_dtype(dtype)))

    def copy(self):
        return NDArray(self._data.clone())

    def copyto(self, other):
        """Copy into another NDArray (rebinding it) or onto a Context (a new
        array there)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError("copyto: shape mismatch %s vs %s"
                                 % (self.shape, other.shape))
            other._set_data(self._data.clone())
            return other
        if isinstance(other, Context):
            return NDArray(self._data.to(resolve_device(other, "copyto"),
                                         copy=True))
        raise MXNetError("copyto: unsupported target %r" % (other,))

    def as_in_context(self, ctx):
        if ctx == self.context:
            return self
        return self.copyto(ctx)

    # -- arithmetic (through the registry, so autograd records it) -------
    def _binary(self, opname, other, reverse=False):
        if isinstance(other, NDArray):
            lhs, rhs = (other, self) if reverse else (self, other)
            if lhs.shape == rhs.shape:
                return invoke(_reg.get("_" + opname), [lhs, rhs], {})
            return invoke(_reg.get("broadcast_" + opname), [lhs, rhs], {})
        if np.isscalar(other):
            if reverse and opname in ("sub", "div", "power", "mod"):
                return invoke(_reg.get({"sub": "_rminus_scalar",
                                        "div": "_rdiv_scalar",
                                        "power": "_rpower_scalar",
                                        "mod": "_rmod_scalar"}[opname]),
                              [self], {"scalar": other})
            return invoke(_reg.get("_%s_scalar" % opname), [self],
                          {"scalar": other})
        return NotImplemented

    def __add__(self, o): return self._binary("add", o)
    def __radd__(self, o): return self._binary("add", o)
    def __sub__(self, o): return self._binary("sub", o)
    def __rsub__(self, o): return self._binary("sub", o, reverse=True)
    def __mul__(self, o): return self._binary("mul", o)
    def __rmul__(self, o): return self._binary("mul", o)
    def __truediv__(self, o): return self._binary("div", o)
    def __rtruediv__(self, o): return self._binary("div", o, reverse=True)
    def __pow__(self, o): return self._binary("power", o)
    def __rpow__(self, o): return self._binary("power", o, reverse=True)
    def __mod__(self, o): return self._binary("mod", o)
    def __neg__(self): return invoke(_reg.get("negative"), [self], {})
    def __eq__(self, o): return self._binary("equal", o)
    def __ne__(self, o): return self._binary("not_equal", o)
    def __gt__(self, o): return self._binary("greater", o)
    def __ge__(self, o): return self._binary("greater_equal", o)
    def __lt__(self, o): return self._binary("lesser", o)
    def __le__(self, o): return self._binary("lesser_equal", o)

    def __hash__(self):
        return id(self)

    def _inplace(self, opname, other):
        self._set_data(self._binary(opname, other)._data)
        return self

    def __iadd__(self, o): return self._inplace("add", o)
    def __isub__(self, o): return self._inplace("sub", o)
    def __imul__(self, o): return self._inplace("mul", o)
    def __itruediv__(self, o): return self._inplace("div", o)


# ---------------------------------------------------------------------------
# imperative invoke (ref: MXImperativeInvoke, src/c_api/c_api_ndarray.cc)
# ---------------------------------------------------------------------------

def invoke(opdef, nd_inputs, attrs, out=None, aux=(), is_train=None,
           ctx=None):
    """Run ``opdef`` on NDArrays (numpy and scalars are taken as arrays).
    Arrays come out on the inputs' device; ops without array inputs put
    theirs on ``ctx`` or the current context."""
    from . import autograd as _ag
    if is_train is None:
        is_train = _ag.is_training()
    first = next((x for x in list(nd_inputs) + list(aux)
                  if isinstance(x, NDArray)), None)
    device = first._data.device if first is not None else _device_of(ctx)
    in_vals = [_as_tensor(x, device) for x in nd_inputs]
    aux_vals = [_as_tensor(x, device) for x in aux]
    rng = rng_state = None
    if opdef.needs_rng:
        rng = _random.generator(device)
        rng_state = rng.get_state()
    op_ctx = _reg.OpContext(is_train=is_train, rng=rng, device=device)
    with torch.no_grad():
        outs, aux_updates = opdef.apply(op_ctx, attrs, in_vals, aux_vals)
    if aux_updates is not None:
        for a, u in zip(aux, aux_updates):
            if isinstance(a, NDArray):
                a._set_data(u)
    if out is not None:
        out_list = out if isinstance(out, (list, tuple)) else [out]
        # the reference's out= contract: the arrays must already match the
        # results; nothing is reshaped or cast
        if len(out_list) != len(outs):
            raise MXNetError(
                "op %r produced %d output(s) but out= supplied %d "
                "output array(s)" % (opdef.name, len(outs), len(out_list)))
        for i, (o, v) in enumerate(zip(out_list, outs)):
            if tuple(o.shape) != tuple(v.shape):
                raise MXNetError(
                    "output %d shape mismatch: op %r produced %s but the "
                    "supplied out= array has %s"
                    % (i, opdef.name, tuple(v.shape), tuple(o.shape)))
            if o.dtype != numpy_dtype(v.dtype):
                raise MXNetError(
                    "output %d dtype mismatch: op %r produced %s but the "
                    "supplied out= array has %s"
                    % (i, opdef.name, numpy_dtype(v.dtype), o.dtype))
        for o, v in zip(out_list, outs):
            o._set_data(v)
        results = list(out_list)
    else:
        results = [NDArray(v) for v in outs]
        for r in results:
            _engine.maybe_sync(r.data)
    if _ag.is_recording():
        _ag._record(opdef, dict(attrs), list(nd_inputs), in_vals, results,
                    aux_vals, (device, rng_state), is_train)
    return results[0] if len(results) == 1 else results


def _make_op_func(opdef):
    def op_func(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)  # accepted for symmetry with mx.sym
        ctx = kwargs.pop("ctx", None)
        nd_inputs = list(args)
        aux = ()
        n_in = len(opdef.list_inputs(kwargs))
        if opdef.list_aux(kwargs) and len(nd_inputs) > n_in:
            # trailing positional arrays are aux states (imperative
            # BatchNorm: nd.BatchNorm(x, gamma, beta, moving_mean, moving_var))
            nd_inputs, aux = nd_inputs[:n_in], tuple(nd_inputs[n_in:])
        return invoke(opdef, nd_inputs, kwargs, out=out, aux=aux, ctx=ctx)
    op_func.__name__ = opdef.name
    op_func.__doc__ = "mxnet_tpu_torch operator %s" % opdef.name
    return op_func


def _init_ndarray_module():
    mod = sys.modules[__name__]
    for name in _reg.list_ops():
        setattr(mod, name, _make_op_func(_reg.get(name)))


# ---------------------------------------------------------------------------
# creation and utility API (ref: python/mxnet/ndarray.py)
# ---------------------------------------------------------------------------

#: 64-bit sources land in 32 bits unless a dtype is asked for, as in the
#: JAX package (whose arrays are 32-bit)
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.uint64: torch.uint32}


def array(source_array, ctx=None, dtype=None):
    """An NDArray from a numpy array, list, tensor or NDArray; 64-bit
    sources become 32-bit unless ``dtype`` says otherwise."""
    if isinstance(source_array, NDArray):
        src = source_array.data
    elif isinstance(source_array, torch.Tensor):
        src = source_array
    else:
        src = _to_tensor(np.asarray(source_array))
    if dtype is not None:
        src = src.to(torch_dtype(dtype))
    else:
        src = src.to(_NARROW.get(src.dtype, src.dtype))
    return NDArray(src.to(_device_of(ctx), copy=True))


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def empty(shape, ctx=None, dtype=np.float32):
    return zeros(shape, ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype=np.float32):
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device_of(ctx)))


def ones(shape, ctx=None, dtype=np.float32):
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=_device_of(ctx)))


def full(shape, val, ctx=None, dtype=np.float32):
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=_device_of(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=np.float32):
    if stop is None:
        start, stop = 0, start
    r = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                     device=_device_of(ctx))
    return NDArray(torch.repeat_interleave(r, repeat) if repeat > 1 else r)


def concatenate(arrays, axis=0, always_copy=True):
    if not arrays:
        raise MXNetError("concatenate: need at least one array")
    if len(arrays) == 1 and not always_copy:
        return arrays[0]
    return NDArray(torch.cat([a.data for a in arrays], dim=axis))


def add_n(*arrays, **kwargs):
    """Element-wise sum of the arguments (ref: ElementwiseSum)."""
    out = kwargs.pop("out", None)
    acc = arrays[0].data
    for a in arrays[1:]:
        acc = acc + a.data
    if out is not None:
        out._set_data(acc)
        return out
    return NDArray(acc.clone() if len(arrays) == 1 else acc)


ElementWiseSum = add_n


def imdecode(str_img, clip_rect=(0, 0, 0, 0), out=None, index=0, channels=3,
             mean=None):
    """The reference's ``nd.imdecode`` lives in :mod:`mxnet_tpu_torch.image`
    (as in the JAX package)."""
    raise MXNetError("imdecode lives in mxnet_tpu_torch.image")


def onehot_encode(indices, out):
    depth = out.shape[1]
    idx = indices.data.long()
    oh = idx[:, None] == torch.arange(depth, device=idx.device)
    out._set_data(oh.to(out.data.dtype))
    return out


def moveaxis(tensor, source, destination):
    return NDArray(torch.movedim(tensor.data, source, destination))


def waitall():
    """Wait for all queued work on the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# serialization (ref: MXNDArraySave/Load) in the dmlc .params layout, so a
# checkpoint written by either package opens in the other; the JAX
# package's early .npz files are still read
# ---------------------------------------------------------------------------
_SAVE_LIST_KEY = "__mxnet_tpu_list__"


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
    """Load a ``.params`` file (or an early ``.npz`` one): a dict when it
    carries names, else a list. Arrays land on ``ctx`` or the current
    context, as ``array`` puts them."""
    with open(_npz_name(fname, must_exist=True), "rb") as f:
        buf = f.read()
    if dmlc_serial.sniff(buf):
        arrs, names = dmlc_serial.loads(buf)
        if names:
            return {k: array(v, ctx=ctx) for k, v in zip(names, arrs)}
        return [array(v, ctx=ctx) for v in arrs]
    import io as _io
    try:
        z = np.load(_io.BytesIO(buf))
    except (ValueError, OSError):
        raise MXNetError("load: %s is neither a .params nor an .npz file"
                         % fname)
    keys = list(z.keys())
    if keys and all(k.startswith(_SAVE_LIST_KEY) for k in keys):
        return [array(z[k], ctx=ctx) for k in sorted(keys)]
    return {k: array(z[k], ctx=ctx) for k in keys}


def _npz_name(fname, must_exist=False):
    if (must_exist and not os.path.exists(fname)
            and os.path.exists(fname + ".npz")):
        return fname + ".npz"
    return fname


_init_ndarray_module()
