"""Custom operators written in Python (ref: python/mxnet/operator.py,
src/operator/custom/custom.cc).

Counterpart of ``mxnet_tpu/operator.py``, with the same API: subclass
:class:`CustomOp` (``forward``/``backward`` writing through ``assign``),
describe it with a :class:`CustomOpProp`, register it with
``@operator.register("name")`` and use it as ``sym.Custom(...,
op_type="name")`` or ``nd.Custom(...)``.

The JAX package runs the user's ``forward``/``backward`` on host numpy
arrays through ``jax.pure_callback``, since a TPU cannot run Python. Here
they get NDArrays on the op's device, as in the reference, so a custom op
may launch ``rtc`` kernels on the card. The op is a
``torch.autograd.Function``: its backward calls the user's ``backward``
with the tensors that ``declare_backward_dependency`` names (the others
are None), and the output gradients only when ``need_top_grad()``.

The legacy ``PythonOp`` (aliases ``NumpyOp``, ``NDArrayOp``) hands the
user numpy arrays, as the JAX package's does.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .ops.registry import OpDef, register_def

_CUSTOM_PROPS = {}


def register(reg_name):
    """Decorator: register a CustomOpProp subclass under ``reg_name``."""
    def do_register(prop_cls):
        _CUSTOM_PROPS[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_prop_cls(name):
    if name not in _CUSTOM_PROPS:
        raise MXNetError("custom op type %r is not registered" % name)
    return _CUSTOM_PROPS[name]


class CustomOp(object):
    """Base class for custom operator implementations."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` by ``req`` (ref: operator.py)."""
        if req == "null":
            return
        elif req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] += src


class CustomOpProp(object):
    """Operator description (ref: operator.py CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad():
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def _instantiate(attrs):
    op_type = attrs.get("op_type")
    if op_type is None:
        raise MXNetError("Custom op requires op_type attr")
    return get_prop_cls(op_type)(**{k: v for k, v in attrs.items()
                                    if k != "op_type"})


def _custom_inputs(attrs):
    return list(_instantiate(attrs).list_arguments())


def _custom_outputs(attrs):
    return list(_instantiate(attrs).list_outputs())


def _custom_infer(attrs, in_shapes):
    prop = _instantiate(attrs)
    if any(s is None for s in in_shapes):
        raise MXNetError("Custom op %s: all input shapes required"
                         % attrs.get("op_type"))
    in_s, out_s, aux_s = prop.infer_shape([list(s) for s in in_shapes])
    return ([tuple(s) for s in in_s], [tuple(s) for s in out_s],
            [tuple(s) for s in aux_s])


def _nd(t):
    from .ndarray import NDArray
    return NDArray(t)


class _CustomFunction(torch.autograd.Function):
    """The user's forward and backward as one autograd node."""

    @staticmethod
    def forward(ctx, prop, op, is_train, out_shapes, *xs):
        in_data = [_nd(x) for x in xs]
        out_data = [_nd(torch.zeros(s, dtype=xs[0].dtype, device=xs[0].device))
                    for s in out_shapes]
        op.forward(is_train, ["write"] * len(out_data), in_data, out_data, [])
        outs = [o.data for o in out_data]
        n_out, n_in = len(outs), len(xs)
        # ids as the reference numbers them: out_grad, in_data, out_data
        deps = set(prop.declare_backward_dependency(
            list(range(n_out)), list(range(n_out, n_out + n_in)),
            list(range(n_out + n_in, 2 * n_out + n_in))))
        ctx.op, ctx.deps = op, deps
        ctx.need_top_grad = prop.need_top_grad()
        ctx.in_meta = [(x.shape, x.dtype, x.device) for x in xs]
        ctx.out_meta = [(o.shape, o.dtype, o.device) for o in outs]
        # the in_data and out_data the user reads in backward, by their ids
        ctx.kept = [i for i, t in enumerate(list(xs) + outs)
                    if n_out + i in deps]
        ctx.save_for_backward(*[(list(xs) + outs)[i] for i in ctx.kept])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n_out, n_in = len(ctx.out_meta), len(ctx.in_meta)
        data = [None] * (n_in + n_out)
        for i, t in zip(ctx.kept, ctx.saved_tensors):
            data[i] = _nd(t)
        out_grad = []
        for i, (g, (s, d, dev)) in enumerate(zip(gs, ctx.out_meta)):
            if not (ctx.need_top_grad and i in ctx.deps):
                out_grad.append(None)
                continue
            out_grad.append(_nd(g if g is not None
                                else torch.zeros(s, dtype=d, device=dev)))
        in_grad = [_nd(torch.zeros(s, dtype=d, device=dev))
                   for s, d, dev in ctx.in_meta]
        ctx.op.backward(["write"] * n_in, out_grad, data[:n_in],
                        data[n_in:], in_grad, [])
        return (None, None, None, None) + tuple(g.data for g in in_grad)


def _custom_fn(op_ctx, attrs, inputs, aux):
    prop = _instantiate(attrs)
    in_shapes = [tuple(x.shape) for x in inputs]
    _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
    op = prop.create_operator(None, in_shapes, [x.dtype for x in inputs])
    return tuple(_CustomFunction.apply(
        prop, op, bool(op_ctx.is_train), [tuple(s) for s in out_shapes],
        *inputs))


_CUSTOM = register_def(OpDef("Custom", _custom_fn, inputs=("data",),
                             infer_shape=_custom_infer))
_CUSTOM.list_inputs = _custom_inputs
_CUSTOM.list_outputs = _custom_outputs


# ---------------------------------------------------------------------------
# legacy Python-op API (ref: operator.py NumpyOp/NDArrayOp)
# ---------------------------------------------------------------------------

class PythonOp(object):
    """Legacy op: subclass with forward/backward/infer_shape/
    list_arguments/list_outputs on numpy arrays, then call
    ``get_symbol`` (ref: operator.py)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def forward(self, in_data, out_data):
        raise NotImplementedError()

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError()

    def need_top_grad(self):
        return self.need_top_grad_

    def get_symbol(self, *args, **kwargs):
        op_self = self
        reg_name = "_legacy_%s_%d" % (type(self).__name__, id(self))

        def host(arrays):
            return [None if a is None else a.asnumpy() for a in arrays]

        class _Shim(CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                outs = [np.zeros(o.shape, o.dtype) for o in out_data]
                op_self.forward(host(in_data), outs)
                for o, v in zip(out_data, outs):
                    o[:] = v

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                grads = [np.zeros(g.shape, g.dtype) for g in in_grad]
                op_self.backward(host(out_grad), host(in_data),
                                 host(out_data), grads)
                for g, v in zip(in_grad, grads):
                    g[:] = v

        class _ShimProp(CustomOpProp):
            def __init__(self):
                super().__init__(need_top_grad=op_self.need_top_grad())

            def list_arguments(self):
                return op_self.list_arguments()

            def list_outputs(self):
                return op_self.list_outputs()

            def infer_shape(self, in_shape):
                res = op_self.infer_shape(in_shape)
                return (res[0], res[1], []) if len(res) == 2 else res

            def create_operator(self, ctx, in_shapes, in_dtypes):
                return _Shim()

        register(reg_name)(lambda **kw: _ShimProp())
        from . import symbol as sym
        kwargs["op_type"] = reg_name
        return sym.Custom(*args, **kwargs)


NumpyOp = PythonOp
NDArrayOp = PythonOp
