"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py``: one ``OpDef`` per operator,
holding a plain function on ``torch.Tensor`` plus declarative metadata.
From one registration the port derives the symbolic constructor
(``symbol._make_sym_func``) and shape inference. The default
``infer_shape`` runs the op on ``torch.device("meta")`` tensors, which
carry shapes and no data; ops with learnable inputs override it so weight
shapes complete from the data shape.
"""
from __future__ import annotations

import torch

from ..base import MXNetError


class OpContext(object):
    """Per-invocation context threaded into op functions: ``is_train``
    (ref: OpContext.is_train, include/mxnet/operator.h), a
    ``torch.Generator`` for ops that declared ``needs_rng`` (ref:
    ResourceRequest::kRandom), and ``fused_stats``, the ``(s1, s2, count)``
    batch statistics a fused producer computed (``ops/matmul_stats.py``),
    which BatchNorm's ``fused_stats`` branch consumes."""

    __slots__ = ("is_train", "rng", "fused_stats")

    def __init__(self, is_train=False, rng=None, fused_stats=None):
        self.is_train = is_train
        self.rng = rng
        self.fused_stats = fused_stats


class OpDef(object):
    """A registered operator."""

    def __init__(self, name, fn, inputs=("data",), aux=(), outputs=("output",),
                 infer_shape=None, needs_rng=False, var_inputs_attr=None,
                 var_outputs=None):
        self.name = name
        # fn(op_ctx, attrs, inputs, aux) -> outputs tuple, or
        # (outputs tuple, aux updates tuple) for ops with aux state
        self.fn = fn
        self._inputs = tuple(inputs)
        self._aux = tuple(aux)
        self._outputs = tuple(outputs)
        self._infer_shape = infer_shape
        self.needs_rng = needs_rng
        # e.g. "num_args" for Concat, whose inputs are arg0, arg1, ...
        self.var_inputs_attr = var_inputs_attr
        self.var_outputs = var_outputs   # callable(attrs) -> names, or None

    # -- arity ----------------------------------------------------------
    def list_inputs(self, attrs):
        if self.var_inputs_attr is not None:
            n = int(attrs.get(self.var_inputs_attr, 1))
            return ["arg%d" % i for i in range(n)]
        return list(self._inputs)

    def list_aux(self, attrs):
        return list(self._aux)

    def list_outputs(self, attrs):
        if self.var_outputs is not None:
            return list(self.var_outputs(attrs))
        return list(self._outputs)

    def num_outputs(self, attrs):
        return len(self.list_outputs(attrs))

    # -- execution ------------------------------------------------------
    def apply(self, op_ctx, attrs, inputs, aux):
        """Run the op. Returns ``(outputs tuple, aux updates tuple or
        None)``."""
        out = self.fn(op_ctx, attrs, list(inputs), list(aux))
        if (isinstance(out, tuple) and len(out) == 2
                and isinstance(out[0], (tuple, list))
                and isinstance(out[1], (tuple, list))):
            return tuple(out[0]), tuple(out[1])
        if not isinstance(out, (tuple, list)):
            out = (out,)
        return tuple(out), None

    # -- inference ------------------------------------------------------
    def infer_shape(self, attrs, in_shapes):
        """Complete shapes. ``in_shapes``: list of tuple|None per input.
        Returns (in_shapes, out_shapes, aux_shapes); raises if
        underdetermined."""
        if self._infer_shape is not None:
            return self._infer_shape(attrs, list(in_shapes))
        if any(s is None for s in in_shapes):
            missing = [self.list_inputs(attrs)[i]
                       for i, s in enumerate(in_shapes) if s is None]
            raise MXNetError(
                "op %s: cannot infer shapes of inputs %s (no custom "
                "infer_shape)" % (self.name, missing))
        args = [torch.empty(tuple(s), dtype=torch.float32, device="meta")
                for s in in_shapes]
        try:
            outs, _ = self.apply(OpContext(is_train=False), attrs, args, [])
        except Exception as e:
            raise MXNetError("op %s: meta shape eval failed for %s: %s"
                             % (self.name, in_shapes, e))
        return list(in_shapes), [tuple(o.shape) for o in outs], []


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY = {}
_ALIASES = {}


def register(name, **kwargs):
    """Decorator: register ``fn(op_ctx, attrs, inputs, aux)`` as operator
    ``name``."""
    aliases = kwargs.pop("aliases", ())

    def deco(fn):
        register_def(OpDef(name, fn, **kwargs), aliases=aliases)
        return fn
    return deco


def register_def(opdef, aliases=()):
    _REGISTRY[opdef.name] = opdef
    for a in aliases:
        _ALIASES[a] = opdef.name
    return opdef


def get(name):
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _ALIASES:
        return _REGISTRY[_ALIASES[name]]
    raise MXNetError("operator %r is not registered" % (name,))


def exists(name):
    return name in _REGISTRY or name in _ALIASES


def list_ops():
    return sorted(set(_REGISTRY) | set(_ALIASES))


# ---------------------------------------------------------------------------
# bulk registration of elementwise ops
# ---------------------------------------------------------------------------

def register_unary(name, tfn):
    """Elementwise unary op (ref: MXNET_OPERATOR_REGISTER_UNARY family)."""
    def fn(op_ctx, attrs, inputs, aux):
        return (tfn(inputs[0]),)
    register_def(OpDef(name, fn, inputs=("data",)))


def register_binary(name, tfn, aliases=()):
    """Elementwise binary op over ``lhs`` and ``rhs`` (ref:
    elemwise_binary_op.h, elemwise_binary_broadcast_op.h)."""
    def fn(op_ctx, attrs, inputs, aux):
        return (tfn(inputs[0], inputs[1]),)
    register_def(OpDef(name, fn, inputs=("lhs", "rhs")), aliases=aliases)


def register_binary_scalar(name, tfn):
    """``data`` op the ``scalar`` attr (ref: elemwise_binary_scalar_op.h)."""
    def fn(op_ctx, attrs, inputs, aux):
        return (tfn(inputs[0], float(attrs.get("scalar", 0.0))),)
    register_def(OpDef(name, fn, inputs=("data",)))
