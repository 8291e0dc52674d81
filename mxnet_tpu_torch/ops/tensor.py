"""Tensor operators: Reshape, Flatten, transpose, ``relu`` and
``negative``, and the elementwise binary families (same-shape, broadcast
and scalar) that symbol arithmetic such as ResNet's ``body + shortcut``
builds. Counterparts of ``mxnet_tpu/ops/tensor.py``.
"""
from __future__ import annotations

import torch

from ..base import attr_bool, attr_tuple, MXNetError
from .registry import (register, register_binary, register_binary_scalar,
                       register_unary)


register_unary("relu", torch.relu)
register_unary("negative", torch.neg)


def _as_dtype_of(fn):
    """A comparison returning 1/0 in the left operand's dtype."""
    return lambda a, b: fn(a, b).to(a.dtype)


# ---------------------------------------------------------------------------
# binary: same-shape elemwise (ref: elemwise_binary_op.h), broadcast
# (ref: elemwise_binary_broadcast_op.h), scalar (ref: *_scalar_op.h). ``mod``
# takes the divisor's sign, as jnp.mod does.
# ---------------------------------------------------------------------------
_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.div, "power": torch.pow, "maximum": torch.maximum,
    "minimum": torch.minimum, "hypot": torch.hypot, "mod": torch.remainder,
    "equal": _as_dtype_of(torch.eq), "not_equal": _as_dtype_of(torch.ne),
    "greater": _as_dtype_of(torch.gt), "greater_equal": _as_dtype_of(torch.ge),
    "lesser": _as_dtype_of(torch.lt), "lesser_equal": _as_dtype_of(torch.le),
}
for _n, _f in _BINARY.items():
    register_binary("_" + _n, _f, aliases=("elemwise_" + _n,))
    register_binary("broadcast_" + _n, _f)

register_binary("_plus", torch.add)
register_binary("_minus", torch.sub)
register_binary("broadcast_plus", torch.add)
register_binary("broadcast_minus", torch.sub)
register_binary("_grad_add", torch.add)
register_binary("maximum", torch.maximum)
register_binary("minimum", torch.minimum)


def _full(x, s):
    return torch.full_like(x, s)


# scalar forms: the scalar arrives as a Python float and the result keeps
# the tensor's dtype
_BINARY_SCALAR = dict(_BINARY)
_BINARY_SCALAR.update({
    "maximum": torch.clamp_min, "minimum": torch.clamp_max,
    "hypot": lambda x, s: torch.hypot(x, _full(x, s)),
})
for _n, _f in _BINARY_SCALAR.items():
    register_binary_scalar("_%s_scalar" % _n, _f)
register_binary_scalar("_plus_scalar", torch.add)
register_binary_scalar("_minus_scalar", torch.sub)
register_binary_scalar("_rminus_scalar", lambda x, s: s - x)
register_binary_scalar("_rdiv_scalar", lambda x, s: s / x)
register_binary_scalar("_rpower_scalar", lambda x, s: torch.pow(s, x))
register_binary_scalar("_rmod_scalar",
                       lambda x, s: torch.remainder(_full(x, s), x))


def _reshape_target(shape_attr, src_shape):
    """Implements the reference Reshape's special codes 0, -1, -2, -3, -4
    (ref: matrix_op-inl.h ReshapeParam)."""
    target = list(shape_attr)
    src = list(src_shape)
    out = []
    src_idx = 0
    i = 0
    while i < len(target):
        s = target[i]
        if s == 0:
            out.append(src[src_idx]); src_idx += 1
        elif s == -1:
            out.append(-1); src_idx += 1
        elif s == -2:
            out.extend(src[src_idx:]); src_idx = len(src)
        elif s == -3:
            out.append(src[src_idx] * src[src_idx + 1]); src_idx += 2
        elif s == -4:
            d1, d2 = target[i + 1], target[i + 2]
            cur = src[src_idx]; src_idx += 1
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2]); i += 2
        else:
            out.append(s); src_idx += 1
        i += 1
    return tuple(out)


@register("Reshape", inputs=("data",), aliases=("reshape",))
def _reshape(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    if "shape" in attrs and attrs["shape"] not in (None, ""):
        tgt = _reshape_target(attr_tuple(attrs["shape"]), x.shape)
    elif attr_bool(attrs.get("reverse", False), False):
        raise MXNetError("Reshape: reverse without shape unsupported")
    else:
        raise MXNetError("Reshape requires shape attr")
    return (torch.reshape(x, tgt),)


@register("Flatten", inputs=("data",), aliases=("flatten",))
def _flatten(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    return (torch.reshape(x, (x.shape[0], -1)),)


@register("transpose", inputs=("data",))
def _transpose(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    axes = attrs.get("axes", None)
    axes = attr_tuple(axes) if axes not in (None, "", ()) else None
    if not axes:
        axes = tuple(range(x.dim() - 1, -1, -1))
    return (x.permute(*axes),)
