"""Tensor operators of the SSD serving slice: Reshape, Flatten, transpose
(counterparts of ``mxnet_tpu/ops/tensor.py``), and ``relu``, the
elementwise op the repo's legacy symbol-JSON fixtures name.
"""
from __future__ import annotations

import torch

from ..base import attr_bool, attr_tuple, MXNetError
from .registry import register


@register("relu", inputs=("data",))
def _relu(op_ctx, attrs, inputs, aux):
    return (torch.relu(inputs[0]),)


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
