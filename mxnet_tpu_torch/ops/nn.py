"""Neural-network layer operators of the SSD serving slice.

Counterparts of ``mxnet_tpu/ops/nn.py``: Convolution, Activation,
SoftmaxActivation, Pooling and Concat, NCHW as in the JAX package (NHWC is
taken by permuting around the NCHW call). Convolution goes to
``torch.nn.functional.conv2d``, as the JAX package leaves it to XLA outside
any Pallas kernel. Weights are OIHW in every layout, so checkpoints
transfer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import attr_bool, attr_int, attr_str, attr_tuple, MXNetError
from .registry import OpDef, register, register_def


# ---------------------------------------------------------------------------
# Convolution (ref: src/operator/convolution-inl.h:570)
# ---------------------------------------------------------------------------

def _conv_attrs(attrs):
    kernel = attr_tuple(attrs["kernel"])
    nd = len(kernel)
    stride = attr_tuple(attrs.get("stride", (1,) * nd), (1,) * nd)
    dilate = attr_tuple(attrs.get("dilate", (1,) * nd), (1,) * nd)
    pad = attr_tuple(attrs.get("pad", (0,) * nd), (0,) * nd)
    num_filter = attr_int(attrs["num_filter"])
    num_group = attr_int(attrs.get("num_group", 1), 1)
    no_bias = attr_bool(attrs.get("no_bias", False), False)
    return kernel, stride, dilate, pad, num_filter, num_group, no_bias


def _conv_inputs(attrs):
    if attr_bool(attrs.get("no_bias", False), False):
        return ["data", "weight"]
    return ["data", "weight", "bias"]


def _conv_layout(attrs, nd):
    """Activation layout: NCHW (the default) or, for 2-d, NHWC."""
    default = "NCHW" if nd == 2 else ("NCW" if nd == 1 else "NCDHW")
    layout = attr_str(attrs.get("layout", ""), "")
    if not layout or layout == default:
        return default
    if nd != 2 or layout != "NHWC":
        raise MXNetError("Convolution: unsupported layout %r for %d-d"
                         % (layout, nd))
    return layout


def _conv_infer(attrs, in_shapes):
    kernel, stride, dilate, pad, nf, ng, no_bias = _conv_attrs(attrs)
    data = in_shapes[0]
    if data is None:
        raise MXNetError("Convolution: data shape required")
    nhwc = _conv_layout(attrs, len(kernel)) == "NHWC"
    c = data[-1] if nhwc else data[1]
    wshape = (nf, c // ng) + kernel
    out_sp = tuple(
        (data[(1 if nhwc else 2) + i] + 2 * pad[i]
         - dilate[i] * (kernel[i] - 1) - 1) // stride[i] + 1
        for i in range(len(kernel)))
    shapes = [tuple(data), wshape] + ([] if no_bias else [(nf,)])
    out = ((data[0],) + out_sp + (nf,)) if nhwc else ((data[0], nf) + out_sp)
    return shapes, [out], []


_CONV_FNS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv(op_ctx, attrs, inputs, aux):
    kernel, stride, dilate, pad, nf, ng, no_bias = _conv_attrs(attrs)
    x, w = inputs[0], inputs[1]
    nd = len(kernel)
    nhwc = _conv_layout(attrs, nd) == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    y = _CONV_FNS[nd](x, w, None if no_bias else inputs[2], stride=stride,
                      padding=pad, dilation=dilate, groups=ng)
    if nhwc:
        y = y.permute(0, 2, 3, 1)
    return (y,)


_CONV = register_def(OpDef("Convolution", _conv,
                           inputs=("data", "weight", "bias"),
                           infer_shape=_conv_infer))
_CONV.list_inputs = _conv_inputs


# ---------------------------------------------------------------------------
# Activation / softmax (ref: activation-inl.h, softmax_activation-inl.h)
# ---------------------------------------------------------------------------

@register("Activation", inputs=("data",))
def _activation(op_ctx, attrs, inputs, aux):
    act = attr_str(attrs.get("act_type", "relu"), "relu")
    x = inputs[0]
    if act == "relu":
        return (torch.relu(x),)
    if act == "sigmoid":
        return (torch.sigmoid(x),)
    if act == "tanh":
        return (torch.tanh(x),)
    if act == "softrelu":
        return (F.softplus(x),)
    raise MXNetError("Activation: unknown act_type %r" % act)


@register("SoftmaxActivation", inputs=("data",), aliases=("softmax",))
def _softmax_activation(op_ctx, attrs, inputs, aux):
    mode = attr_str(attrs.get("mode", "instance"), "instance")
    x = inputs[0]
    if mode == "channel":
        return (torch.softmax(x, dim=1),)
    return (torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape),)


# ---------------------------------------------------------------------------
# Pooling (ref: src/operator/pooling-inl.h:316). avg pooling divides by the
# constant kernel area (padding included), matching mshadow.
# ---------------------------------------------------------------------------

def _pool_out_dim(in_dim, k, s, p, convention):
    if convention == "full":
        return int(math.ceil((in_dim + 2 * p - k) / float(s))) + 1
    return (in_dim + 2 * p - k) // s + 1


def _pool_nhwc(attrs):
    layout = attr_str(attrs.get("layout", ""), "")
    if layout and layout not in ("NCHW", "NHWC", "NCW", "NCDHW"):
        raise MXNetError("Pooling: unsupported layout %r" % layout)
    return layout == "NHWC"


def _pool_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        raise MXNetError("Pooling: data shape required")
    nhwc = _pool_nhwc(attrs)
    if attr_bool(attrs.get("global_pool", False), False):
        if nhwc:
            return [tuple(data)], [(data[0],) + (1,) * (len(data) - 2)
                                   + (data[-1],)], []
        return [tuple(data)], [tuple(data[:2]) + (1,) * (len(data) - 2)], []
    kernel = attr_tuple(attrs["kernel"])
    nd = len(kernel)
    stride = attr_tuple(attrs.get("stride", (1,) * nd), (1,) * nd)
    pad = attr_tuple(attrs.get("pad", (0,) * nd), (0,) * nd)
    conv = attr_str(attrs.get("pooling_convention", "valid"), "valid")
    sp0 = 1 if nhwc else 2
    out_sp = tuple(_pool_out_dim(data[sp0 + i], kernel[i], stride[i], pad[i],
                                 conv)
                   for i in range(nd))
    if nhwc:
        return [tuple(data)], [(data[0],) + out_sp + (data[-1],)], []
    return [tuple(data)], [tuple(data[:2]) + out_sp], []


def _pooling(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    ptype = attr_str(attrs.get("pool_type", "max"), "max")
    if ptype not in ("max", "avg", "sum"):
        raise MXNetError("Pooling: unknown pool_type %r" % ptype)
    nhwc = _pool_nhwc(attrs)
    if nhwc:
        x = x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))
    if attr_bool(attrs.get("global_pool", False), False):
        red = tuple(range(2, x.dim()))
        if ptype == "max":
            y = torch.amax(x, dim=red, keepdim=True)
        elif ptype == "sum":
            y = torch.sum(x, dim=red, keepdim=True)
        else:
            y = torch.mean(x, dim=red, keepdim=True)
    else:
        y = _window_pool(x, attrs, ptype)
    if nhwc:
        y = y.permute(0, *range(2, y.dim()), 1)
    return (y,)


def _window_pool(x, attrs, ptype):
    """Windowed NC* pooling with the JAX package's padding: ``pad`` on the
    low side, and on the high side whatever the convention's output size
    needs (at least ``pad``), filled with -inf for max and 0 otherwise."""
    kernel = attr_tuple(attrs["kernel"])
    nd = len(kernel)
    if nd != 2:
        raise MXNetError("Pooling: only 2-d windows are ported, got "
                         "kernel %s" % (kernel,))
    stride = attr_tuple(attrs.get("stride", (1,) * nd), (1,) * nd)
    pad = attr_tuple(attrs.get("pad", (0,) * nd), (0,) * nd)
    conv = attr_str(attrs.get("pooling_convention", "valid"), "valid")
    pads = []            # F.pad order: last dim first, (low, high) each
    for i in reversed(range(nd)):
        size = x.shape[2 + i]
        out = _pool_out_dim(size, kernel[i], stride[i], pad[i], conv)
        needed = (out - 1) * stride[i] + kernel[i] - size
        pads += [pad[i], max(pad[i], needed - pad[i])]
    if ptype == "max":
        xp = F.pad(x, pads, value=-math.inf)
        return F.max_pool2d(xp, kernel, stride)
    xp = F.pad(x, pads, value=0.0)
    y = F.avg_pool2d(xp, kernel, stride, divisor_override=1)   # window sums
    if ptype == "avg":
        y = y / (kernel[0] * kernel[1])
    return y


register_def(OpDef("Pooling", _pooling, inputs=("data",),
                   infer_shape=_pool_infer))


# ---------------------------------------------------------------------------
# Concat (ref: concat-inl.h:244)
# ---------------------------------------------------------------------------

def _concat_infer(attrs, in_shapes):
    dim = attr_int(attrs.get("dim", 1), 1)
    known = [s for s in in_shapes if s is not None]
    if not known:
        raise MXNetError("Concat: at least one input shape required")
    base = tuple(known[0])
    filled = [tuple(s) if s is not None else base for s in in_shapes]
    out = list(filled[0])
    out[dim] = sum(s[dim] for s in filled)
    return filled, [tuple(out)], []


@register("Concat", var_inputs_attr="num_args", infer_shape=_concat_infer,
          aliases=("concat",))
def _concat(op_ctx, attrs, inputs, aux):
    dim = attr_int(attrs.get("dim", 1), 1)
    return (torch.cat(inputs, dim=dim),)
