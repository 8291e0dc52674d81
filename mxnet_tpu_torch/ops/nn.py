"""Neural-network layer operators.

Counterparts of ``mxnet_tpu/ops/nn.py``: FullyConnected, Convolution,
BatchNorm, Activation, SoftmaxActivation, SoftmaxOutput, Pooling and
Concat, NCHW as in the JAX package. NHWC is taken by permuting around the
NCHW call: the permuted tensor is channels-last in memory, so cuDNN and
the pooling ops keep it so and the NHWC result comes back contiguous.
Convolution goes to ``torch.nn.functional.conv2d``, as the JAX package
leaves it to XLA outside any Pallas kernel. Weights are OIHW in every
layout, so checkpoints transfer.

Loss layers keep the reference's contract: the backward produces the
loss gradient and ignores the incoming one (``SoftmaxOutput`` is a
``torch.autograd.Function``, as the JAX package's is a ``custom_vjp``).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import (attr_bool, attr_float, attr_int, attr_str, attr_tuple,
                    MXNetError)
from .registry import OpDef, register, register_def


#: whether float32 convolutions may run in TF32 on the card. cuDNN's default
#: is TF32, which keeps about three decimal digits; the port's entry points
#: are held against the JAX package's f32 results, so they run full FP32
CONV_TF32 = False


@contextlib.contextmanager
def conv_precision(device):
    """Set cuDNN's TF32 switch to :data:`CONV_TF32` while an entry point
    runs on ``device``, and restore it after."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = CONV_TF32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# FullyConnected (ref: src/operator/fully_connected-inl.h:113-131)
# ---------------------------------------------------------------------------

def _fc_inputs(attrs):
    if attr_bool(attrs.get("no_bias", False), False):
        return ["data", "weight"]
    return ["data", "weight", "bias"]


def _fc_infer(attrs, in_shapes):
    num_hidden = attr_int(attrs["num_hidden"])
    no_bias = attr_bool(attrs.get("no_bias", False), False)
    flatten = attr_bool(attrs.get("flatten", True), True)
    data = in_shapes[0]
    if data is None:
        raise MXNetError("FullyConnected: data shape required")
    if flatten:
        in_units = int(np.prod(data[1:], dtype=np.int64))
        out = (data[0], num_hidden)
    else:
        # contract the last dim only, keep the leading dims
        in_units = data[-1]
        out = tuple(data[:-1]) + (num_hidden,)
    shapes = [tuple(data), (num_hidden, in_units)]
    if not no_bias:
        shapes.append((num_hidden,))
    return shapes, [out], []


def _fc(op_ctx, attrs, inputs, aux):
    no_bias = attr_bool(attrs.get("no_bias", False), False)
    flatten = attr_bool(attrs.get("flatten", True), True)
    data = inputs[0]
    x = data.reshape(data.shape[0], -1) if flatten else data
    # product, then bias: rounded in two steps as the JAX package does
    y = x @ inputs[1].t()
    if not no_bias:
        y = y + inputs[2]
    return (y,)


_FC = register_def(OpDef("FullyConnected", _fc,
                         inputs=("data", "weight", "bias"),
                         infer_shape=_fc_infer))
_FC.list_inputs = _fc_inputs


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
# BatchNorm (ref: src/operator/batch_norm-inl.h:358). Returns the moving
# statistics' updates, which the caller writes back; they and fix_gamma's
# ones carry no gradient.
# ---------------------------------------------------------------------------

def _bn_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        raise MXNetError("BatchNorm: data shape required")
    axis = attr_int(attrs.get("axis", 1), 1)
    c = data[axis] if len(data) > 1 else data[0]
    out_mv = attr_bool(attrs.get("output_mean_var", False), False)
    outs = [tuple(data)] + ([(c,), (c,)] if out_mv else [])
    return [tuple(data), (c,), (c,)], outs, [(c,), (c,)]


def _bn_outputs(attrs):
    if attr_bool(attrs.get("output_mean_var", False), False):
        return ["output", "mean", "var"]
    return ["output"]


def _moving(moving, batch_stat, momentum):
    return momentum * moving + (1 - momentum) * batch_stat.detach().to(
        moving.dtype)


def _batch_norm(op_ctx, attrs, inputs, aux):
    eps = attr_float(attrs.get("eps", 1e-3), 1e-3)
    momentum = attr_float(attrs.get("momentum", 0.9), 0.9)
    fix_gamma = attr_bool(attrs.get("fix_gamma", True), True)
    use_global = attr_bool(attrs.get("use_global_stats", False), False)
    out_mv = attr_bool(attrs.get("output_mean_var", False), False)
    x, gamma, beta = inputs
    moving_mean, moving_var = aux
    axis = attr_int(attrs.get("axis", 1), 1) % x.dim()
    red = tuple(i for i in range(x.dim()) if i != axis)
    bshape = tuple(-1 if i == axis else 1 for i in range(x.dim()))
    if fix_gamma:
        gamma = torch.ones_like(gamma).detach()
    fused = op_ctx.fused_stats
    if op_ctx.is_train and not use_global:
        if fused is not None:
            # statistics from the fused producer (ops/matmul_stats.py): f32
            # sum and sum of squares over the reduced axes, differentiable
            # back into the producer
            s1, s2, count = fused
            mean32 = s1 / count
            var32 = torch.clamp_min(s2 / count - mean32.square(), 0.0)
            mean, var = mean32.to(x.dtype), var32.to(x.dtype)
        elif x.dtype in (torch.bfloat16, torch.float16):
            # one pass: f32 sum and sum of squares in a single read of x
            n = float(np.prod([x.shape[i] for i in red]))
            x32 = x.float()
            mean32 = x32.sum(red) / n
            var32 = torch.clamp_min(x32.square().sum(red) / n
                                    - mean32.square(), 0.0)
            mean, var = mean32.to(x.dtype), var32.to(x.dtype)
        else:
            # two passes, exact for ill-conditioned (|mean| >> std) data
            mean = x.mean(red)
            var = x.var(red, unbiased=False)
            mean32, var32 = mean, var
        aux_updates = (_moving(moving_mean, mean32, momentum),
                       _moving(moving_var, var32, momentum))
    else:
        mean, var = moving_mean, moving_var
        aux_updates = (moving_mean, moving_var)
    inv = torch.rsqrt(var.reshape(bshape) + eps)
    y = ((x - mean.reshape(bshape)) * inv * gamma.reshape(bshape)
         + beta.reshape(bshape))
    outs = (y, mean, var) if out_mv else (y,)
    return outs, aux_updates


register_def(OpDef("BatchNorm", _batch_norm, inputs=("data", "gamma", "beta"),
                   aux=("moving_mean", "moving_var"), infer_shape=_bn_infer,
                   var_outputs=_bn_outputs))


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
# SoftmaxOutput (ref: src/operator/softmax_output-inl.h): forward is the
# softmax; backward emits softmax - onehot(label), scaled, and ignores the
# incoming gradient.
# ---------------------------------------------------------------------------

def _softmax_out_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        raise MXNetError("SoftmaxOutput: data shape required")
    multi = attr_bool(attrs.get("multi_output", False), False)
    preserve = attr_bool(attrs.get("preserve_shape", False), False)
    if preserve:
        label = tuple(data[:-1])
    elif multi:
        label = (data[0],) + tuple(data[2:])
    else:
        label = (data[0],)
    return [tuple(data), label], [tuple(data)], []


def _onehot(lab, n, dim, dtype):
    """One-hot of integer ``lab`` with the class axis inserted at ``dim``;
    a label outside [0, n) gives a row of zeros, as ``jax.nn.one_hot``."""
    shape = [1] * (lab.dim() + 1)
    shape[dim] = n
    classes = torch.arange(n, device=lab.device).reshape(shape)
    return (lab.unsqueeze(dim) == classes).to(dtype)


class _SoftmaxOutput(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, cfg):
        grad_scale, ignore_label, use_ignore, multi, norm, preserve = cfg
        if preserve:
            out = torch.softmax(data, dim=-1)
        elif multi:
            out = torch.softmax(data, dim=1)
        else:
            out = torch.softmax(data.reshape(data.shape[0], -1),
                                dim=-1).reshape(data.shape)
        ctx.save_for_backward(out, label)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, multi, norm, preserve = ctx.cfg
        if preserve:
            lab = label.to(torch.int32)
            grad = out - _onehot(lab, out.shape[-1], lab.dim(), out.dtype)
            expand = (...,) + (None,)
        elif multi:
            lab = label.to(torch.int32)
            grad = out - _onehot(lab, out.shape[1], 1, out.dtype)
            expand = (slice(None), None)
        else:
            lab = label.reshape(label.shape[0]).to(torch.int32)
            grad = out - _onehot(lab, out.shape[1], 1, out.dtype).reshape(
                out.shape)
            expand = (slice(None),) + (None,) * (out.dim() - 1)
        valid = torch.ones(lab.shape, dtype=out.dtype, device=out.device)
        if use_ignore:
            valid = (lab != int(ignore_label)).to(out.dtype)
            grad = grad * valid[expand]
        if norm == "batch":
            grad = grad / out.shape[0]
        elif norm == "valid":
            grad = grad / torch.clamp_min(valid.sum(), 1.0)
        return grad * grad_scale, None, None


@register("SoftmaxOutput", inputs=("data", "label"),
          infer_shape=_softmax_out_infer, aliases=("Softmax",))
def _softmax_output(op_ctx, attrs, inputs, aux):
    cfg = (attr_float(attrs.get("grad_scale", 1.0), 1.0),
           attr_float(attrs.get("ignore_label", -1.0), -1.0),
           attr_bool(attrs.get("use_ignore", False), False),
           attr_bool(attrs.get("multi_output", False), False),
           attr_str(attrs.get("normalization", "null"), "null"),
           attr_bool(attrs.get("preserve_shape", False), False))
    return (_SoftmaxOutput.apply(inputs[0], inputs[1], cfg),)


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
