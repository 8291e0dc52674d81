"""Neural-network layer operators.

Counterparts of ``mxnet_tpu/ops/nn.py``: FullyConnected, Convolution,
BatchNorm, Activation, SoftmaxActivation, SoftmaxOutput, Pooling, Concat,
L2Normalization, LRN, Dropout, MakeLoss, SliceChannel (``split``) and the
Sequence ops (SequenceLast, SequenceMask, SequenceReverse), NCHW as in the
JAX package. NHWC is taken
by permuting around the NCHW call: the permuted tensor is channels-last
in memory, so cuDNN and the pooling ops keep it so and the NHWC result
comes back contiguous.
Convolution goes to ``torch.nn.functional.conv2d``, as the JAX package
leaves it to XLA outside any Pallas kernel. Weights are OIHW in every
layout, so checkpoints transfer.

Loss layers keep the reference's contract: the backward produces the
loss gradient and ignores the incoming one (``SoftmaxOutput`` and
``MakeLoss`` are ``torch.autograd.Function``s, as the JAX package's are
``custom_vjp``s).
"""
from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..base import (attr_bool, attr_float, attr_int, attr_str, attr_tuple,
                    MXNetError)
from .registry import OpDef, get as get_op, register, register_def


#: whether float32 convolutions may run in TF32 on the card. cuDNN's default
#: is TF32, which keeps about three decimal digits; the port's entry points
#: are held against the JAX package's f32 results, so they run full FP32
CONV_TF32 = False

class _HeldSwitch(object):
    """A process-global backend switch held at one value while any
    section on a CUDA device is open, and given back to the caller after.

    Entry points run on several threads at once (each serving replica's
    batching thread calls ``ServingEngine.infer``, a ``DecodeLoop`` runs
    its own thread). A save, set and restore in each section let one
    thread's restore turn the switch back while another was mid-forward.
    So the sections are counted under a lock: the first to open saves the
    caller's value and sets the held one, the last to close restores the
    saved value. Setting it once at the first entry point was rejected
    because the caller's value must come back."""

    def __init__(self, read, write, held):
        self._read, self._write, self._held = read, write, held
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    @contextlib.contextmanager
    def hold(self, device):
        if device.type != "cuda":
            yield
            return
        with self._lock:
            if self._depth == 0:
                self._saved = self._read()
                self._write(self._held())
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    self._write(self._saved)


def _set_cudnn_tf32(value):
    torch.backends.cudnn.allow_tf32 = value


def _set_matmul_tf32(value):
    torch.backends.cuda.matmul.allow_tf32 = value


_CONV_SWITCH = _HeldSwitch(lambda: torch.backends.cudnn.allow_tf32,
                           _set_cudnn_tf32, lambda: CONV_TF32)
_MATMUL_SWITCH = _HeldSwitch(lambda: torch.backends.cuda.matmul.allow_tf32,
                             _set_matmul_tf32, lambda: False)


def conv_precision(device):
    """Hold cuDNN's TF32 switch at :data:`CONV_TF32` while an entry point
    runs on ``device``, and give the caller's value back after (see
    :class:`_HeldSwitch`). While any entry point runs, the switch reads
    :data:`CONV_TF32`; when none runs, it is the caller's again: a caller
    that runs its own convolutions in TF32 finds them so after the port's
    calls."""
    return _CONV_SWITCH.hold(device)


def matmul_precision(device):
    """Hold cuBLAS's TF32 switch (``torch.backends.cuda.matmul.allow_tf32``)
    off while a float32 entry point's products run on ``device`` (the
    decode loop's), and give the caller's value back after, as
    :func:`conv_precision` does for cuDNN's."""
    return _MATMUL_SWITCH.hold(device)


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
                         infer_shape=_fc_infer, mesh_split=True,
                         mesh_weight="num_hidden"))
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
                           infer_shape=_conv_infer, mesh_split=True,
                           mesh_weight="num_filter"))
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
    # the two factors take the moving statistic's dtype, as the JAX
    # package's weak-typed Python floats do: in bfloat16 (MXTPU_BF16_STATS)
    # 0.9 is 0.8984375, and the update rounds after each operation
    m = float(torch.tensor(momentum, dtype=moving.dtype))
    m1 = float(torch.tensor(1 - momentum, dtype=moving.dtype))
    return m * moving + m1 * batch_stat.detach().to(moving.dtype)


def _bn_attrs(attrs):
    return (attr_float(attrs.get("eps", 1e-3), 1e-3),
            attr_float(attrs.get("momentum", 0.9), 0.9),
            attr_bool(attrs.get("fix_gamma", True), True),
            attr_bool(attrs.get("use_global_stats", False), False),
            attr_bool(attrs.get("output_mean_var", False), False))


def _bn_normalize(x, gamma, beta, mean, var, eps, axis, fix_gamma):
    bshape = tuple(-1 if i == axis else 1 for i in range(x.dim()))
    if fix_gamma:
        gamma = torch.ones_like(gamma).detach()
    inv = torch.rsqrt(var.reshape(bshape) + eps)
    return ((x - mean.reshape(bshape)) * inv * gamma.reshape(bshape)
            + beta.reshape(bshape))


def _batch_norm(op_ctx, attrs, inputs, aux):
    eps, momentum, fix_gamma, use_global, out_mv = _bn_attrs(attrs)
    x, gamma, beta = inputs
    moving_mean, moving_var = aux
    axis = attr_int(attrs.get("axis", 1), 1) % x.dim()
    red = tuple(i for i in range(x.dim()) if i != axis)
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
    y = _bn_normalize(x, gamma, beta, mean, var, eps, axis, fix_gamma)
    outs = (y, mean, var) if out_mv else (y,)
    return outs, aux_updates


def _batch_norm_mesh(op_ctx, attrs, ins, aux, devices):
    """Training BatchNorm over a 'data' mesh: every branch's statistics
    over the whole batch. Each replica's partial sums are summed across
    replicas (``parallel.mesh.all_reduce``) before any replica normalises:
    the fused producer's ``(s1, s2)`` (their cotangents flow back into each
    replica's kernel), the one-pass 16-bit sums, or the two-pass f32 mean
    and then the sum of squared deviations from it. The moving statistics
    move once, from the global values, the same on every replica. None
    (the per-replica op) outside training or for a replicated input."""
    from ..parallel.mesh import MeshArray, all_reduce
    eps, momentum, fix_gamma, use_global, out_mv = _bn_attrs(attrs)
    x, gamma, beta = ins
    if not op_ctx.is_train or use_global or x.axis is None:
        return None
    nd = x.ndim
    axis = attr_int(attrs.get("axis", 1), 1) % nd
    if axis == x.axis:
        raise MXNetError("BatchNorm: channel axis %d is the batch axis the "
                         "'data' mesh splits" % axis)
    red = tuple(i for i in range(nd) if i != axis)
    bshape = tuple(-1 if i == axis else 1 for i in range(nd))
    gshape = x.shape
    n = float(np.prod([gshape[i] for i in red]))
    parts = x.parts
    dt = x.dtype
    fused = op_ctx.fused_stats
    if fused is not None:
        s1 = all_reduce([f[0] for f in fused], devices)
        s2 = all_reduce([f[1] for f in fused], devices)
        count = float(sum(f[2] for f in fused))
        mean32 = [a / count for a in s1]
        var32 = [torch.clamp_min(b / count - m.square(), 0.0)
                 for b, m in zip(s2, mean32)]
        mean = [m.to(dt) for m in mean32]
        var = [v.to(dt) for v in var32]
    elif dt in (torch.bfloat16, torch.float16):
        x32 = [p.float() for p in parts]
        s1 = all_reduce([p.sum(red) for p in x32], devices)
        s2 = all_reduce([p.square().sum(red) for p in x32], devices)
        mean32 = [a / n for a in s1]
        var32 = [torch.clamp_min(b / n - m.square(), 0.0)
                 for b, m in zip(s2, mean32)]
        mean = [m.to(dt) for m in mean32]
        var = [v.to(dt) for v in var32]
    else:
        # two passes, two reductions: the global mean, then the global sum
        # of squared deviations from it
        mean = [a / n for a in all_reduce([p.sum(red) for p in parts],
                                          devices)]
        dev2 = all_reduce([(p - m.reshape(bshape)).square().sum(red)
                           for p, m in zip(parts, mean)], devices)
        var = [d / n for d in dev2]
        mean32, var32 = mean, var
    ys, mm, mv = [], [], []
    for r, p in enumerate(parts):
        ys.append(_bn_normalize(p, gamma.parts[r], beta.parts[r], mean[r],
                                var[r], eps, axis, fix_gamma))
        mm.append(_moving(aux[0].parts[r], mean32[r], momentum))
        mv.append(_moving(aux[1].parts[r], var32[r], momentum))
    mesh = x.mesh
    outs = [MeshArray(mesh, ys, x.axis)]
    if out_mv:
        outs += [MeshArray(mesh, mean, None), MeshArray(mesh, var, None)]
    return outs, [MeshArray(mesh, mm, None), MeshArray(mesh, mv, None)]


register_def(OpDef("BatchNorm", _batch_norm, inputs=("data", "gamma", "beta"),
                   aux=("moving_mean", "moving_var"), infer_shape=_bn_infer,
                   var_outputs=_bn_outputs)).mesh_fn = _batch_norm_mesh


# ---------------------------------------------------------------------------
# Activation / softmax (ref: activation-inl.h, softmax_activation-inl.h)
# ---------------------------------------------------------------------------

@register("Activation", inputs=("data",), mesh_split=True)
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
        _gs, _il, _ui, multi, _norm, preserve, _denom = cfg
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
        (grad_scale, ignore_label, use_ignore, multi, norm, preserve,
         denom) = ctx.cfg
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
        if denom is not None:
            # over a 'data' mesh: the whole batch's normaliser
            grad = grad / denom
        elif norm == "batch":
            grad = grad / out.shape[0]
        elif norm == "valid":
            grad = grad / torch.clamp_min(valid.sum(), 1.0)
        return grad * grad_scale, None, None


def _softmax_cfg(attrs, denom=None):
    return (attr_float(attrs.get("grad_scale", 1.0), 1.0),
            attr_float(attrs.get("ignore_label", -1.0), -1.0),
            attr_bool(attrs.get("use_ignore", False), False),
            attr_bool(attrs.get("multi_output", False), False),
            attr_str(attrs.get("normalization", "null"), "null"),
            attr_bool(attrs.get("preserve_shape", False), False), denom)


@register("SoftmaxOutput", inputs=("data", "label"),
          infer_shape=_softmax_out_infer, aliases=("Softmax",),
          loss_head=True)
def _softmax_output(op_ctx, attrs, inputs, aux):
    return (_SoftmaxOutput.apply(inputs[0], inputs[1], _softmax_cfg(attrs)),)


def _softmax_output_mesh(op_ctx, attrs, ins, aux, devices):
    """SoftmaxOutput over a mesh's 'data' and 'seq' axes: each position's
    shard with the whole array's normaliser, the global batch (``batch``)
    or the valid labels summed over the distinct label shards
    (``valid``). The class axis is gathered first where it is split."""
    from ..parallel import mesh as _mesh
    data, label = ins
    if not data.split_dims():
        return None
    if label.axis is None and data.axis is not None:
        raise MXNetError("SoftmaxOutput: the label of a batch split over a "
                         "'data' mesh must be split too")
    cfg = _softmax_cfg(attrs)
    gs, ignore, use_ignore, multi, norm, preserve, _ = cfg
    nd = data.ndim
    cls = {nd - 1} if preserve else ({1} if multi else set(range(1, nd)))
    for dim, a in data.split_dims():
        if dim in cls:
            data = _mesh.gather_axis(data, a)
    # the label laid out as the data's non-class dimensions
    want = (data.spec[:-1] if preserve else
            (data.spec[:1] + data.spec[2:]) if multi else data.spec[:1])
    if tuple(label.spec[:len(want)]) != tuple(want):
        label = _mesh.reshard(label, want)
    if not data.split_dims():
        return None
    mesh = data.mesh
    denoms = [None] * len(data.parts)
    if norm == "batch":
        denoms = [data.shape[0]] * len(data.parts)
    elif norm == "valid":
        with torch.no_grad():
            pos = _mesh.distinct_positions(mesh, label.spec)
            counts = [((lab != ignore).sum() if use_ignore
                       else torch.tensor(lab.numel(), device=lab.device)
                       ).to(data.dtype)
                      for lab in (label.parts[r] for r in pos)]
            denoms = [torch.clamp_min(c, 1.0)
                      for c in _mesh.all_reduce(counts, devices)]
    outs = [_SoftmaxOutput.apply(d, lab, cfg[:6] + (dn,))
            for d, lab, dn in zip(data.parts, label.parts, denoms)]
    return [_mesh.MeshArray(mesh, outs, spec=data.spec)], None


get_op("SoftmaxOutput").mesh_fn = _softmax_output_mesh
get_op("SoftmaxOutput").mesh_axes = ("data", "seq")


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
          aliases=("concat",), mesh_split=True, mesh_axis=("dim", 1))
def _concat(op_ctx, attrs, inputs, aux):
    dim = attr_int(attrs.get("dim", 1), 1)
    return (torch.cat(inputs, dim=dim),)


# ---------------------------------------------------------------------------
# L2Normalization (ref: src/operator/l2_normalization-inl.h)
# ---------------------------------------------------------------------------

@register("L2Normalization", inputs=("data",))
def _l2_normalization(op_ctx, attrs, inputs, aux):
    eps = attr_float(attrs.get("eps", 1e-10), 1e-10)
    mode = attr_str(attrs.get("mode", "instance"), "instance")
    x = inputs[0]
    if mode == "instance":
        red = tuple(range(1, x.dim()))
    elif mode == "channel":
        red = (1,)
    elif mode == "spatial":
        red = tuple(range(2, x.dim()))
    else:
        raise MXNetError("L2Normalization: unknown mode %r" % mode)
    n = torch.sqrt(torch.sum(torch.square(x), dim=red, keepdim=True) + eps)
    return (x / n,)


# ---------------------------------------------------------------------------
# LRN (ref: src/operator/lrn-inl.h): across-channel local response norm
# ---------------------------------------------------------------------------

@register("LRN", inputs=("data",))
def _lrn(op_ctx, attrs, inputs, aux):
    alpha = attr_float(attrs.get("alpha", 1e-4), 1e-4)
    beta = attr_float(attrs.get("beta", 0.75), 0.75)
    knorm = attr_float(attrs.get("knorm", 2.0), 2.0)
    nsize = attr_int(attrs.get("nsize", 5), 5)
    if nsize % 2 != 1:
        # the window of nsize channels centred on each channel, zero-padded
        # by nsize // 2 on each side, exists only for odd nsize (MXNet
        # checks the same; the JAX package fails on the broadcast)
        raise MXNetError("LRN: nsize must be odd, got %d" % nsize)
    x = inputs[0]
    half = nsize // 2
    sq = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    c = x.shape[1]
    win = sq[:, 0:c]
    for i in range(1, nsize):
        win = win + sq[:, i:i + c]
    return (x * torch.pow(knorm + (alpha / nsize) * win, -beta),)


# ---------------------------------------------------------------------------
# Dropout (ref: src/operator/dropout-inl.h): in training, each element is
# kept with probability 1 - p and scaled by 1 / (1 - p); the mask is drawn
# from the node's generator (executor.node_generator), so a recomputed
# forward draws the same mask
# ---------------------------------------------------------------------------

@register("Dropout", inputs=("data",), needs_rng=True)
def _dropout(op_ctx, attrs, inputs, aux):
    p = attr_float(attrs.get("p", 0.5), 0.5)
    x = inputs[0]
    if not op_ctx.is_train or p <= 0.0:
        return (x,)
    if op_ctx.rng is None:
        raise MXNetError("Dropout requires rng in training mode")
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=op_ctx.rng, device=x.device) < keep
    return (torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device)),)


def _dropout_mesh(op_ctx, attrs, ins, aux, devices):
    """Dropout over a mesh: the mask drawn once at the whole array's shape
    from the node's stream (as one device draws it) and sliced per
    position by the input's spec, so a mesh run masks as the
    single-device run does."""
    from ..parallel.mesh import MeshArray, _narrow
    p = attr_float(attrs.get("p", 0.5), 0.5)
    x = ins[0]
    if not op_ctx.is_train or p <= 0.0 or not x.split_dims():
        return None
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=op_ctx.rng, device=devices[0]) < keep
    outs = [torch.where(_narrow(mask, x.mesh, x.spec, r).to(t.device),
                        t / keep, torch.zeros((), dtype=t.dtype,
                                              device=t.device))
            for r, t in enumerate(x.parts)]
    return [MeshArray(x.mesh, outs, spec=x.spec)], None


get_op("Dropout").mesh_fn = _dropout_mesh
get_op("Dropout").mesh_axes = ("data", "model", "pipe", "seq")


# ---------------------------------------------------------------------------
# MakeLoss (ref: src/operator/make_loss-inl.h): forward is the identity;
# backward emits grad_scale everywhere and ignores the head gradient's value
# ---------------------------------------------------------------------------

class _MakeLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, grad_scale):
        ctx.grad_scale = grad_scale
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.grad_scale), None


@register("MakeLoss", inputs=("data",), loss_head=True)
def _make_loss(op_ctx, attrs, inputs, aux):
    gs = attr_float(attrs.get("grad_scale", 1.0), 1.0)
    # as the JAX package: "batch" divides by the batch, every other value
    # ("valid" included) is taken as "null"
    norm = attr_str(attrs.get("normalization", "null"), "null")
    x = inputs[0]
    if norm == "batch":
        gs = gs / x.shape[0]
    return (_make_loss_head(x, gs),)


def _make_loss_head(x, gs):
    if gs == 0.0:
        # a zero gradient everywhere: the head is a constant of its input,
        # so autograd neither keeps its graph nor sends it a cotangent
        return x.detach()
    return _MakeLoss.apply(x, gs)


def _make_loss_mesh(op_ctx, attrs, ins, aux, devices):
    """MakeLoss over a mesh: ``batch`` normalisation divides by the whole
    batch."""
    from ..parallel.mesh import MeshArray
    x = ins[0]
    if not x.split_dims():
        return None
    gs = attr_float(attrs.get("grad_scale", 1.0), 1.0)
    if attr_str(attrs.get("normalization", "null"), "null") == "batch":
        gs = gs / x.shape[0]
    return [MeshArray(x.mesh, [_make_loss_head(t, gs) for t in x.parts],
                      spec=x.spec)], None


get_op("MakeLoss").mesh_fn = _make_loss_mesh
get_op("MakeLoss").mesh_axes = ("data", "model", "pipe", "seq")


# ---------------------------------------------------------------------------
# SliceChannel (ref: slice_channel-inl.h): ``num_outputs`` equal parts along
# ``axis``, named output0, output1, ...; ``squeeze_axis`` drops the axis
# ---------------------------------------------------------------------------

def _slice_channel_outputs(attrs):
    n = attr_int(attrs.get("num_outputs", 1), 1)
    return ["output%d" % i for i in range(n)]


@register("SliceChannel", inputs=("data",), var_outputs=_slice_channel_outputs,
          aliases=("split",), mesh_split=True, mesh_axis=("axis", 1))
def _slice_channel(op_ctx, attrs, inputs, aux):
    n = attr_int(attrs.get("num_outputs", 1), 1)
    ax = attr_int(attrs.get("axis", 1), 1)
    squeeze = attr_bool(attrs.get("squeeze_axis", False), False)
    x = inputs[0]
    if x.shape[ax] % n:
        raise MXNetError("SliceChannel: axis %d of size %d does not split "
                         "into %d parts" % (ax, x.shape[ax], n))
    parts = torch.split(x, x.shape[ax] // n, dim=ax)
    if squeeze:
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts)


# ---------------------------------------------------------------------------
# Sequence ops (ref: sequence_last/mask/reverse-inl.h): sequence axis 0,
# batch axis 1, as the JAX package's (T, N, ...) layout; with
# ``use_sequence_length`` a second input gives each sequence's length
# ---------------------------------------------------------------------------

def _seq_inputs(attrs):
    if attr_bool(attrs.get("use_sequence_length", False), False):
        return ["data", "sequence_length"]
    return ["data"]


def _seq_op(name, fn):
    od = register_def(OpDef(name, fn, inputs=("data",)))
    od.list_inputs = _seq_inputs


def _along_time(x, idx):
    """``x`` gathered along axis 0 at ``idx`` of shape (T', N)."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 0, idx.expand(idx.shape[:2] + x.shape[2:]))


def _sequence_last(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    if len(inputs) == 2:
        idx = (inputs[1].to(torch.int64) - 1).clamp(0, x.shape[0] - 1)
        return (_along_time(x, idx.reshape(1, -1)).squeeze(0),)
    return (x[-1],)


def _sequence_mask(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    val = attr_float(attrs.get("value", 0.0), 0.0)
    if len(inputs) == 1:
        return (x,)
    t = torch.arange(x.shape[0], device=x.device).reshape(
        (-1, 1) + (1,) * (x.dim() - 2))
    mask = t < inputs[1].to(torch.int64).reshape(
        (1, -1) + (1,) * (x.dim() - 2))
    return (torch.where(mask, x, torch.full((), val, dtype=x.dtype,
                                            device=x.device)),)


def _sequence_reverse(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    if len(inputs) == 1:
        return (torch.flip(x, dims=(0,)),)
    # a length past T reverses the whole sequence (the JAX package's gather
    # reads NaN there)
    seq_len = inputs[1].to(torch.int64).clamp(0, x.shape[0])[None, :]
    t = torch.arange(x.shape[0], device=x.device)[:, None]
    rev_idx = torch.where(t < seq_len, seq_len - 1 - t, t)
    return (_along_time(x, rev_idx),)


_seq_op("SequenceLast", _sequence_last)
_seq_op("SequenceMask", _sequence_mask)
_seq_op("SequenceReverse", _sequence_reverse)
