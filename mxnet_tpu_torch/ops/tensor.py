"""Tensor operators: the unary math menu, the elementwise binary families
(same-shape, broadcast and scalar), reductions, shape and matrix ops,
indexing and embedding, ordering, creation ops and random sampling.
Counterparts of ``mxnet_tpu/ops/tensor.py`` (ref:
src/operator/tensor/*), each computing what the JAX function computes.

Where PyTorch and ``jax.numpy`` differ, the JAX package's meaning wins:
integer sums keep the input's dtype, ``round`` rounds halves to even,
``one_hot`` of an index out of range is a row of zeros, ``dot`` of an N-d
``rhs`` contracts its second-to-last axis. Samplers draw from
``OpContext.rng``, a ``torch.Generator``: the same distributions as the
JAX package's, not the same numbers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import (attr_bool, attr_float, attr_int, attr_tuple, MXNetError,
                    torch_dtype)
from .registry import (OpDef, register, register_binary,
                       register_binary_scalar, register_def, register_unary)

# ---------------------------------------------------------------------------
# unary math menu (ref: mshadow_op.h)
# ---------------------------------------------------------------------------
_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "rint": torch.round,
    "ceil": torch.ceil, "floor": torch.floor, "round": torch.round,
    "fix": torch.trunc, "square": torch.square, "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt, "exp": torch.exp,
    "log": torch.log, "log10": torch.log10, "log2": torch.log2,
    "log1p": torch.log1p, "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "gamma": lambda x: torch.exp(torch.lgamma(x)), "gammaln": torch.lgamma,
    "negative": torch.neg, "sigmoid": torch.sigmoid,
    "relu": torch.relu, "softsign": F.softsign,
    "erf": torch.erf, "reciprocal": torch.reciprocal,
}
for _n, _f in _UNARY.items():
    register_unary(_n, _f)

register_unary("identity", torch.clone, aliases=("_copy",))


@register("BlockGrad", inputs=("data",), aliases=("stop_gradient",))
def _block_grad(op_ctx, attrs, inputs, aux):
    return (inputs[0].detach(),)


@register("Cast", inputs=("data",), aliases=("cast",))
def _cast(op_ctx, attrs, inputs, aux):
    return (inputs[0].to(torch_dtype(str(attrs["dtype"]))),)


@register("clip", inputs=("data",))
def _clip(op_ctx, attrs, inputs, aux):
    return (torch.clamp(inputs[0], attr_float(attrs.get("a_min")),
                        attr_float(attrs.get("a_max"))),)


@register("smooth_l1", inputs=("data",))
def _smooth_l1(op_ctx, attrs, inputs, aux):
    # ref: mshadow_op.h smooth_l1_loss: 0.5 (s x)^2 where |x| < 1/s^2,
    # else |x| - 0.5/s^2
    s = attr_float(attrs.get("scalar", 1.0), 1.0)
    x = inputs[0]
    s2 = s * s
    return (torch.where(x.abs() < 1.0 / s2, 0.5 * s2 * x * x,
                        x.abs() - 0.5 / s2),)


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


@register("expand_dims", inputs=("data",))
def _expand_dims(op_ctx, attrs, inputs, aux):
    return (torch.unsqueeze(inputs[0], attr_int(attrs["axis"])),)


@register("SwapAxis", inputs=("data",), aliases=("swapaxes",))
def _swapaxis(op_ctx, attrs, inputs, aux):
    return (torch.swapaxes(inputs[0], attr_int(attrs.get("dim1", 0), 0),
                           attr_int(attrs.get("dim2", 0), 0)),)


@register("slice", inputs=("data",), aliases=("crop",))
def _slice(op_ctx, attrs, inputs, aux):
    begin = attr_tuple(attrs["begin"])
    end = attr_tuple(attrs["end"])
    return (inputs[0][tuple(slice(b, e) for b, e in zip(begin, end))],)


@register("slice_axis", inputs=("data",))
def _slice_axis(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    ax = attr_int(attrs["axis"]) % x.dim()
    b = attr_int(attrs["begin"], 0) or 0
    e = attrs.get("end", None)
    e = x.shape[ax] if e in (None, "None", "") else attr_int(e)
    if b < 0:
        b += x.shape[ax]
    if e < 0:
        e += x.shape[ax]
    return (torch.narrow(x, ax, b, max(e - b, 0)),)


@register("flip", inputs=("data",), aliases=("reverse",))
def _flip(op_ctx, attrs, inputs, aux):
    return (torch.flip(inputs[0], attr_tuple(attrs["axis"])),)


@register("repeat", inputs=("data",))
def _repeat(op_ctx, attrs, inputs, aux):
    ax = attrs.get("axis", None)
    ax = attr_int(ax) if ax not in (None, "", "None") else None
    return (torch.repeat_interleave(inputs[0], attr_int(attrs["repeats"]),
                                    dim=ax),)


@register("tile", inputs=("data",))
def _tile(op_ctx, attrs, inputs, aux):
    return (torch.tile(inputs[0], attr_tuple(attrs["reps"])),)


def _full_transpose(x):
    return x.permute(*range(x.dim() - 1, -1, -1))


@register("dot", inputs=("lhs", "rhs"))
def _dot(op_ctx, attrs, inputs, aux):
    a, b = inputs
    if attr_bool(attrs.get("transpose_a", False), False):
        a = _full_transpose(a)
    if attr_bool(attrs.get("transpose_b", False), False):
        b = _full_transpose(b)
    # jnp.dot: the last axis of a against b's second-to-last (its only
    # axis when b is 1-d)
    return (torch.tensordot(a, b, dims=([a.dim() - 1],
                                        [max(b.dim() - 2, 0)])),)


@register("batch_dot", inputs=("lhs", "rhs"))
def _batch_dot(op_ctx, attrs, inputs, aux):
    a, b = inputs
    if attr_bool(attrs.get("transpose_a", False), False):
        a = torch.swapaxes(a, -1, -2)
    if attr_bool(attrs.get("transpose_b", False), False):
        b = torch.swapaxes(b, -1, -2)
    return (torch.matmul(a, b),)


# ---------------------------------------------------------------------------
# reductions (ref: tensor/broadcast_reduce_op.h)
# ---------------------------------------------------------------------------

def _parse_axis(attrs, ndim):
    ax = attrs.get("axis", None)
    if ax is None or ax == "":
        return tuple(range(ndim))
    return tuple(a % ndim for a in attr_tuple(ax))


def _over_axes(fn, x, axes, keepdims):
    """``fn(t, dim)`` over several axes at once, for reductions that take
    one ``dim`` only: the axes are moved last and flattened."""
    rest = [d for d in range(x.dim()) if d not in axes]
    y = fn(x.permute(*rest, *axes).reshape(
        [x.shape[d] for d in rest] + [-1]), -1)
    if keepdims:
        y = y.reshape([1 if d in axes else x.shape[d]
                       for d in range(x.dim())])
    return y


def _sum(x, axes, keepdims):
    y = torch.sum(x, dim=axes, keepdim=keepdims)
    # jnp.sum keeps an integer input's dtype (32-bit); torch widens to int64
    return y if x.is_floating_point() else y.to(x.dtype)


def _mean(x, axes, keepdims):
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=axes, keepdim=keepdims)


def _nanprod(x, axes, keepdims):
    return _over_axes(torch.prod, torch.where(torch.isnan(x),
                                              torch.ones_like(x), x),
                      axes, keepdims)


_REDUCE = {
    "sum": _sum, "mean": _mean,
    "prod": lambda x, a, k: _over_axes(torch.prod, x, a, k),
    "nansum": lambda x, a, k: torch.nansum(x, dim=a, keepdim=k),
    "nanprod": _nanprod,
    "max": lambda x, a, k: torch.amax(x, dim=a, keepdim=k),
    "min": lambda x, a, k: torch.amin(x, dim=a, keepdim=k),
}


def _register_reduce(name, tfn, aliases=()):
    def fn(op_ctx, attrs, inputs, aux):
        x = inputs[0]
        return (tfn(x, _parse_axis(attrs, x.dim()),
                    attr_bool(attrs.get("keepdims", False), False)),)
    register_def(OpDef(name, fn, inputs=("data",)), aliases=aliases)


for _n, _f in _REDUCE.items():
    _register_reduce(_n, _f, aliases=(_n + "_axis",) if _n in (
        "sum", "max", "min") else ())


def _register_arg_reduce(name, tfn):
    def fn(op_ctx, attrs, inputs, aux):
        x = inputs[0]
        ax = attrs.get("axis", None)
        if ax is None or ax == "":
            # ref semantics: over the flattened array, index in x's dtype
            return (tfn(x.reshape(-1), 0).to(x.dtype),)
        ax = attr_int(ax) % x.dim()
        r = tfn(x, ax)
        if attr_bool(attrs.get("keepdims", False), False):
            r = torch.unsqueeze(r, ax)
        return (r.to(x.dtype),)
    register_def(OpDef(name, fn, inputs=("data",)))


_register_arg_reduce("argmax", torch.argmax)
_register_arg_reduce("argmin", torch.argmin)


@register("argmax_channel", inputs=("data",))
def _argmax_channel(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    return (torch.argmax(x, dim=1).to(x.dtype),)


@register("norm", inputs=("data",))
def _norm(op_ctx, attrs, inputs, aux):
    # ref: the L2 norm of the whole array, shape (1,)
    return (torch.sqrt(torch.sum(torch.square(inputs[0]))).reshape(1),)


# ---------------------------------------------------------------------------
# broadcast shape ops
# ---------------------------------------------------------------------------

@register("broadcast_to", inputs=("data",))
def _broadcast_to(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    shape = attr_tuple(attrs["shape"])
    # ref semantics: 0 in the target keeps the existing dim
    return (x.expand(*[x.shape[i] if s == 0 else s
                       for i, s in enumerate(shape)]),)


@register("broadcast_axis", inputs=("data",), aliases=("broadcast_axes",))
def _broadcast_axis(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    tgt = list(x.shape)
    for a, s in zip(attr_tuple(attrs["axis"]), attr_tuple(attrs["size"])):
        tgt[a % x.dim()] = s
    return (x.expand(*tgt),)


# ---------------------------------------------------------------------------
# indexing and embedding (ref: tensor/indexing_op.h)
# ---------------------------------------------------------------------------

def _embedding_infer(attrs, in_shapes):
    data = in_shapes[0]
    out_dim = attr_int(attrs["output_dim"])
    if data is None:
        raise MXNetError("Embedding: data shape required")
    return ([data, (attr_int(attrs["input_dim"]), out_dim)],
            [tuple(data) + (out_dim,)], [])


@register("Embedding", inputs=("data", "weight"), infer_shape=_embedding_infer)
def _embedding(op_ctx, attrs, inputs, aux):
    data, weight = inputs
    return (weight[data.long()],)


@register("take", inputs=("a", "indices"))
def _take(op_ctx, attrs, inputs, aux):
    a, idx = inputs
    ax = attr_int(attrs.get("axis", 0), 0) % a.dim()
    mode = str(attrs.get("mode", "clip"))
    idx = idx.long()
    if mode == "clip":
        idx = torch.clamp(idx, 0, a.shape[ax] - 1)
    elif mode == "wrap":
        idx = torch.remainder(idx, a.shape[ax])
    out = torch.index_select(a, ax, idx.reshape(-1))
    return (out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:]),)


@register("batch_take", inputs=("a", "indices"))
def _batch_take(op_ctx, attrs, inputs, aux):
    a, idx = inputs
    return (torch.gather(a, 1, idx.long()[:, None])[:, 0],)


@register("one_hot", inputs=("indices",))
def _one_hot(op_ctx, attrs, inputs, aux):
    depth = attr_int(attrs["depth"])
    on_v = attr_float(attrs.get("on_value", 1.0), 1.0)
    off_v = attr_float(attrs.get("off_value", 0.0), 0.0)
    dt = torch_dtype(str(attrs.get("dtype", "float32")))
    idx = inputs[0].long()
    # an index outside [0, depth) gives a row of zeros, as jax.nn.one_hot
    oh = (idx[..., None] == torch.arange(depth, device=idx.device)).to(dt)
    return ((oh * (on_v - off_v) + off_v).to(dt),)


@register("where", inputs=("condition", "x", "y"))
def _where(op_ctx, attrs, inputs, aux):
    cond, x, y = inputs
    if cond.dim() == 1 and x.dim() > 1:
        cond = cond.reshape((-1,) + (1,) * (x.dim() - 1))
    return (torch.where(cond != 0, x, y),)


# ---------------------------------------------------------------------------
# ordering (ref: tensor/ordering_op-inl.h)
# ---------------------------------------------------------------------------

def _topk_outputs(attrs):
    rt = str(attrs.get("ret_typ", "indices"))
    return ["output0", "output1"] if rt == "both" else ["output"]


@register("topk", inputs=("data",), var_outputs=_topk_outputs)
def _topk(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    ax = attr_int(attrs.get("axis", -1), -1) % x.dim()
    k = attr_int(attrs.get("k", 1), 1)
    rt = str(attrs.get("ret_typ", "indices"))
    if rt == "mask":
        raise MXNetError("topk ret_typ=mask not yet supported")
    vals, idxs = torch.topk(
        x, k, dim=ax, sorted=True,
        largest=not attr_bool(attrs.get("is_ascend", False), False))
    idxs = idxs.to(x.dtype)
    if rt == "value":
        return (vals,)
    if rt == "both":
        return (vals, idxs)
    return (idxs,)


@register("sort", inputs=("data",))
def _sort(op_ctx, attrs, inputs, aux):
    ax = attr_int(attrs.get("axis", -1), -1)
    r = torch.sort(inputs[0], dim=ax, stable=True).values
    if not attr_bool(attrs.get("is_ascend", True), True):
        r = torch.flip(r, (ax,))
    return (r,)


@register("argsort", inputs=("data",))
def _argsort(op_ctx, attrs, inputs, aux):
    x = inputs[0]
    ax = attr_int(attrs.get("axis", -1), -1)
    # stable ascending, flipped for descending, as jnp.argsort then flip
    r = torch.argsort(x, dim=ax, stable=True)
    if not attr_bool(attrs.get("is_ascend", True), True):
        r = torch.flip(r, (ax,))
    return (r.to(x.dtype),)


# ---------------------------------------------------------------------------
# creation ops (ref: tensor/init_op.h): no array inputs, so they land on
# ``OpContext.device``
# ---------------------------------------------------------------------------

def _creation_shape_infer(attrs, in_shapes):
    return [], [attr_tuple(attrs.get("shape", (1,)), (1,))], []


def _dtype_attr(attrs):
    return torch_dtype(str(attrs.get("dtype", "float32")))


def _register_filler(name, value):
    def fn(op_ctx, attrs, inputs, aux):
        v = value if value is not None else attr_float(
            attrs.get("value", 0.0), 0.0)
        return (torch.full(attr_tuple(attrs["shape"]), v,
                           dtype=_dtype_attr(attrs), device=op_ctx.device),)
    register_def(OpDef(name, fn, inputs=(),
                       infer_shape=_creation_shape_infer))


_register_filler("_zeros", 0)
_register_filler("_ones", 1)
_register_filler("_full", None)


@register("zeros_like", inputs=("data",))
def _zeros_like(op_ctx, attrs, inputs, aux):
    return (torch.zeros_like(inputs[0]),)


@register("ones_like", inputs=("data",))
def _ones_like(op_ctx, attrs, inputs, aux):
    return (torch.ones_like(inputs[0]),)


def _arange_args(attrs):
    start = attr_float(attrs.get("start", 0.0), 0.0)
    stop = attrs.get("stop", None)
    step = attr_float(attrs.get("step", 1.0), 1.0)
    if stop in (None, "None", ""):
        start, stop = 0.0, start
    else:
        stop = attr_float(stop)
    return start, stop, step, attr_int(attrs.get("repeat", 1), 1)


def _arange_infer(attrs, in_shapes):
    start, stop, step, rep = _arange_args(attrs)
    return [], [(max(0, int(math.ceil((stop - start) / step))) * rep,)], []


@register("_arange", inputs=(), infer_shape=_arange_infer)
def _arange(op_ctx, attrs, inputs, aux):
    start, stop, step, rep = _arange_args(attrs)
    r = torch.arange(start, stop, step, dtype=_dtype_attr(attrs),
                     device=op_ctx.device)
    return (torch.repeat_interleave(r, rep) if rep > 1 else r,)


# ---------------------------------------------------------------------------
# random sampling (ref: tensor/sample_op.h): scalar parameters, the output
# on the generator's device
# ---------------------------------------------------------------------------

def _gen(op_ctx, name):
    if op_ctx.rng is None:
        raise MXNetError("op %s requires a random generator (rng resource)"
                         % name)
    return op_ctx.rng


def _gamma(alpha, gen):
    """Gamma(alpha, 1) draws, one per element of the tensor ``alpha``."""
    return torch._standard_gamma(alpha, generator=gen)


def _poisson(lam, gen):
    return torch.poisson(lam, generator=gen)


def _neg_binomial(k, p, gen):
    # NB(k, p) = Poisson(Gamma(k, (1 - p) / p)), as the JAX package
    return _poisson(_gamma(k, gen) * ((1.0 - p) / p), gen)


def _draw_scalar(kind, attrs, shape, gen):
    f32 = dict(dtype=torch.float32, device=gen.device)
    if kind == "uniform":
        lo = attr_float(attrs.get("low", 0.0), 0.0)
        hi = attr_float(attrs.get("high", 1.0), 1.0)
        return torch.rand(shape, generator=gen, **f32) * (hi - lo) + lo
    if kind == "normal":
        return (attr_float(attrs.get("loc", 0.0), 0.0)
                + attr_float(attrs.get("scale", 1.0), 1.0)
                * torch.randn(shape, generator=gen, **f32))
    if kind == "gamma":
        alpha = torch.full(shape, attr_float(attrs.get("alpha", 1.0), 1.0),
                           **f32)
        return _gamma(alpha, gen) * attr_float(attrs.get("beta", 1.0), 1.0)
    if kind == "exponential":
        return (torch.empty(shape, **f32).exponential_(1.0, generator=gen)
                / attr_float(attrs.get("lam", 1.0), 1.0))
    if kind == "poisson":
        return _poisson(torch.full(
            shape, attr_float(attrs.get("lam", 1.0), 1.0), **f32), gen)
    k = torch.full(shape, float(attr_int(attrs.get("k", 1), 1)), **f32)
    return _neg_binomial(k, attr_float(attrs.get("p", 1.0), 1.0), gen)


def _register_sample(kind, aliases=()):
    name = "_random_" + kind

    def fn(op_ctx, attrs, inputs, aux):
        gen = _gen(op_ctx, name)
        shape = attr_tuple(attrs.get("shape", (1,)), (1,))
        return (_draw_scalar(kind, attrs, shape, gen).to(_dtype_attr(attrs)),)
    register_def(OpDef(name, fn, inputs=(), needs_rng=True,
                       infer_shape=_creation_shape_infer), aliases=aliases)


_register_sample("uniform", aliases=("uniform", "random_uniform"))
_register_sample("normal", aliases=("normal", "random_normal"))
for _k in ("gamma", "exponential", "poisson", "negative_binomial"):
    _register_sample(_k)


# ---------------------------------------------------------------------------
# tensor-parameter multisampling (ref: tensor/multisample_op.cc): each entry
# of the parameter arrays draws its own ``shape``-shaped block; the output
# is param.shape + shape
# ---------------------------------------------------------------------------

_MULTISAMPLE = {
    "_sample_uniform": (("low", "high"), lambda ps, sh, g: torch.rand(
        sh, generator=g, device=g.device) * (ps[1] - ps[0]) + ps[0]),
    "_sample_normal": (("mu", "sigma"), lambda ps, sh, g: ps[0] + ps[1]
                       * torch.randn(sh, generator=g, device=g.device)),
    "_sample_gamma": (("alpha", "beta"),
                      lambda ps, sh, g: _gamma(ps[0], g) * ps[1]),
    "_sample_exponential": (("lam",), lambda ps, sh, g: torch.empty(
        sh, device=g.device).exponential_(1.0, generator=g) / ps[0]),
    "_sample_poisson": (("lam",), lambda ps, sh, g: _poisson(ps[0], g)),
    "_sample_negbinomial": (("k", "p"),
                            lambda ps, sh, g: _neg_binomial(ps[0], ps[1], g)),
}


def _register_multisample(name, params, draw):
    n = len(params)

    def infer(attrs, in_shapes):
        p0 = in_shapes[0]
        if p0 is None:
            raise MXNetError("%s: parameter shape required" % name)
        tail = attr_tuple(attrs.get("shape", ()), ())
        return [tuple(p0)] * n, [tuple(p0) + tuple(tail)], []

    def fn(op_ctx, attrs, inputs, aux):
        gen = _gen(op_ctx, name)
        if len(inputs) != n:
            raise MXNetError("%s takes %d parameter array(s), got %d"
                             % (name, n, len(inputs)))
        tail = tuple(attr_tuple(attrs.get("shape", ()), ()))
        shape = tuple(inputs[0].shape) + tail
        ps = [p.to(torch.float32).reshape(
            tuple(p.shape) + (1,) * len(tail)).expand(shape).contiguous()
            for p in inputs]
        return (draw(ps, shape, gen).to(_dtype_attr(attrs)),)

    register_def(OpDef(name, fn, inputs=params, needs_rng=True,
                       infer_shape=infer))


for _n, (_params, _draw) in _MULTISAMPLE.items():
    _register_multisample(_n, _params, _draw)
