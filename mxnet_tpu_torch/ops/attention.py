"""Symbol-level attention ops: ``MultiHeadAttention`` and ``LayerNorm``.

Counterpart of ``mxnet_tpu/ops/attention.py``. The JAX package computes
attention in plain JAX (no Pallas kernel): a blockwise (streaming-softmax)
core, ``mxnet_tpu/parallel/ring.py:blockwise_attention``, which never
materialises the full (seq, seq) score matrix. The port's copy of that
core lives in ``parallel/ring.py`` (:func:`blockwise_attention`,
:func:`_block_attn`) and runs the same block loop in torch ops, in the same
order of operations, so float32 results agree with the JAX package's to
rounding. It is not ``torch.nn.functional.scaled_dot_product_attention``,
whose numerics differ.

``seq_parallel="ring"|"ulysses"`` shards the sequence over the 'seq' axis
of the ambient mesh (``parallel.mesh.MeshScope``, or the ``TrainStep``'s
mesh): under a graph walk over the mesh (``executor``) each position
projects its own sequence shard and the shards meet in
``parallel.ring.ring_attention`` or ``ulysses_attention``; a whole tensor
under an ambient mesh is split over it for the call and gathered back.
Without a 'seq' axis it raises, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..base import attr_bool, attr_int, attr_float, attr_str, MXNetError
from ..parallel.ring import _block_attn, blockwise_attention  # noqa: F401
from .registry import OpDef, register_def


# ---------------------------------------------------------------------------
# MultiHeadAttention
# ---------------------------------------------------------------------------

def _mha_attrs(attrs):
    num_heads = attr_int(attrs["num_heads"])
    causal = attr_bool(attrs.get("causal", False), False)
    no_bias = attr_bool(attrs.get("no_bias", False), False)
    seq_par = attr_str(attrs.get("seq_parallel", ""), "")
    block = attr_int(attrs.get("block_size", 0), 0)
    if seq_par not in ("", "ring", "ulysses"):
        raise MXNetError("MultiHeadAttention: seq_parallel must be "
                         "'', 'ring', or 'ulysses'")
    return num_heads, causal, no_bias, seq_par, block


def _mha_inputs(attrs):
    no_bias = attr_bool(attrs.get("no_bias", False), False)
    if no_bias:
        return ["data", "qkv_weight", "out_weight"]
    return ["data", "qkv_weight", "qkv_bias", "out_weight", "out_bias"]


def _mha_infer(attrs, in_shapes):
    num_heads, _, no_bias, _, _ = _mha_attrs(attrs)
    data = in_shapes[0]
    if data is None:
        raise MXNetError("MultiHeadAttention: data shape required")
    if len(data) != 3:
        raise MXNetError("MultiHeadAttention: data must be "
                         "(batch, seq, embed), got %s" % (data,))
    e = data[2]
    if e % num_heads:
        raise MXNetError("MultiHeadAttention: embed %d %% num_heads %d != 0"
                         % (e, num_heads))
    shapes = [tuple(data), (3 * e, e)]
    if not no_bias:
        shapes.append((3 * e,))
    shapes.append((e, e))
    if not no_bias:
        shapes.append((e,))
    return shapes, [tuple(data)], []


def _seq_mesh():
    """The ambient mesh, where it carries a 'seq' axis."""
    from ..parallel import mesh as _mesh
    m = _mesh.current_mesh()
    if m is not None and _mesh.AXIS_SEQ in m.axis_names:
        return m
    return None


def _seq_checks(mesh, seq_par, b, h, s, block):
    """The JAX package's prechecks of a sequence-parallel attention, each
    naming the failing axis: the sequence over 'seq', the batch over
    'data', the heads over 'seq' for Ulysses; ``block_size`` with ring
    refuses."""
    from ..parallel.mesh import check_axis_divides
    check_axis_divides(mesh, "seq", s, "MultiHeadAttention: sequence dim")
    check_axis_divides(mesh, "data", b, "MultiHeadAttention: batch dim")
    if seq_par == "ulysses":
        check_axis_divides(
            mesh, "seq", h,
            "MultiHeadAttention(seq_parallel='ulysses'): num_heads")
    if seq_par == "ring" and block:
        # ring shards K/V across positions; there is no intra-shard
        # blocking to honour, so refuse rather than ignore the bound
        raise MXNetError(
            "MultiHeadAttention: block_size is not supported with "
            "seq_parallel='ring' (K/V are already sharded per "
            "device); unset block_size or use 'ulysses'")


def _seq_attend(q, k, v, causal, block, seq_par):
    """Ring or Ulysses attention over MeshArrays split along 'seq' at dim
    2."""
    from ..parallel import ring as _ring
    if seq_par == "ring":
        return _ring.ring_attention(q, k, v, "seq", causal=causal)
    return _ring.ulysses_attention(
        q, k, v, "seq", attn_fn=lambda a, b_, c: blockwise_attention(
            a, b_, c, block_size=block or None, causal=causal))


def _attend(q, k, v, causal, block, seq_par):
    """(b, h, s, d) -> (b, h, s, d): blockwise on one device, or split over
    the ambient mesh's 'seq' axis (and its 'data' axis) for ``seq_par``."""
    if not seq_par:
        return blockwise_attention(q, k, v, block_size=block or None,
                                   causal=causal)
    mesh = _seq_mesh()
    if mesh is None:
        raise MXNetError(
            "MultiHeadAttention(seq_parallel=%r) needs an ambient mesh "
            "with a 'seq' axis (parallel.mesh.MeshScope / TrainStep "
            "mesh)" % seq_par)
    from ..parallel import mesh as _mesh
    b, h, s, _ = q.shape
    _seq_checks(mesh, seq_par, b, h, s, block)
    bax = "data" if "data" in mesh.axis_names else None
    spec = (bax, None, "seq", None)
    out = _seq_attend(*[_mesh.split_spec(t, mesh, spec) for t in (q, k, v)],
                      causal, block, seq_par)
    return out.gather(q.device)


def _mha(op_ctx, attrs, inputs, aux):
    num_heads, causal, no_bias, seq_par, block = _mha_attrs(attrs)
    if no_bias:
        x, wqkv, wout = inputs
        bqkv = bout = None
    else:
        x, wqkv, bqkv, wout, bout = inputs
    b, s, e = x.shape
    d = e // num_heads
    qkv = torch.einsum("bse,fe->bsf", x, wqkv)
    if bqkv is not None:
        qkv = qkv + bqkv
    qkv = qkv.reshape(b, s, 3, num_heads, d)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    out = _attend(q, k, v, causal, block, seq_par)
    out = out.permute(0, 2, 1, 3).reshape(b, s, e)
    out = torch.einsum("bse,fe->bsf", out, wout)
    if bout is not None:
        out = out + bout
    return (out,)


_MHA = register_def(OpDef(
    "MultiHeadAttention", _mha,
    inputs=("data", "qkv_weight", "qkv_bias", "out_weight", "out_bias"),
    infer_shape=_mha_infer))
_MHA.list_inputs = _mha_inputs


def _mha_mesh(op_ctx, attrs, ins, aux, devices):
    """A sequence-parallel MultiHeadAttention over a mesh with a 'seq'
    axis: each position projects its own sequence shard (the data split
    along 'seq' at dim 1 first, where it is not), the shards meet in ring
    or Ulysses attention, and each position projects its output shard.
    None (the plan's walk) for an attention that is not
    sequence-parallel."""
    from ..parallel import mesh as _mesh
    num_heads, causal, no_bias, seq_par, block = _mha_attrs(attrs)
    x = ins[0]
    mesh = x.mesh
    if not seq_par or _mesh.AXIS_SEQ not in mesh.axis_names:
        return None
    b, s, e = x.shape
    _seq_checks(mesh, seq_par, b, num_heads, s, block)
    x = _mesh.reshard(x, (x.spec[0] if x.spec[0] == "data" else None,
                          "seq", None))
    d = e // num_heads
    qkv = []
    for r, t in enumerate(x.parts):
        w = [p.parts[r] for p in ins[1:]]
        y = torch.einsum("bse,fe->bsf", t, w[0])
        if not no_bias:
            y = y + w[1]
        bl, sl = t.shape[:2]
        y = y.reshape(bl, sl, 3, num_heads, d)
        qkv.append([y[:, :, i].permute(0, 2, 1, 3) for i in range(3)])
    spec = (x.spec[0], None, "seq", None)
    q, k, v = (_mesh.MeshArray(mesh, [t[i] for t in qkv], spec=spec)
               for i in range(3))
    o = _seq_attend(q, k, v, causal, block, seq_par)
    outs = []
    for r, t in enumerate(o.parts):
        bl, _, sl, _ = t.shape
        wout = ins[2 if no_bias else 3].parts[r]
        y = torch.einsum("bse,fe->bsf",
                         t.permute(0, 2, 1, 3).reshape(bl, sl, e), wout)
        if not no_bias:
            y = y + ins[4].parts[r]
        outs.append(y)
    return [_mesh.MeshArray(mesh, outs, spec=x.spec)], None


_MHA.mesh_fn = _mha_mesh
_MHA.mesh_axes = ("data", "seq")


# ---------------------------------------------------------------------------
# LayerNorm (the post-0.9 reference op of the same name)
# ---------------------------------------------------------------------------

def _ln_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        raise MXNetError("LayerNorm: data shape required")
    axis = attr_int(attrs.get("axis", -1), -1) % len(data)
    c = data[axis]
    return [tuple(data), (c,), (c,)], [tuple(data)], []


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """Normalise ``x`` over ``axis``, then scale by ``gamma`` and shift by
    ``beta`` (both along ``axis``), in the JAX package's order."""
    axis = axis % x.dim()
    mean = x.mean(dim=axis, keepdim=True)
    var = torch.square(x - mean).mean(dim=axis, keepdim=True)
    xhat = (x - mean) * torch.rsqrt(var + eps)
    bshape = tuple(-1 if i == axis else 1 for i in range(x.dim()))
    return xhat * gamma.reshape(bshape) + beta.reshape(bshape)


def _layer_norm(op_ctx, attrs, inputs, aux):
    eps = attr_float(attrs.get("eps", 1e-5), 1e-5)
    x, gamma, beta = inputs
    return (layer_norm(x, gamma, beta, attr_int(attrs.get("axis", -1), -1),
                       eps),)


register_def(OpDef("LayerNorm", _layer_norm,
                   inputs=("data", "gamma", "beta"),
                   infer_shape=_ln_infer, mesh_split=True,
                   mesh_axis=("axis", -1)))
