"""Symbol-level attention ops: ``MultiHeadAttention`` and ``LayerNorm``.

Counterpart of ``mxnet_tpu/ops/attention.py``. The JAX package computes
attention in plain JAX (no Pallas kernel): a blockwise (streaming-softmax)
core, ``mxnet_tpu/parallel/ring.py:blockwise_attention``, which never
materialises the full (seq, seq) score matrix. The port keeps its own copy
of that core (:func:`blockwise_attention`, :func:`_block_attn`) and runs the
same block loop in torch ops, in the same order of operations, so float32
results agree with the JAX package's to rounding. It is not
``torch.nn.functional.scaled_dot_product_attention``, whose numerics
differ.

``seq_parallel="ring"|"ulysses"`` shards the sequence over a mesh's 'seq'
axis in the JAX package. The port has no mesh yet, so such a symbol builds
and its first forward raises :class:`MXNetError` (ROADMAP.md A.7b).
"""
from __future__ import annotations

import torch

from ..base import attr_bool, attr_int, attr_float, attr_str, MXNetError
from .registry import OpDef, register_def


# ---------------------------------------------------------------------------
# the single-device attention core (copy of mxnet_tpu/parallel/ring.py)
# ---------------------------------------------------------------------------

def _block_attn(q, k, v, m_prev, l_prev, acc, scale):
    """One blockwise-softmax accumulation step (log-sum-exp streaming)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    m_cur = s.amax(dim=-1)
    m_new = torch.maximum(m_prev, m_cur)
    p = torch.exp(s - m_new[..., None])
    l_corr = l_prev * torch.exp(m_prev - m_new)
    l_new = l_corr + p.sum(dim=-1)
    acc = acc * torch.exp(m_prev - m_new)[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, acc


def blockwise_attention(q, k, v, block_size=None, causal=False):
    """Memory-efficient attention via streaming softmax over K/V blocks.

    q, k, v: (batch, heads, seq, dim). Equal to softmax(q k^T / sqrt(d)) v,
    computed one K/V block at a time (``block_size``, default
    ``min(512, seq_k)``); padding and causal positions are masked with
    -inf, and the running maximum is made safe where a row has seen no key
    yet, exactly as the JAX package's ``lax.scan`` body does."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = 1.0 / (d ** 0.5)
    if block_size is None:
        block_size = min(512, sk)
    nblocks = (sk + block_size - 1) // block_size
    pad = nblocks * block_size - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    dev = q.device
    qpos = torch.arange(sq, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=q.dtype, device=dev)
    zero = torch.zeros((), dtype=q.dtype, device=dev)
    m = torch.full_like(q[..., 0], float("-inf"))
    l = torch.zeros_like(q[..., 0])
    acc = torch.zeros_like(q)
    for i in range(nblocks):
        lo = i * block_size
        kblk = k[:, :, lo:lo + block_size]
        vblk = v[:, :, lo:lo + block_size]
        s = torch.einsum("bhqd,bhkd->bhqk", q, kblk) * scale
        kpos = lo + torch.arange(block_size, device=dev)
        mask = (kpos < sk)[None, None, None, :]
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])[None, None]
        s = torch.where(mask, s, neg_inf)
        m_cur = s.amax(dim=-1)
        m_new = torch.maximum(m, m_cur)
        m_safe = torch.where(torch.isneginf(m_new), zero, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), zero)
        corr = torch.where(torch.isneginf(m), zero, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                   vblk)
        m = m_new
    return acc / torch.clamp_min(l, 1e-20)[..., None]


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


def seq_parallel_error(seq_par):
    """The error of a sequence-parallel attention: it needs a mesh with a
    'seq' axis, which the port cannot form yet."""
    return MXNetError(
        "MultiHeadAttention(seq_parallel=%r) needs an ambient mesh with a "
        "'seq' axis (parallel.mesh.MeshScope / TrainStep mesh), which is "
        "not ported yet (ROADMAP.md A.7b)" % seq_par)


def _attend(q, k, v, causal, block, seq_par):
    """(b, h, s, d) -> (b, h, s, d) on one device."""
    if seq_par:
        raise seq_parallel_error(seq_par)
    return blockwise_attention(q, k, v, block_size=block or None,
                               causal=causal)


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
                   infer_shape=_ln_infer))
