"""Blockwise attention on one device, and ring and Ulysses attention over
a mesh's 'seq' axis.

Counterpart of ``mxnet_tpu/parallel/ring.py``, and the port's one copy of
the attention core (``ops/attention.py`` and ``ops/transformer_stack.py``
import it). The JAX package runs ring and Ulysses attention inside
``shard_map``, each device holding its sequence shard and the collectives
named by the axis; the port's single controller holds every position's
shard itself, so both functions take the shards explicitly: a list of
tensors, one per position along the axis in order, or a
:class:`~mxnet_tpu_torch.parallel.mesh.MeshArray` whose spec splits the
sequence dimension (dim 2 of ``(batch, heads, seq, dim)``) along the axis,
where each group of positions along it runs its own ring.

- :func:`ring_attention`: each position keeps its queries while the K/V
  shards rotate position to position (``mesh.ppermute``), accumulating
  the streaming-softmax statistics in the JAX package's order, with the
  causal mask on global positions and its ``-inf`` guards;
- :func:`ulysses_attention`: ``mesh.all_to_all`` turns sequence shards
  into head shards, each position attends over the whole sequence for its
  heads, and a second exchange turns the result back.

Both are plain PyTorch, as the JAX package's are plain ``jnp`` (no
Pallas kernel), and differentiable through autograd.
"""
from __future__ import annotations

import functools

import torch

from . import mesh as _mesh


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


def _ring(qs, ks, vs, causal, axis=None):
    """Ring attention over the shards ``qs``/``ks``/``vs`` (one per
    position along the mesh axis ``axis``, in order)."""
    n = len(qs)
    devs = [q.device for q in qs]
    _, _, sq, d = qs[0].shape
    sk = ks[0].shape[2]
    scale = 1.0 / (d ** 0.5)
    m = [torch.full_like(q[..., 0], float("-inf")) for q in qs]
    l = [torch.zeros_like(q[..., 0]) for q in qs]
    acc = [torch.zeros_like(q) for q in qs]
    kr, vr = list(ks), list(vs)
    for i in range(n):
        for my in range(n):
            src = (my - i) % n   # the shard position ``my`` holds now
            q, dev = qs[my], devs[my]
            zero = torch.zeros((), dtype=q.dtype, device=dev)
            s = torch.einsum("bhqd,bhkd->bhqk", q, kr[my]) * scale
            if causal:
                qpos = my * sq + torch.arange(sq, device=dev)
                kpos = src * sk + torch.arange(sk, device=dev)
                mask = (kpos[None, :] <= qpos[:, None])[None, None]
                s = torch.where(mask, s, torch.tensor(
                    float("-inf"), dtype=q.dtype, device=dev))
            m_cur = s.amax(dim=-1)
            m_new = torch.maximum(m[my], m_cur)
            m_safe = torch.where(torch.isneginf(m_new), zero, m_new)
            p = torch.exp(s - m_safe[..., None])
            if causal:
                p = torch.where(mask, p, zero)
            corr = torch.where(torch.isneginf(m[my]), zero,
                               torch.exp(m[my] - m_safe))
            l[my] = l[my] * corr + p.sum(dim=-1)
            acc[my] = acc[my] * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vr[my])
            m[my] = m_new
        if i < n - 1:
            # rotate K/V to the next position around the ring (the JAX
            # package's last rotation feeds nothing and is left out)
            axes = None if axis is None else (axis,)
            kr = _mesh.ppermute(kr, devs, axes=axes)
            vr = _mesh.ppermute(vr, devs, axes=axes)
    return [a / torch.clamp_min(s_, 1e-20)[..., None]
            for a, s_ in zip(acc, l)]


def _ulysses(qs, ks, vs, attn_fn, axis=None):
    """Ulysses attention over the shards (one per position along the mesh
    axis ``axis``, in order)."""
    devs = [q.device for q in qs]
    axes = None if axis is None else (axis,)
    # (b, h, s/n, d) -> (b, h/n, s, d)
    qh = _mesh.all_to_all(qs, devs, 1, 2, axes)
    kh = _mesh.all_to_all(ks, devs, 1, 2, axes)
    vh = _mesh.all_to_all(vs, devs, 1, 2, axes)
    out = [attn_fn(a, b, c) for a, b, c in zip(qh, kh, vh)]
    # back to sequence shards
    return _mesh.all_to_all(out, devs, 2, 1, axes)


def _over_axis(fn, axis_name, q, k, v):
    """``fn`` on lists of shards: directly for lists, else on each group
    of a MeshArray's positions along ``axis_name``."""
    if not isinstance(q, _mesh.MeshArray):
        return fn(list(q), list(k), list(v))
    parts = list(q.parts)
    for grp in _mesh.axis_groups(q.mesh, axis_name):
        out = fn([q.parts[r] for r in grp], [k.parts[r] for r in grp],
                 [v.parts[r] for r in grp])
        for r, o in zip(grp, out):
            parts[r] = o
    return _mesh.MeshArray(q.mesh, parts, spec=q.spec)


def ring_attention(q, k, v, axis_name="seq", causal=False):
    """Ring attention over the 'seq' shards of q, k, v ((batch, heads,
    seq/n, dim) each): lists with one shard per position along the axis,
    or MeshArrays split along ``axis_name`` at dim 2. Returns the output
    shards the same way."""
    return _over_axis(functools.partial(_ring, causal=causal,
                                        axis=axis_name), axis_name, q, k, v)


def ulysses_attention(q, k, v, axis_name="seq", attn_fn=None):
    """Ulysses attention over the 'seq' shards of q, k, v (as
    :func:`ring_attention`): heads exchanged for sequence, ``attn_fn``
    (default :func:`blockwise_attention`) over the whole sequence per head
    shard, and exchanged back."""
    if attn_fn is None:
        attn_fn = blockwise_attention
    return _over_axis(functools.partial(_ulysses, attn_fn=attn_fn,
                                        axis=axis_name), axis_name, q, k, v)
