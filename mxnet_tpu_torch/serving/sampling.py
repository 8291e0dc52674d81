"""Token sampling on the device for the decode loop.

Counterpart of ``mxnet_tpu/serving/sampling.py``. Two rules make every
decode feature on top of it composable:

1. **Stateless per-(seed, position) randomness.** The uniform driving a
   slot's sample at cache position ``p`` is ``uniform(fold_in(
   PRNGKey(seed), p))`` in the JAX package's ``jax.random`` (threefry2x32,
   partitionable): a pure function of the slot's seed and the absolute
   position, whoever shares the batch and however the prefix got into the
   cache. :func:`position_uniforms` computes the same 32 bits with the
   port's own threefry2x32 (:func:`threefry2x32`), in int64 tensor
   arithmetic masked to 32 bits, on the tensors' device: no host round
   trip a slot.

2. **Inverse-CDF sampling.** The token at a position is the deterministic
   image of that position's uniform under the sorted, temperature-scaled,
   top-k/top-p-filtered distribution, so speculative decoding needs no
   stochastic accept/reject: the verify pass recomputes the same function
   and its stream is token-identical to target-only decoding.

:func:`sample_rows` is the one row-wise sampler of the single-token decode
body and the verify body. Per-row knobs: ``temp`` (0 = greedy argmax, with
no scaling or sort in the value chain), ``top_k`` (0 = off), ``top_p`` (1
= off).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError

_M32 = 0xFFFFFFFF
#: threefry2x32's rotations, alternating by group of four rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the key schedule's parity constant
_KS_PARITY = 0x1BD11BDA


def validate_sampling(temperature, top_k, top_p, who="generate"):
    """Host-side knob validation (the sampler clamps nothing: a nonsense
    knob must fail its caller, not silently skew a stream)."""
    t, k, p = float(temperature), int(top_k), float(top_p)
    if not np.isfinite(t) or t < 0.0:
        raise MXNetError("%s: temperature must be finite and >= 0, got %r"
                         % (who, temperature))
    if k < 0:
        raise MXNetError("%s: top_k must be >= 0 (0 disables), got %r"
                         % (who, top_k))
    if not (0.0 < p <= 1.0):
        raise MXNetError("%s: top_p must be in (0, 1], got %r"
                         % (who, top_p))
    return t, k, p


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) of ``jax.random``, on
    int64 tensors holding unsigned 32-bit values (every add and rotate is
    masked back to 32 bits). Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _M32
    return x0, x1


def position_uniforms(seeds, pos):
    """The per-slot random stream: ``u[i] = uniform(fold_in(PRNGKey(
    seeds[i]), pos[i]))`` as ``jax.random`` gives it, bit for bit, as a
    float32 tensor on ``seeds``' device. ``PRNGKey(s)`` is the key ``(0,
    s)``; ``fold_in(key, p)`` is ``threefry2x32(key, (0, p))``; the 32
    bits of a scalar uniform are ``o0 ^ o1`` of ``threefry2x32(key, (0,
    0))``, and the float is those bits' top 23 under exponent 0, minus
    one."""
    seeds = seeds.to(torch.int64) & _M32
    pos = pos.to(torch.int64) & _M32
    zero = torch.zeros_like(seeds)
    f0, f1 = threefry2x32(zero, seeds, zero, pos)
    o0, o1 = threefry2x32(f0, f1, zero, zero)
    bits = (((o0 ^ o1) >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def sample_rows(logits, u, temp, top_k, top_p):
    """Sample one token per row from ``logits`` (n, vocab) via inverse
    CDF on ``u`` (n,). Rows with ``temp == 0`` return ``argmax(logits)``
    (the first maximum), bitwise the greedy path.

    Filtering is the standard order: temperature-scale, sort descending
    (stable: ties by index), keep the top-k ranks, keep the smallest
    prefix whose exclusive cumulative probability is < top_p (so the head
    token always survives), renormalise implicitly by sampling
    ``u * kept_mass``."""
    vocab = logits.shape[-1]
    dev = logits.device
    greedy = logits.argmax(dim=-1).to(torch.int32)

    one = torch.ones((), dtype=temp.dtype, device=dev)
    safe_t = torch.where(temp > 0, temp, one)
    scaled = logits / safe_t[:, None]
    order = torch.argsort(-scaled, dim=-1, stable=True)
    probs = torch.softmax(torch.gather(scaled, -1, order), dim=-1)

    ranks = torch.arange(vocab, dtype=torch.int32, device=dev)[None, :]
    k_eff = torch.where(top_k > 0, top_k.to(torch.int32),
                        torch.full_like(top_k, vocab, dtype=torch.int32))
    cum = torch.cumsum(probs, dim=-1)
    keep = (ranks < k_eff[:, None]) & ((cum - probs) < top_p[:, None])
    kept = torch.where(keep, probs, torch.zeros((), dtype=probs.dtype,
                                                device=dev))

    cdf = torch.cumsum(kept, dim=-1)
    target = u[:, None] * cdf[:, -1:]
    hit = cdf > target
    # float-edge guard (u ~ 1.0): with no strict crossing, take the last
    # kept rank; ``keep`` is a prefix mask, so that is count - 1
    rank = torch.where(hit.any(dim=-1),
                       hit.to(torch.int8).argmax(dim=-1),
                       keep.sum(dim=-1) - 1)
    sampled = torch.gather(order, -1, rank[:, None])[:, 0].to(torch.int32)
    return torch.where(temp > 0, sampled, greedy)
