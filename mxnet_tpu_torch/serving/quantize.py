"""Weight-only quantization for the serving tier.

Counterpart of ``mxnet_tpu/serving/quantize.py``, on tensors. Modes
(``MXTPU_SERVE_QUANT`` / the ``quantize=`` argument of ``ServingEngine``):

- ``"none"``  — f32 weights as trained (default).
- ``"bf16"``  — every float weight stored bf16 (round to nearest even, as
  the JAX package's cast), widened to f32 for each dispatch. 2x fewer
  weight bytes, no scales.
- ``"int8"``  — per-channel (axis 0) symmetric int8 for every float
  weight with ndim >= 2: scale = max|w| / 127 per output channel in
  float32, ``q = clip(rint(w / scale), -127, 127)``. 1-D parameters
  (biases, gains) stay f32. ~4x fewer bytes on the matmul and convolution
  weights.

A quantized tree swaps each eligible leaf for ``{"q": int8, "s": f32
(out,)}``; :func:`dequant_leaf` rebuilds the f32 weight as ``q.float() *
s`` with ``s`` along axis 0, the same IEEE operations as the JAX package's
in-graph dequantization, so a quantized engine's f32 views equal the JAX
package's bit for bit, and equal a host-side dequantization too. The
stored arrays themselves equal the JAX package's bit for bit.

Quality is gated, not assumed: :func:`quality_report` compares a probe
batch's outputs from an f32 engine and a quantized one (top-1 agreement,
max |difference|); :func:`check_quality` raises below the floor
(``MXTPU_SERVE_QUANT_MIN_AGREE``, default 0.98).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, env_float

QUANT_MODES = ("none", "bf16", "int8")
_INT8_LEAF_KEYS = frozenset(("q", "s"))


def resolve_mode(mode):
    m = str(mode or "none").lower()
    if m not in QUANT_MODES:
        raise MXNetError("quantize mode must be one of %s, got %r"
                         % (QUANT_MODES, mode))
    return m


def is_quantized_leaf(leaf):
    """True for an int8 ``{"q","s"}`` leaf (treated atomically in trees)."""
    return isinstance(leaf, dict) and set(leaf) == _INT8_LEAF_KEYS


def _as_tensor(arr):
    """Array-like, NDArray or tensor -> tensor (numpy arrays are shared,
    not copied)."""
    data = getattr(arr, "data", arr)
    if isinstance(data, torch.Tensor):
        return data
    if hasattr(arr, "asnumpy"):          # an NDArray of another package
        data = arr.asnumpy()
    return torch.from_numpy(np.asarray(data))


def quantize_array(arr, mode):
    """Quantize one array; returns the stored form, a tensor or a ``{"q",
    "s"}`` dict of tensors, on the array's device (the engine quantizes on
    the host). Arrays the mode does not take (integers; 1-D arrays under
    int8) pass through unchanged."""
    a = _as_tensor(arr)
    if mode == "none" or not a.is_floating_point():
        return a
    if mode == "bf16":
        return a.to(torch.bfloat16)
    if a.dim() < 2:
        return a
    amax = a.to(torch.float32).abs().amax(dim=tuple(range(1, a.dim())))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(a / scale.reshape((-1,) + (1,) * (a.dim()
                                                                 - 1))),
                    -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def quantize_tree(params, mode):
    """Quantize a flat name->array dict. ``mode == "none"`` is identity,
    so callers can run unconditionally."""
    mode = resolve_mode(mode)
    return {k: quantize_array(v, mode) for k, v in params.items()}


def dequant_leaf(leaf):
    """The f32 view of one stored leaf. An f32 (or non-float) leaf passes
    through untouched, so an unquantized engine's weights are used as
    they lie."""
    if is_quantized_leaf(leaf):
        q = leaf["q"]
        return q.to(torch.float32) * leaf["s"].reshape(
            (-1,) + (1,) * (q.dim() - 1))
    if leaf.is_floating_point() and leaf.dtype != torch.float32:
        return leaf.to(torch.float32)
    return leaf


def dequant_tree(params):
    return {k: dequant_leaf(v) for k, v in params.items()}


def _leaf_arrays(tree):
    for v in tree.values():
        if is_quantized_leaf(v):
            yield v["q"]
            yield v["s"]
        else:
            yield v


def tree_bytes(tree):
    """Resident weight bytes of a (possibly quantized) param tree, from
    dtype and shape metadata only (nothing is read back from the card)."""
    return int(sum(a.element_size() * a.numel() for a in _leaf_arrays(tree)))


def quality_report(ref_logits, quant_logits):
    """Compare f32 vs quantized forward outputs on a probe batch.
    Both are (n, classes) host arrays from the SAME inputs."""
    ref = np.asarray(ref_logits, np.float32)
    got = np.asarray(quant_logits, np.float32)
    if ref.shape != got.shape:
        raise MXNetError("quality_report: shape mismatch %s vs %s"
                         % (ref.shape, got.shape))
    agree = float(np.mean(np.argmax(ref, -1) == np.argmax(got, -1)))
    return {"top1_agreement": agree,
            "max_abs_err": float(np.max(np.abs(ref - got))),
            "probe_rows": int(ref.shape[0])}


def check_quality(report, min_agree=None, who="quantize"):
    """Gate: raise unless top-1 agreement clears the floor
    (``MXTPU_SERVE_QUANT_MIN_AGREE``, default 0.98)."""
    if min_agree is None:
        min_agree = env_float("MXTPU_SERVE_QUANT_MIN_AGREE", 0.98)
    agree = float(report["top1_agreement"])
    if agree < float(min_agree):
        raise MXNetError(
            "%s: quantization quality gate FAILED — top-1 agreement "
            "%.4f < floor %.4f over %d probe rows (max|dlogit|=%.3g). "
            "Use bf16 or quantize=none for this model."
            % (who, agree, float(min_agree), report["probe_rows"],
               report["max_abs_err"]))
    return agree
