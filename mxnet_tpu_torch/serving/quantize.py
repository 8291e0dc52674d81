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
from ..parallel.mesh import MeshArray, split_spec

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


def _widen(q, s):
    return q.to(torch.float32) * s.reshape((-1,) + (1,) * (q.dim() - 1))


def _widen_float(t):
    if t.is_floating_point() and t.dtype != torch.float32:
        return t.to(torch.float32)
    return t


def _per_shard(fn, first, *rest):
    """``fn`` over a MeshArray's parts (with the matching parts of
    ``rest``), once for each distinct part: positions sharing a shard on
    one device share its result."""
    done, parts = {}, []
    for r, p in enumerate(first.parts):
        key = (id(p),) + tuple(id(a.parts[r]) for a in rest)
        if key not in done:
            done[key] = fn(p, *(a.parts[r] for a in rest))
        parts.append(done[key])
    return MeshArray(first.mesh, parts, spec=first.spec)


def dequant_leaf(leaf):
    """The f32 view of one stored leaf. An f32 (or non-float) leaf passes
    through untouched, so an unquantized engine's weights are used as
    they lie. A leaf laid out over a mesh (MeshArrays) widens each
    position's own shard."""
    if is_quantized_leaf(leaf):
        if isinstance(leaf["q"], MeshArray):
            return _per_shard(_widen, leaf["q"], leaf["s"])
        return _widen(leaf["q"], leaf["s"])
    if isinstance(leaf, MeshArray):
        return (_per_shard(_widen_float, leaf)
                if leaf.dtype.is_floating_point
                and leaf.dtype != torch.float32 else leaf)
    return _widen_float(leaf)


def place_leaf(stored, mesh):
    """A stored leaf (a host tensor, or an int8 ``{"q", "s"}`` pair) laid
    out over a 'model' mesh by ``parallel.placement.model_spec``: the
    int8 payload by the rule, its per-channel scale along the same split
    of axis 0 (replicated where the payload's axis 0 is whole), so each
    position holds its rows' bytes beside their scales (positions on one
    device share a shard, and a replicated leaf one copy a device)."""
    from ..parallel.placement import model_spec
    if not is_quantized_leaf(stored):
        return split_spec(stored, mesh, model_spec(stored.shape, mesh))
    spec = model_spec(stored["q"].shape, mesh)
    s_spec = spec[:1] if len(spec) and spec[0] is not None else ()
    return {"q": split_spec(stored["q"], mesh, spec),
            "s": split_spec(stored["s"], mesh, s_spec)}


def dequant_tree(params):
    return {k: dequant_leaf(v) for k, v in params.items()}


def _leaf_arrays(tree):
    for v in tree.values():
        if is_quantized_leaf(v):
            yield v["q"]
            yield v["s"]
        else:
            yield v


def _nbytes(a, position):
    if not isinstance(a, MeshArray):
        return a.element_size() * a.numel()
    if position is None:        # the whole array, once
        return a.parts[0].element_size() * int(np.prod(a.shape))
    p = a.parts[position]
    return p.element_size() * p.numel()


def tree_bytes(tree, position=None):
    """Resident weight bytes of a (possibly quantized) param tree, from
    dtype and shape metadata only (nothing is read back from the card).
    A tree laid out over a mesh counts each array whole (global across
    the positions), or with ``position=r`` what position ``r`` holds."""
    return int(sum(_nbytes(a, position) for a in _leaf_arrays(tree)))


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
