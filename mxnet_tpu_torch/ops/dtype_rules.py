"""Per-op dtype inference rules (ref: the reference's per-op InferType
functions). Counterpart of ``mxnet_tpu/ops/dtype_rules.py``: most ops keep
the default one-dtype rule of ``OpDef.infer_type``; this module attaches
the exceptions once every op has registered (imported last by
``ops/__init__``). Dtypes are numpy dtypes, as the JAX package's.

- Cast: the output dtype is the attribute, the input free.
- one_hot and the samplers: the output dtype from the ``dtype`` attr
  (default float32), inputs keep their own.
- Embedding: indices keep their dtype; weight and output share a float.
- Loss heads (SoftmaxOutput family) and CTCLoss: the label keeps its own
  dtype.
- count_sketch: the hash indices ``h`` keep their dtype.
- quantize: the output is uint8 and the two ranges pass through;
  dequantize: the output is float32, the uint8 data keeps its dtype.
- where: the condition keeps its dtype; x, y and the output unify.
"""
from __future__ import annotations

import numpy as np

from . import registry as _reg

_F32 = np.dtype(np.float32)


def _set(name, fn):
    if _reg.exists(name):
        _reg.get(name)._infer_type = fn


def _cast_type(attrs, ins):
    return [ins[0]], [np.dtype(str(attrs.get("dtype", "float32")))], []


def _attr_dtype_out(attrs, ins):
    return list(ins), [np.dtype(str(attrs.get("dtype", "float32")))], []


def _embedding_type(attrs, ins):
    data, weight = ins[0], ins[1]
    if weight is None:
        weight = data if (data is not None
                          and np.issubdtype(data, np.floating)) else _F32
    return [data, weight], [weight], []


def _label_free_loss(attrs, ins):
    data = ins[0]
    return [data] + [i if i is not None else data for i in ins[1:]], \
        [data], []


def _count_sketch_type(attrs, ins):
    data, h, s = ins
    return [data, h if h is not None else data,
            s if s is not None else data], [data], []


def _with_ranges(ins):
    """``(data, min_range, max_range)`` with an unknown range taking the
    other's dtype (float32 where neither is known)."""
    data, lo, hi = ins
    lo = next((d for d in (lo, hi) if d is not None), _F32)
    return data, lo, hi if hi is not None else lo


def _quantize_type(attrs, ins):
    data, lo, hi = _with_ranges(ins)
    return [data, lo, hi], [np.dtype(np.uint8), lo, hi], []


def _dequantize_type(attrs, ins):
    data, lo, hi = _with_ranges(ins)
    return [data if data is not None else np.dtype(np.uint8), lo, hi], \
        [_F32], []


def _where_type(attrs, ins):
    known = [d for d in ins[1:] if d is not None]
    dt = known[0] if known else None
    return [ins[0], dt, dt], [dt], []


def install():
    _set("Cast", _cast_type)
    _set("one_hot", _attr_dtype_out)
    for s in ("_random_uniform", "_random_normal", "_random_gamma",
              "_random_exponential", "_random_poisson",
              "_random_negative_binomial",
              "_sample_uniform", "_sample_normal", "_sample_gamma",
              "_sample_exponential", "_sample_poisson",
              "_sample_negbinomial"):
        _set(s, _attr_dtype_out)
    _set("Embedding", _embedding_type)
    for loss in ("SoftmaxOutput", "LinearRegressionOutput",
                 "LogisticRegressionOutput", "MAERegressionOutput",
                 "SVMOutput", "CTCLoss"):
        _set(loss, _label_free_loss)
    _set("count_sketch", _count_sketch_type)
    _set("quantize", _quantize_type)
    _set("dequantize", _dequantize_type)
    _set("where", _where_type)


install()
