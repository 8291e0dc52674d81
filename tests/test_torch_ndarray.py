"""The imperative NDArray API of the PyTorch port against the JAX package's
``mx.nd`` on the CPU: every op this slice ports, Python arithmetic,
in-place operators, slice write-back, ``out=``, copies, ``.params`` files
across the packages and the samplers.

The same numpy inputs, made from a seed, go through ``mx.nd.<op>`` and
``mt.nd.<op>``. Tolerances, each with its reason:
- float32 ops ``rtol=1e-5, atol=1e-6``: XLA:CPU and PyTorch sum in other
  orders and approximate transcendental functions differently (a few
  ulps);
- ``gamma``/``gammaln`` and the Adam/RMSProp updates ``rtol=1e-4,
  atol=1e-5``: log-gamma approximations and the square roots and
  divisions of the updates compound those ulps;
- integer and index results, ordering and creation ops exactly;
- samplers by shape, dtype and moments only (the packages draw different
  numbers): the sample mean within 5 standard errors of the
  distribution's mean, the sample variance within 10% of its variance,
  over 40,000 draws.
"""
import zlib

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError

F32 = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=1e-4, atol=1e-5)
EXACT = dict(rtol=0, atol=0)


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _normal(rng, shape, lo=None, hi=None):
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _both(pkg_nd, arrays, ctx):
    return [pkg_nd.array(a, ctx=ctx, dtype=a.dtype) for a in arrays]


def _run(op, arrays, attrs):
    """Run ``op`` in both packages on the same numpy arrays -> (JAX
    outputs, port outputs) as lists of numpy arrays."""
    j = getattr(mx.nd, op)(*_both(mx.nd, arrays, mx.cpu()), **attrs)
    with mt.cpu():
        t = getattr(mt.nd, op)(*_both(mt.nd, arrays, mt.cpu()), **attrs)
    j = j if isinstance(j, list) else [j]
    t = t if isinstance(t, list) else [t]
    return [a.asnumpy() for a in j], [a.asnumpy() for a in t]


# -- one case per op this slice ports (the samplers are below, by moments)
_UNARY_DOMAIN = {
    "log": (0.2, 3), "log10": (0.2, 3), "log2": (0.2, 3), "log1p": (0.2, 3),
    "sqrt": (0.2, 3), "rsqrt": (0.2, 3), "gamma": (0.3, 4),
    "gammaln": (0.3, 4), "arcsin": (-0.9, 0.9), "arccos": (-0.9, 0.9),
    "arctanh": (-0.9, 0.9), "arccosh": (1.1, 4), "reciprocal": (0.5, 2),
}
_UNARY = ["_copy", "abs", "arccos", "arccosh", "arcsin", "arcsinh", "arctan",
          "arctanh", "ceil", "cos", "cosh", "degrees", "erf", "exp", "expm1",
          "fix", "floor", "gamma", "gammaln", "identity", "log", "log10",
          "log1p", "log2", "radians", "reciprocal", "rint", "round", "rsqrt",
          "sigmoid", "sign", "sin", "sinh", "softsign", "sqrt", "square",
          "tan", "tanh"]


def _unary_case(op):
    lo, hi = _UNARY_DOMAIN.get(op, (-2.5, 2.5))
    tol = LOOSE if op in ("gamma", "gammaln") else F32
    return (op, op, lambda r: [_normal(r, (3, 4, 5), lo, hi)], {}, tol)


def _idx(r, shape, n):
    return r.integers(0, n, shape).astype(np.float32)


def _upd(r, n):
    return [_normal(r, (4, 5)) for _ in range(n)]


CASES = [_unary_case(op) for op in _UNARY] + [
    ("BlockGrad", "BlockGrad", lambda r: [_normal(r, (3, 4))], {}, EXACT),
    ("stop_gradient", "stop_gradient", lambda r: [_normal(r, (3, 4))], {},
     EXACT),
    ("Cast_f16", "Cast", lambda r: [_normal(r, (3, 4))],
     dict(dtype="float16"), EXACT),
    ("cast_i32", "cast", lambda r: [_normal(r, (3, 4)) * 5],
     dict(dtype="int32"), EXACT),
    ("clip", "clip", lambda r: [_normal(r, (3, 4))],
     dict(a_min=-0.5, a_max=0.7), EXACT),
    ("smooth_l1", "smooth_l1", lambda r: [_normal(r, (3, 4)) * 2],
     dict(scalar=1.5), F32),
    ("sum", "sum", lambda r: [_normal(r, (2, 3, 4))], dict(axis=(0, 2)), F32),
    ("sum_axis_keep", "sum_axis", lambda r: [_normal(r, (2, 3, 4))],
     dict(axis=1, keepdims=True), F32),
    ("sum_all", "sum", lambda r: [_normal(r, (2, 3, 4))], {}, F32),
    ("mean", "mean", lambda r: [_normal(r, (2, 3, 4))], dict(axis=2), F32),
    ("prod", "prod", lambda r: [_normal(r, (2, 3, 4), 0.5, 1.5)],
     dict(axis=(1, 2)), F32),
    ("nansum", "nansum",
     lambda r: [np.where(_normal(r, (3, 4)) > 1, np.nan,
                         _normal(r, (3, 4))).astype(np.float32)],
     dict(axis=1), F32),
    ("nanprod", "nanprod",
     lambda r: [np.where(_normal(r, (3, 4)) > 1, np.nan,
                         _normal(r, (3, 4), 0.5, 1.5)).astype(np.float32)],
     dict(axis=(0, 1), keepdims=True), F32),
    ("max", "max", lambda r: [_normal(r, (2, 3, 4))], dict(axis=1), EXACT),
    ("max_axis", "max_axis", lambda r: [_normal(r, (2, 3, 4))],
     dict(axis=(0, 2), keepdims=True), EXACT),
    ("min", "min", lambda r: [_normal(r, (2, 3, 4))], {}, EXACT),
    ("min_axis", "min_axis", lambda r: [_normal(r, (2, 3, 4))],
     dict(axis=-1), EXACT),
    ("argmax", "argmax", lambda r: [_normal(r, (3, 5))], dict(axis=1),
     EXACT),
    ("argmax_flat", "argmax", lambda r: [_normal(r, (3, 5))], {}, EXACT),
    ("argmin_keep", "argmin", lambda r: [_normal(r, (3, 5))],
     dict(axis=0, keepdims=True), EXACT),
    ("argmax_channel", "argmax_channel", lambda r: [_normal(r, (4, 6))], {},
     EXACT),
    ("norm", "norm", lambda r: [_normal(r, (3, 4))], {}, F32),
    ("broadcast_to", "broadcast_to", lambda r: [_normal(r, (1, 3))],
     dict(shape=(4, 0)), EXACT),
    ("broadcast_axis", "broadcast_axis", lambda r: [_normal(r, (1, 3, 1))],
     dict(axis=(0, 2), size=(2, 4)), EXACT),
    ("broadcast_axes", "broadcast_axes", lambda r: [_normal(r, (3, 1))],
     dict(axis=1, size=5), EXACT),
    ("expand_dims", "expand_dims", lambda r: [_normal(r, (3, 4))],
     dict(axis=-1), EXACT),
    ("SwapAxis", "SwapAxis", lambda r: [_normal(r, (2, 3, 4))],
     dict(dim1=0, dim2=2), EXACT),
    ("swapaxes", "swapaxes", lambda r: [_normal(r, (2, 3, 4))],
     dict(dim1=1, dim2=2), EXACT),
    ("slice", "slice", lambda r: [_normal(r, (4, 5, 3))],
     dict(begin=(1, 0), end=(3, 4)), EXACT),
    ("crop", "crop", lambda r: [_normal(r, (4, 5))],
     dict(begin=(0, -3), end=(2, 5)), EXACT),
    ("slice_axis", "slice_axis", lambda r: [_normal(r, (4, 5))],
     dict(axis=1, begin=1, end=-1), EXACT),
    ("slice_axis_open", "slice_axis", lambda r: [_normal(r, (4, 5))],
     dict(axis=0, begin=-2, end=None), EXACT),
    ("flip", "flip", lambda r: [_normal(r, (3, 4))], dict(axis=1), EXACT),
    ("reverse", "reverse", lambda r: [_normal(r, (3, 4, 2))],
     dict(axis=(0, 2)), EXACT),
    ("repeat", "repeat", lambda r: [_normal(r, (3, 4))],
     dict(repeats=2, axis=1), EXACT),
    ("repeat_flat", "repeat", lambda r: [_normal(r, (3, 2))],
     dict(repeats=3), EXACT),
    ("tile", "tile", lambda r: [_normal(r, (3, 2))], dict(reps=(2, 1, 3)),
     EXACT),
    ("dot", "dot", lambda r: [_normal(r, (3, 4)), _normal(r, (4, 5))], {},
     F32),
    ("dot_transposed", "dot", lambda r: [_normal(r, (4, 3)),
                                         _normal(r, (5, 4))],
     dict(transpose_a=True, transpose_b=True), F32),
    ("dot_vector", "dot", lambda r: [_normal(r, (3, 4)), _normal(r, (4,))],
     {}, F32),
    ("batch_dot", "batch_dot", lambda r: [_normal(r, (2, 3, 4)),
                                          _normal(r, (2, 5, 4))],
     dict(transpose_b=True), F32),
    ("Embedding", "Embedding", lambda r: [_idx(r, (3, 4), 10),
                                          _normal(r, (10, 5))],
     dict(input_dim=10, output_dim=5), EXACT),
    ("take_clip", "take", lambda r: [_normal(r, (5, 3)),
                                     np.array([[0, 4], [7, -2]], np.float32)],
     {}, EXACT),
    ("take_wrap_axis1", "take", lambda r: [_normal(r, (2, 5)),
                                           np.array([1, 6, -1], np.float32)],
     dict(axis=1, mode="wrap"), EXACT),
    ("batch_take", "batch_take", lambda r: [_normal(r, (4, 5)),
                                            _idx(r, (4,), 5)], {}, EXACT),
    ("one_hot", "one_hot", lambda r: [np.array([0, 2, 5, -1, 3],
                                               np.float32)],
     dict(depth=4, on_value=2.0, off_value=-1.0), EXACT),
    ("where", "where", lambda r: [(r.random((3, 4)) > 0.5).astype(
        np.float32), _normal(r, (3, 4)), _normal(r, (3, 4))], {}, EXACT),
    ("where_rows", "where", lambda r: [np.array([1, 0, 1], np.float32),
                                       _normal(r, (3, 4)),
                                       _normal(r, (3, 4))], {}, EXACT),
    ("topk_indices", "topk", lambda r: [_normal(r, (3, 6))], dict(k=2),
     EXACT),
    ("topk_both_asc", "topk", lambda r: [_normal(r, (4, 3))],
     dict(k=3, axis=0, ret_typ="both", is_ascend=True), EXACT),
    ("topk_value", "topk", lambda r: [_normal(r, (3, 6))],
     dict(k=4, ret_typ="value"), EXACT),
    ("sort", "sort", lambda r: [_normal(r, (3, 6))], {}, EXACT),
    ("sort_desc", "sort", lambda r: [_normal(r, (3, 6))],
     dict(axis=0, is_ascend=False), EXACT),
    ("argsort", "argsort", lambda r: [_normal(r, (3, 6))], {}, EXACT),
    ("argsort_desc_ties", "argsort",
     lambda r: [np.round(_normal(r, (2, 8)))], dict(is_ascend=False), EXACT),
    ("_zeros", "_zeros", lambda r: [], dict(shape=(2, 3)), EXACT),
    ("_ones", "_ones", lambda r: [], dict(shape=(4,), dtype="int32"), EXACT),
    ("_full", "_full", lambda r: [], dict(shape=(2, 2), value=2.5), EXACT),
    ("_arange", "_arange", lambda r: [],
     dict(start=1.0, stop=7.0, step=1.5, repeat=2), EXACT),
    ("_arange_stop_only", "_arange", lambda r: [], dict(start=5), EXACT),
    ("zeros_like", "zeros_like", lambda r: [_normal(r, (3, 2))], {}, EXACT),
    ("ones_like", "ones_like", lambda r: [_normal(r, (3, 2))], {}, EXACT),
    ("sgd_update", "sgd_update", lambda r: _upd(r, 2),
     dict(lr=0.1, wd=1e-3, rescale_grad=0.5, clip_gradient=0.3), F32),
    ("sgd_mom_update", "sgd_mom_update", lambda r: _upd(r, 3),
     dict(lr=0.1, momentum=0.9, wd=1e-4, rescale_grad=1.0 / 128), F32),
    ("adam_update", "adam_update",
     lambda r: _upd(r, 3) + [np.abs(_normal(r, (4, 5)))],
     dict(lr=0.01, wd=1e-3, clip_gradient=1.0), LOOSE),
    ("rmsprop_update", "rmsprop_update",
     lambda r: _upd(r, 2) + [np.abs(_normal(r, (4, 5)))],
     dict(lr=0.01, gamma1=0.9, clip_weights=0.5), LOOSE),
    ("rmspropalex_update", "rmspropalex_update",
     lambda r: _upd(r, 2) + [np.abs(_normal(r, (4, 5))) + 1,
                             _normal(r, (4, 5)) * 0.1, _normal(r, (4, 5))],
     dict(lr=0.01, wd=1e-4), LOOSE),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_against_jax(case):
    name, op, make, attrs, tol = case
    arrays = make(_rng(name))
    jouts, touts = _run(op, arrays, attrs)
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        assert t.shape == j.shape and t.dtype == j.dtype, (t.shape, j.shape,
                                                           t.dtype, j.dtype)
        np.testing.assert_allclose(t, j, equal_nan=True, **tol)


def test_every_tensor_and_update_op_is_ported():
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg
    mods = ("mxnet_tpu.ops.tensor", "mxnet_tpu.ops.registry",
            "mxnet_tpu.ops.optimizer_op", "mxnet_tpu.operator")
    want = [n for n in jreg.list_ops() if jreg.get(n).fn.__module__ in mods]
    missing = [n for n in want if not treg.exists(n)]
    assert not missing
    assert all(hasattr(mt.nd, n) and hasattr(mt.sym, n) for n in want)


# -- Python arithmetic: broadcasting, scalars, reverse operands -----------
ARITH = [
    ("add", lambda a, b: a + b), ("sub_bcast", lambda a, b: a - b[0:1]),
    ("mul", lambda a, b: a * b), ("div_bcast", lambda a, b: a / b[1:2]),
    ("pow_scalar", lambda a, b: a ** 2), ("radd", lambda a, b: 3 + a),
    ("rsub", lambda a, b: 2 - a), ("rmul", lambda a, b: 0.5 * a),
    ("rdiv", lambda a, b: 2 / b), ("rpow", lambda a, b: 2 ** a),
    ("mod", lambda a, b: a % 0.7), ("neg", lambda a, b: -a),
    ("eq", lambda a, b: a == b), ("ne_scalar", lambda a, b: a != 0),
    ("gt", lambda a, b: a > b), ("ge_bcast", lambda a, b: a >= b[2:3]),
    ("lt_scalar", lambda a, b: a < 0.1), ("le", lambda a, b: a <= b),
    ("chain", lambda a, b: (a * 2 + b) / (b * b + 1) - a),
]


@pytest.mark.parametrize("case", ARITH, ids=[c[0] for c in ARITH])
def test_arithmetic_against_jax(case):
    name, fn = case
    r = _rng(name)
    a = np.round(_normal(r, (3, 4)), 1)
    b = np.round(_normal(r, (3, 4)), 1) + 2.0
    b[0, 0] = a[0, 0]
    ja, jb = _both(mx.nd, [a, b], mx.cpu())
    with mt.cpu():
        ta, tb = _both(mt.nd, [a, b], mt.cpu())
        got = fn(ta, tb).asnumpy()
    np.testing.assert_allclose(got, fn(ja, jb).asnumpy(), **F32)


INPLACE = [
    ("iadd", lambda x, y: x.__iadd__(y)),
    ("isub_scalar", lambda x, y: x.__isub__(2.0)),
    ("imul", lambda x, y: x.__imul__(y)),
    ("itruediv", lambda x, y: x.__itruediv__(4.0)),
]


@pytest.mark.parametrize("case", INPLACE, ids=[c[0] for c in INPLACE])
def test_inplace_operators_against_jax(case):
    name, fn = case
    r = _rng(name)
    a, b = _normal(r, (3, 4)), _normal(r, (3, 4))
    ja, jb = _both(mx.nd, [a, b], mx.cpu())
    ta, tb = _both(mt.nd, [a, b], mt.cpu())
    keep = ta.data
    assert fn(ta, tb) is ta and fn(ja, jb) is ja
    np.testing.assert_allclose(ta.asnumpy(), ja.asnumpy(), **F32)
    # the old tensor is left as it was (the array was rebound)
    np.testing.assert_array_equal(keep.numpy(), a)


def _write_back(pkg_nd, ctx, a):
    x = pkg_nd.array(a, ctx=ctx)
    out = {}
    y = x[1:3]
    y[:] = 0
    out["step1_slice"] = x.asnumpy().copy()
    z = x[3]
    z[:] = 5
    out["int_key"] = x.asnumpy().copy()
    w = x[::2]
    w[:] = -1
    out["step2_slice"] = x.asnumpy().copy()
    out["step2_view"] = w.asnumpy().copy()
    v = x[1:4]
    v[1:2] = 9
    out["nested_slice"] = x.asnumpy().copy()
    c = x[:, 1]
    c[:] = 7
    out["column"] = x.asnumpy().copy()
    x[0:2] = 3
    out["setitem_slice"] = x.asnumpy().copy()
    return out


def test_slice_write_back_matches_jax():
    a = _normal(_rng("wb"), (5, 3))
    j = _write_back(mx.nd, mx.cpu(), a)
    t = _write_back(mt.nd, mt.cpu(), a)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    # step-1 slices write back, x[::2] and x[:, 1] are copies
    assert (t["step1_slice"][1:3] == 0).all()
    assert (t["step2_slice"] == t["int_key"]).all()


def test_first_axis_slice_is_a_view_of_the_parent():
    x = mt.nd.array(np.zeros((4, 3), np.float32), ctx=mt.cpu())
    y = x[1:3]
    y.data.fill_(2.0)    # a raw write, as a user kernel makes it
    np.testing.assert_array_equal(x.asnumpy()[1:3], 2.0)
    y[:] = 1.0           # still a view after an assignment
    y.data.fill_(4.0)
    np.testing.assert_array_equal(x.asnumpy(),
                                  [[0] * 3, [4] * 3, [4] * 3, [0] * 3])


@pytest.mark.parametrize("bad", ["shape", "dtype", "count"])
def test_out_errors_match_jax(bad):
    a = _normal(_rng("out"), (3, 4))
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        x = pkg.nd.array(a, ctx=ctx)
        if bad == "shape":
            out, op, args = pkg.nd.zeros((4, 3), ctx=ctx), "exp", [x]
        elif bad == "dtype":
            out = pkg.nd.zeros((3, 4), ctx=ctx, dtype=np.int32)
            op, args = "exp", [x]
        else:
            out, op, args = [pkg.nd.zeros((3, 4), ctx=ctx)], \
                "sgd_mom_update", [x, x, x]
        with pytest.raises(pkg.MXNetError, match=bad if bad != "count"
                           else "output"):
            getattr(pkg.nd, op)(*args, out=out, **(
                dict(lr=0.1) if op == "sgd_mom_update" else {}))


def test_out_writes_results_like_jax():
    r = _rng("out_ok")
    w, g, m = _normal(r, (3, 4)), _normal(r, (3, 4)), _normal(r, (3, 4))
    attrs = dict(lr=0.1, momentum=0.9, wd=1e-4)
    res = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        tw, tg, tm = (pkg.nd.array(v, ctx=ctx) for v in (w, g, m))
        got = pkg.nd.sgd_mom_update(tw, tg, tm, out=[tw, tm], **attrs)
        assert got[0] is tw and got[1] is tm
        res.append((tw.asnumpy(), tm.asnumpy()))
    for j, t in zip(*res):
        np.testing.assert_allclose(t, j, **F32)


def test_copyto_and_as_in_context():
    a = _normal(_rng("copy"), (2, 3))
    x = mt.nd.array(a, ctx=mt.cpu())
    y = mt.nd.zeros((2, 3), ctx=mt.cpu())
    assert x.copyto(y) is y
    np.testing.assert_array_equal(y.asnumpy(), a)
    assert y.data.data_ptr() != x.data.data_ptr()
    z = x.copyto(mt.cpu())
    assert z is not x and z.context == mt.cpu()
    np.testing.assert_array_equal(z.asnumpy(), a)
    assert x.as_in_context(mt.cpu()) is x
    with pytest.raises(MXNetError, match="shape mismatch"):
        x.copyto(mt.nd.zeros((3, 2), ctx=mt.cpu()))
    # the JAX package says the same
    jx = mx.nd.array(a)
    with pytest.raises(mx.MXNetError, match="shape mismatch"):
        jx.copyto(mx.nd.zeros((3, 2)))


def test_array_api_against_jax():
    r = _rng("api")
    a = _normal(r, (2, 3, 4))
    ja = mx.nd.array(a)
    with mt.cpu():
        ta = mt.nd.array(a)
        pairs = [
            (ta.T, ja.T), (ta.reshape((6, 4)), ja.reshape((6, 4))),
            (ta.astype("float16"), ja.astype("float16")),
            (ta.broadcast_to((2, 2, 3, 4)), ja.broadcast_to((2, 2, 3, 4))),
            (mt.nd.concatenate([ta, ta], axis=1),
             mx.nd.concatenate([ja, ja], axis=1)),
            (mt.nd.add_n(ta, ta, ta), mx.nd.add_n(ja, ja, ja)),
            (mt.nd.moveaxis(ta, 0, 2), mx.nd.moveaxis(ja, 0, 2)),
            (mt.nd.arange(2, 11, 3, repeat=2), mx.nd.arange(2, 11, 3,
                                                            repeat=2)),
            (mt.nd.full((2, 2), 7.0), mx.nd.full((2, 2), 7.0)),
            (mt.nd.empty((3,), dtype=np.int32),
             mx.nd.empty((3,), dtype=np.int32)),
            (ta[1], ja[1]), (ta[0, 1:3], ja[0, 1:3]),
        ]
        oh_t = mt.nd.zeros((3, 4))
        mt.nd.onehot_encode(mt.nd.array([2, 0, 3]), oh_t)
    oh_j = mx.nd.zeros((3, 4))
    mx.nd.onehot_encode(mx.nd.array([2, 0, 3]), oh_j)
    pairs.append((oh_t, oh_j))
    for t, j in pairs:
        assert t.shape == j.shape and t.dtype == j.dtype
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **F32)
    assert ta.size == ja.size and ta.ndim == ja.ndim and len(ta) == len(ja)
    assert mt.nd.array([3.5], ctx=mt.cpu()).asscalar() == np.float32(3.5)
    for src in (np.arange(3.0), [1, 2], np.array([1, 2], np.uint64),
                np.array([True, False])):
        assert (mt.nd.array(src, ctx=mt.cpu()).dtype
                == mx.nd.array(src).dtype), src


def test_creation_lands_on_current_context():
    with mt.cpu():
        for x in (mt.nd.zeros((2,)), mt.nd.ones(3), mt.nd.array([1, 2]),
                  mt.nd._zeros(shape=(2,)), mt.random.uniform(shape=(2,))):
            assert x.context == mt.cpu()
    x = mt.nd._ones(shape=(2,), ctx=mt.cpu())
    assert x.context == mt.cpu()


def test_creation_without_cuda_raises_instead_of_falling_back():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default context is usable")
    for make in (lambda: mt.nd.zeros((2,)), lambda: mt.nd.array([1.0]),
                 lambda: mt.nd._zeros(shape=(2,))):
        with pytest.raises(MXNetError, match="CUDA is not available"):
            make()


# -- .params files across the packages, and where load puts arrays --------

def test_save_load_across_packages(tmp_path):
    r = _rng("saveload")
    src = {"w": _normal(r, (3, 4)), "b": _normal(r, (4,)),
           "i": r.integers(0, 9, (5,)).astype(np.int32)}
    fj = str(tmp_path / "j.params")
    mx.nd.save(fj, {k: mx.nd.array(v, dtype=v.dtype) for k, v in src.items()})
    got = mt.nd.load(fj, ctx=mt.cpu())
    ft = str(tmp_path / "t.params")
    mt.nd.save(ft, got)
    back = mx.nd.load(ft)
    for k, v in src.items():
        np.testing.assert_array_equal(got[k].asnumpy(), v)
        np.testing.assert_array_equal(back[k].asnumpy(), v)
    assert open(fj, "rb").read() == open(ft, "rb").read()
    fl = str(tmp_path / "l.params")
    mt.nd.save(fl, [got["w"], got["b"]])
    lst = mx.nd.load(fl)
    assert isinstance(lst, list)
    np.testing.assert_array_equal(lst[0].asnumpy(), src["w"])


def test_load_default_is_the_current_context(tmp_path):
    f = str(tmp_path / "x.params")
    mx.nd.save(f, {"x": mx.nd.ones((2,))})
    with mt.cpu():
        assert mt.nd.load(f)["x"].context == mt.cpu()
    assert mt.nd.load(f, ctx=mt.cpu())["x"].context == mt.cpu()
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA is not available"):
            mt.nd.load(f)


def test_load_reads_npz_files_of_the_jax_package(tmp_path):
    f = str(tmp_path / "old.params")
    a = _normal(_rng("npz"), (2, 3))
    np.savez(f + ".npz", w=a)
    np.testing.assert_array_equal(mt.nd.load(f, ctx=mt.cpu())["w"].asnumpy(),
                                  mx.nd.load(f)["w"].asnumpy())


# -- samplers: shape, dtype and moments ------------------------------------
N_DRAWS = 40000

SAMPLERS = [
    ("uniform", dict(low=-1.0, high=3.0), 1.0, 16.0 / 12),
    ("normal", dict(loc=1.0, scale=2.0), 1.0, 4.0),
    ("gamma", dict(alpha=2.0, beta=3.0), 6.0, 18.0),
    ("exponential", dict(lam=2.0), 0.5, 0.25),
    ("poisson", dict(lam=3.0), 3.0, 3.0),
    ("negative_binomial", dict(k=3, p=0.4), 4.5, 11.25),
]


def _moments_ok(x, mean, var):
    x = np.asarray(x, np.float64).ravel()
    se = np.sqrt(var / x.size)
    assert abs(x.mean() - mean) < 5 * se, (x.mean(), mean)
    assert abs(x.var() - var) < 0.1 * var, (x.var(), var)


@pytest.mark.parametrize("case", SAMPLERS, ids=[c[0] for c in SAMPLERS])
def test_sampler_moments_like_jax(case):
    kind, params, mean, var = case
    shape = (200, N_DRAWS // 200)
    j = getattr(mx.random, kind)(shape=shape, **params)
    t = getattr(mt.random, kind)(shape=shape, ctx=mt.cpu(), **params)
    assert t.shape == j.shape == shape and t.dtype == j.dtype == np.float32
    _moments_ok(j.asnumpy(), mean, var)
    _moments_ok(t.asnumpy(), mean, var)
    # the op form with a dtype
    o = getattr(mt.nd, "_random_" + kind)(shape=(3, 2), dtype="float16",
                                          ctx=mt.cpu(), **params)
    assert o.shape == (3, 2) and o.dtype == np.float16


MULTI = [
    ("_sample_uniform", [[-1.0, 2.0], [3.0, 2.5]],
     lambda p: ((p[0] + p[1]) / 2, (p[1] - p[0]) ** 2 / 12)),
    ("_sample_normal", [[0.0, 5.0], [1.0, 0.5]],
     lambda p: (p[0], p[1] ** 2)),
    ("_sample_gamma", [[2.0, 0.5], [1.0, 4.0]],
     lambda p: (p[0] * p[1], p[0] * p[1] ** 2)),
    ("_sample_exponential", [[1.0, 4.0]],
     lambda p: (1 / p[0], 1 / p[0] ** 2)),
    ("_sample_poisson", [[2.0, 7.0]], lambda p: (p[0], p[0])),
    ("_sample_negbinomial", [[2.0, 5.0], [0.5, 0.3]],
     lambda p: (p[0] * (1 - p[1]) / p[1], p[0] * (1 - p[1]) / p[1] ** 2)),
]


@pytest.mark.parametrize("case", MULTI, ids=[c[0] for c in MULTI])
def test_multisampler_moments_like_jax(case):
    op, params, moments = case
    arrays = [np.asarray(p, np.float32) for p in params]
    j = getattr(mx.nd, op)(*_both(mx.nd, arrays, mx.cpu()), shape=(N_DRAWS,))
    with mt.cpu():
        t = getattr(mt.nd, op)(*_both(mt.nd, arrays, mt.cpu()),
                               shape=(N_DRAWS,))
    assert t.shape == j.shape == (2, N_DRAWS) and t.dtype == j.dtype
    for row in range(2):
        mean, var = moments([a[row] for a in arrays])
        _moments_ok(j.asnumpy()[row], mean, var)
        _moments_ok(t.asnumpy()[row], mean, var)


def test_seed_replays_draws():
    mt.random.seed(11)
    a = mt.random.normal(shape=(5,), ctx=mt.cpu()).asnumpy()
    b = mt.random.normal(shape=(5,), ctx=mt.cpu()).asnumpy()
    mt.random.seed(11)
    np.testing.assert_array_equal(
        mt.random.normal(shape=(5,), ctx=mt.cpu()).asnumpy(), a)
    assert not np.array_equal(a, b)
