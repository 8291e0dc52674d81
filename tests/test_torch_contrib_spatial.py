"""The port's spatial ops (``ops/spatial.py``: GridGenerator,
BilinearSampler, SpatialTransformer, ROIPooling, Correlation) and the rest
of ``ops/contrib.py`` (CTCLoss, fft, ifft, count_sketch, quantize,
dequantize) against the JAX package on the CPU: the counterpart of
``tests/test_contrib_spatial.py``.

Each case runs the op through both packages' ``nd`` and ``autograd`` on the
same numpy inputs (from a seed): outputs and the gradient of every float
input under a seeded cotangent, the shapes both infer, and the JAX
package's symbol JSON loaded and bound by the port. The cases hold the
edges: a grid on pixel edges and outside [-1, 1], a ROIPooling bin tied at
its maximum (zeros after a ReLU) and rois smaller than the pooled size, a
CTC row with an empty label and rows with repeated labels, quantize values
exactly at .5 (both round half to even).

Tolerance: float32 ``rtol=1e-5, atol=1e-6``. Correlation averages over the
channels and CTCLoss sums over time, fft over 8-16 points: in other orders
than XLA:CPU, so those take ``rtol=1e-4, atol=1e-5``. ROIPooling's maxima
and quantize's levels are exact.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.executor import spec_plan
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.symbol import _topo

from test_torch_nn_extra_ops import (SUM_TOL, check_case, json_round_trip,
                                     run_op, seeded)

EXACT = dict(rtol=0, atol=0)


def _n(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _edge_grid(n, ho, wo, w):
    """Grid points on pixel edges (x = -1 + 2k / (w - 1)), at -1 and 1 and
    outside [-1, 1], in both coordinates."""
    xs = np.concatenate([-1 + 2 * np.arange(w) / (w - 1),
                         [-1.4, -1.0, 1.0, 1.3, 0.0]]).astype(np.float32)
    r = seeded("edge_grid")
    g = r.choice(xs, size=(n, 2, ho, wo)).astype(np.float32)
    return g


def _rois():
    # (batch, x1, y1, x2, y2) at spatial_scale 0.5: whole map, a window on
    # image 1, one smaller than the pooled size, one past the map's edge
    return np.array([[0, 0, 0, 19, 23],
                     [1, 4, 2, 15, 13],
                     [1, 6, 6, 7, 8],
                     [0, 10, 14, 40, 40],
                     [1, -6, -4, 5, 3]], np.float32)


def _ctc_case(r):
    T, N, V = 7, 4, 5
    label = np.array([[1, 2, 2], [3, 0, 0], [0, 0, 0], [4, 4, 1]],
                     np.float32)
    return _n(r, T, N, V), label


def _cases():
    """(id, op, input names, inputs, attrs, gradient inputs, tolerance)."""
    r = seeded("contrib_spatial")
    theta = np.tile(np.array([0.9, 0.1, 0.05, -0.1, 1.1, 0.0], np.float32),
                    (2, 1)) + 0.05 * _n(r, 2, 6)
    fmap = _n(r, 2, 3, 12, 10)
    relu_map = np.maximum(fmap, 0.0)
    data, label = _ctc_case(r)
    x16 = _n(r, 3, 16)
    half = (np.arange(12, dtype=np.float32).reshape(3, 4) + 0.5)
    q = r.integers(0, 256, (4, 5)).astype(np.uint8)
    lo = np.array([-1.5], np.float32)
    hi = np.array([2.0], np.float32)
    return [
        ("grid_affine", "GridGenerator", ["data"], [theta],
         dict(transform_type="affine", target_shape=(5, 7)), [0], None),
        ("grid_warp", "GridGenerator", ["data"], [_n(r, 2, 2, 4, 5)],
         dict(transform_type="warp"), [0], None),
        ("bilinear_random", "BilinearSampler", ["data", "grid"],
         [_n(r, 2, 3, 6, 7), 1.2 * (r.random((2, 2, 5, 4)) * 2 - 1).astype(
             np.float32)], {}, [0, 1], None),
        ("bilinear_edges", "BilinearSampler", ["data", "grid"],
         [_n(r, 2, 3, 6, 7), _edge_grid(2, 6, 5, 7)], {}, [0, 1], None),
        ("spatial_transformer", "SpatialTransformer", ["data", "loc"],
         [_n(r, 2, 3, 8, 8), theta],
         dict(target_shape=(6, 5), transform_type="affine",
              sampler_type="bilinear"), [0, 1], None),
        ("roi_pooling", "ROIPooling", ["data", "rois"], [fmap, _rois()],
         dict(pooled_size=(3, 2), spatial_scale=0.5), [0], EXACT),
        ("roi_pooling_ties", "ROIPooling", ["data", "rois"],
         [relu_map, _rois()], dict(pooled_size=(2, 3), spatial_scale=0.5),
         [0], EXACT),
        ("roi_pooling_constant", "ROIPooling", ["data", "rois"],
         [np.ones((2, 3, 12, 10), np.float32), _rois()],
         dict(pooled_size=(2, 2), spatial_scale=0.5), [0], EXACT),
        ("correlation", "Correlation", ["data1", "data2"],
         [_n(r, 2, 4, 7, 8), _n(r, 2, 4, 7, 8)],
         dict(kernel_size=1, max_displacement=1, stride1=1, stride2=1,
              pad_size=2), [0, 1], SUM_TOL),
        ("correlation_k3_strides", "Correlation", ["data1", "data2"],
         [_n(r, 2, 3, 9, 11), _n(r, 2, 3, 9, 11)],
         dict(kernel_size=3, max_displacement=2, stride1=2, stride2=2,
              pad_size=1), [0, 1], SUM_TOL),
        ("correlation_abs_nopad", "Correlation", ["data1", "data2"],
         [_n(r, 1, 2, 8, 8), _n(r, 1, 2, 8, 8)],
         dict(kernel_size=1, max_displacement=1, is_multiply=False),
         [0, 1], SUM_TOL),
        ("ctc_loss", "CTCLoss", ["data", "label"], [data, label], {}, [0],
         SUM_TOL),
        ("ctc_loss_alias", "ctc_loss", ["data", "label"], [data, label], {},
         [0], SUM_TOL),
        ("fft", "fft", ["data"], [_n(r, 3, 8)], {}, [0], SUM_TOL),
        ("ifft", "ifft", ["data"], [x16], {}, [0], SUM_TOL),
        ("contrib_fft", "_contrib_fft", ["data"], [_n(r, 2, 4)], {}, [0],
         SUM_TOL),
        ("count_sketch", "count_sketch", ["data", "h", "s"],
         [_n(r, 4, 6), np.array([0, 3, 1, 3, 4, 0], np.float32),
          np.array([1, -1, 1, 1, -1, -1], np.float32)], dict(out_dim=5),
         [0, 2], None),
        ("quantize_half_even", "quantize", ["data", "min_range",
                                            "max_range"],
         [half, np.array([0.0], np.float32), np.array([255.0], np.float32)],
         {}, [], EXACT),
        ("quantize", "_contrib_quantize", ["data", "min_range", "max_range"],
         [_n(r, 5, 6), lo, hi], {}, [], EXACT),
        ("dequantize", "dequantize", ["data", "min_range", "max_range"],
         [q, lo, hi], {}, [], None),
    ]


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_and_gradient_match_jax(case):
    _, op, _, xs, attrs, wrt, tol = case
    check_case(op, xs, attrs, wrt, tol)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_symbol_json_round_trip(case):
    _, op, names, xs, attrs, _, tol = case
    json_round_trip(op, names, xs, attrs, tol)


def test_roi_pooling_splits_a_tied_bin_evenly():
    """A bin of zeros after a ReLU: its gradient is shared equally by every
    tied element, as JAX's ``max`` shares it."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, 0, 0] = -1.0
    rois = np.array([[0, 0, 0, 3, 3]], np.float32)
    attrs = dict(pooled_size=(1, 1), spatial_scale=1.0)
    _, (g,) = run_op(mt, "ROIPooling", [x, rois], attrs, [0],
                     [np.ones((1, 1, 1, 1), np.float32)])
    want = np.full((4, 4), 1.0 / 15, np.float32)
    want[0, 0] = 0.0
    np.testing.assert_allclose(g[0, 0], want, rtol=1e-6)


def test_roi_pooling_chunks_agree(monkeypatch):
    """The rois in chunks of one roi's map give what one chunk gives."""
    from mxnet_tpu_torch.ops import spatial
    xs = CASES[[c[0] for c in CASES].index("roi_pooling")][3]
    attrs = dict(pooled_size=(3, 2), spatial_scale=0.5)
    whole, (gw,) = run_op(mt, "ROIPooling", xs, attrs, [0])
    monkeypatch.setattr(spatial, "ROI_CHUNK_VALUES", 1)
    chunked, (gc,) = run_op(mt, "ROIPooling", xs, attrs, [0])
    np.testing.assert_array_equal(chunked[0], whole[0])
    np.testing.assert_array_equal(gc, gw)


def test_ctc_empty_label_scores_the_all_blank_path():
    r = seeded("ctc_empty")
    data = _n(r, 6, 1, 4)
    got, _ = run_op(mt, "CTCLoss", [data, np.zeros((1, 3), np.float32)], {})
    logp = torch.log_softmax(torch.from_numpy(data), -1).numpy()
    np.testing.assert_allclose(got[0], [-logp[:, 0, 0].sum()], rtol=1e-5)


def test_ctc_loss_perfect_prediction():
    acts = np.full((4, 1, 3), -10.0, np.float32)
    acts[0, 0, 1] = acts[1, 0, 1] = acts[2, 0, 2] = acts[3, 0, 2] = 10.0
    got, _ = run_op(mt, "CTCLoss", [acts, np.array([[1, 2]], np.float32)],
                    {})
    assert got[0][0] < 0.1


def test_fft_round_trip_is_unnormalised():
    x = seeded("fft_rt").random((2, 8)).astype(np.float32)
    f, _ = run_op(mt, "fft", [x], {})
    back, _ = run_op(mt, "ifft", [f[0]], {})
    np.testing.assert_allclose(back[0] / 8, x, atol=1e-5)


def test_quantize_types_and_ranges():
    """quantize gives uint8 and its two ranges unchanged; the port's
    InferType says so, and dequantize gives float32."""
    for name in ("quantize", "_contrib_quantize"):
        s = getattr(mt.sym, name)(mt.sym.Variable("d"),
                                  mt.sym.Variable("lo"),
                                  mt.sym.Variable("hi"))
        _, outs, _ = s.infer_type(d=np.float32)
        assert outs == [np.uint8, np.float32, np.float32]
    s = mt.sym.dequantize(mt.sym.Variable("q"), mt.sym.Variable("lo"),
                          mt.sym.Variable("hi"))
    args, outs, _ = s.infer_type(q=np.uint8, lo=np.float32)
    assert args == [np.uint8, np.float32, np.float32]
    assert outs == [np.float32]
    x = seeded("q").uniform(-1, 1, (3, 4)).astype(np.float32)
    lo, hi = np.array([-1.0], np.float32), np.array([1.0], np.float32)
    (q, qlo, qhi), _ = run_op(mt, "quantize", [x, lo, hi], {})
    assert q.dtype == np.uint8
    np.testing.assert_array_equal(qlo, lo)
    np.testing.assert_array_equal(qhi, hi)
    (deq,), _ = run_op(mt, "dequantize", [q, qlo, qhi], {})
    np.testing.assert_allclose(deq, x, atol=0.01)


def test_ops_keep_the_dimensions_they_reduce_over_whole_on_a_mesh():
    """``spec_plan``: InstanceNorm runs per position on a batch split and
    gathers a spatial one; Correlation gathers a split of the channels or
    of the map; ROIPooling gathers a feature map split by batch (its rois
    index the whole batch) and runs per position on a split of the rois."""
    mesh = tmesh.make_mesh({"data": 2}, ["cpu"] * 2)
    s = mt.sym
    x, y = s.Variable("x"), s.Variable("y")

    def node(sym):
        return [n for n in _topo(sym._out_nodes()) if not n.is_variable][-1]

    def arr(shape, spec):
        return tmesh.split_spec(torch.zeros(shape), mesh, spec)
    inorm = node(s.InstanceNorm(x, s.Variable("g"), s.Variable("b")))
    gb = [arr((3,), ()), arr((3,), ())]
    assert spec_plan(inorm, [arr((4, 3, 6, 6), ("data",))] + gb, mesh)[0] \
        == [[], [], []]
    assert spec_plan(inorm, [arr((4, 3, 6, 6), (None, None, "data"))] + gb,
                     mesh)[0] == [["data"], [], []]
    corr = node(s.Correlation(x, y, max_displacement=1, pad_size=1))
    for spec, gathered in (((("data",)), []), ((None, "data"), ["data"]),
                           ((None, None, None, "data"), ["data"])):
        plan = spec_plan(corr, [arr((4, 2, 6, 6), spec)] * 2, mesh)
        assert plan[0] == [gathered, gathered], spec
    roi = node(s.ROIPooling(x, y, pooled_size=(2, 2), spatial_scale=1.0))
    assert spec_plan(roi, [arr((4, 2, 6, 6), ("data",)),
                           arr((6, 5), ())], mesh)[0] == [["data"], []]
    gathers, specs, _ = spec_plan(roi, [arr((4, 2, 6, 6), ()),
                                        arr((6, 5), ("data",))], mesh)
    assert gathers == [[], []] and specs == [("data", None, None, None)]
