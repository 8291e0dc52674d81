"""Registry-wide parity sweep of the port: the counterpart of
``tests/test_op_sweep.py::test_registry_coverage``.

- The two registries hold the same names (ops and aliases).
- Every configuration of ``tests/test_op_sweep.py``'s tables (unary,
  binary, scalar, broadcast, reduce, shape, init, random and sample ops)
  runs through both packages' ``nd`` and ``autograd`` on the CPU: outputs,
  and for the ops those tables hold differentiable, the gradients of their
  float inputs under a seeded cotangent, within ``rtol=1e-4, atol=1e-5``
  (the sweep's own tolerance). The random and sample ops draw from each
  package's own stream, so they are held to the same shape and dtype,
  finite values and the distribution's mean (within 6 standard errors).
  The tables are imported, not edited; their inputs are drawn again here
  from a seed of this file's, on the tables' own generators.
- Every op the tables do not sweep is mapped to the named port test that
  holds it against the JAX package; each named test must exist. The skip
  list is empty.
"""
import os
import zlib

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
import test_op_sweep as sweep

from test_torch_nn_extra_ops import run_op

TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _configs():
    """{name: (family, inputs, attrs, gradient inputs)} from the sweep's
    tables, with inputs drawn on the tables' generators from this file's
    own RandomState (the sweep's is put back after)."""
    saved = sweep.RNG
    sweep.RNG = np.random.RandomState(20240516)
    try:
        out = {}
        s = sweep.S
        for name, (_, gen, diff) in sweep.UNARY.items():
            out[name] = ("unary", [gen(s)], {}, [0] if diff else [])
        for name in sweep.BINARY:
            out[name] = ("binary", [sweep._pos(s), sweep._pos(s)], {},
                         [0, 1] if name in sweep._BINARY_DIFF else [])
        for name in sweep.SCALAR:
            out[name] = ("scalar", [sweep._pos(s)], {"scalar": "2.0"}, [])
        for name in sweep.BROADCAST:
            out[name] = ("broadcast",
                         [sweep._pos((2, 3, 4)), sweep._pos((1, 3, 1))], {},
                         [0, 1] if name in sweep._BCAST_DIFF else [])
        for name, (_, attrs) in sweep.REDUCE.items():
            out[name] = ("reduce", [sweep._pos((3, 4))], attrs,
                         [0] if name in sweep._REDUCE_DIFF else [])
        for name, (inputs, attrs, _) in sweep.SHAPE_OPS.items():
            wrt = ([i for i, x in enumerate(inputs)
                    if np.asarray(x).dtype == np.float32][:2]
                   if name in sweep._SHAPE_DIFF else [])
            out[name] = ("shape", list(inputs), attrs, wrt)
        for name, (attrs, _) in sweep.INIT_OPS.items():
            out[name] = ("init", [], attrs, [])
        for name, attrs in sweep.RANDOM_OPS.items():
            out[name] = ("random", [], attrs, [])
        for name, params in sweep.SAMPLE_OPS.items():
            out[name] = ("sample", list(params), {"shape": "(200,)"}, [])
        return out
    finally:
        sweep.RNG = saved


CONFIGS = _configs()

#: ops the tables do not sweep -> the port test holding each against the
#: JAX package
COVERED = {
    "Activation": "test_torch_ops.py::test_op_matches_jax",
    "Convolution": "test_torch_ops.py::test_op_matches_jax",
    "Pooling": "test_torch_ops.py::test_op_matches_jax",
    "SoftmaxActivation": "test_torch_ops.py::test_op_matches_jax",
    "MultiBoxPrior": "test_torch_ops.py::test_op_matches_jax",
    "_contrib_MultiBoxPrior": "test_torch_ops.py::test_op_matches_jax",
    "BatchNorm": "test_torch_train.py::test_batch_norm_branches",
    "FullyConnected": "test_torch_train.py::test_fully_connected",
    "SoftmaxOutput":
        "test_torch_train.py::test_softmax_output_forward_and_gradient",
    "Softmax": "test_torch_train.py::test_softmax_output_forward_and_gradient",
    "Dropout": "test_torch_zoo.py::test_dropout_kept_fraction_scaling_and_"
               "gradient",
    "LRN": "test_torch_zoo.py::test_lrn_forward_and_gradient_match_jax",
    "L2Normalization": "test_torch_ssd_train.py::test_l2_normalization",
    "MakeLoss": "test_torch_ssd_train.py::test_make_loss_forward_and_gradient",
    "MultiBoxTarget": "test_torch_ssd_train.py::test_multibox_target_random",
    "_contrib_MultiBoxTarget":
        "test_torch_ssd_train.py::test_multibox_target_random",
    "MultiBoxDetection":
        "test_torch_multibox.py::test_multibox_detection_matches_jax",
    "_contrib_MultiBoxDetection":
        "test_torch_multibox.py::test_multibox_detection_matches_jax",
    "LayerNorm": "test_torch_attention.py::test_layer_norm_matches_jax",
    "MultiHeadAttention": "test_torch_attention.py::test_mha_matches_jax",
    "TransformerStack":
        "test_torch_attention.py::test_transformer_stack_matches_jax",
    "RNN": "test_torch_rnn.py::test_rnn_op_matches_jax",
    "SequenceLast": "test_torch_rnn.py::test_sequence_ops_match_jax",
    "SequenceMask": "test_torch_rnn.py::test_sequence_ops_match_jax",
    "SequenceReverse": "test_torch_rnn.py::test_sequence_ops_match_jax",
    "SliceChannel": "test_torch_rnn.py::test_slice_channel_and_split_match_jax",
    "split": "test_torch_rnn.py::test_slice_channel_and_split_match_jax",
    "crop": "test_torch_ndarray.py::test_op_against_jax",
    "topk": "test_torch_ndarray.py::test_op_against_jax",
    "sgd_update": "test_torch_ndarray.py::test_op_against_jax",
    "sgd_mom_update": "test_torch_ndarray.py::test_op_against_jax",
    "adam_update": "test_torch_ndarray.py::test_op_against_jax",
    "rmsprop_update": "test_torch_ndarray.py::test_op_against_jax",
    "rmspropalex_update": "test_torch_ndarray.py::test_op_against_jax",
    "Custom": "test_torch_operator.py::test_nd_custom_against_jax",
}
for _op in ("LeakyReLU", "InstanceNorm", "Deconvolution", "Crop",
            "UpSampling", "LinearRegressionOutput",
            "LogisticRegressionOutput", "MAERegressionOutput", "SVMOutput",
            "IdentityAttachKLSparseReg"):
    COVERED[_op] = "test_torch_nn_extra_ops.py::test_op_and_gradient_match_jax"
for _op in ("GridGenerator", "BilinearSampler", "SpatialTransformer",
            "ROIPooling", "Correlation", "CTCLoss", "ctc_loss",
            "_contrib_CTCLoss", "fft", "ifft", "_contrib_fft", "_contrib_ifft",
            "count_sketch", "_contrib_count_sketch", "quantize",
            "_contrib_quantize", "dequantize", "_contrib_dequantize"):
    COVERED[_op] = \
        "test_torch_contrib_spatial.py::test_op_and_gradient_match_jax"

#: name -> reason; empty: every op is swept or covered by a named test
SKIP = {}


def _stochastic(name, xs, attrs):
    if xs:
        g = run_op(mt, name, xs, attrs, train=False)[0][0]
        w = run_op(mx, name, xs, attrs, train=False)[0][0]
    else:
        g = getattr(mt.nd, name)(ctx=mt.cpu(), **attrs).asnumpy()
        w = getattr(mx.nd, name)(**attrs).asnumpy()
    assert g.shape == w.shape and g.dtype == w.dtype
    assert np.isfinite(g).all()
    g2 = g.reshape(-1, g.shape[-1]).astype(np.float64)
    w2 = w.reshape(-1, w.shape[-1]).astype(np.float64)
    se = np.sqrt((g2.var(1) + w2.var(1)) / g2.shape[1]) + 1e-12
    assert (np.abs(g2.mean(1) - w2.mean(1)) < 6 * se).all(), (
        g2.mean(1), w2.mean(1))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_matches_jax(name):
    family, xs, attrs, wrt = CONFIGS[name]
    if family in ("random", "sample"):
        _stochastic(name, xs, attrs)
        return
    if family == "init":
        got = getattr(mt.nd, name)(ctx=mt.cpu(), **attrs).asnumpy()
        want = getattr(mx.nd, name)(**attrs).asnumpy()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        return
    xs = [np.asarray(x) for x in xs]
    cots = None
    if wrt:
        shape = run_op(mt, name, xs, attrs, train=False)[0][0].shape
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        cots = [rng.standard_normal(shape).astype(np.float32)]
    got, tg = run_op(mt, name, xs, attrs, wrt, cots)
    want, jg = run_op(mx, name, xs, attrs, wrt, cots)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), **TOL)
    for i, g, w in zip(wrt, tg, jg):
        np.testing.assert_allclose(g, w, err_msg="gradient of input %d" % i,
                                   **TOL)


def test_registry_coverage():
    """The registries hold the same names, and each is swept here or held
    by a named port test that exists."""
    names = set(mt.ops.registry.list_ops())
    assert names == set(mx.ops.registry.list_ops())
    assert set(CONFIGS) <= names
    missing = sorted(n for n in names
                     if n not in CONFIGS and n not in COVERED and n not in SKIP)
    assert not missing, "ops with no port test: %s" % missing
    assert not SKIP
    assert not set(COVERED) & set(CONFIGS)
    for op, ref in COVERED.items():
        path, fn = ref.split("::")
        with open(os.path.join(ROOT, "tests", path)) as f:
            assert "\ndef %s(" % fn in f.read(), (op, ref)
    assert len(CONFIGS) >= 167
