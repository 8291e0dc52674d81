"""The port's initializers against the JAX package's, on the CPU.

- ``Constant``, ``Bilinear``, ``LSTMBias``, ``Load`` and ``Mixed`` draw
  nothing at random: the same values as the JAX package's, exactly.
- ``Orthogonal`` draws from the port's generator: ``scale`` times an
  orthonormal factor, so ``W^T W`` (or ``W W^T`` for a wide array) is
  ``scale^2 I`` within ``atol=1e-5`` (float32 of a float64 SVD).
- ``MSRAPrelu`` is Xavier gaussian with magnitude ``2 / (1 + slope^2)``:
  the standard deviation of 400,000 draws within 1% of
  ``sqrt(magnitude / fan)``, the mean within 5 standard errors of 0.
- ``FusedRNN`` is held in ``tests/test_torch_rnn.py``.
- The suffix dispatch is the JAX package's: ``*_bias``, ``*_beta`` zero,
  ``*_gamma`` one, an ``__init__`` attribute overrides it.
"""
import json
import math
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu import initializer as jinit


def _both(jfn, tfn, name, shape):
    """Fill an array named ``name`` through each package: numpy pair."""
    j = mx.nd.zeros(shape)
    jfn(jinit.InitDesc(name), j)
    t = mt.nd.zeros(shape, ctx=mt.cpu())
    tfn(tinit.InitDesc(name), t)
    return j.asnumpy(), t.asnumpy()


@pytest.mark.parametrize("name", ["fc_weight", "fc_bias", "bn_gamma",
                                  "bn_moving_var", "anything"])
def test_constant(name):
    j, t = _both(jinit.Constant(0.37), tinit.Constant(0.37), name, (3, 4))
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, np.full((3, 4), 0.37, np.float32))


@pytest.mark.parametrize("shape", [(2, 1, 4, 4), (3, 2, 5, 5),
                                   (1, 1, 3, 7)])
def test_bilinear(shape):
    j, t = _both(jinit.Bilinear(), tinit.Bilinear(), "up_weight", shape)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("name", ["lstm_i2h_bias", "lstm_i2h_weight",
                                  "lstm_state"])
def test_lstm_bias(name):
    j, t = _both(jinit.LSTMBias(2.5), tinit.LSTMBias(2.5), name, (12,))
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t[3:6], np.full(3, 2.5, np.float32))


def test_load_and_fallback():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    params = {"arg:fc_weight": w, "aux:bn_moving_mean": b}
    jl = jinit.Load(params, default_init=jinit.Constant(0.5))
    tl = tinit.Load(params, default_init=tinit.Constant(0.5))
    for name, shape in (("fc_weight", (3, 4)), ("bn_moving_mean", (4,)),
                        ("other_bias", (2,))):
        j, t = _both(jl, tl, name, shape)
        np.testing.assert_array_equal(t, j)
    # either package's NDArray, and a tensor, load as their values
    tl2 = tinit.Load({"fc_weight": mx.nd.array(w),
                      "fc_bias": torch.from_numpy(b)})
    t = mt.nd.zeros((3, 4), ctx=mt.cpu())
    tl2("fc_weight", t)
    np.testing.assert_array_equal(t.asnumpy(), w)
    t = torch.zeros(4)
    tl2("fc_bias", t)
    np.testing.assert_array_equal(t.numpy(), b)
    with pytest.raises(MXNetError, match="shape mismatch"):
        tl2("fc_weight", mt.nd.zeros((4, 3), ctx=mt.cpu()))
    with pytest.raises(MXNetError, match="no init"):
        tinit.Load({})("fc_weight", mt.nd.zeros((2,), ctx=mt.cpu()))


def test_mixed():
    jm = jinit.Mixed([".*_bias", ".*"],
                     [jinit.Constant(0.25), jinit.Bilinear()])
    tm = tinit.Mixed([".*_bias", ".*"],
                     [tinit.Constant(0.25), tinit.Bilinear()])
    for name, shape in (("conv_bias", (3,)), ("up_weight", (2, 1, 4, 4))):
        j, t = _both(jm, tm, name, shape)
        np.testing.assert_array_equal(t, j)
    only = tinit.Mixed(["^fc"], [tinit.Constant(1.0)])
    with pytest.raises(MXNetError, match="no matching pattern"):
        only("conv_weight", torch.zeros(2))


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (8, 2, 3, 3), (5, 5)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal(shape, rand_type):
    mt.random.seed(1)
    t = torch.zeros(shape)
    tinit.Orthogonal(scale=1.5, rand_type=rand_type)(
        tinit.InitDesc("q_weight"), t)
    w = t.reshape(shape[0], -1).double()
    gram = w.t() @ w if w.shape[0] >= w.shape[1] else w @ w.t()
    np.testing.assert_allclose(gram.numpy() / 1.5 ** 2,
                               np.eye(gram.shape[0]), rtol=0, atol=1e-5)


def test_msra_prelu_scale():
    mt.random.seed(2)
    shape = (400, 100, 2, 5)          # fan in 1000, fan out 4000
    t = torch.zeros(shape)
    init = tinit.MSRAPrelu(factor_type="in", slope=0.5)
    init(tinit.InitDesc("conv_weight"), t)
    std = math.sqrt(2.0 / (1 + 0.5 ** 2) / 1000)
    v = t.double()
    assert float(v.std()) == pytest.approx(std, rel=0.01)
    assert abs(float(v.mean())) < 5 * std / math.sqrt(v.numel())
    assert json.loads(init.dumps()) == json.loads(
        jinit.MSRAPrelu(factor_type="in", slope=0.5).dumps())


@pytest.mark.parametrize("name,want", [("fc_bias", 0.0), ("bn_beta", 0.0),
                                       ("bn_gamma", 1.0),
                                       ("bn_moving_mean", 0.0),
                                       ("bn_moving_var", 1.0)])
def test_suffix_dispatch(name, want):
    j, t = _both(jinit.Xavier(), tinit.Xavier(), name, (5,))
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, np.full(5, want, np.float32))


def test_init_attr_overrides_dispatch():
    attrs = {"__init__": tinit.Constant(0.75).dumps()}
    t = torch.zeros(3)
    tinit.Xavier()(tinit.InitDesc("fc_bias", attrs), t)
    np.testing.assert_array_equal(t.numpy(), np.full(3, 0.75, np.float32))
    assert re.search("constant", attrs["__init__"])
