"""The port's zoo models (AlexNet, VGG, Inception-BN) and the ops they add
(LRN, Dropout) against the JAX package, on the CPU.

The same numpy inputs and weights go through both packages. Tolerances,
each with its reason:
- LRN forward ``rtol=1e-5, atol=1e-6`` and gradient ``rtol=1e-4,
  atol=1e-6``: XLA:CPU and PyTorch sum the window in different orders;
- an inference forward of a whole network: ``rtol=1e-5, atol=2e-6`` on
  the softmax (measured: at most 6.6e-7 apart, VGG-11);
- one Inception-BN ``TrainStep`` step: the outputs within ``atol=1e-4``,
  the moving statistics within ``rtol=1e-3, atol=1e-5``, and each
  parameter's and momentum's update within 5e-2 of its norm (2e-2 over all
  of them). Its 69 BatchNorm layers normalise by batch statistics, so the
  packages' last-bit differences (1e-7 a layer) grow to some 1e-5 of the
  activations by block 4b, and a ReLU whose input lies that close to zero
  flips, moving one batch entry of its channel's gradient (measured: the
  updates 1.2% apart in norm over all, 0.4-1.6% each, the worst a beta;
  the inference forward agrees to 1e-7);
- Dropout: the port's generators are not JAX's, so masks cannot match bit
  for bit; held by statistics (kept fraction within 0.5 +- 0.01 on 256x256
  at p = 0.5), by the scaling and gradient given the mask (exact), and by
  equal seeds giving equal masks (exact).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.train_step import TrainStep as JTrainStep
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import node_generator
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.train_step import TrainStep

#: (network, kwargs, the smallest square input it admits)
ZOO = [("alexnet", {}, 67),
       ("vgg", {"num_layers": 11}, 32),
       ("vgg", {"num_layers": 11, "batch_norm": True}, 32),
       ("inception-bn", {}, 8)]


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _weights(sym, shape, rng):
    """He-scaled weights, gamma near 1, small biases, aux statistics near
    (0, 1), from ``rng``."""
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("weight"):
            args[n] = rng.standard_normal(s) * np.sqrt(2.0 / np.prod(s[1:]))
        elif n.endswith("gamma"):
            args[n] = 1 + 0.1 * rng.standard_normal(s)
        else:
            args[n] = 0.1 * rng.standard_normal(s)
    aux = {n: (np.abs(1 + 0.1 * rng.standard_normal(s)) if n.endswith("var")
               else 0.1 * rng.standard_normal(s))
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    cast = {n: v.astype(np.float32) for n, v in args.items()}
    return cast, {n: v.astype(np.float32) for n, v in aux.items()}


def _params(pkg, args, aux, **ctx):
    p = {"arg:%s" % k: pkg.nd.array(v, **ctx) for k, v in args.items()}
    p.update({"aux:%s" % k: pkg.nd.array(v, **ctx) for k, v in aux.items()})
    return p


@pytest.mark.parametrize("name,kw,size", ZOO)
def test_zoo_symbols_and_shapes_match_jax(name, kw, size):
    js = mx.models.get_symbol(name, num_classes=10, **kw)
    ts = mt.models.get_symbol(name, num_classes=10, **kw)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs()
    shape = (2, 3, size, size)
    assert ts.infer_shape(data=shape) == js.infer_shape(data=shape)
    # one pixel less is refused by both
    if name != "inception-bn":
        small = (2, 3, size - 1, size - 1)
        inter = ts.get_internals()
        with pytest.raises(Exception):
            _, outs, _ = inter.infer_shape(data=small)
            assert all(all(d > 0 for d in s) for s in outs)


@pytest.mark.parametrize("name,kw,size", ZOO)
def test_zoo_inference_forward_matches_jax(name, kw, size):
    rng = _rng("fwd" + name + str(kw))
    js = mx.models.get_symbol(name, num_classes=10, **kw)
    ts = mt.models.get_symbol(name, num_classes=10, **kw)
    shape = (2, 3, size, size)
    args, aux = _weights(js, shape, rng)
    x = rng.standard_normal(shape).astype(np.float32)
    want = mx.Predictor(js, _params(mx, args, aux), {"data": shape}) \
        .forward(data=x).get_output(0).asnumpy()
    got = mt.Predictor(ts, _params(mt, args, aux, ctx=mt.cpu()),
                       {"data": shape}, ctx=mt.cpu()) \
        .forward(data=x).get_output(0).asnumpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


def test_zoo_factory_names_and_transformer():
    assert sorted(mt.models._FACTORIES) == sorted(mx.models._FACTORIES)
    # the LM builds by name, with the JAX package's JSON
    with mt.symbol.NameManager():
        tjs = mt.models.get_symbol("transformer", num_layers=1).tojson()
    with mx.symbol.NameManager():
        assert tjs == mx.models.get_symbol("transformer",
                                           num_layers=1).tojson()
    with pytest.raises(ValueError, match="unknown network"):
        mt.models.get_symbol("lenet5")
    with pytest.raises(ValueError, match="vgg depth"):
        mt.models.vgg(num_layers=12)


def test_inception_bn_train_step_matches_jax():
    rng = _rng("inception step")
    b, size = 4, 64
    kw = dict(optimizer="sgd", learning_rate=0.01, momentum=0.9, wd=1e-4)
    jstep = JTrainStep(mx.models.get_symbol("inception-bn", num_classes=10),
                       **kw)
    tstep = TrainStep(mt.models.get_symbol("inception-bn", num_classes=10),
                      device="cpu", **kw)
    jst = jstep.init({"data": (b, 3, size, size)}, {"softmax_label": (b,)},
                     seed=3)
    tst = convert.from_reference_state(jst, "cpu")
    init = convert.to_reference_state(tst)
    batch = {"data": rng.standard_normal((b, 3, size, size))
             .astype(np.float32),
             "softmax_label": rng.integers(0, 10, b).astype(np.float32)}
    jst, jouts = jstep.step(jst, batch)
    tst, touts = tstep.step(tst, batch)
    np.testing.assert_allclose(touts[0].numpy(), np.asarray(jouts[0]),
                               rtol=0, atol=1e-4)
    got = convert.to_reference_state(tst)
    assert int(got["step"]) == int(np.asarray(jst["step"])) == 1
    for n, v in jst["aux"].items():
        np.testing.assert_allclose(got["aux"][n], np.asarray(v), rtol=1e-3,
                                   atol=1e-5, err_msg=n)
    num = den = 0.0
    for key in ("params", "opt"):
        for n, v in jst[key].items():
            want = np.asarray(v) - init[key][n]
            d = np.sum((got[key][n] - init[key][n] - want) ** 2)
            w = np.sum(want ** 2)
            assert d <= (5e-2) ** 2 * w, (key, n, np.sqrt(d / w))
            num, den = num + d, den + w
    assert num <= (2e-2) ** 2 * den, np.sqrt(num / den)


# ---------------------------------------------------------------------------
# LRN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nsize", [1, 3, 5, 7])
def test_lrn_forward_and_gradient_match_jax(nsize):
    rng = _rng("lrn%d" % nsize)
    x = rng.standard_normal((2, 9, 5, 4)).astype(np.float32)
    c = rng.standard_normal(x.shape).astype(np.float32)
    attrs = dict(alpha=1e-2, beta=0.75, knorm=2.0, nsize=nsize)

    def jf(v):
        out = jreg.get("LRN").apply(jreg.OpContext(), attrs, [v], [])[0][0]
        return jnp.sum(out * c), out

    (_, jy), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    ty = treg.get("LRN").apply(treg.OpContext(), attrs, [xt], [])[0][0]
    (ty * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("nsize", [2, 4])
def test_lrn_even_window_raises_in_both(nsize):
    x = np.ones((1, 6, 2, 2), np.float32)
    with pytest.raises(TypeError):
        jreg.get("LRN").apply(jreg.OpContext(), dict(nsize=nsize),
                              [jnp.asarray(x)], [])
    with pytest.raises(MXNetError, match="odd"):
        treg.get("LRN").apply(treg.OpContext(), dict(nsize=nsize),
                              [torch.from_numpy(x)], [])


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

def _dropout(x, p, is_train=True, gen=None):
    return treg.get("Dropout").apply(treg.OpContext(is_train=is_train,
                                                    rng=gen),
                                     dict(p=p), [x], [])[0][0]


def test_dropout_identity_in_eval_and_at_p0():
    x = torch.from_numpy(_rng("id").standard_normal((8, 16))
                         .astype(np.float32))
    assert _dropout(x, 0.5, is_train=False) is x
    assert _dropout(x, 0.0, gen=node_generator(1, 0, "cpu")) is x
    assert _dropout(x, -0.1, gen=node_generator(1, 0, "cpu")) is x
    # the JAX package's op is the identity there too
    jx = jnp.asarray(x.numpy())
    assert np.array_equal(np.asarray(jreg.get("Dropout").apply(
        jreg.OpContext(is_train=False), dict(p=0.5), [jx], [])[0][0]),
        x.numpy())
    with pytest.raises(MXNetError, match="rng"):
        _dropout(x, 0.5)


def test_dropout_kept_fraction_scaling_and_gradient():
    x = torch.from_numpy(_rng("frac").uniform(0.5, 1.5, (256, 256))
                         .astype(np.float32)).requires_grad_()
    p = 0.5
    y = _dropout(x, p, gen=node_generator(7, 3, "cpu"))
    mask = y.detach() != 0
    kept = float(mask.float().mean())
    assert abs(kept - (1 - p)) <= 0.01, kept
    # kept entries are x / keep, exactly as the JAX package writes it
    keep = 1.0 - p
    assert torch.equal(y.detach()[mask], (x.detach() / keep)[mask])
    # the gradient given the mask: mask / keep
    g = torch.from_numpy(_rng("g").standard_normal((256, 256))
                         .astype(np.float32))
    (y * g).sum().backward()
    assert torch.equal(x.grad, torch.where(mask, g / keep,
                                           torch.zeros(())))
    # the JAX package's fraction on the same shape, same tolerance
    jy = jreg.get("Dropout").apply(
        jreg.OpContext(is_train=True, rng=jax.random.key(0)), dict(p=p),
        [jnp.asarray(x.detach().numpy())], [])[0][0]
    assert abs(float(jnp.mean(jy != 0)) - keep) <= 0.01


def test_dropout_equal_seeds_equal_masks():
    x = torch.ones((64, 64))
    a = _dropout(x, 0.3, gen=node_generator(11, 5, "cpu"))
    b = _dropout(x, 0.3, gen=node_generator(11, 5, "cpu"))
    c = _dropout(x, 0.3, gen=node_generator(12, 5, "cpu"))
    d = _dropout(x, 0.3, gen=node_generator(11, 6, "cpu"))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_dropout_in_a_bound_symbol_trains_and_is_identity_at_inference():
    with mt.symbol.NameManager():
        net = mt.sym.Dropout(mt.sym.Variable("data"), p=0.5)
    ex = net.simple_bind(mt.cpu(), grad_req="write", data=(32, 32))
    x = np.ones((32, 32), np.float32)
    out = ex.forward(is_train=True, data=x)[0].asnumpy()
    assert set(np.unique(out)) <= {0.0, 2.0}
    assert 0.4 < (out != 0).mean() < 0.6
    ex.backward(out_grads=[mt.nd.ones((32, 32), ctx=mt.cpu())])
    np.testing.assert_array_equal(ex.grad_dict["data"].asnumpy(), out)
    np.testing.assert_array_equal(ex.forward(is_train=False, data=x)[0]
                                  .asnumpy(), x)
