"""The port's optimizers against the JAX package's, on the CPU.

Every optimizer of ``optimizer.py`` (SGD, NAG, ccSGD, DCASGD, Adam,
AdaGrad, RMSProp plain and centered, AdaDelta, Ftrl, Test), with
``rescale_grad``, ``clip_gradient``, ``wd`` and per-parameter lr/wd
multipliers, over 5 steps of the same numpy weights and gradients:

- ``update`` through the per-index ``Updater`` (NDArrays);
- ``fused_update`` called directly (the port updates in place, the JAX
  package returns new arrays);
- ``TrainStep`` on a graph whose gradient is exact in both packages
  (``MakeLoss(data * w_weight + 2 b_bias)``: the gradient of ``w_weight``
  is the data, of ``b_bias`` 2), with ``clip_global_norm`` small enough to
  scale every step.

Weights and states agree within ``rtol=1e-5, atol=1e-7`` (float32; the two
packages' ``sqrt``, ``pow`` and global-norm sums may differ by an ulp).

SGLD draws noise, from each package's own generator: its deterministic
part is held with the noise source fixed (the port's generator for
parameter i is the step key's stream ``_OPT_KEY_OFFSET + i``, as the JAX
package folds its key), and the noise on its mean and variance (500,000
draws: the mean within 5 standard errors, the variance within 1%).

An Adam ``.states`` blob written by either package's ``Updater`` opens in
the other's, and both go on to the same weights.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import node_generator
from mxnet_tpu_torch.train_step import _OPT_KEY_OFFSET

TOL = dict(rtol=1e-5, atol=1e-7)
STEPS = 5
COMMON = dict(rescale_grad=0.5, wd=1e-3, clip_gradient=0.8,
              learning_rate=0.05)
CASES = [
    ("sgd", {"momentum": 0.9}), ("sgd", {}),
    ("nag", {"momentum": 0.9}), ("nag", {}),
    ("ccsgd", {"momentum": 0.9}),
    ("dcasgd", {"momentum": 0.9}), ("dcasgd", {}),
    ("adam", {}), ("adagrad", {}),
    ("rmsprop", {}), ("rmsprop", {"centered": True, "clip_weights": 0.5}),
    ("adadelta", {}), ("ftrl", {}), ("test", {}),
]
IDS = ["%s%s" % (n, "-" + "-".join(sorted(k)) if k else "")
       for n, k in CASES]
NAMES = {0: "fc_weight", 1: "fc_bias"}


def _flat(state):
    """A state (None, an array or a tuple) as a list of numpy arrays."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat(s)]
    if hasattr(state, "asnumpy"):
        return [state.asnumpy()]
    if isinstance(state, torch.Tensor):
        return [state.numpy()]
    return [np.asarray(state)]


def _make(pkg, name, kw, **extra):
    opt = pkg.optimizer.create(name, param_idx2name=NAMES,
                               **dict(COMMON, **kw, **extra))
    opt.set_lr_mult({"fc_bias": 2.0})
    opt.set_wd_mult({"fc_weight": 0.5})
    return opt


def _data(seed, shapes=((3, 5), (5,))):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs = [[(3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
          for _ in range(STEPS)]
    return ws, gs


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_update_matches_reference(name, kw):
    ws, gs = _data(1)
    out = []
    for pkg in (mx, mt):
        updater = pkg.optimizer.get_updater(_make(pkg, name, kw))
        weights = [pkg.nd.array(w, ctx=pkg.cpu()) for w in ws]
        for step in gs:
            for i, g in enumerate(step):
                updater(i, pkg.nd.array(g, ctx=pkg.cpu()), weights[i])
        out.append(([w.asnumpy() for w in weights],
                    [_flat(updater.states[i]) for i in range(len(ws))]))
    (jw, js), (tw, ts) = out
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(ts, js):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, **TOL)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_fused_update_matches_reference(name, kw):
    ws, gs = _data(2)
    jopt, topt = _make(mx, name, kw), _make(mt, name, kw)
    jw = [jnp.asarray(w) for w in ws]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    js = [jopt.create_fused_state(w) for w in jw]
    ts = [topt.create_fused_state(w) for w in tw]
    for t, step in enumerate(gs):
        for i, g in enumerate(step):
            lr, wd = 0.05 * (1 + i), 1e-3 / (1 + i)
            jw[i], js[i] = jopt.fused_update(
                NAMES[i], jw[i], jnp.asarray(g), js[i], lr, wd,
                jnp.float32(t + 1))
            w, s = topt.fused_update(NAMES[i], tw[i], torch.from_numpy(g),
                                     ts[i], lr, wd,
                                     torch.tensor(t + 1.0))
            assert w is tw[i]                 # in place
    for i in range(len(ws)):
        np.testing.assert_allclose(tw[i].numpy(), np.asarray(jw[i]), **TOL)
        a, b = _flat(ts[i]), _flat(js[i])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, **TOL)


def _linear_syms(shape=(4, 6)):
    """``MakeLoss(data * w_weight + 2 b_bias)`` in both packages, with the
    lr multiplier 0.5 on ``w_weight`` and the wd multiplier 0 on ``b_bias``
    as symbol attributes."""
    out = []
    for pkg in (mx, mt):
        with pkg.symbol.NameManager():
            data = pkg.sym.Variable("data")
            w = pkg.sym.Variable("w_weight", shape=shape, lr_mult=0.5)
            b = pkg.sym.Variable("b_bias", shape=shape, wd_mult=0.0)
            out.append(pkg.sym.MakeLoss(data * w + b * 2.0))
    return out


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_train_step_with_clip_global_norm(name, kw):
    jsym, tsym = _linear_syms()
    rng = np.random.default_rng(3)
    shape = (4, 6)
    w0 = {"w_weight": rng.standard_normal(shape).astype(np.float32),
          "b_bias": rng.standard_normal(shape).astype(np.float32)}
    datas = [rng.standard_normal(shape).astype(np.float32)
             for _ in range(STEPS)]
    opts = []
    for pkg, sym in ((mx, jsym), (mt, tsym)):
        opts.append(pkg.optimizer.create(name, sym=sym,
                                         clip_global_norm=0.3,
                                         **dict(COMMON, **kw)))
    assert opts[1].lr_mult == {"w_weight": 0.5}
    assert opts[1].wd_mult == {"b_bias": 0.0}
    jstep = mx.train_step.TrainStep(jsym, data_names=("data",),
                                    label_names=(), optimizer=opts[0])
    tstep = mt.TrainStep(tsym, data_names=("data",), label_names=(),
                         optimizer=opts[1], device="cpu")
    jstate = jstep.init({"data": shape})
    jstate["params"] = {n: jnp.asarray(v) for n, v in w0.items()}
    jstate["opt"] = {n: opts[0].create_fused_state(v)
                     for n, v in jstate["params"].items()}
    tstate = mt.convert.from_reference_state(jstate, "cpu")
    for x in datas:
        jstate, _ = jstep.step(jstate, {"data": x})
        tstate, _ = tstep.step(tstate, {"data": x})
    for n in w0:
        np.testing.assert_allclose(tstate["params"][n].numpy(),
                                   np.asarray(jstate["params"][n]), **TOL)
        a, b = _flat(tstate["opt"][n]), _flat(jstate["opt"][n])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, **TOL)
    assert int(tstate["step"]) == STEPS


def test_clip_global_norm_scales_the_step():
    # SGD without momentum: w1 = w0 - lr * scale * g, with scale from the
    # norm of every parameter's gradient together
    _, tsym = _linear_syms()
    shape = (4, 6)
    x = np.full(shape, 3.0, np.float32)
    opt = mt.optimizer.create("sgd", learning_rate=1.0, rescale_grad=1.0,
                              clip_global_norm=1.0, sym=tsym)
    step = mt.TrainStep(tsym, data_names=("data",), label_names=(),
                        optimizer=opt, device="cpu")
    state = step.init({"data": shape})
    w0 = {n: v.clone() for n, v in state["params"].items()}
    state, _ = step.step(state, {"data": x})
    norm = math.sqrt(24 * 9.0 + 24 * 4.0)
    for n, g, mult in (("w_weight", 3.0, 0.5), ("b_bias", 2.0, 1.0)):
        np.testing.assert_allclose(
            (w0[n] - state["params"][n]).numpy(),
            np.full(shape, mult * g / norm, np.float32), rtol=1e-5)


def test_global_norm_helpers_match_reference():
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (7,), (2, 2, 2))]
    j = [mx.nd.array(a) for a in arrays]
    t = [mt.nd.array(a, ctx=mt.cpu()) for a in arrays]
    assert mt.optimizer.global_norm(t) == mx.optimizer.global_norm(j)
    jn = mx.optimizer.clip_by_global_norm(j, 1.5)
    tn = mt.optimizer.clip_by_global_norm(t, 1.5)
    assert tn == jn
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)
    assert mt.optimizer.global_norm(t) == pytest.approx(1.5, rel=1e-6)
    updater = mt.optimizer.get_updater(
        mt.optimizer.create("adam", clip_global_norm=1.0))
    with pytest.raises(MXNetError, match="clip_by_global_norm"):
        updater(0, t[0], t[0])


def test_sgld_fused_noise_source_fixed():
    """The port's SGLD step with its noise stream read back: the weight
    equals the deterministic part plus sqrt(lr) times the stream's draw,
    and a second TrainStep from the same seed repeats it bit for bit."""
    _, tsym = _linear_syms()
    shape = (4, 6)
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    results = []
    for _ in range(2):
        mt.random.seed(11)
        opt = mt.optimizer.create("sgld", learning_rate=0.01, wd=1e-2,
                                  rescale_grad=1.0, sym=tsym)
        step = mt.TrainStep(tsym, data_names=("data",), label_names=(),
                            optimizer=opt, device="cpu")
        state = step.init({"data": shape})
        w0 = {n: v.clone() for n, v in state["params"].items()}
        state, _ = step.step(state, {"data": x})
        results.append((step, w0, {n: v.clone() for n, v in
                                   state["params"].items()}))
    step, w0, w1 = results[0]
    assert all(torch.equal(w1[n], results[1][2][n]) for n in w1)
    key = step._base_key            # the step key at step 0
    grads = {"w_weight": torch.from_numpy(x), "b_bias": torch.full(shape,
                                                                    2.0)}
    mults = {"w_weight": (0.5, 1.0), "b_bias": (1.0, 0.0)}
    for i, n in enumerate(step.param_names):
        gen = node_generator(key, _OPT_KEY_OFFSET + i, torch.device("cpu"))
        lr, wd = 0.01 * mults[n][0], 1e-2 * mults[n][1]
        noise = math.sqrt(lr) * torch.randn(shape, generator=gen)
        want = w0[n] - lr / 2 * (grads[n] + wd * w0[n]) + noise
        assert torch.equal(w1[n], want), n


@pytest.mark.parametrize("path", ["update", "fused"])
def test_sgld_noise_mean_and_variance(path):
    lr, n = 0.04, 500_000
    opt = mt.optimizer.create("sgld", learning_rate=lr, rescale_grad=1.0)
    w = torch.zeros(n)
    if path == "update":
        mt.random.seed(3)
        wt = mt.nd.array(w, ctx=mt.cpu())
        opt.update(0, wt, mt.nd.zeros((n,), ctx=mt.cpu()), None)
        d = wt.asnumpy().astype(np.float64)
    else:
        gen = torch.Generator().manual_seed(3)
        opt.fused_update("w", w, torch.zeros(n), None, lr, 0.0,
                         torch.tensor(1.0), key=gen)
        d = w.numpy().astype(np.float64)
    assert abs(d.mean()) < 5 * math.sqrt(lr / n)
    assert d.var() == pytest.approx(lr, rel=0.01)


def test_adam_states_open_in_either_package():
    ws, gs = _data(6)
    ups = {pkg: pkg.optimizer.get_updater(_make(pkg, "adam", {}))
           for pkg in (mx, mt)}
    weights = {pkg: [pkg.nd.array(w, ctx=pkg.cpu()) for w in ws]
               for pkg in (mx, mt)}
    for step in gs[:3]:
        for pkg in (mx, mt):
            for i, g in enumerate(step):
                ups[pkg](i, pkg.nd.array(g, ctx=pkg.cpu()), weights[pkg][i])
    # each package's states, loaded into a fresh updater of the other
    for src, dst in ((mt, mx), (mx, mt)):
        blob = ups[src].get_states()
        fresh = dst.optimizer.get_updater(_make(dst, "adam", {}))
        fresh.set_states(blob)
        assert sorted(fresh.states) == [0, 1]
        for i in range(2):
            assert isinstance(fresh.states[i], tuple)
            for x, y in zip(_flat(fresh.states[i]),
                            _flat(ups[src].states[i])):
                np.testing.assert_array_equal(x, y)
    # the port carries on from the JAX package's states, and the JAX
    # package from the port's, to the same weights
    swapped = {mt: mt.optimizer.get_updater(_make(mt, "adam", {})),
               mx: mx.optimizer.get_updater(_make(mx, "adam", {}))}
    swapped[mt].set_states(ups[mx].get_states())
    swapped[mx].set_states(ups[mt].get_states())
    for pkg in (mx, mt):
        swapped[pkg].optimizer._index_update_count = dict(
            ups[pkg].optimizer._index_update_count)
        for step in gs[3:]:
            for i, g in enumerate(step):
                swapped[pkg](i, pkg.nd.array(g, ctx=pkg.cpu()),
                             weights[pkg][i])
    for a, b in zip(weights[mt], weights[mx]):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)


def test_train_step_takes_every_fused_optimizer_by_name():
    _, tsym = _linear_syms()
    for name in ("sgd", "nag", "ccsgd", "dcasgd"):
        step = mt.TrainStep(tsym, data_names=("data",), label_names=(),
                            optimizer=name, momentum=0.8, device="cpu")
        assert step._opt.momentum == 0.8
    for name in ("sgld", "adam", "adagrad", "rmsprop", "adadelta", "ftrl",
                 "test"):
        step = mt.TrainStep(tsym, data_names=("data",), label_names=(),
                            optimizer=name, learning_rate=0.02,
                            device="cpu")
        assert type(step._opt).__name__.lower() == name
        assert step._opt.lr == 0.02

    class NoFused(mt.optimizer.Optimizer):
        pass

    with pytest.raises(MXNetError, match="has no fused update"):
        mt.TrainStep(tsym, data_names=("data",), label_names=(),
                     optimizer=NoFused(), device="cpu")
