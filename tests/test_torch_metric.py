"""The port's metrics and callbacks against the JAX package's, on the CPU.

- Every metric ``create`` can build (but ``multibox``), a ``CustomMetric``,
  ``metric.np`` and a composite, updated with the same ``(labels, preds)``:
  the same value (``rtol=1e-6``: numpy sums the same float32 inputs in both
  packages; only the float64 host accumulators' order could differ).
- Each metric's device-sum spec (the packed-accumulator protocol): the
  port's torch ``step_sums`` against the JAX package's ``jnp`` ones on the
  same arrays (``rtol=1e-6, atol=1e-6``: float32 sums), and folded, against
  the host ``update`` (``rtol=1e-5``).
- ``TrainStep.run_steps(metric_spec=)`` folded by
  ``update_from_device_sums`` against the host ``update`` over the same K
  steps, from the same state (``rtol=1e-5``; counts exact).
- ``Speedometer``, ``log_train_metric``, ``do_checkpoint`` and
  ``module_checkpoint`` fire at the same batches and epochs as the JAX
  package's, at k=1 and at k=4 (``nbatch`` in jumps of 4).
"""
import logging
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.train_step import TrainStep

VALUE = dict(rtol=1e-6)
SUMS = dict(rtol=1e-6, atol=1e-6)


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _probs(rng, shape):
    p = rng.random(shape).astype(np.float32) + 0.05
    return p / p.sum(axis=-1, keepdims=True)


def _cases(name):
    """name -> (create kwargs or metric builder, labels, preds) as numpy."""
    rng = _rng(name)
    cls = [rng.integers(0, 5, 6).astype(np.float32) for _ in range(2)]
    prob = [_probs(rng, (6, 5)) for _ in range(2)]
    binary = [rng.integers(0, 2, 6).astype(np.float32)]
    bprob = [_probs(rng, (6, 2))]
    reg_l = [rng.standard_normal(6).astype(np.float32)]
    reg_p = [rng.standard_normal((6, 1)).astype(np.float32)]
    seq_l = [rng.integers(0, 5, (3, 4)).astype(np.float32)]
    seq_p = [_probs(rng, (3, 4, 5))]
    return {
        "acc": (("acc", {}), cls, prob),
        "accuracy": (("accuracy", {}), cls, prob),
        "ce": (("ce", {}), cls, prob),
        "cross-entropy": (("cross-entropy", {"eps": 1e-4}), cls, prob),
        "f1": (("f1", {}), binary, bprob),
        "mae": (("mae", {}), reg_l, reg_p),
        "mse": (("mse", {}), reg_l, reg_p),
        "rmse": (("rmse", {}), reg_l, reg_p),
        "top_k_accuracy": (("top_k_accuracy", {"top_k": 3}), cls, prob),
        "perplexity": (("perplexity", {"ignore_label": None}), seq_l,
                       seq_p),
        "perplexity_ignore": (("perplexity", {"ignore_label": 2}), seq_l,
                              seq_p),
        "loss": (("loss", {}), cls, prob),
        "composite": ((["acc", "ce"], {}), cls, prob),
        "custom": (("custom", {}), cls, prob),
        "np": (("np", {}), cls, prob),
    }


CASES = sorted(_cases("x"))


def _mean_abs(label, pred):
    return float(np.abs(label - pred.argmax(axis=1)).mean())


def _sum_count(label, pred):
    return float((pred.argmax(axis=1) == label).sum()), len(label)


def _make(pkg, spec):
    name, kw = spec
    if name == "custom":
        return pkg.metric.CustomMetric(_mean_abs, name="mean_abs")
    if name == "np":
        return pkg.metric.np(_sum_count)
    return pkg.metric.create(name, **kw)


def _nd(pkg, arrays):
    ctx = mt.cpu() if pkg is mt else mx.cpu()
    return [pkg.nd.array(a, ctx=ctx) for a in arrays]


@pytest.mark.parametrize("case", CASES)
def test_metric_values_match_reference(case):
    spec, labels, preds = _cases(case)[case]
    jm, tm = _make(mx, spec), _make(mt, spec)
    for _ in range(2):      # two updates accumulate
        jm.update(_nd(mx, labels), _nd(mx, preds))
        tm.update(_nd(mt, labels), _nd(mt, preds))
    jn, jv = jm.get()
    tn, tv = tm.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, **VALUE)
    tm.reset()
    assert np.all(np.isnan(tm.get()[1]))


@pytest.mark.parametrize("case", CASES)
def test_device_sum_specs_match_reference_and_host(case):
    spec, labels, preds = _cases(case)[case]
    jm, tm = _make(mx, spec), _make(mt, spec)
    out_shapes = [p.shape for p in preds]
    label_shapes = [l.shape for l in labels]
    jspec = mx.metric.device_sum_spec(jm, out_shapes, label_shapes)
    tspec = mt.metric.device_sum_spec(tm, out_shapes, label_shapes)
    assert (tspec is None) == (jspec is None)
    assert mt.metric.supports_device_sums(tm, out_shapes, label_shapes) \
        == (tspec is not None)
    if tspec is None:
        return
    assert tspec.slots == jspec.slots
    assert tspec.loss_slots == jspec.loss_slots
    tvals = tspec.step_sums([torch.from_numpy(p) for p in preds],
                            [torch.from_numpy(l) for l in labels])
    jvals = jspec.step_sums([jnp.asarray(p) for p in preds],
                            [jnp.asarray(l) for l in labels])
    np.testing.assert_allclose([float(v) for v in tvals],
                               [float(v) for v in jvals], **SUMS)
    folded = _make(mt, spec)
    tspec.fold(folded, {s: float(v) for s, v in zip(tspec.slots, tvals)})
    host = _make(mt, spec)
    host.update(_nd(mt, labels), _nd(mt, preds))
    np.testing.assert_allclose(folded.get()[1], host.get()[1], rtol=1e-5)


def _tiny_sym(pkg):
    with pkg.symbol.NameManager():
        data = pkg.sym.Variable("data")
        fc = pkg.sym.FullyConnected(data=data, num_hidden=5, name="fc")
        return pkg.sym.SoftmaxOutput(data=fc, name="softmax")


def _clone_state(st):
    return {"params": {n: v.clone() for n, v in st["params"].items()},
            "aux": {n: v.clone() for n, v in st["aux"].items()},
            "opt": {n: (None if v is None else v.clone())
                    for n, v in st["opt"].items()},
            "step": st["step"].clone()}


@pytest.mark.parametrize("name", ["acc", "ce", "top_k_accuracy", "mse",
                                  "loss", "composite"])
def test_run_steps_metric_spec_equals_host_update(name):
    """run_steps(metric_spec=) over K steps, folded with
    update_from_device_sums, against step() K times with the host update
    on each step's outputs, from the same state."""
    rng = _rng("runsteps/" + name)
    k, b = 3, 4
    x = rng.standard_normal((k, b, 7)).astype(np.float32)
    y = rng.integers(0, 5, (k, b)).astype(np.float32)
    kwargs = {"top_k_accuracy": {"top_k": 2}}.get(name, {})
    metric = mt.metric.create(["acc", "ce"] if name == "composite" else name,
                              **kwargs)
    step = TrainStep(_tiny_sym(mt), learning_rate=0.1, device="cpu")
    st = step.init({"data": (b, 7)}, {"softmax_label": (b,)}, seed=1)
    twin = _clone_state(st)
    spec = mt.metric.device_sum_spec(metric, [(b, 5)], [(b,)])
    assert spec is not None
    _, sums = step.run_steps(st, {"data": x, "softmax_label": y},
                             metric_spec=spec)
    assert not sums.fetched
    mt.metric.update_from_device_sums(metric, sums)
    host = mt.metric.create(["acc", "ce"] if name == "composite" else name,
                            **kwargs)
    for i in range(k):
        twin, outs = step.step(twin, {"data": x[i], "softmax_label": y[i]})
        host.update([mt.nd.array(y[i], ctx=mt.cpu())],
                    [mt.nd.NDArray(o) for o in outs])
    np.testing.assert_allclose(metric.get()[1], host.get()[1], rtol=1e-5)
    for n, v in twin["params"].items():
        np.testing.assert_allclose(st["params"][n].numpy(), v.numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_legacy_sums_fold_acc_and_ce_only():
    step = TrainStep(_tiny_sym(mt), learning_rate=0.1, device="cpu")
    st = step.init({"data": (4, 7)}, {"softmax_label": (4,)})
    x = np.ones((2, 4, 7), np.float32)
    y = np.zeros((2, 4), np.float32)
    _, sums = step.run_steps(st, {"data": x, "softmax_label": y})
    acc = mt.metric.Accuracy()
    mt.metric.update_from_device_sums(acc, sums)
    assert acc.num_inst == 8
    with pytest.raises(MXNetError, match="MAE"):
        mt.metric.update_from_device_sums(mt.metric.MAE(), sums)
    with pytest.raises(MXNetError, match="eps"):
        mt.metric.update_from_device_sums(mt.metric.CrossEntropy(eps=1e-3),
                                          sums)


def _fires(pkg, callback_of, nbatches, caplog):
    """The (epoch, nbatch) of every log line a batch-end callback emits
    over ``nbatches`` (two epochs)."""
    metric = pkg.metric.Accuracy()
    cb = callback_of(pkg)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        for epoch in range(2):
            for nb in nbatches:
                cb(pkg.model.BatchEndParam(epoch=epoch, nbatch=nb,
                                           eval_metric=metric, locals={}))
    return [(r.args[0], r.args[1]) for r in caplog.records]


SPEEDO = {"speedometer": lambda pkg: pkg.callback.Speedometer(8, 5),
          "log_train_metric": lambda pkg: pkg.callback.log_train_metric(5)}


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("which", sorted(SPEEDO))
def test_batch_callbacks_fire_at_the_reference_batches(which, k, caplog):
    nbatches = list(range(k - 1, 24, k))
    want = _fires(mx, SPEEDO[which], nbatches, caplog)
    got = _fires(mt, SPEEDO[which], nbatches, caplog)
    assert got == want and got


def test_checkpoint_callbacks_fire_at_the_reference_epochs(tmp_path):
    jsym, tsym = _tiny_sym(mx), _tiny_sym(mt)
    arg = {"fc_weight": np.ones((5, 7), np.float32),
           "fc_bias": np.zeros(5, np.float32)}
    written = {}
    for pkg, sym in ((mx, jsym), (mt, tsym)):
        d = tmp_path / pkg.__name__
        d.mkdir()
        cb = pkg.callback.do_checkpoint(str(d / "net"), period=2)
        ctx = mt.cpu() if pkg is mt else mx.cpu()
        for epoch in range(5):
            cb(epoch, sym, {n: pkg.nd.array(v, ctx=ctx)
                            for n, v in arg.items()}, {})
        written[pkg] = sorted(os.listdir(d))
    assert written[mt] == written[mx] == [
        "net-0002.params", "net-0004.params", "net-symbol.json"]
    # the port's files open in the JAX package
    _, jarg, _ = mx.model.load_checkpoint(str(tmp_path / "mxnet_tpu_torch"
                                              / "net"), 4)
    np.testing.assert_array_equal(jarg["fc_weight"].asnumpy(),
                                  arg["fc_weight"])


def test_module_checkpoint_fires_by_period(tmp_path):
    calls = []

    class _Mod(object):
        def save_checkpoint(self, prefix, epoch, states):
            calls.append((prefix, epoch, states))

    cb = mt.callback.module_checkpoint(_Mod(), "p", period=3,
                                       save_optimizer_states=True)
    for epoch in range(7):
        cb(epoch)
    assert calls == [("p", 3, True), ("p", 6, True)]


def test_progress_bar_logs_each_batch(caplog):
    bar = mt.callback.ProgressBar(total=4, length=8)
    with caplog.at_level(logging.INFO):
        bar(mt.model.BatchEndParam(epoch=0, nbatch=2, eval_metric=None,
                                   locals={}))
    assert "[====----] 50%" in caplog.text
