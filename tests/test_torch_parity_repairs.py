"""Three gaps of the port against the JAX package, each held here on the CPU.

- The metrics registry carries the ``training_health`` view (with
  ``data_health`` and ``pipeline_stats``): after the same poisoned guarded
  step in both packages, every ``training_health.*`` key of the port's
  ``REGISTRY.snapshot()`` is in the JAX package's with the same value
  (exact; a NaN gradient norm equals a NaN). The JAX package's one more key,
  ``retraces``, counts its retrace watch, which the port does not have.
- The top-level names ``TrainingGuard``, ``TrainingHealth``,
  ``TrainingDivergedError``, ``FeedForward`` and the modules ``image`` and
  ``recordio`` resolve in both packages, each to its own package's object.
- ``MXNET_ENGINE_TYPE=NaiveEngine`` and ``engine.set_engine_type``: naive
  mode in both packages, each imperative op passes its result through
  ``engine.maybe_sync``, and the values equal the JAX package's (exact:
  small integers in float32).
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import faults as jfaults
from mxnet_tpu.obs.registry import REGISTRY as JREGISTRY
from mxnet_tpu.train_step import TrainStep as JTrainStep
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert, faults as tfaults
from mxnet_tpu_torch.obs.registry import REGISTRY
from mxnet_tpu_torch.train_step import TrainStep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data=data, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(data=net, act_type="tanh")
    net = pkg.sym.FullyConnected(data=net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(data=net, name="softmax")


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def test_training_health_view_matches_reference():
    rng = np.random.default_rng(3)
    batch = {"data": rng.normal(size=(8, 10)).astype(np.float32),
             "softmax_label": rng.integers(0, 4, 8).astype(np.float32)}
    kw = dict(learning_rate=0.05, momentum=0.9, rescale_grad=1.0 / 8)
    jstep = JTrainStep(_mlp(mx), optimizer=mx.optimizer.create("sgd", **kw))
    tstep = TrainStep(_mlp(mt), optimizer=mt.optimizer.create("sgd", **kw),
                      device="cpu")
    jst = jstep.init({"data": (8, 10)}, {"softmax_label": (8,)}, seed=2)
    tst = convert.from_reference_state(jst, "cpu")
    snaps = {}
    try:
        for pkg, step, st, faults, reg in (
                (mx, jstep, jst, jfaults, JREGISTRY),
                (mt, tstep, tst, tfaults, REGISTRY)):
            pkg.guard.TRAINING_HEALTH.reset()
            faults.clear()
            faults.inject("guard.grad_nan", nth=1)
            _, _, packed = step.step(st, batch, guard=True)
            p = [float(v) for v in np.asarray(
                packed.numpy() if hasattr(packed, "numpy") else packed)]
            assert p[3] == 1.0                      # the step was skipped
            g = pkg.guard.TrainingGuard(max_skips_per_window=100)
            g.on_dispatch(loss_sum=p[0], nsamp=p[2], skipped=p[3],
                          grad_norm=p[4], nsteps=1)
            snaps[pkg] = {k[len("training_health."):]: v
                          for k, v in reg.snapshot().items()
                          if k.startswith("training_health.")}
    finally:
        for f in (jfaults, tfaults):
            f.clear()
        mx.guard.TRAINING_HEALTH.reset()
        mt.guard.TRAINING_HEALTH.reset()
    got, want = snaps[mt], snaps[mx]
    assert got["skipped"] == 1 and got["steps"] == 1
    assert set(got) == set(want) - {"retraces"}
    for k in got:
        assert _same(got[k], want[k]), (k, got[k], want[k])
    assert {"data_health", "pipeline_stats", "serving_health"} <= {
        k.split(".")[0] for k in REGISTRY.snapshot()}


@pytest.mark.parametrize("name", ["TrainingGuard", "TrainingHealth",
                                  "TrainingDivergedError", "FeedForward",
                                  "AttrScope", "image", "recordio"])
def test_top_level_names_resolve_in_both(name):
    owner = {"TrainingGuard": "guard", "TrainingHealth": "guard",
             "TrainingDivergedError": "guard", "FeedForward": "model",
             "AttrScope": "symbol"}
    for pkg in (mx, mt):
        obj = getattr(pkg, name)
        if name in owner:
            assert obj is getattr(getattr(pkg, owner[name]), name)
            assert obj.__module__.startswith(pkg.__name__ + ".")
        else:
            assert obj.__name__ == "%s.%s" % (pkg.__name__, name)


def test_symbol_prefix_names_as_in_jax():
    """``symbol.Prefix`` prefixes auto and given names in both packages."""
    for pkg in (mx, mt):
        with pkg.symbol.Prefix("mp_"):
            net = pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                         num_hidden=4)
        assert pkg.symbol.Prefix.__module__ == pkg.__name__ + ".symbol"
        assert net.list_arguments() == ["data", "mp_fullyconnected0_weight",
                                        "mp_fullyconnected0_bias"]


def test_naive_engine_syncs_every_op_and_matches_reference(monkeypatch):
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    calls = []
    real = mt.engine.maybe_sync
    monkeypatch.setattr(mt.engine, "maybe_sync",
                        lambda t: calls.append(t.shape) or real(t))
    prev = (mx.engine.is_naive(), mt.engine.is_naive())
    try:
        out = {}
        for pkg in (mx, mt):
            pkg.engine.set_engine_type("NaiveEngine")
            assert pkg.engine.is_naive()
            a = pkg.nd.array(x, ctx=pkg.cpu())
            b = (a * 2 + 1).T
            c = pkg.nd.dot(a, b)
            a[:] = pkg.nd.dot(c, a) - 3
            pkg.engine.wait_for_var(c)
            seen = []
            pkg.engine.push(lambda: seen.append(True))
            assert seen == [True]
            out[pkg] = (b.asnumpy(), c.asnumpy(), a.asnumpy())
        for u, v in zip(out[mt], out[mx]):
            np.testing.assert_array_equal(u, v)
        assert len(calls) >= 4     # every op and the assignment
        for pkg in (mx, mt):
            pkg.engine.set_engine_type("ThreadedEnginePerDevice")
            assert not pkg.engine.is_naive()
    finally:
        for pkg, was in zip((mx, mt), prev):
            pkg.engine.set_engine_type("NaiveEngine" if was
                                       else "ThreadedEngine")


def test_engine_type_is_read_from_the_environment():
    env = dict(os.environ, MXNET_ENGINE_TYPE="NaiveEngine",
               PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", "import mxnet_tpu_torch as mt; "
         "print(mt.engine.is_naive())"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"
