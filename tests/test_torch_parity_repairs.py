"""Gaps of the port against the JAX package, each held here on the CPU.

- The metrics registry carries the ``training_health`` view (with
  ``data_health`` and ``pipeline_stats``): after the same poisoned guarded
  step in both packages, every ``training_health.*`` key of the port's
  ``REGISTRY.snapshot()`` is in the JAX package's with the same value
  (exact; a NaN gradient norm equals a NaN), and the two key sets are the
  same (``retraces`` included, the count of the retrace watch).
- The top-level names ``TrainingGuard``, ``TrainingHealth``,
  ``TrainingDivergedError``, ``FeedForward``, ``num_devices``, ``tpu``, the
  modules ``image``, ``recordio``, ``viz`` and ``test_utils``, and
  ``mod.BatchEndParam``, ``models.ssd_train``, ``context.default_context``
  and ``base.string_types`` resolve in both packages, each to its own
  package's object of the same kind; ``mt.tpu(i)`` places on the card as
  ``mt.gpu(i)`` does.
- The shared submodules' names (``ops.get``/``exists``/``list_ops``/
  ``OpContext``/``OpDef``/``register``/``register_def``,
  ``obs.trace.nest_check``, ``base.MXNET_TPU_MAJOR``/``MINOR``/``PATCH``
  and ``base.NotImplementedForTPU``) resolve in both packages to the same
  kind of object, and ``nest_check`` gives the JAX package's list on the
  same events, an overlap violation among them (exact).
- The device defaults of the analyzers do not fall back to the CPU on a
  host without CUDA: ``memcheck._device(None)`` and
  ``devspec.device_kind(None)`` raise ``MXNetError`` as
  ``context.resolve_device`` does (``parallel.mesh.devices()``: in
  ``tests/test_torch_parallel.py``), and ``memcheck``'s lints budget a
  report by the device it priced: a CPU report on a card host gets the
  CPU's 16 GiB, not the card's memory (exact).
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
import torch

import mxnet_tpu as mx
from mxnet_tpu import faults as jfaults
from mxnet_tpu.obs.registry import REGISTRY as JREGISTRY
from mxnet_tpu.train_step import TrainStep as JTrainStep
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert, faults as tfaults
from mxnet_tpu_torch.base import MXNetError
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
    assert set(got) == set(want)
    for k in got:
        assert _same(got[k], want[k]), (k, got[k], want[k])
    assert {"data_health", "pipeline_stats", "serving_health"} <= {
        k.split(".")[0] for k in REGISTRY.snapshot()}


@pytest.mark.parametrize("name", ["TrainingGuard", "TrainingHealth",
                                  "TrainingDivergedError", "FeedForward",
                                  "AttrScope", "image", "recordio",
                                  "num_devices", "tpu", "viz", "test_utils",
                                  "mod.BatchEndParam", "models.ssd_train",
                                  "context.default_context",
                                  "base.string_types"])
def test_top_level_names_resolve_in_both(name):
    owner = {"TrainingGuard": "guard", "TrainingHealth": "guard",
             "TrainingDivergedError": "guard", "FeedForward": "model",
             "AttrScope": "symbol", "num_devices": "context",
             "tpu": "context"}
    module_name = {"viz": "visualization"}
    objs = []
    for pkg in (mx, mt):
        obj = pkg
        for part in name.split("."):
            obj = getattr(obj, part)
        objs.append(obj)
        if name in owner:
            assert obj is getattr(getattr(pkg, owner[name]), name)
            assert obj.__module__.startswith(pkg.__name__ + ".")
        elif "." in name:
            assert obj.__module__.startswith(pkg.__name__ + ".")
        else:
            assert obj.__name__ == "%s.%s" % (pkg.__name__,
                                              module_name.get(name, name))
    # the same kind of object in both: a module, a class or a function
    assert type(objs[0]) is type(objs[1]) or (
        isinstance(objs[0], type) and isinstance(objs[1], type))
    if name == "num_devices":
        assert mt.num_devices() == mt.context.num_devices()
    if name == "tpu":
        # the JAX package's accelerator name is the card in the port
        assert mt.tpu(0).to_device() == mt.gpu(0).to_device()
        assert mt.Context("tpu", 2).to_device() == mt.gpu(2).to_device()
        for pkg in (mx, mt):
            assert pkg.Context.devtype2str[4] == "tpu"
            assert pkg.Context("tpu", 1).device_typeid == 4
            assert str(pkg.tpu(1)) == "tpu(1)"
    if name == "base.string_types":
        assert mt.base.string_types() == mx.base.string_types()


@pytest.mark.parametrize("name", [
    "ops.get", "ops.exists", "ops.list_ops", "ops.OpContext", "ops.OpDef",
    "ops.register", "ops.register_def", "obs.trace.nest_check",
    "base.MXNET_TPU_MAJOR", "base.MXNET_TPU_MINOR", "base.MXNET_TPU_PATCH",
    "base.NotImplementedForTPU"])
def test_shared_submodule_names_resolve_in_both(name):
    """The names of shared submodules the port lacked: each resolves in
    both packages to the same kind of object (the version numbers to the
    same value, the error to a subclass of each package's MXNetError)."""
    objs = []
    for pkg in (mx, mt):
        obj = pkg
        for part in name.split("."):
            obj = getattr(obj, part)
        objs.append(obj)
        if callable(obj):
            assert obj.__module__.startswith(pkg.__name__ + ".")
    j, t = objs
    if isinstance(j, int):
        assert t == j
    elif isinstance(j, type):
        assert isinstance(t, type)
        if name == "base.NotImplementedForTPU":
            assert issubclass(t, mt.base.MXNetError)
            assert issubclass(j, mx.base.MXNetError)
    else:
        assert type(t) is type(j)
    if name == "ops.list_ops":
        assert mt.ops.list_ops() == mx.ops.list_ops()
    if name == "ops.exists":
        assert mt.ops.exists("Convolution") and not mt.ops.exists("nope")
        assert mt.ops.get("Convolution") is mt.ops.registry.get(
            "Convolution")


def test_nest_check_matches_jax_on_the_same_events():
    """Span nesting per (pid, tid), one overlap violation among nested,
    disjoint and instant events: the JAX package's list, exact."""
    evs = [
        {"ph": "X", "name": "step", "ts": 0, "dur": 100, "pid": 1,
         "tid": 7},
        {"ph": "X", "name": "fwd", "ts": 10, "dur": 30, "pid": 1, "tid": 7},
        {"ph": "X", "name": "bwd", "ts": 40, "dur": 50, "pid": 1, "tid": 7},
        {"ph": "X", "name": "leak", "ts": 80, "dur": 40, "pid": 1,
         "tid": 7},
        {"ph": "X", "name": "other", "ts": 85, "dur": 40, "pid": 1,
         "tid": 8},
        {"ph": "i", "name": "mark", "ts": 50, "pid": 1, "tid": 7},
        {"ph": "X", "name": "after", "ts": 100, "dur": 5, "pid": 1,
         "tid": 7},
    ]
    import copy
    got = mt.obs.trace.nest_check(copy.deepcopy(evs))
    want = mx.obs.trace.nest_check(copy.deepcopy(evs))
    assert got == want
    assert got == ["span 'leak' [80,120) overlaps 'bwd' [40,90) on tid 7"]
    assert mt.obs.trace.nest_check(evs[:3]) == []


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


def test_analyzer_device_defaults_raise_without_cuda(monkeypatch):
    from mxnet_tpu_torch import devspec, memcheck
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: memcheck._device(None), memcheck.device_budget,
                 memcheck.budget_bytes, lambda: devspec.device_kind(None),
                 devspec.lookup, devspec.peak_flops):
        with pytest.raises(MXNetError, match="device='cpu'"):
            call()
    assert memcheck._device("cpu") == torch.device("cpu")
    assert devspec.device_kind("cpu") == "cpu"


def test_memcheck_lints_budget_by_the_reports_device(monkeypatch):
    """On a card host (CUDA monkeypatched in, an 80 GB card) a report
    priced on the CPU is budgeted at the CPU's 16 GiB, and one priced on
    the card at the card's memory, with no budget passed."""
    from mxnet_tpu_torch import memcheck

    class Props:
        total_memory = 80 * 10 ** 9

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i=0: Props)
    monkeypatch.delenv("MXTPU_MEMCHECK_BUDGET", raising=False)
    rep = memcheck.analyze(lambda x: x * 2.0, (torch.zeros(4),),
                           name="cpu/step")
    assert rep.device == "cpu" and rep.as_dict()["device"] == "cpu"
    peak = 20 << 30      # between the CPU's 16 GiB and the card's 80 GB
    for device, fires in (("cpu", True), ("cuda:0", False)):
        r = memcheck.MemoryReport("p/step", "cpu", peak, 0, 0, 0,
                                  device=device)
        got = [f.lint for f in memcheck.lint_report(r)]
        assert got == (["hbm-budget"] if fires else []), device
        got = memcheck.lint_resident_set([r], "p/resident-set")
        assert bool(got) is fires, device
    assert memcheck.MemoryReport("p", "gpu", 0, 0, 0, 0).device == "cuda:0"
