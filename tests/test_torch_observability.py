"""The port's single-process observability (Monitor, the profiler, the
registry's Window and Prometheus export, the flight recorder's counter
deltas, fault plans) against the JAX package, on the CPU.

Tolerances, each with its reason:
- Monitor statistics: ``rtol=1e-5``. Each is ``norm(x) / sqrt(size)`` of
  an op output or a weight, which the two packages compute in float32 in
  other summation orders;
- the record names and steps, the Prometheus text, the windows' deltas,
  the flight marks and the fault counts: exact.
"""
import json
import logging
import os

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import faults as jfaults
from mxnet_tpu.obs import flight as jflight
from mxnet_tpu.obs import registry as jregistry
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import faults as tfaults
from mxnet_tpu_torch import profiler as tprofiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.obs import flight as tflight
from mxnet_tpu_torch.obs import registry as tregistry
from mxnet_tpu_torch.obs import trace as ttrace

BATCH = 8


def _mlp(pkg):
    d = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(data=d, num_hidden=6, name="fc1")
    h = pkg.sym.Activation(data=h, act_type="relu", name="relu1")
    h = pkg.sym.FullyConnected(data=h, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(data=h, name="softmax")


def _data():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((32, 5)).astype(np.float32)
    y = rng.integers(0, 3, size=32).astype(np.float32)
    w = {"fc1_weight": (0.5 * rng.standard_normal((6, 5))).astype(np.float32),
         "fc1_bias": np.zeros(6, np.float32),
         "fc2_weight": (0.5 * rng.standard_normal((3, 6))).astype(np.float32),
         "fc2_bias": np.zeros(3, np.float32)}
    return x, y, w


def _recording_monitor(pkg, **kw):
    """A Monitor whose toc_print keeps its rows."""
    class Rec(pkg.Monitor):
        rows = []

        def toc_print(self):
            self.rows.extend(self.toc())
    mon = Rec(**kw)
    mon.rows = []
    return mon


def _rows_close(trows, jrows):
    assert [(n, k) for n, k, _ in trows] == [(n, k) for n, k, _ in jrows]
    for (_, k, tv), (_, _, jv) in zip(trows, jrows):
        np.testing.assert_allclose(
            np.array(tv.split(","), np.float64),
            np.array(jv.split(","), np.float64), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("pattern,sort", [(".*", False), (".*weight", True),
                                          ("fc1.*", True)])
def test_fit_with_monitor_matches_jax(pattern, sort):
    """``fit(monitor=Monitor(interval=2, ...))``: the rows of every second
    batch (op outputs during the forward, then the matching arguments after
    the update), their names and values, against the JAX package's."""
    x, y, w = _data()
    rows = {}
    for pkg in (mx, mt):
        ctx = pkg.cpu()
        mod = pkg.mod.Module(_mlp(pkg), context=ctx)
        mon = _recording_monitor(pkg, interval=2, pattern=pattern, sort=sort)
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
                monitor=mon, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                arg_params={n: pkg.nd.array(v, ctx=ctx)
                            for n, v in w.items()})
        rows[pkg.__name__] = mon.rows
    t, j = rows["mxnet_tpu_torch"], rows["mxnet_tpu"]
    assert len(t) > 0 and {n for n, _, _ in t} == {1, 3}
    _rows_close(t, j)


def test_install_monitor_with_custom_stat_matches_jax():
    """``Module.install_monitor`` with a ``stat_func`` that returns a list
    of arrays, driven by hand (tic, forward, backward, update, toc), and
    the module off the fused path."""
    x, y, w = _data()
    rows = {}
    for pkg in (mx, mt):
        ctx = pkg.cpu()
        mod = pkg.mod.Module(_mlp(pkg), context=ctx)
        it = pkg.io.NDArrayIter(x, y, batch_size=BATCH)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params={n: pkg.nd.array(v, ctx=ctx)
                                    for n, v in w.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        mon = pkg.Monitor(1, stat_func=lambda a, nd=pkg.nd: [nd.max(a),
                                                             nd.min(a)],
                          pattern="fc2.*")
        mod.install_monitor(mon)
        ok, why = mod._can_bulk_dispatch()
        assert not ok and "monitor" in why
        got = []
        for b in it:
            mon.tic()
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
            got.extend(mon.toc())
        rows[pkg.__name__] = got
    # each batch: fc2's output in the forward, then its weight and bias
    assert len(rows["mxnet_tpu_torch"]) == 4 * 3
    _rows_close(rows["mxnet_tpu_torch"], rows["mxnet_tpu"])


def test_monitor_takes_fit_off_the_k_step_path(caplog):
    x, y, w = _data()
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    with caplog.at_level(logging.WARNING):
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
                monitor=mt.Monitor(100), steps_per_dispatch=4)
    assert "a monitor needs per-step executor access" in caplog.text
    assert mod._fused is None


# -- the profiler --------------------------------------------------------

@pytest.fixture
def profiler_state(monkeypatch):
    monkeypatch.setattr(tprofiler, "_state", dict(tprofiler._state))
    yield tprofiler
    tprofiler.dump_profile()


def test_profiler_autostart_deferred_to_first_dispatch(profiler_state,
                                                       monkeypatch, tmp_path):
    """``MXNET_PROFILER_AUTOSTART``: nothing starts before the first
    dispatch, so a ``profiler_set_config`` made after the import decides
    the file; the first fused step starts the profile, and stopping it
    writes a Chrome trace of the step's operators."""
    prof = profiler_state
    monkeypatch.setattr(prof, "_autostart_pending", True)
    path = str(tmp_path / "prof" / "late.json")
    prof.profiler_set_config(filename=path)
    x, y, _ = _data()
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 5))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params()
    mod.init_optimizer()
    assert not prof._state["running"]
    batch = mt.io.DataBatch([mt.nd.array(x[:BATCH], ctx=mt.cpu())],
                            [mt.nd.array(y[:BATCH], ctx=mt.cpu())])
    assert mod._try_fused_fit_step(batch)
    assert prof._state["running"] and not prof._autostart_pending
    with prof.Scope("user_region", epoch=3):
        mod._try_fused_fit_step(batch)
    prof.maybe_autostart()       # resolved: a no-op
    prof.dump_profile()
    assert not prof._state["running"]
    doc = json.load(open(path))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "user_region" in names
    assert "aten::mm" in names


def test_profiler_set_state_and_executor_autostart(profiler_state,
                                                   monkeypatch, tmp_path):
    """The executor's forward also starts a pending profile; an explicit
    ``run`` supersedes the pending one; a bad state raises."""
    prof = profiler_state
    monkeypatch.setattr(prof, "_autostart_pending", True)
    path = str(tmp_path / "exec.json")
    prof.profiler_set_config(mode="all", filename=path)
    ex = _mlp(mt).simple_bind(mt.cpu(), data=(BATCH, 5),
                              softmax_label=(BATCH,))
    ex.forward()
    assert prof._state["running"]
    prof.profiler_set_state("stop")
    assert os.path.exists(path)
    monkeypatch.setattr(prof, "_autostart_pending", True)
    prof.profiler_set_state("run")
    assert not prof._autostart_pending
    prof.profiler_set_state("stop")
    with pytest.raises(MXNetError, match="run' or 'stop"):
        prof.profiler_set_state("pause")


def test_profiler_scope_emits_host_span():
    """``Scope`` is an ``obs.span`` too, with its arguments, as the JAX
    package's."""
    ttrace.clear()
    ttrace.start()
    try:
        with tprofiler.Scope("user_region", epoch=3):
            pass
        spans = [e for e in ttrace.events() if e["ph"] == "X"]
    finally:
        ttrace.stop()
        ttrace.clear()
    assert spans and spans[-1]["name"] == "user_region"
    assert spans[-1]["args"] == {"epoch": 3}


# -- Window, to_prometheus, flight deltas ---------------------------------

@pytest.mark.parametrize("reg", [jregistry, tregistry], ids=["jax", "port"])
def test_window_delta_peek_rebase_and_keying(reg):
    """The same script against both packages' Window."""
    vals = {"a": 0, "s": "str", "f": True}
    w = reg.Window(lambda: dict(vals))
    vals["a"] = 5
    assert w.delta() == {"a": 5, "s": "str", "f": True}
    vals["a"] = 7
    assert w.peek() == {"a": 2, "s": "str", "f": True}
    assert w.delta() == {"a": 2, "s": "str", "f": True}
    vals["a"] = 9
    w.rebase()
    assert w.delta() == {"a": 0, "s": "str", "f": True}
    key = object()
    wk = reg.Window(lambda: dict(vals), key=key)
    vals["a"] = 17
    assert wk.delta(object()) is None
    assert wk.delta(key)["a"] == 8
    err = mx.MXNetError if reg is jregistry else MXNetError
    with pytest.raises(err, match="callable"):
        reg.Window(42)


def test_registry_window_over_the_global_views():
    w = mt.obs.REGISTRY.window()
    mt.guard.TRAINING_HEALTH.record_steps(4, 1)
    d = w.delta()
    assert d["training_health.steps"] == 4
    assert d["training_health.skipped"] == 1


def _fill(reg):
    reg.counter("serve.requests", "requests").inc(3)
    reg.counter("a-b/c").inc(2)
    reg.gauge("queue.depth").set(2.5)
    h = reg.histogram("serve.latency_ms")
    for v in (1.0, 4.0, 2.5):
        h.observe(v)
    reg.register_view("v", lambda: {"x": 1.5, "n": 4, "ok": True,
                                    "last_error": "nope", "9lives": 1})
    reg.register_view("broken", lambda: 1 / 0)
    return reg


def test_to_prometheus_matches_jax():
    """The same counters, gauge, histogram and views give the same
    exposition text: ``# TYPE`` lines, mangled names, no strings or
    bools."""
    t = _fill(tregistry.Registry()).to_prometheus()
    j = _fill(jregistry.Registry()).to_prometheus()
    assert t == j
    assert "# TYPE serve_requests counter\nserve_requests 3\n" in t
    assert "serve_latency_ms_count 3" in t and "nope" not in t
    assert "_9lives 1" in t


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_flight_note_captures_registry_deltas(pkg):
    """Each note carries the counter delta since the previous one (the
    first an empty baseline), in both packages alike."""
    reg_mod, fl = ((jregistry, jflight) if pkg == "jax"
                   else (tregistry, tflight))
    reg = reg_mod.Registry()
    c = reg.counter("x")
    g = reg.gauge("g")
    rec = fl.FlightRecorder(ring=16, registry=reg)
    rec.note("dispatch_retired", dispatch=0)
    c.inc(3)
    g.set(2.0)
    rec.note("dispatch_retired", dispatch=1)
    rec.note("dispatch_retired", dispatch=2)
    marks = [{k: v for k, v in m.items() if k != "t"} for m in rec._marks]
    assert marks == [
        {"marker": "dispatch_retired", "dispatch": 0, "delta": {}},
        {"marker": "dispatch_retired", "dispatch": 1,
         "delta": {"x": 3, "g": 2.0}},
        {"marker": "dispatch_retired", "dispatch": 2, "delta": {}}]


def test_flight_dump_holds_the_fit_dispatch_deltas(tmp_path):
    """A K-step fit notes each retired dispatch; the dump's
    ``counter_deltas`` carry them, and its ``counters`` the snapshot."""
    x, y, _ = _data()
    tflight.FLIGHT.clear()
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
            steps_per_dispatch=2, dispatch_pipeline=0)
    path = tflight.dump("unit test", path=str(tmp_path / "d.json"))
    doc = json.load(open(path))
    retired = [m for m in doc["counter_deltas"]
               if m["marker"] == "dispatch_retired"]
    assert [m["dispatch"] for m in retired] == [0, 1]
    assert all(isinstance(m["delta"], dict) for m in retired)
    assert any("pipeline_stats" in k for m in retired for k in m["delta"])
    assert "training_health.skipped" in doc["counters"]


# -- fault plans -----------------------------------------------------------

PLAN = [{"site": "io.batch_read", "kind": "transient", "nth": 2,
         "times": 2},
        {"site": "guard.grad_nan", "kind": "poison", "nth": 1},
        {"site": "checkpoint.write", "kind": "raise", "nth": 5}]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_plan_scope_and_fired_counts(pkg):
    """A plan armed for a block: the sites fire on their calls,
    ``fired_counts`` names the rules that matched (not the one whose call
    never came), and the block's end clears every site it touched."""
    f = jfaults if pkg == "jax" else tfaults
    f.clear()
    raised = 0
    with f.plan_scope(PLAN):
        for _ in range(4):
            try:
                f.fire("io.batch_read")
            except f.InjectedTransientFault:
                raised += 1
        assert f.fire_flag("guard.grad_nan")
        f.fire("checkpoint.write")
        assert f.fired_counts() == {"io.batch_read": 2, "guard.grad_nan": 1}
    assert raised == 2
    assert f.fired_counts() == {}
    assert f.count("io.batch_read") == 0
    err = mx.MXNetError if pkg == "jax" else MXNetError
    with pytest.raises(err, match="unregistered fault site"):
        with f.plan_scope([{"site": "no.such.site", "kind": "raise"}]):
            pass


def test_site_describe_matches_jax():
    """Every site the port registers describes itself as the JAX
    package's site of that name does."""
    assert tfaults.SITES
    for name, site in tfaults.SITES.items():
        d = site.describe()
        assert d == jfaults.SITES[name].describe()
        assert json.loads(json.dumps(d)) == d
