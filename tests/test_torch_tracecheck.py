"""The port's ``tracecheck`` against the JAX package's on the CPU: the
retrace watch, the program registry, the static lints and the CLI.

- the signature differ: ``explain_diff`` and ``benign_diff`` give the JAX
  package's lines (exact) for a shape, dtype, static value and Python
  scalar type change and an unchanged call;
- the retrace watch on the zoo's mlp TrainStep: the same dispatch
  sequence (a float32 -> float16 flip of ``data``, back to float32, then a
  ``softmax_label`` shape change under the one key) records the same
  events in both packages (site after the watcher's name, and diff lines,
  exact); under ``error`` the raised ``RetraceError`` carries the
  dispatch's result, whose step counter advanced as in the JAX package;
  two same-named TrainSteps register their own programs; ``off`` captures
  nothing; the mode's parsing and messages;
- ``Speedometer``'s ``Retraces: 1`` and its re-baselining,
  ``TrainingHealth.report()['retraces']`` through the parent chain, the
  ``retrace_events`` view;
- the CLI's ``--list`` names and its error for an unknown model, and the
  ``--json`` summary's suppressed count;
- the lints, which have no JAX oracle here (the JAX package's lint tests
  fail on jax 0.9.0): each of ``host-sync``, ``dtype-f64``, ``donation``
  and ``const-capture`` fires once on a seeded CPU program at the exact
  ``file:line`` and stays silent on its clean twin; programmatic and
  inline suppression; ``check_zoo(device="cpu")`` over the whole zoo;
- ``ServingEngine.check``, ``DecodeLoop.check`` and
  ``BucketingModule.check`` on small CPU models, their memory findings
  held to ``memcheck.lint_report``/``lint_resident_set`` over the same
  reports, and ``memcheck.check_registered``.
"""
import inspect
import json
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import tracecheck as jtc
from mxnet_tpu_torch import MXNetError, engine, memcheck as mc
from mxnet_tpu_torch import tracecheck as tc
from mxnet_tpu_torch.test_utils import assert_no_retrace
from mxnet_tpu_torch.train_step import TrainStep

B = 8
HERE = os.path.realpath(__file__)


@pytest.fixture(autouse=True)
def _clean_slate():
    for pkg, t in ((mx, jtc), (mt, tc)):
        t.clear_suppressions()
        t.RETRACE_EVENTS.clear()
        t.PROGRAMS.clear()
        pkg.guard.TRAINING_HEALTH.reset()
        pkg.engine.set_tracecheck(None)
    yield
    for pkg, t in ((mx, jtc), (mt, tc)):
        t.clear_suppressions()
        t.RETRACE_EVENTS.clear()
        pkg.guard.TRAINING_HEALTH.reset()
        pkg.engine.set_tracecheck(None)


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data=data, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(data=net, act_type="tanh")
    net = pkg.sym.FullyConnected(data=net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(data=net, name="softmax")


def _step(pkg):
    if pkg is mx:
        from mxnet_tpu.train_step import TrainStep as JTrainStep
        return JTrainStep(_mlp(mx), optimizer="sgd", learning_rate=0.05)
    return TrainStep(_mlp(mt), optimizer="sgd", learning_rate=0.05,
                     device="cpu")


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    return {"data": rng.normal(size=(B, 10)).astype(np.float32),
            "softmax_label": rng.integers(0, 4, (B,)).astype(np.float32)}


def _line(fn, marker):
    """``file:line`` of the line of ``fn``'s source holding ``marker``."""
    lines, start = inspect.getsourcelines(fn)
    (i,) = [i for i, ln in enumerate(lines) if marker in ln]
    return "%s:%d" % (HERE, start + i)


# ---------------------------------------------------------------------------
# the signature differ
# ---------------------------------------------------------------------------

def test_explain_and_benign_diff_lines_match_jax():
    import jax.numpy as jnp
    x = np.ones((4, 3), np.float32)
    cases = [
        ((x, 5), {"mode": "fast"}),
        ((np.ones((5, 3), np.float32), 5), {"mode": "fast"}),
        ((x.astype(np.float16), 5), {"mode": "fast"}),
        ((x, 5), {"mode": "slow"}),
        ((x, 5.0), {"mode": "fast"}),
        ((x, 7), {"mode": "fast"}),
        ((x, 5), {"mode": "fast", "extra": 1}),
    ]
    for t, conv in ((tc, torch.from_numpy), (jtc, jnp.asarray)):
        sigs = [t.signature((conv(a[0]),) + a[1:], k) for a, k in cases]
        got = [(t.explain_diff(sigs[0], s), t.benign_diff(sigs[0], s))
               for s in sigs]
        if t is tc:
            port = got
        else:
            want = got
    assert port == want
    assert port[1][0] == ["argument [0][0]: shape (4, 3) -> (5, 3)"]
    assert port[2][0] == ["argument [0][0]: dtype float32 -> float16"]
    assert port[3][0] == ["argument [1]['mode']: static value 'fast' -> "
                          "'slow'"]
    assert port[4][0] == ["argument [0][1]: Python scalar type int -> float"]
    assert port[5][0] == port[0][0] == []
    # two leaves at once, in a dict given out of key order: the lines come
    # in the JAX package's leaf order (sorted keys)
    two = {}
    for t, conv in ((tc, torch.from_numpy), (jtc, jnp.asarray)):
        a = t.signature(({"zeta": conv(x), "alpha": conv(x)},))
        b = t.signature(({"zeta": conv(x.astype(np.float16)),
                          "alpha": conv(x.astype(np.float16))},))
        two[t] = t.explain_diff(a, b)
    assert two[tc] == two[jtc] == [
        "argument [0][0]['alpha']: dtype float32 -> float16",
        "argument [0][0]['zeta']: dtype float32 -> float16"]


# ---------------------------------------------------------------------------
# the retrace watch on a TrainStep
# ---------------------------------------------------------------------------

def _events_after_sequence(pkg, t):
    """Run the same dispatches through ``pkg``'s mlp TrainStep; return its
    watcher's name and the events (site after the name, diff)."""
    ts = _step(pkg)
    state = ts.init({"data": (B, 10)}, {"softmax_label": (B,)}, seed=0)
    b = _batch()
    seq = [b, dict(b, data=b["data"].astype(np.float16)), b,
           dict(b, softmax_label=b["softmax_label"].reshape(B, 1)), b]
    for batch in seq:
        state, _ = ts.step(state, batch)
    name = ts._watcher.name
    return name, [(e.site[len(name):], e.diff) for e in t.RETRACE_EVENTS]


def test_mlp_dtype_flip_and_label_shape_change_record_the_jax_events():
    jname, jev = _events_after_sequence(mx, jtc)
    name, ev = _events_after_sequence(mt, tc)
    assert name.split("#")[0] == jname.split("#")[0] == "TrainStep(softmax)"
    assert ev == jev == [
        ("/step[bs=8]", ("argument [0][1]['data']: dtype float32 -> "
                         "float16",)),
        ("/step[bs=8]", ("argument [0][1]['softmax_label']: shape (8,) -> "
                         "(8, 1)",))]
    assert tc.retrace_count() == 2
    assert mt.guard.TRAINING_HEALTH.report()["retraces"] == 2


def test_scan_keys_and_the_spec_crc_match_jax():
    """``run_steps`` dispatches register under the JAX package's keys,
    a metric spec's crc32 included."""
    names = {}
    for pkg, t in ((mx, jtc), (mt, tc)):
        ts = _step(pkg)
        state = ts.init({"data": (B, 10)}, {"softmax_label": (B,)}, seed=0)
        b = _batch()
        sb = {k: np.stack([v, v]) for k, v in b.items()}
        spec = pkg.metric.device_sum_spec(pkg.metric.Accuracy(), [(B, 4)],
                                          [(B,)])
        state, _ = ts.run_steps(state, dict(sb))
        state, _ = ts.run_steps(state, dict(sb), guard=True)
        state, _ = ts.run_steps(state, dict(sb), metric_spec=spec)
        state, _ = ts.run_steps(state, dict(sb), guard=True,
                                metric_spec=spec)
        names[pkg] = sorted(r.name[len(ts._watcher.name):]
                            for r in t.registered_programs())
    assert names[mt] == names[mx]
    assert "/scan[bs=8,k=2]" in names[mt]
    assert any(n.startswith("/guard-scan[bs=8,k=2,m=") for n in names[mt])


def test_error_mode_carries_the_dispatch_result():
    steps = {}
    for pkg, t in ((mx, jtc), (mt, tc)):
        pkg.engine.set_tracecheck("error")
        ts = _step(pkg)
        state = ts.init({"data": (B, 10)}, {"softmax_label": (B,)}, seed=0)
        b = _batch()
        state, _ = ts.step(state, b)
        with pytest.raises(t.RetraceError, match="float32 -> float16") as ei:
            ts.step(state, dict(b, data=b["data"].astype(np.float16)))
        new_state, outs = ei.value.result
        steps[pkg] = int(np.asarray(new_state["step"]))
    assert steps[mt] == steps[mx] == 2


def test_two_same_named_train_steps_register_their_own_programs():
    steps = []
    for seed in (0, 1):
        ts = _step(mt)
        state = ts.init({"data": (B, 10)}, {"softmax_label": (B,)},
                        seed=seed)
        ts.step(state, _batch())
        steps.append(ts)
    assert steps[0]._watcher.name != steps[1]._watcher.name
    regs = [r for r in tc.registered_programs()
            if "step[bs=%d]" % B in r.name]
    assert len(regs) == 2
    assert {r.fn_ref() for r in regs} == {
        s._programs[("step", B)][2] for s in steps}
    # the registry keeps fake arguments, never the live state
    from torch._subclasses.fake_tensor import is_fake
    state_s, batch_s = regs[0].arg_structs
    assert all(is_fake(v) for v in state_s["params"].values())
    # and drops a program once its TrainStep is gone
    import gc
    del steps, ts
    gc.collect()
    assert not [r for r in tc.registered_programs()
                if "step[bs=%d]" % B in r.name]


def test_off_mode_skips_capture():
    for pkg, t in ((mx, jtc), (mt, tc)):
        pkg.engine.set_tracecheck("off")
        ts = _step(pkg)
        state = ts.init({"data": (B, 10)}, {"softmax_label": (B,)}, seed=0)
        ts.step(state, _batch())
        assert ts._watcher is None
        assert not any("TrainStep" in n for n in t.PROGRAMS)


def test_engine_mode_parsing_and_messages(monkeypatch):
    for raw, want in [("", "warn"), ("warn", "warn"), ("1", "warn"),
                      ("error", "error"), ("raise", "error"),
                      ("off", "off"), ("0", "off")]:
        monkeypatch.setenv("MXTPU_TRACECHECK", raw)
        assert engine.tracecheck_mode() == mx.engine.tracecheck_mode() \
            == want
    msgs = []
    for eng in (engine, mx.engine):
        monkeypatch.setenv("MXTPU_TRACECHECK", "bogus")
        with pytest.raises(Exception, match="MXTPU_TRACECHECK") as e1:
            eng.tracecheck_mode()
        monkeypatch.delenv("MXTPU_TRACECHECK")
        with pytest.raises(Exception, match="set_tracecheck") as e2:
            eng.set_tracecheck("loud")
        assert eng.set_tracecheck("error") == "warn"
        assert eng.set_tracecheck(None) == "error"
        msgs.append((str(e1.value), str(e2.value)))
    assert msgs[0] == msgs[1]


def test_assert_no_retrace_on_a_train_step():
    ts = _step(mt)
    state = ts.init({"data": (B, 10)}, {"softmax_label": (B,)}, seed=0)
    b = _batch()
    ts.step(state, b)
    engine.set_tracecheck("off")
    with assert_no_retrace(ts._watcher):
        for _ in range(3):
            ts.step(state, b)
    assert engine.tracecheck_mode() == "off"   # restored on exit
    with pytest.raises(AssertionError, match="float32 -> float16"):
        with assert_no_retrace():
            ts.step(state, dict(b, data=b["data"].astype(np.float16)))
    # a new key grows the watcher's signatures without a retrace
    with pytest.raises(AssertionError, match="re-traced"):
        with assert_no_retrace(ts._watcher):
            ts.step(state, {k: v[:4] for k, v in b.items()})


# ---------------------------------------------------------------------------
# Speedometer, TrainingHealth, the registry view
# ---------------------------------------------------------------------------

def _speedometer_lines(pkg, t, monkeypatch):
    from importlib import import_module
    param = import_module(pkg.__name__ + ".model").BatchEndParam
    sp = pkg.callback.Speedometer(batch_size=16, frequent=10)
    out = []
    t.RETRACE_EVENTS.append(t.RetraceEvent("stale/run", ("old",)))
    monkeypatch.setattr(logging, "info", lambda *a: out.append(
        " ".join(str(x) for x in a)))
    sp(param(epoch=0, nbatch=5, eval_metric=None, locals=None))
    t.RETRACE_EVENTS.append(t.RetraceEvent(
        "TrainStep(softmax)/scan[bs=8,k=2]",
        ("argument data: dtype float32 -> float16",)))
    sp(param(epoch=0, nbatch=15, eval_metric=None, locals=None))
    first = list(out)
    # a reused Speedometer re-baselines at its re-init, and a clean window
    # stays quiet
    t.RETRACE_EVENTS.append(t.RetraceEvent("between/runs", ("x",)))
    del out[:]
    sp(param(epoch=0, nbatch=5, eval_metric=None, locals=None))
    sp(param(epoch=0, nbatch=15, eval_metric=None, locals=None))
    return first, list(out)


def test_speedometer_surfaces_the_retrace_count(monkeypatch):
    got = {}
    for pkg, t in ((mx, jtc), (mt, tc)):
        first, second = _speedometer_lines(pkg, t, monkeypatch)
        got[pkg] = ("Retraces: 1" in " ".join(first),
                    "Retraces" in " ".join(second))
    assert got[mt] == got[mx] == (True, False)


def test_training_health_retraces_and_the_registry_view():
    from mxnet_tpu.obs.registry import REGISTRY as JREGISTRY
    from mxnet_tpu_torch.obs.registry import REGISTRY
    reports = {}
    for pkg, t, reg in ((mx, jtc, JREGISTRY), (mt, tc, REGISTRY)):
        run = pkg.guard.TrainingHealth(parent=pkg.guard.TRAINING_HEALTH)
        w = t.TraceWatcher("toy")
        if pkg is mx:
            import jax
            import jax.numpy as jnp
            f = jax.jit(lambda x: x + 1.0)
            for n in (4, 5):
                x = jnp.ones((n,))
                f(x)
                w.after_call("k", f, t.signature((x,)), health=run)
        else:
            for n in (4, 5):
                w.after_call("k", None, t.signature((torch.ones(n),)),
                             health=run)
        reports[pkg] = (run.report(), pkg.guard.TRAINING_HEALTH.report(),
                        reg.snapshot()["retrace_events.count"])
    assert reports[mt] == reports[mx]
    assert reports[mt][0]["retraces"] == reports[mt][1]["retraces"] == 1
    assert reports[mt][0]["last_event"] == "unexpected retrace at toy/k"
    assert reports[mt][2] == 1


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_list_and_unknown_model(capsys):
    outs = []
    for t in (tc, jtc):
        assert t.main(["--list"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[0].split() == sorted(tc.ZOO)
    msgs = []
    for t in (tc, jtc):
        with pytest.raises(Exception, match="unknown zoo model") as ei:
            t.main(["--models", "nope", "--device", "cpu"]
                   if t is tc else ["--models", "nope"])
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_cli_json_counts_suppressed_findings(capsys, monkeypatch):
    outs = []
    for t in (tc, jtc):
        seeded = [t.Finding("host-sync", "fake/step", "seeded-suppressed",
                            suppressed=True),
                  t.Finding("dtype-f64", "fake/step", "seeded-live")]
        monkeypatch.setattr(t, "check_zoo",
                            lambda seeded=seeded, **kw: (list(seeded), 4))
        rc = t.main(["--models", "mlp", "--json"])
        outs.append((rc, json.loads(capsys.readouterr().out)))
    assert outs[0] == outs[1]
    rc, data = outs[0]
    assert rc == 1 and data["total"] == 2 and data["suppressed"] == 1


def test_cli_audits_a_zoo_subset_on_the_cpu(capsys):
    rc = tc.main(["--models", "mlp,lenet", "--json", "--device", "cpu"])
    data = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert data["programs"] == 8 and data["findings"] == []


# ---------------------------------------------------------------------------
# the lints: seeded CPU programs and their clean twins
# ---------------------------------------------------------------------------

def _hits(findings, lint):
    return [f for f in findings if f.lint == lint]


def _host_read(x):
    y = x * 2.0
    s = y.sum().item()   # seeded: host-sync
    return y + s


def _host_read_clean(x):
    y = x * 2.0
    return y + y.sum()


def _tolist(x):
    return x * float(len(x.tolist()))   # seeded: tolist


def _mask(x):
    return x[x > 0]   # seeded: nonzero


def test_host_sync_fires_at_the_reading_line():
    (f,) = _hits(tc.check_program(_host_read, (torch.ones(4),),
                                  name="seeded-sync"), "host-sync")
    assert f.provenance == _line(_host_read, "seeded: host-sync")
    assert ".item()" in f.message and not f.suppressed
    assert tc.check_program(_host_read_clean, (torch.ones(4),)) == []
    # .tolist() reads once per element: one finding at its line
    (f,) = _hits(tc.check_program(_tolist, (torch.ones(4),)), "host-sync")
    assert f.provenance == _line(_tolist, "seeded: tolist")
    # a data-dependent output shape syncs too, and ends the dry run there
    (f,) = _hits(tc.check_program(_mask, (torch.ones(4),)), "host-sync")
    assert "nonzero" in f.message or "output shape" in f.message
    assert f.provenance == _line(_mask, "seeded: nonzero")


def _f64(x):
    y = x.double()   # seeded: dtype-f64
    return y.float() * 2.0


def _f64_clean(x):
    return x.sum()


def test_dtype_f64_fires_at_the_producing_line():
    (f,) = _hits(tc.check_program(_f64, (torch.ones(4),), name="f64"),
                 "dtype-f64")
    assert f.provenance == _line(_f64, "seeded: dtype-f64")
    assert "float64[4]" in f.message
    assert tc.check_program(_f64_clean, (torch.ones(4),)) == []
    # a float64 argument is named by its label (and its sum is float64)
    fs = _hits(tc.check_program(_f64_clean, (torch.ones(4).double(),)),
               "dtype-f64")
    assert [(f.op_path, f.provenance) for f in fs] == [
        ("args[0]", None), (None, _line(_f64_clean, "x.sum()"))]


def _rebind(state, x):
    state["w"] = state["w"] * 0.5   # seeded: donation
    return state, x + 1.0


def _in_place(state, x):
    state["w"].mul_(0.5)
    return state, x + 1.0


def test_donation_fires_at_the_rebinding_line():
    args = ({"w": torch.ones(64, 64), "b": torch.ones(64)}, torch.ones(4))
    (f,) = _hits(tc.check_program(_rebind, args, donate_argnums=(0,),
                                  name="don"), "donation")
    assert f.provenance == _line(_rebind, "seeded: donation")
    assert "args[0]['w']" in f.message
    assert tc.check_program(_in_place, args, donate_argnums=(0,)) == []
    # without donation there is nothing to waste
    assert tc.check_program(_rebind, args) == []


BIG = torch.ones(1024, 300)   # 1.2 MB, read by _with_const


def _with_const(x):
    return x + BIG.sum(dim=1)[:4]   # seeded: const-capture


def _const_as_arg(x, big):
    return x + big.sum(dim=1)[:4]


def test_const_capture_fires_at_the_reading_line():
    (f,) = _hits(tc.check_program(_with_const, (torch.ones(4),),
                                  name="const"), "const-capture")
    assert f.provenance == _line(_with_const, "seeded: const-capture")
    assert "variable 'BIG'" in f.message and "float32[1024, 300]" in \
        f.message
    assert tc.check_program(_const_as_arg, (torch.ones(4), BIG)) == []
    # below the threshold (MXTPU_TRACECHECK_CONST_BYTES or const_bytes=)
    assert tc.check_program(_with_const, (torch.ones(4),),
                            const_bytes=2 << 20) == []


def _quiet(x):
    y = x * 2.0
    s = y.sum().item()   # tracecheck: ignore[host-sync]
    return y + s


def _noisy(x):
    y = x * 2.0
    s = y.sum().item()   # tracecheck: ignore[dtype-f64]
    return y + s


def test_programmatic_and_inline_suppression():
    tok = tc.add_suppression("host-sync", program="seeded")
    try:
        (f,) = tc.check_program(_host_read, (torch.ones(4),),
                                name="seeded-sync")
        assert f.suppressed and tc.unsuppressed([f]) == []
        (f,) = tc.check_program(_host_read, (torch.ones(4),), name="other")
        assert not f.suppressed
    finally:
        tc.remove_suppression(tok)
    (f,) = tc.check_program(_quiet, (torch.ones(4),), name="inline")
    assert f.lint == "host-sync" and f.suppressed
    (f,) = tc.check_program(_noisy, (torch.ones(4),), name="inline")
    assert not f.suppressed
    with pytest.raises(MXNetError, match="unknown lint"):
        tc.add_suppression("not-a-lint")


def test_check_zoo_on_the_cpu():
    """The whole zoo on the CPU: four programs a model, and no unsuppressed
    finding (each one the port had is repaired or suppressed inline)."""
    findings, nprog = tc.check_zoo(device="cpu", k=2)
    assert nprog == 4 * len(tc.ZOO)
    assert tc.unsuppressed(findings) == [], [f.format() for f in findings]


def test_registered_train_step_programs_audit_clean():
    ts = _step(mt)
    state = ts.init({"data": (B, 10)}, {"softmax_label": (B,)}, seed=0)
    b = _batch()
    sb = {k: np.stack([v, v]) for k, v in b.items()}
    ts.run_steps(state, dict(sb))
    ts.run_steps(state, dict(sb), guard=True)
    ts.step(state, b)
    n0 = ts._opt.num_update
    names = sorted(r.name for r in tc.registered_programs())
    assert names == sorted("%s/%s" % (ts._watcher.name, k) for k in (
        "scan[bs=8,k=2]", "guard-scan[bs=8,k=2]", "step[bs=8]"))
    assert tc.check_registered(match=ts._watcher.name + "/") == []
    # an audit advances nothing, and watches nothing
    assert ts._opt.num_update == n0 and tc.retrace_count() == 0
    fs, reps = mc.check_registered(match=ts._watcher.name + "/")
    assert sorted(reps) == names and fs == []


# ---------------------------------------------------------------------------
# the check methods
# ---------------------------------------------------------------------------

def _tiny_engine(buckets=(1, 4)):
    from mxnet_tpu_torch import serving
    net = _mlp(mt)
    rng = np.random.default_rng(0)
    params = {"fc1_weight": rng.normal(size=(16, 10)),
              "fc1_bias": np.zeros(16), "fc2_weight": rng.normal(size=(4, 16)),
              "fc2_bias": np.zeros(4)}
    params = {"arg:" + k: mt.nd.array(v.astype(np.float32), ctx=mt.cpu())
              for k, v in params.items()}
    return serving.ServingEngine(net.tojson(), params, {"data": (10,)},
                                 buckets=buckets, device="cpu")


def test_serving_engine_check_registers_and_audits_its_buckets():
    eng = _tiny_engine()
    names = sorted(r.name for r in tc.registered_programs()
                   if r.name.startswith(eng.name + "/"))
    assert names == ["%s/bucket[b=1]" % eng.name,
                     "%s/bucket[b=4]" % eng.name]
    assert eng.check() == []
    reps = eng.memory_report()
    budget = min(r.peak_bytes for r in reps.values()) - 1
    want = []
    for rep in reps.values():
        want += mc.lint_report(rep, budget=budget)
    want += mc.lint_resident_set(reps.values(), "%s/resident-set"
                                 % eng.name, budget=budget)
    got = eng.check(memory=True, budget=budget)
    assert [f.format() for f in got] == [f.format() for f in want]
    assert {f.lint for f in got} == {"hbm-budget", "resident-set"}
    assert eng.check(memory=True) == []
    # one device: no collective to lint
    assert eng.check(comms=True) == []
    assert all(r.collective_count == 0 for r in eng.comms_report().values())


def test_decode_loop_check_audits_its_programs():
    from test_torch_decode import _loop
    from mxnet_tpu_torch import serving
    loop = _loop(serving)
    try:
        names = sorted(r.name for r in tc.registered_programs()
                       if r.name.startswith(loop.name + "/"))
        assert names == sorted(loop.memory_report())
        assert loop.check() == []
        reps = loop.memory_report()
        budget = min(r.peak_bytes for r in reps.values()) - 1
        want = []
        for rep in reps.values():
            want += mc.lint_report(rep, budget=budget)
        want += mc.lint_resident_set(reps.values(), "%s/resident-set"
                                     % loop.name, budget=budget)
        got = loop.check(memory=True, budget=budget)
        assert [f.format() for f in got] == [f.format() for f in want]
        assert "resident-set" in {f.lint for f in got}
    finally:
        loop.close()


def test_bucketing_module_check_audits_every_bucket_step():
    from test_torch_bucketing import KEYS, _batches, _fit, _weights
    mod, _ = _fit(mt, _batches("check", KEYS), _weights("check"), 1,
                  epochs=1)
    prefixes = [ts._watcher.name + "/" for ts in mod._bucket_fused.values()]
    assert len(prefixes) >= 2
    assert mod.check() == []
    fs, reps = mc.check_registered(
        match=tuple(prefixes), budget=1024,
        resident_name="BucketingModule(%s)" % mod._default_bucket_key)
    got = mod.check(memory=True, budget=1024)
    assert [f.format() for f in got] == [f.format() for f in fs]
    assert "resident-set" in {f.lint for f in got}
    assert len(reps) >= 2
