"""The port's roofline analyzer (``mxnet_tpu_torch.flopcheck``) against the
JAX package's, and its inventory on its own, on the CPU.

The JAX package walks XLA's scheduled HLO; the port records the aten ops
of memcheck's shape-only dry run (the module's note). So the two agree on
everything that does not read a program: a report's pricing built from
the same kernels, the lints on the same hand-built reports (compared by
lint, op path, provenance and the knob the message names), the shared
suppression registry, the knobs, ``flopcheck_mode``, the dispatch hook's
three modes, the baseline gate's verdicts and the CLI's ``--list`` and
bad model. These are the JAX tests of ``tests/test_flopcheck.py`` that
pass on this host; its HLO-parser tests have no counterpart (the port has
no HLO), and its ``memory-bound-hot`` test on a real program has no
passing JAX oracle here, so the port's is held to a seeded program of its
own.

The port's inventory is held to exact figures: ``mm``, ``addmm`` and a
convolution at ``flop_registry``'s FLOPs; ``conv2d`` and ``linear`` under
``inference_mode`` priced as outside it; views are not kernels; an
in-place add's written tensor counted once; a clone is layout; a K=2 scan
doubles the step's multipliers; on a ``device="meta"`` ResNet-50 step
B1 is one entry a launch priced by ``ops/matmul_stats.launch_cost``; a
seeded 16 MiB add fires ``memory-bound-hot`` at its own line and its
64 KiB twin does not; the zoo on the CPU has no unsuppressed finding.

Tolerances: the JAX tests' own (floats exact where they use ``==``,
``1e-12`` absolute and ``1e-9`` relative where they do); the inventory's
figures exact.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

import jax
from mxnet_tpu import engine as jengine, flopcheck as jfc
from mxnet_tpu import tracecheck as jtc
from mxnet_tpu.base import MXNetError as JMXNetError
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import engine, flopcheck as fc, models
from mxnet_tpu_torch import tracecheck as tc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import matmul_stats as ms

# a hand-picked spec for deterministic pricing: ridge = 100 FLOP/B
_PEAK, _BW = 1e12, 1e10
HERE = os.path.realpath(__file__)


def _kernel(pkg, name, flops=0.0, nbytes=0, mult=1, opcode="fusion",
            layout=False, op_path=None, prov=None, norm_flops=None):
    return pkg.KernelEntry(name, opcode, flops, nbytes, multiplier=mult,
                           is_layout=layout, op_path=op_path,
                           provenance=prov, norm_flops=norm_flops)


def _report(pkg, name, kernels, hlo_unavailable=False, loop_trips=1,
            flops=None):
    return pkg.RooflineReport(
        name, "cpu", kernels, loop_trips=loop_trips, flops=flops,
        peak_flops_per_s=_PEAK, hbm_bytes_per_s=_BW,
        peak_source="test-spec", hlo_unavailable=hlo_unavailable)


def _both(build):
    """``build(pkg)`` for the JAX package and the port."""
    return build(jfc), build(fc)


def _same_findings(jf, tf):
    assert [(f.lint, f.op_path, f.provenance, f.suppressed) for f in tf] \
        == [(f.lint, f.op_path, f.provenance, f.suppressed) for f in jf]
    for a, b in zip(jf, tf):
        knobs = {w for w in a.message.split() if "MXTPU_" in w}
        assert knobs and all(k in b.message for k in knobs), b.message


# ---------------------------------------------------------------------------
# the report and its pricing (the JAX tests, on both packages)
# ---------------------------------------------------------------------------

def test_report_pricing_and_roofline():
    def build(pkg):
        k1 = _kernel(pkg, "k.dot", flops=1e6, nbytes=1000,
                     op_path="path/dot")
        k2 = _kernel(pkg, "k.copy", nbytes=2000, mult=2, opcode="copy",
                     layout=True)
        return _report(pkg, "p/step", [k1, k2]), k1, k2
    for rep, k1, k2 in _both(build):
        assert rep.ridge_intensity == 100.0
        assert k1.bound == "compute" and k1.seconds == 1e6 / _PEAK
        assert k2.bound == "memory" and k2.seconds == 2000 / _BW
        assert rep.kernel_count == 3
        assert rep.bytes_per_dispatch == 1000 + 2 * 2000
        t = 1e6 / _PEAK + 2 * (2000 / _BW)
        assert abs(rep.predicted_step_seconds - t) < 1e-12
        assert abs(rep.predicted_mfu - 1e6 / (t * _PEAK)) < 1e-9
        assert rep.top_hotspot == "path/dot"
        assert rep.hotspots(5, memory_only=True) == [k2]
        assert "p/step" in rep.format()
    (j, _, _), (t, _, _) = _both(build)
    assert t.predicted_step_seconds == j.predicted_step_seconds
    assert t.predicted_mfu == j.predicted_mfu


def test_report_cost_analysis_apportioning_respects_norm_basis():
    for pkg in (jfc, fc):
        merged = _kernel(pkg, "w", flops=100.0 * 50, nbytes=8,
                         norm_flops=100.0)
        plain = _kernel(pkg, "k", flops=100.0, nbytes=8)
        rep = _report(pkg, "p/step", [merged, plain], flops=400.0)
        by_name = {k.instruction: k for k in rep.kernels}
        assert by_name["w"].flops == 10000.0
        assert by_name["k"].flops == 200.0


def test_report_blind_program_claims_nothing():
    for pkg in (jfc, fc):
        rep = _report(pkg, "p/step", [], hlo_unavailable=True)
        assert rep.predicted_mfu is None
        assert rep.top_hotspot is None
        assert rep.as_dict()["hlo_unavailable"] is True


# ---------------------------------------------------------------------------
# the lints on hand-built reports, and the shared suppressions
# ---------------------------------------------------------------------------

def test_lint_layout_copy_seeded_and_share_gated():
    def lint(pkg, big):
        copy = _kernel(pkg, "relayout", nbytes=10 << 20, opcode="copy",
                       layout=True, op_path="jit(f)/transpose",
                       prov="m.py:7")
        other = (_kernel(pkg, "conv", flops=1e12, nbytes=1 << 30) if big
                 else _kernel(pkg, "k", flops=100.0, nbytes=1 << 20))
        return [f for f in pkg.lint_report(
            _report(pkg, "seed/layout", [copy, other]), mfu_floor=0.0)
            if f.lint == "layout-copy"]
    jf, tf = lint(jfc, False), lint(fc, False)
    assert len(tf) == 1 and tf[0].provenance == "m.py:7"
    assert "MXTPU_FLOPCHECK_LAYOUT_FRAC" in tf[0].message
    _same_findings(jf, tf)
    assert lint(fc, True) == [] == lint(jfc, True)


def test_lint_tiny_dispatch_seeded():
    def lint(pkg, mult, path=None, prov=None):
        shard = _kernel(pkg, "tiny", flops=10.0, nbytes=40, mult=mult,
                        op_path=path, prov=prov)
        return pkg.lint_report(_report(pkg, "seed/tiny", [shard]),
                               tiny_floor_us=1.0, tiny_threshold=4096,
                               mfu_floor=0.0)
    args = (5000, "jit(f)/while/body/slice", "m.py:3")
    jf, tf = lint(jfc, *args), lint(fc, *args)
    assert [f.lint for f in tf] == ["tiny-dispatch"]
    assert "5000" in tf[0].message
    _same_findings(jf, tf)
    assert lint(fc, 100) == [] == lint(jfc, 100)


def test_lint_predicted_mfu_seeded_and_disabled_by_default():
    def lint(pkg, floor):
        k = _kernel(pkg, "hbm", flops=1e4, nbytes=int(1e6),
                    op_path="jit(f)/add")
        return [f for f in pkg.lint_report(
            _report(pkg, "seed/mfu", [k]), hot_threshold=2.0,
            **({} if floor is None else {"mfu_floor": floor}))
            if f.lint == "predicted-mfu"]
    jf, tf = lint(jfc, 0.9), lint(fc, 0.9)
    assert len(tf) == 1 and "Inventory:" in tf[0].message
    _same_findings(jf, tf)
    assert lint(fc, None) == [] == lint(jfc, None)


def test_suppression_registry_shared_with_tracecheck():
    for pkg, reg in ((jfc, jtc), (fc, tc)):
        rep = _report(pkg, "supp/step", [_kernel(pkg, "hbm", flops=1e4,
                                                 nbytes=int(1e6))])
        token = reg.add_suppression("predicted-mfu", program="supp/")
        try:
            findings = pkg.lint_report(rep, hot_threshold=2.0,
                                       mfu_floor=0.9)
            assert findings and all(f.suppressed for f in findings)
            assert reg.unsuppressed(findings) == []
        finally:
            reg.remove_suppression(token)
        assert reg.unsuppressed(pkg.lint_report(rep, hot_threshold=2.0,
                                                mfu_floor=0.9))


# ---------------------------------------------------------------------------
# knobs and the mode
# ---------------------------------------------------------------------------

def test_knob_defaults_and_env(monkeypatch):
    for var in ("HOT_FRAC", "HOT_BYTES", "LAYOUT_BYTES", "LAYOUT_FRAC",
                "TINY_US", "TINY_COUNT", "MIN_MFU", "TOL"):
        monkeypatch.delenv("MXTPU_FLOPCHECK_" + var, raising=False)
    names = ("hot_frac", "hot_bytes", "layout_bytes", "layout_frac",
             "tiny_us", "tiny_count", "min_mfu", "tolerance")
    want = (0.6, 4 << 20, 4 << 20, 0.25, 1.0, 4096, 0.0, 0.1)
    for pkg in (jfc, fc):
        assert tuple(getattr(pkg, n)() for n in names) == want
    monkeypatch.setenv("MXTPU_FLOPCHECK_HOT_FRAC", "0.8")
    monkeypatch.setenv("MXTPU_FLOPCHECK_HOT_BYTES", "8M")
    monkeypatch.setenv("MXTPU_FLOPCHECK_LAYOUT_FRAC", "0.5")
    monkeypatch.setenv("MXTPU_FLOPCHECK_TINY_COUNT", "128")
    monkeypatch.setenv("MXTPU_FLOPCHECK_MIN_MFU", "0.4")
    for pkg in (jfc, fc):
        assert (pkg.hot_frac(), pkg.hot_bytes(), pkg.layout_frac(),
                pkg.tiny_count(), pkg.min_mfu()) == (0.8, 8 << 20, 0.5, 128,
                                                     0.4)
    for var in ("HOT_BYTES", "HOT_FRAC"):
        monkeypatch.setenv("MXTPU_FLOPCHECK_" + var, "banana")
        for pkg, err in ((jfc, JMXNetError), (fc, MXNetError)):
            with pytest.raises(err, match="MXTPU_FLOPCHECK_" + var):
                getattr(pkg, var.lower())()


def test_flopcheck_mode_knob(monkeypatch):
    for eng, err in ((jengine, JMXNetError), (engine, MXNetError)):
        eng.set_flopcheck(None)
        monkeypatch.delenv("MXTPU_FLOPCHECK", raising=False)
        assert eng.flopcheck_mode() == "off"
        for v in ("warn", "error"):
            monkeypatch.setenv("MXTPU_FLOPCHECK", v)
            assert eng.flopcheck_mode() == v
        monkeypatch.setenv("MXTPU_FLOPCHECK", "banana")
        with pytest.raises(err, match="MXTPU_FLOPCHECK"):
            eng.flopcheck_mode()
        monkeypatch.delenv("MXTPU_FLOPCHECK", raising=False)
        prev = eng.set_flopcheck("error")
        try:
            assert eng.flopcheck_mode() == "error"
        finally:
            eng.set_flopcheck(prev if prev != "off" else None)
        with pytest.raises(err, match="set_flopcheck"):
            eng.set_flopcheck("loud")


# ---------------------------------------------------------------------------
# the dispatch hook's three modes
# ---------------------------------------------------------------------------

def _train_step(pkg):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(2, 8, 16)).astype(np.float32)
    label = rng.integers(0, 4, (2, 8)).astype(np.float32)
    if pkg is fc:
        ts = mt.TrainStep(models.mlp(num_classes=4, hidden=(16,)),
                          optimizer="sgd", learning_rate=0.1, device="cpu")
        sb = {"data": torch.from_numpy(data),
              "softmax_label": torch.from_numpy(label)}
    else:
        import jax.numpy as jnp
        from mxnet_tpu import models as jmodels
        from mxnet_tpu.train_step import TrainStep
        ts = TrainStep(jmodels.mlp(num_classes=4, hidden=(16,)),
                       optimizer="sgd", learning_rate=0.1)
        sb = {k: jnp.asarray(v) for k, v in (("data", data),
                                              ("softmax_label", label))}
    state = ts.init({"data": (8, 16)}, {"softmax_label": (8,)})
    return ts, state, sb


@pytest.mark.parametrize("pkg", [jfc, fc], ids=["jax", "port"])
def test_dispatch_hook_audits_single_device_program_once(pkg):
    eng = jengine if pkg is jfc else engine
    prev = eng.set_flopcheck("warn")
    try:
        before = set(pkg._AUDITED)
        ts, state, sb = _train_step(pkg)
        state, m = ts.run_steps(state, sb)
        new = set(pkg._AUDITED) - before
        assert len(new) == 1 and "scan" in next(iter(new))
        state, m = ts.run_steps(state, sb)
        assert set(pkg._AUDITED) - before == new
        assert m.num_samples > 0
    finally:
        eng.set_flopcheck(prev if prev != "off" else None)


@pytest.mark.parametrize("pkg", [jfc, fc], ids=["jax", "port"])
def test_dispatch_hook_error_mode_raises_on_finding(pkg, monkeypatch):
    """An impossible MFU floor under ``error``: the first dispatch raises
    the roofline findings; the audit ran on fakes, so the state the
    dispatch updated stays real."""
    eng, err = (jengine, JMXNetError) if pkg is jfc else (engine,
                                                         MXNetError)
    monkeypatch.setenv("MXTPU_FLOPCHECK_MIN_MFU", "0.999")
    prev = eng.set_flopcheck("error")
    try:
        ts, state, sb = _train_step(pkg)
        with pytest.raises(err, match="predicted-mfu"):
            ts.run_steps(state, sb)
        if pkg is fc:
            assert int(state["step"]) == 2
            assert all(np.isfinite(v.numpy()).all()
                       for v in state["params"].values())
    finally:
        eng.set_flopcheck(prev if prev != "off" else None)


@pytest.mark.parametrize("pkg", [jfc, fc], ids=["jax", "port"])
def test_dispatch_hook_off_by_default(pkg, monkeypatch):
    eng = jengine if pkg is jfc else engine
    eng.set_flopcheck(None)
    monkeypatch.delenv("MXTPU_FLOPCHECK", raising=False)
    before = set(pkg._AUDITED)
    ts, state, sb = _train_step(pkg)
    ts.run_steps(state, sb)
    assert set(pkg._AUDITED) == before


# ---------------------------------------------------------------------------
# the baseline gate (the JAX tests' logic, on both packages)
# ---------------------------------------------------------------------------

def _uniform(pkg, name, count=4, ms_total=1.0):
    per = int(ms_total * 1e-3 / count * _BW)
    return _report(pkg, name, [_kernel(pkg, "k.%d" % i, nbytes=per,
                                       op_path="path/k.%d" % i)
                               for i in range(count)])


def test_baseline_roundtrip_passes(tmp_path):
    for pkg in (jfc, fc):
        reports = {"a/step": _uniform(pkg, "a/step", 4, 1.0),
                   "b/scan[k=2]": _uniform(pkg, "b/scan[k=2]", 7, 2.0)}
        path = str(tmp_path / ("%s.json" % pkg.__name__))
        pkg.write_baseline(reports, path)
        assert pkg.compare_baseline(reports, path) == ([], [])
    with open(tmp_path / "mxnet_tpu.flopcheck.json") as f:
        jdata = json.load(f)
    with open(tmp_path / "mxnet_tpu_torch.flopcheck.json") as f:
        assert json.load(f) == jdata


def test_baseline_mfu_drop_fails_rise_and_hotspot_move_note():
    def run(pkg):
        rep = _report(pkg, "a/step", [_kernel(pkg, "hbm", flops=1e4,
                                              nbytes=int(1e6),
                                              op_path="path/hbm")])
        base = {"platform": "cpu", "tolerance": 0.1,
                "programs": {"a/step": {
                    "kernel_count": 1,
                    "predicted_step_ms": rep.predicted_step_ms,
                    "predicted_mfu": 0.9, "top_hotspot": "path/other"}}}
        first = pkg.compare_baseline({"a/step": rep}, base)
        base["programs"]["a/step"]["predicted_mfu"] = rep.predicted_mfu / 2
        base["programs"]["a/step"]["top_hotspot"] = "path/hbm"
        return first, pkg.compare_baseline({"a/step": rep}, base)
    (j1, j2), (t1, t2) = _both(run)
    assert any("predicted_mfu dropped" in f for f in t1[0])
    assert any("top hotspot moved" in n for n in t1[1])
    assert t2[0] == [] and any("rose" in n for n in t2[1])
    for j, t in ((j1, t1), (j2, t2)):
        assert (len(t[0]), len(t[1])) == (len(j[0]), len(j[1]))


def test_baseline_missing_stale_platform_shrink_collapse(tmp_path):
    def run(pkg):
        reports = {"a/step": _uniform(pkg, "a/step", 8, 4.0)}
        path = str(tmp_path / ("%s.json" % pkg.__name__))
        pkg.write_baseline(reports, path)
        return [
            pkg.compare_baseline(
                {"a/step": reports["a/step"],
                 "new/step": _uniform(pkg, "new/step", 1, 0.1)}, path),
            pkg.compare_baseline({}, path),
            pkg.compare_baseline(reports, {
                "platform": "made-up-platform", "tolerance": 0.1,
                "programs": {"a/step": {"kernel_count": 1,
                                        "predicted_step_ms": 1.0}}}),
            pkg.compare_baseline(
                {"a/step": _uniform(pkg, "a/step", 4, 1.0)}, path),
            pkg.compare_baseline(
                {"a/step": _report(pkg, "a/step", [])}, path)]
    jr, tr = _both(run)
    (f1, _), (f2, n2), (f3, n3), (f4, n4), (f5, _) = tr
    assert len(f1) == 1 and "new/step" in f1[0] and "--write-baseline" \
        in f1[0]
    assert f2 == [] and any("stale" in n for n in n2)
    assert f3 == [] and len(n3) == 1 and "platform" in n3[0]
    assert f4 == [] and any("kernel_count shrank" in n for n in n4)
    assert any("predicted_step_ms shrank" in n for n in n4)
    assert any("collapsed" in f for f in f5)
    assert [(len(f), len(n)) for f, n in tr] == [(len(f), len(n))
                                                 for f, n in jr]


def test_baseline_tol_env_overrides_stored_band(tmp_path, monkeypatch):
    for pkg in (jfc, fc):
        path = str(tmp_path / ("%s.json" % pkg.__name__))
        pkg.write_baseline({"a/step": _uniform(pkg, "a/step", 10, 1.0)},
                           path, tol=0.1)
        grown = {"a/step": _uniform(pkg, "a/step", 13, 1.0)}
        monkeypatch.delenv("MXTPU_FLOPCHECK_TOL", raising=False)
        assert pkg.compare_baseline(grown, path)[0]
        monkeypatch.setenv("MXTPU_FLOPCHECK_TOL", "0.5")
        assert pkg.compare_baseline(grown, path)[0] == []
        monkeypatch.delenv("MXTPU_FLOPCHECK_TOL")


def test_baseline_refuses_absence_of_evidence(tmp_path):
    for pkg, err in ((jfc, JMXNetError), (fc, MXNetError)):
        blind = _report(pkg, "blind/step", [], hlo_unavailable=True)
        with pytest.raises(err, match="fabricated"):
            pkg.write_baseline({"blind/step": blind},
                               str(tmp_path / "b.json"))
        path = str(tmp_path / ("%s.json" % pkg.__name__))
        pkg.write_baseline({"blind/step": _uniform(pkg, "blind/step", 2,
                                                   1.0)}, path)
        failures, _ = pkg.compare_baseline({"blind/step": blind}, path)
        assert len(failures) == 1 and "absence of evidence" in failures[0]


def test_cli_write_and_gate_baseline_with_hotspots(tmp_path, capsys):
    path = str(tmp_path / "b.json")
    assert fc.main(["--models", "mlp", "--device", "cpu", "--quiet",
                    "--write-baseline", path]) == 0
    capsys.readouterr()
    with open(path) as f:
        base = json.load(f)
    assert len(base["programs"]) == 4 and base["platform"] == "cpu"
    assert fc.main(["--models", "mlp", "--device", "cpu", "--quiet",
                    "--baseline", path, "--hotspots", "3"]) == 0
    out = capsys.readouterr().out
    assert "0 baseline regression(s)" in out and "ridge" in out
    base["programs"]["ghost/step"] = {"kernel_count": 1,
                                      "predicted_step_ms": 1.0}
    with open(path, "w") as f:
        json.dump(base, f)
    assert fc.main(["--models", "mlp", "--device", "cpu", "--quiet",
                    "--baseline", path]) == 0
    assert "stale" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# hotspots, the CLI
# ---------------------------------------------------------------------------

def test_autotune_hotspot_report_accessor():
    from mxnet_tpu import autotune as jat
    from mxnet_tpu_torch import autotune as tat
    x = np.zeros((128, 128), np.float32)
    b = np.zeros((128,), np.float32)
    runs = ((jat, (jax.ShapeDtypeStruct(x.shape, x.dtype),
                   jax.ShapeDtypeStruct(b.shape, b.dtype))),
            (tat, (torch.from_numpy(x), torch.from_numpy(b))))
    for at, args in runs:
        entries = at.hotspot_report(lambda x, b: x @ x + b, args,
                                    name="tune/fn", top=5,
                                    memory_only=False)
        assert entries
        fracs = [e["step_time_frac"] for e in entries]
        assert all(0.0 <= f <= 1.0 for f in fracs)
        assert sum(fracs) <= 1.0 + 1e-6
        times = [e["predicted_us"] * e["multiplier"] for e in entries]
        assert times == sorted(times, reverse=True)
        assert all(e["bound"] in ("compute", "memory") for e in entries)
    # the port's: the mm (compute bound at the CPU's ridge of 10) and the
    # add, nothing else
    assert [(e["opcode"], e["bound"]) for e in entries] == [
        ("aten.mm", "compute"), ("aten.add", "memory")]


def test_cli_list_and_bad_model(capsys):
    for pkg, err in ((jfc, JMXNetError), (fc, MXNetError)):
        assert pkg.main(["--list"]) == 0
        assert "mlp" in capsys.readouterr().out
        with pytest.raises(err, match="unknown zoo model"):
            pkg.main(["--models", "nope"] + (["--device", "cpu"]
                                             if pkg is fc else []))


def test_cli_smoke_json_mlp(capsys):
    """mlp and lenet in json mode, both packages: exit 0, no finding, a
    priced inventory for each of the 8 programs, and the same program
    names."""
    names = {}
    for pkg, extra in ((jfc, []), (fc, ["--device", "cpu"])):
        rc = pkg.main(["--models", "mlp,lenet", "--json"] + extra)
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert data["findings"] == [] and data["suppressed"] == 0
        assert data["baseline_failures"] == []
        assert len(data["programs"]) == 8
        for rep in data["programs"].values():
            assert rep["kernel_count"] > 0
            assert rep["predicted_step_ms"] > 0
            assert rep["top_hotspot"]
            assert rep["hlo_unavailable"] is False
        assert data["platform"] == "cpu"
        names[pkg] = sorted(data["programs"])
    assert names[fc] == names[jfc]
    assert data["analyzers_sharing_dry_run"] == 1


def test_not_ported_and_sharded_entry_points_raise(tmp_path, monkeypatch,
                                                   capsys):
    """The HLO entry points raise: there is no HLO. The sharded half runs
    (the name predates it, when it raised): ``compiled_sharded_programs``
    dry-runs ``commscheck``'s sharded set once each (two CPU positions
    here), each report carrying the ``CommsReport`` of its own dry run, so
    ``comm_seconds`` is the collectives' wire time (non-zero) in the
    predicted step; ``check_sharded`` lints those reports, and the CLI's
    ``--sharded`` and ``--commscheck-baseline`` run commscheck's gate from
    the same dry runs. A report without collectives prices none."""
    from mxnet_tpu_torch import commscheck as cc
    for fn in (fc.analyze_compiled, fc.parse_kernels):
        with pytest.raises(MXNetError, match="HLO"):
            fn()
    progs = list(fc.compiled_sharded_programs(n_devices=2, device="cpu"))
    names = [n for n, _, _ in progs]
    assert names == ["dp2/lenet/scan[k=2]", "dp1xtp2/resnet18/step",
                     "dp1xsp2/transformer-ring/step",
                     "dp1xsp2/transformer-ring/scan[k=2]"]
    findings, reports = fc.check_sharded(programs=progs)
    for name, rep, mem in progs:
        assert reports[name] is rep and mem.program == name
        assert rep.comms.collective_count > 0 and rep.comm_seconds > 0
        assert rep.comm_seconds == rep.comms.comm_seconds * rep.loop_trips
        assert rep.predicted_step_seconds == (rep.kernel_seconds
                                              + rep.comm_seconds)
    path = str(tmp_path / "comms.json")
    cc.write_baseline({n: r.comms for n, r in reports.items()}, path)
    monkeypatch.setattr(fc, "compiled_sharded_programs",
                        lambda **kw: iter(progs))
    rc = fc.main(["--sharded", "--devices", "2", "--device", "cpu",
                  "--json", "--commscheck-baseline", path])
    data = json.loads(capsys.readouterr().out)
    assert sorted(data["programs"]) == sorted(names)
    assert data["analyzers_sharing_dry_run"] == 2
    assert data["baseline_failures"] == []
    for n in names:
        assert data["programs"][n]["comm_seconds"] > 0
    bad = [f for f in data["findings"] if not f["suppressed"]]
    assert rc == (1 if bad else 0)
    # the flat head's label: gathered along 'seq' before its Reshape (a
    # kept divergence: GSPMD gathers the Reshape's output)
    assert [(f["lint"], f["program"]) for f in bad] == [
        ("resharding-copy", "dp1xsp2/transformer-ring/step")]
    assert "['softmax_label']" in bad[0]["message"]
    assert bad[0]["op_path"].startswith("reshape")
    rep = _report(fc, "p/step", [])
    assert rep.comm_seconds == 0.0


# ---------------------------------------------------------------------------
# the port's inventory
# ---------------------------------------------------------------------------

def _entries(fn, *args, **kw):
    return fc.analyze(fn, args, name="inv", **kw).kernels


def test_registry_families_priced_exactly():
    from torch.utils.flop_counter import conv_flop_count
    a, b = torch.zeros(8, 16), torch.zeros(16, 4)
    x, w = torch.zeros(2, 3, 8, 8), torch.zeros(5, 3, 3, 3)
    (mm,) = _entries(lambda a, b: a @ b, a, b)
    assert (mm.opcode, mm.flops) == ("aten.mm", 2.0 * 8 * 16 * 4)
    assert mm.bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4
    (addmm,) = _entries(lambda c, a, b: torch.addmm(c, a, b),
                        torch.zeros(4), a, b)
    assert (addmm.opcode, addmm.flops) == ("aten.addmm", 2.0 * 8 * 16 * 4)
    (conv,) = _entries(lambda x, w: torch.nn.functional.conv2d(x, w), x, w)
    assert conv.opcode == "aten.convolution"
    assert conv.flops == conv_flop_count([2, 3, 8, 8], [5, 3, 3, 3],
                                         [2, 5, 6, 6]) == 2 * 2 * 5 * 36 * 27
    # float32 convolutions at TF32's rate while cuDNN's switch is on
    assert conv.compute == ("tf32" if torch.backends.cudnn.allow_tf32
                            else "float32")


def test_inference_mode_composites_priced_as_outside():
    x, w = torch.zeros(2, 3, 8, 8), torch.zeros(5, 3, 3, 3)
    a, lw = torch.zeros(6, 16), torch.zeros(4, 16)

    def fn(x, w, a, lw):
        return (torch.nn.functional.conv2d(x, w),
                torch.nn.functional.linear(a, lw), torch.matmul(a, lw.t()))
    out = {k.opcode: k.flops for k in _entries(fn, x, w, a, lw)}
    with torch.inference_mode():
        inf = {k.opcode: k.flops for k in _entries(fn, x, w, a, lw)}
    assert inf == {"aten.conv2d": out["aten.convolution"],
                   "aten.linear": 2.0 * 6 * 16 * 4,
                   "aten.matmul": 2.0 * 6 * 16 * 4}
    assert out["aten.mm"] == 2.0 * 6 * 16 * 4


def test_views_are_not_kernels_and_in_place_counts_once():
    def fn(a, b):
        v = a.t().t().reshape(-1).view(16, 8)[2:].expand(2, 14, 8)
        v = torch.as_strided(v.detach(), (4,), (1,))
        a.add_(b)
        return v
    a, b = torch.zeros(8, 16), torch.zeros(8, 16)
    (add,) = _entries(fn, a, b)
    assert add.opcode == "aten.add_" and add.flops == 128.0
    # a and b read, a written in place: the written tensor once
    assert add.bytes == 2 * 128 * 4 and not add.is_layout


def test_layout_kernels():
    def fn(a):
        return a.clone(), a.t().contiguous(), a.to(torch.bfloat16)
    by = {k.opcode: k for k in _entries(fn, torch.zeros(8, 16))}
    assert by["aten.clone"].is_layout and by["aten.clone"].bytes == 1024
    assert not by["aten._to_copy"].is_layout      # a cast computes
    assert by["aten._to_copy"].compute == "bfloat16"
    assert by["aten._to_copy"].bytes == 8 * 16 * (4 + 2)


def test_k2_scan_doubles_the_step_multipliers():
    ts = mt.TrainStep(models.mlp(num_classes=4, hidden=(16,)),
                      optimizer="sgd", learning_rate=0.1, device="cpu")
    progs = {n.split("/")[1]: (fn, a) for n, fn, a in
             tc.train_step_programs(ts, {"data": (8, 16)},
                                    {"softmax_label": (8,)}, k=2,
                                    guard=False, name="mlp")}
    step = fc.analyze(*progs["step"], name="mlp/step")
    scan = fc.analyze(*progs["scan[k=2]"], name="mlp/scan[k=2]",
                      loop_trips=2)

    def key(k):
        return (k.opcode, k.op_path, k.provenance, k.flops, k.bytes)
    sk = {key(k): k for k in scan.kernels}
    nodes = [k for k in step.kernels if k.op_path is not None]
    assert nodes
    for k in nodes:
        assert sk[key(k)].multiplier == 2 * k.multiplier, k
        assert sk[key(k)].in_loop and not k.in_loop
    assert scan.loop_trips == 2 and step.loop_trips == 1


def test_b1_on_meta_is_one_entry_a_launch_priced_by_its_formula(
        monkeypatch):
    """The ResNet-50 bf16 step on ``meta`` (``MXTPU_FUSE_CONV_BN=1``): the
    33 Conv1x1->BatchNorm pairs reach B1's shape-only route, each one
    ``matmul_stats`` entry priced by ``ops/matmul_stats.launch_cost`` at
    the report's rates; no launch."""
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    sym = models.resnet(num_classes=4, num_layers=50,
                        image_shape="3,32,32", layout="NHWC")
    ts = mt.TrainStep(sym, learning_rate=0.1, compute_dtype="bfloat16",
                      device="meta")
    (name, fn, args), = tc.train_step_programs(
        ts, {"data": (2, 32, 32, 3)}, {"softmax_label": (2,)}, k=1,
        guard=False, name="r50")[:1]
    ms.reset_launches()
    rep = fc.analyze(fn, args, name=name)
    assert ms.LAUNCHES == 0 and ms.SHAPE_ONLY_CALLS == 33
    b1 = [k for k in rep.kernels if k.opcode == "matmul_stats"]
    assert sum(k.multiplier for k in b1) == 33 and len(b1) == 33
    assert rep.device == "meta" and rep.peak_source == "nominal-fallback"
    bw, peak = rep.hbm_bytes_per_s, rep.peak_flops_per_s
    total = 0.0
    for k in b1:
        assert k.instruction.startswith("matmul_stats[wgmma]#")
        ((m, kk), xdt), ((n, _), wdt) = k.inputs
        assert xdt == wdt == "torch.bfloat16"
        flops, nbytes, compute, passes = ms.launch_cost(m, kk, n, "bf16")
        assert (k.flops, k.bytes, k.compute, k.passes) == (
            flops, nbytes, "bfloat16", 1)
        assert k.seconds == max(flops / peak, nbytes / bw)
        total += max(flops / peak, nbytes / bw)
    assert math.isclose(sum(k.total_seconds for k in b1), total,
                        rel_tol=1e-12)


def test_b2_and_b3_on_fake_card_tensors_priced_by_their_formulas():
    """B2 (``nms_alive``) and B3 (a ``TritonKernel``) on fake ``cuda:0``
    tensors take their shape-only routes: one entry a launch each, priced
    by ``ops/multibox_nms.launch_cost`` and ``rtc.launch_cost`` (here at
    the CPU's row: ``device="cpu"``); nothing launches."""
    from mxnet_tpu_torch import memcheck as mc, rtc
    from mxnet_tpu_torch.ops import multibox_nms as mnms
    with mc.fake_mode() as m:
        boxes = m.from_tensor(torch.zeros(2, 400, 4)).to("cuda:0")
        score = torch.empty((2, 400), device="cuda:0")
        cls = torch.empty((2, 400), device="cuda:0")
    tk = rtc.TritonKernel(None, out_like=0)
    mnms.reset_launches()
    launches = rtc.TRITON_LAUNCHES

    def prog(b, s, c):
        return tk(mnms.nms_alive(b, s, c, 0.5), s)
    rep = fc.analyze(prog, (boxes, score, cls), name="b2b3", device="cpu")
    assert mnms.LAUNCHES == 0 and rtc.TRITON_LAUNCHES == launches
    (b2,) = [k for k in rep.kernels if k.opcode == "multibox_nms"]
    assert b2.instruction.startswith("multibox_nms[smem]#")
    assert (b2.flops, b2.bytes) == mnms.launch_cost(2, 400)
    (b3,) = [k for k in rep.kernels if k.opcode == "rtc.TritonKernel"]
    mask = torch.zeros(2, 400)
    assert (b3.flops, b3.bytes) == rtc.launch_cost([mask, mask], [mask])
    assert (b3.flops, b3.bytes) == (800.0, 3 * 800 * 4)


def test_memory_bound_hot_fires_at_the_seeded_line():
    def seeded_add(x):
        return x + 1.0      # the seeded line
    line = seeded_add.__code__.co_firstlineno + 1
    findings, rep = fc.check_program(seeded_add,
                                     (torch.zeros(4 << 20),),
                                     name="seed/hot")
    hot = [f for f in findings if f.lint == "memory-bound-hot"]
    assert len(hot) == 1 and hot[0].program == "seed/hot"
    assert hot[0].provenance == "%s:%d" % (HERE, line)
    assert "MXTPU_FLOPCHECK_HOT_FRAC" in hot[0].message
    assert rep.kernels[0].bound == "memory"
    assert rep.kernels[0].bytes == 2 * (16 << 20)
    twin, _ = fc.check_program(seeded_add, (torch.zeros(16 << 10),),
                               name="seed/twin")
    assert not [f for f in twin if f.lint == "memory-bound-hot"]


def test_zoo_on_the_cpu_has_no_unsuppressed_finding():
    """Every zoo program on the CPU: the findings left are the eager
    port's ``tiny-dispatch`` on the models whose ``tracecheck.ZOO`` entry
    expects it with its reason (inception-bn's guarded programs, the SSD's
    guarded scan), suppressed; a model without that entry (the mlp) still
    fires it past the knob."""
    findings, reports = fc.check_zoo(device="cpu")
    assert len(reports) == 32
    assert tc.unsuppressed(findings) == []
    assert sorted(f.program for f in findings) == [
        "inception-bn/guarded-scan[k=2]", "inception-bn/guarded-step",
        "ssd/guarded-scan[k=2]"]
    assert {f.lint for f in findings} == {"tiny-dispatch"}
    assert all("ROADMAP.md B" in tc.ZOO[f.program.split("/")[0]][
        "suppress"]["tiny-dispatch"] for f in findings)
    assert all(r.kernel_count > 0 and r.predicted_step_ms > 0
               for r in reports.values())
    fs, _ = fc.check_zoo(names=["mlp"], device="cpu", tiny_threshold=1)
    assert fs and [f.lint for f in tc.unsuppressed(fs)] == [
        "tiny-dispatch"] * 4
