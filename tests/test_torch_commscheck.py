"""The port's ``commscheck`` against the JAX package's on the CPU: the
collective inventory of a shape-only dry run, its four lints, the roofline,
the dispatch hook, the baseline gate and the CLI.

- the comms signatures of the parallel stack, exact in kind and axis
  against the JAX package's compiled inventories: ring attention is
  permute-only along 'seq', Ulysses four all-to-alls, the pipeline its
  stage hops (in the schedule's loop) plus its final combine, and the
  data-parallel K=2 scan of the zoo's mlp syncs by in-loop all-reduces
  whose bytes a dispatch are the JAX report's within 1%;
- one seeded program over a data x model mesh of four CPU positions
  carries one violation of each lint (its first FC's weight split along
  its contraction, gathered before use; a sum over the batch, gathered
  in the loop): each finding is held to its op path (the executor node),
  not to its provenance (the JAX package's provenance is None on this
  jax, ROADMAP.md C); suppression through the shared registry;
- the three knobs and the mode switch; the dispatch hook's once, ``error``
  and ``off`` behaviour on a mesh ``TrainStep``, and a sharded serving
  engine's audit at load; a failed dry run is no evidence, never a clean
  audit;
- the baseline gate's round trip (the JAX package's file format), a
  zero-pinned program failing on its first collective, missing, stale,
  shrunk and other-platform programs, the tolerance's precedence;
- the CLI's ``--json``, ``--list`` and an unknown model; a one-device zoo
  program's empty inventory in both packages;
- recording a collective changes no bit of any value or gradient against
  the collectives' code without the recorder (the parent's).

Every dry run is a module-scoped fixture shared by the tests that read it.
"""
import functools
import json
import logging
import re
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from mxnet_tpu import commscheck as jcc
from mxnet_tpu import engine as jengine
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import commscheck as cc, engine, memcheck
from mxnet_tpu_torch import tracecheck as tc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import mesh as pm
from mxnet_tpu_torch.parallel import ring
from mxnet_tpu_torch.parallel.pipeline import pipeline_apply
from mxnet_tpu_torch.tracecheck import train_step_programs
from mxnet_tpu_torch.train_step import TrainStep

JP = jax.sharding.PartitionSpec
#: the dp scan's all-reduce bytes a dispatch against the JAX report's
BYTES_RTOL = 0.01


@pytest.fixture(autouse=True)
def _clean_slate():
    tc.clear_suppressions()
    engine.set_commscheck(None)
    engine.set_tracecheck(None)
    yield
    tc.clear_suppressions()
    engine.set_commscheck(None)
    engine.set_tracecheck(None)


def _cpu(n):
    return ["cpu"] * n


def _jmesh(n, name):
    return jax.sharding.Mesh(np.array(jax.devices()[:n]), (name,))


def _sds(shape, mesh=None, spec=None):
    if mesh is None:
        return jax.ShapeDtypeStruct(tuple(shape), np.float32)
    return jax.ShapeDtypeStruct(tuple(shape), np.float32,
                                sharding=jax.sharding.NamedSharding(mesh,
                                                                    spec))


def _shards(n, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g) for _ in range(n)]


# ---------------------------------------------------------------------------
# the comms signatures of the parallel stack, against the JAX package
# ---------------------------------------------------------------------------

def _jax_seq_program(fn, shape, n):
    from mxnet_tpu.parallel.mesh import shard_map_compat
    mesh = _jmesh(n, "seq")
    spec = JP(None, None, "seq", None)
    sm = shard_map_compat(fn, mesh=mesh, in_specs=(spec,) * 3,
                          out_specs=spec, check_vma=False)
    q = _sds(shape, mesh, spec)
    return jax.jit(sm), (q, q, q), mesh


def test_ring_attention_signature_matches_jax():
    """Permutes only, along 'seq', in both packages. The port rotates K
    and V n-1 times each (its Python loop; the last rotation of the JAX
    package's loop feeds nothing and is left out), 2(n-1) = 6 records at
    n = 4, where the JAX while body holds its two permutes once."""
    from mxnet_tpu.parallel import ring as jring
    n = 4
    fn, args, mesh = _jax_seq_program(
        functools.partial(jring.ring_attention, axis_name="seq",
                          causal=True), (2, 4, 8 * n, 8), n)
    jrep = jcc.analyze(fn, args, name="ring", mesh=mesh)
    q = _shards(n, (2, 4, 8, 8))
    rep = cc.analyze(lambda q, k, v: ring.ring_attention(q, k, v, "seq",
                                                         causal=True),
                     (q, q, q), name="ring")
    assert set(rep.counts_by_kind()) == set(jrep.counts_by_kind()) == {
        "collective-permute"}
    assert jrep.collective_count == 2
    assert rep.collective_count == 2 * (n - 1)
    assert {e.axes for e in rep.entries} == {e.axes for e in jrep.entries} \
        == {("seq",)}
    # one shard a permute: the JAX payload
    assert {e.bytes for e in rep.entries} == {e.bytes for e in jrep.entries}
    assert [f for f in cc.lint_report(rep, min_eff=0.0)] == []


def test_ulysses_signature_matches_jax():
    """Four all-to-alls along 'seq' (q, k, v in, the output back) and
    nothing else, exactly as the JAX package's."""
    from mxnet_tpu.parallel import ring as jring
    n = 4
    fn, args, mesh = _jax_seq_program(
        functools.partial(jring.ulysses_attention, axis_name="seq"),
        (2, n, 8 * n, 8), n)
    jrep = jcc.analyze(fn, args, name="ulysses", mesh=mesh)
    q = _shards(n, (2, n, 8, 8))
    rep = cc.analyze(lambda q, k, v: ring.ulysses_attention(q, k, v, "seq"),
                     (q, q, q), name="ulysses")
    assert rep.counts_by_kind() == jrep.counts_by_kind() == {"all-to-all": 4}
    assert {e.axes for e in rep.entries} == {e.axes for e in jrep.entries} \
        == {("seq",)}
    assert sorted(e.bytes for e in rep.entries) == sorted(
        e.bytes for e in jrep.entries)


def test_pipeline_signature_hops_in_the_loop_and_a_final_combine():
    """The GPipe schedule: the stage hops are permutes along 'pipe' in the
    tick loop in both packages (the port's schedule loops S + M - 2 hops,
    given as its trip count); the last stage's outputs then reach the
    caller. A kept divergence: the JAX package combines them by an
    all-reduce across 'pipe' (each stage adds its masked share), the
    port's single controller moves them once from the last stage, a
    permute out of the loop. gather-in-loop stays clean in both."""
    from mxnet_tpu.parallel.pipeline import pipeline_apply as jpipeline
    n = 4

    def stage(p, x):
        return jnp.tanh(x @ p["w"])

    jmesh = _jmesh(n, "pipe")
    jrep = jcc.analyze(
        jax.jit(lambda p, b: jpipeline(stage, p, b, jmesh,
                                       axis_name="pipe")),
        ({"w": _sds((n, 16, 16))}, _sds((8, 16))), name="pipeline",
        mesh=jmesh)
    assert jrep.counts_by_kind() == {"collective-permute": 1,
                                     "all-reduce": 1}
    mesh = pm.make_mesh({"pipe": n}, _cpu(n))
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(n, 16, 16, generator=g)}
    batch = torch.randn(8, 16, generator=g)
    hops = 2 * n - 2
    rep = cc.analyze(lambda p, b: pipeline_apply(
        lambda p_, x: torch.tanh(x @ p_["w"]), p, b, mesh,
        axis_name="pipe"), (params, batch), name="pipeline",
        loop_trips=hops)
    assert rep.counts_by_kind() == {"collective-permute": hops + 1}
    inloop = [e for e in rep.entries if e.in_loop]
    assert [(e.kind, e.axes, e.multiplier) for e in inloop] == [
        ("collective-permute", ("pipe",), hops)]
    jcp = [e for e in jrep.entries if e.kind == "collective-permute"][0]
    assert jcp.in_loop and jcp.axes == ("pipe",)
    # a hop moves one microbatch's activation, as the JAX permute does
    assert inloop[0].bytes == jcp.bytes
    (final,) = [e for e in rep.entries if not e.in_loop]
    assert final.axes == ("pipe",) and final.bytes == 8 * 16 * 4
    for r in (rep, jrep):
        assert [f for f in (cc if r is rep else jcc).lint_report(
            r, min_eff=0.0) if f.lint == "gather-in-loop"] == []


@pytest.fixture(scope="module")
def dp_scan():
    """The data-parallel K=2 scan of the zoo's mlp over four positions, in
    both packages (the JAX package's ``dp_scan_audit`` fixture)."""
    from mxnet_tpu import models as jmodels
    from mxnet_tpu.parallel.mesh import data_parallel_mesh
    from mxnet_tpu.train_step import TrainStep as JTrainStep
    n, k = 4, 2
    batch = 8 * n
    jmesh = data_parallel_mesh(n)
    jts = JTrainStep(jmodels.mlp(num_classes=4, hidden=(32,)),
                     optimizer="sgd", learning_rate=0.1, momentum=0.9,
                     mesh=jmesh)
    state = jts.init({"data": (batch, 64)}, {"softmax_label": (batch,)},
                     initializer=lambda desc, arr: None, seed=0)
    sb = {"data": _sds((k, batch, 64), jmesh, JP(None, "data")),
          "softmax_label": _sds((k, batch), jmesh, JP(None, "data"))}
    jout = jcc.check_program(
        jts._build_scan(batch, k),
        (jcc.struct_args(state), sb, jts._dispatch_key(),
         _sds((k,), jmesh, JP())), name="dp-mlp-scan", mesh=jmesh,
        loop_trips=k, min_eff=0.0)
    ts = TrainStep(mt.models.mlp(num_classes=4, hidden=(32,)),
                   optimizer="sgd", learning_rate=0.1, momentum=0.9,
                   mesh=pm.data_parallel_mesh(n, devices=_cpu(n)))
    name, fn, args = train_step_programs(
        ts, {"data": (batch, 64)}, {"softmax_label": (batch,)}, k=k,
        guard=False, name="dp-mlp")[1]
    out = cc.check_program(fn, args, name=name, mesh=ts.mesh, loop_trips=k,
                           min_eff=0.0)
    return out, jout


def test_dp_scan_syncs_by_in_loop_all_reduce_like_jax(dp_scan):
    """All-reduce only along 'data', no finding, 0 < efficiency <= 1, and
    the bytes a dispatch within 1% of the JAX report's. The gradient sums
    are in the loop with multiplier 2, as the JAX scan's psum. A kept
    divergence: the port sums each position's K-step metric accumulators
    once a dispatch (one 12-byte all-reduce outside the loop) where the
    JAX scan psums its metrics every step."""
    (findings, rep), (jfindings, jrep) = dp_scan
    assert set(rep.counts_by_kind()) == set(jrep.counts_by_kind()) == {
        "all-reduce"}
    assert all(e.in_loop and e.multiplier == 2 for e in jrep.entries)
    grads = [e for e in rep.entries if (e.op_path or "").startswith(
        "gradient/")]
    assert sorted(e.op_path for e in grads) == [
        "gradient/fc1_bias", "gradient/fc1_weight", "gradient/fc2_bias",
        "gradient/fc2_weight"]
    assert all(e.in_loop and e.multiplier == 2 for e in grads)
    (metric,) = [e for e in rep.entries if e not in grads]
    assert (metric.in_loop, metric.bytes) == (False, 12)
    assert {e.axes for e in rep.entries} == {e.axes for e in jrep.entries} \
        == {("data",)}
    assert 0.0 < rep.predicted_efficiency <= 1.0
    assert findings == jfindings == []
    assert rep.collective_bytes == pytest.approx(jrep.collective_bytes,
                                                 rel=BYTES_RTOL)


def test_zoo_single_device_program_has_empty_inventory():
    findings, reports = cc.check_zoo(names=["mlp"], k=2, guard=False,
                                     device="cpu")
    jfindings, jreports = jcc.check_zoo(names=["mlp"], k=2, guard=False)
    assert sorted(reports) == sorted(jreports)
    assert findings == jfindings == []
    for rep in list(reports.values()) + list(jreports.values()):
        assert rep.entries == [] and rep.collective_count == 0
        assert rep.predicted_efficiency == 1.0


# ---------------------------------------------------------------------------
# one seeded violation of each lint
# ---------------------------------------------------------------------------

def _seeded_symbol():
    """An mlp whose first FC's output is summed over the batch (its
    gather along 'data' runs in the loop)."""
    data = mt.sym.Variable("data")
    h = mt.sym.FullyConnected(data, num_hidden=16, name="fc1")
    s = mt.sym.sum(h, axis=0, keepdims=True, name="batch_sum")
    h = mt.sym.broadcast_add(h, s, name="add_sum")
    h = mt.sym.FullyConnected(h, num_hidden=4, name="fc2")
    return mt.sym.SoftmaxOutput(h, name="softmax")


def _seeded_step(**kw):
    """The seeded step over data x model (four CPU positions): fc1's
    weight declared split along its input dimension, which its product
    contracts, so the step gathers it before use."""
    mesh = pm.make_mesh({"data": 2, "model": 2}, _cpu(4))
    return TrainStep(_seeded_symbol(), optimizer="sgd", learning_rate=0.1,
                     mesh=mesh, param_shardings={
                         "fc1_weight": pm.P(None, "model")}, **kw)


@pytest.fixture(scope="module")
def seeded():
    """The seeded step's K=2 scan, analyzed once: ``(name, program, args,
    report)``; each lint test lints the report at its own thresholds."""
    ts = _seeded_step()
    name, fn, args = train_step_programs(
        ts, {"data": (8, 8)}, {"softmax_label": (8,)}, k=2, guard=False,
        name="seeded")[1]
    rep = cc.analyze(fn, args, name=name, mesh=ts.mesh, loop_trips=2)
    return name, fn, args, rep, ts


def _hits(findings, lint):
    return [f for f in findings if f.lint == lint]


def test_gather_in_loop_finding_seeded(seeded):
    name, fn, args, rep, _ = seeded
    findings = cc.lint_report(rep, min_eff=0.0)
    hits = _hits(findings, "gather-in-loop")
    gathers = sorted((f.op_path, f.message.split("'")[1]) for f in hits)
    # the batch sum's gather and its backward (a reduce-scatter), and the
    # weight's gather and its backward, each x2
    assert gathers == [("batch_sum", "all-gather"),
                       ("batch_sum", "reduce-scatter"),
                       ("fc1", "all-gather"), ("fc1", "reduce-scatter")]
    assert all("x2 per dispatch" in f.message for f in hits)
    e = [e for e in rep.entries if e.op_path == "batch_sum"
         and not e.transpose][0]
    assert (e.kind, e.axes, e.in_loop, e.multiplier) == (
        "all-gather", ("data",), True, 2)
    # tracecheck's collective-in-scan: a thin alias over the same pass,
    # alone and in the static pass of the scan program (its K from the
    # superbatch)
    alias = tc.check_collectives(fn, args, name=name)
    assert sorted(f.op_path for f in alias) == ["batch_sum", "batch_sum",
                                                "fc1", "fc1"]
    assert {f.lint for f in alias} == {"collective-in-scan"}
    static = [f for f in tc.check_program(fn, args, donate_argnums=(0,),
                                          name=name)
              if f.lint == "collective-in-scan"]
    assert [f.format() for f in static] == [f.format() for f in alias]


def test_resharding_copy_finding_seeded(seeded):
    """The weight declared split along 'model' is read by its gather
    directly: the finding names the argument and the node."""
    rep = seeded[3]
    (hit,) = _hits(cc.lint_report(rep, min_eff=0.0), "resharding-copy")
    assert hit.op_path == "fc1"
    assert "['fc1_weight']" in hit.message and "all-gather" in hit.message
    assert "axes model" in hit.message


def test_replicated_large_finding_seeded(seeded):
    rep = seeded[3]
    assert _hits(cc.lint_report(rep, min_eff=0.0), "replicated-large") == []
    hits = _hits(cc.lint_report(rep, min_eff=0.0, repl_threshold=64),
                 "replicated-large")
    assert sorted(f.op_path for f in hits) == ["batch_sum", "fc1"]
    by = {f.op_path: f.message for f in hits}
    assert "MXTPU_COMMSCHECK_REPL_BYTES" in by["batch_sum"]
    assert "across axis data" in by["batch_sum"]
    assert "across axis model" in by["fc1"]


def test_comms_bound_finding_seeded(seeded):
    rep = seeded[3]
    (hit,) = _hits(cc.lint_report(rep, min_eff=0.999), "comms-bound")
    assert "MXTPU_COMMSCHECK_MIN_EFF" in hit.message
    assert "Inventory:" in hit.message and "all-gather" in hit.message
    assert hit.op_path == rep.entries[0].op_path
    assert 0.0 < rep.predicted_efficiency < 0.999


def test_comms_lints_suppressible_via_shared_registry(seeded):
    name, rep = seeded[0], seeded[3]
    tok = tc.add_suppression("gather-in-loop", program=name)
    try:
        hits = _hits(cc.lint_report(rep, min_eff=0.0), "gather-in-loop")
        assert hits and all(f.suppressed for f in hits)
        assert cc.unsuppressed(hits) == []
        assert all(not f.suppressed for f in _hits(
            cc.lint_report(rep, min_eff=0.0), "resharding-copy"))
    finally:
        tc.remove_suppression(tok)
    assert "gather-in-loop" in tc.COMM_LINTS


# ---------------------------------------------------------------------------
# knobs, the mode switch and the dispatch hook
# ---------------------------------------------------------------------------

def test_repl_bytes_min_eff_and_tol_env(monkeypatch):
    for pkg in (cc, jcc):
        monkeypatch.delenv("MXTPU_COMMSCHECK_REPL_BYTES", raising=False)
        assert pkg.repl_bytes() == 1 << 20
        monkeypatch.setenv("MXTPU_COMMSCHECK_REPL_BYTES", "4M")
        assert pkg.repl_bytes() == 4 << 20
        monkeypatch.setenv("MXTPU_COMMSCHECK_REPL_BYTES", "banana")
        with pytest.raises(Exception, match="MXTPU_COMMSCHECK_REPL_BYTES"):
            pkg.repl_bytes()
        monkeypatch.delenv("MXTPU_COMMSCHECK_REPL_BYTES")
        monkeypatch.delenv("MXTPU_COMMSCHECK_MIN_EFF", raising=False)
        assert pkg.min_efficiency() == 0.5
        monkeypatch.setenv("MXTPU_COMMSCHECK_MIN_EFF", "0.8")
        assert pkg.min_efficiency() == 0.8
        monkeypatch.delenv("MXTPU_COMMSCHECK_MIN_EFF")
        monkeypatch.delenv("MXTPU_COMMSCHECK_TOL", raising=False)
        assert pkg.tolerance() == 0.1
        monkeypatch.setenv("MXTPU_COMMSCHECK_TOL", "0.25")
        assert pkg.tolerance() == 0.25
        monkeypatch.delenv("MXTPU_COMMSCHECK_TOL")


def test_commscheck_mode_knob(monkeypatch):
    for eng in (engine, jengine):
        eng.set_commscheck(None)
        monkeypatch.delenv("MXTPU_COMMSCHECK", raising=False)
        assert eng.commscheck_mode() == "off"
        for v, want in (("warn", "warn"), ("1", "warn"), ("error", "error"),
                        ("off", "off")):
            monkeypatch.setenv("MXTPU_COMMSCHECK", v)
            assert eng.commscheck_mode() == want
        monkeypatch.setenv("MXTPU_COMMSCHECK", "banana")
        with pytest.raises(Exception, match="MXTPU_COMMSCHECK"):
            eng.commscheck_mode()
        monkeypatch.delenv("MXTPU_COMMSCHECK")
        prev = eng.set_commscheck("error")
        try:
            assert prev == "off" and eng.commscheck_mode() == "error"
        finally:
            eng.set_commscheck(None)
        with pytest.raises(Exception, match="set_commscheck"):
            eng.set_commscheck("loud")


def _dp_mlp(seed=0, n=2):
    ts = TrainStep(mt.models.mlp(num_classes=4, hidden=(16,)),
                   optimizer="sgd", learning_rate=0.1,
                   mesh=pm.data_parallel_mesh(n, devices=_cpu(n)))
    batch, k = 4 * n, 2
    state = ts.init({"data": (batch, 16)}, {"softmax_label": (batch,)},
                    seed=seed)
    rng = np.random.default_rng(seed)
    sb = {"data": rng.normal(size=(k, batch, 16)).astype(np.float32),
          "softmax_label": rng.integers(0, 4, (k, batch)).astype(
              np.float32)}
    return ts, state, sb


@pytest.fixture
def count_dry_runs(monkeypatch):
    runs = []
    real = cc.check_program

    def counted(*a, **kw):
        runs.append(kw.get("name"))
        return real(*a, **kw)
    monkeypatch.setattr(cc, "check_program", counted)
    return runs


def test_dispatch_hook_audits_a_mesh_program_once(count_dry_runs):
    """MXTPU_COMMSCHECK=warn: a mesh TrainStep's first dispatch of a key
    runs one dry run of that program and no more; training proceeds."""
    engine.set_commscheck("warn")
    before = set(cc._AUDITED)
    ts, state, sb = _dp_mlp()
    state, m = ts.run_steps(state, sb)
    new = set(cc._AUDITED) - before
    assert len(new) == 1 and "scan" in next(iter(new))
    state, m = ts.run_steps(state, sb)
    assert set(cc._AUDITED) - before == new
    assert count_dry_runs == sorted(new)
    assert m.num_samples > 0


def test_dispatch_hook_error_raises_at_the_first_dispatch_on_a_gather():
    """MXTPU_COMMSCHECK=error: the seeded step's first K-step dispatch
    raises with its gather-in-loop findings, naming the node."""
    engine.set_commscheck("error")
    ts = _seeded_step()
    state = ts.init({"data": (8, 8)}, {"softmax_label": (8,)}, seed=0)
    rng = np.random.default_rng(1)
    sb = {"data": rng.normal(size=(2, 8, 8)).astype(np.float32),
          "softmax_label": rng.integers(0, 4, (2, 8)).astype(np.float32)}
    with pytest.raises(MXNetError) as e:
        ts.run_steps(state, sb)
    msg = str(e.value)
    assert "[gather-in-loop]" in msg and "batch_sum" in msg
    assert "MXTPU_COMMSCHECK" in msg


def test_dispatch_hook_off_runs_no_dry_run(count_dry_runs, monkeypatch):
    monkeypatch.delenv("MXTPU_COMMSCHECK", raising=False)
    assert engine.commscheck_mode() == "off"
    before = set(cc._AUDITED)
    ts, state, sb = _dp_mlp(seed=2)
    ts.run_steps(state, sb)
    ts.step(state, {k: v[0] for k, v in sb.items()})
    assert set(cc._AUDITED) == before and count_dry_runs == []


def test_a_failed_dry_run_is_no_evidence(caplog, tmp_path):
    """A program whose dry run fails: the hook raises under ``error`` and
    logs under ``warn``; its report (``hlo_unavailable``) fails the
    baseline gate and cannot be written into a baseline."""
    def broken(x):
        raise RuntimeError("no such op")
    x = torch.zeros(4)
    engine.set_commscheck("error")
    with pytest.raises(MXNetError, match="dry run of failing/a failed"):
        cc.maybe_audit_dispatch("failing/a", broken, (x,))
    engine.set_commscheck("warn")
    with caplog.at_level(logging.WARNING):
        assert cc.maybe_audit_dispatch("failing/b", broken, (x,)) is None
    assert "could not run" in caplog.text
    blind = cc._blind("p/step", "cpu")
    assert blind.predicted_efficiency is None
    with pytest.raises(MXNetError, match="absence of evidence"):
        cc.write_baseline({"p/step": blind}, str(tmp_path / "b.json"))
    failures, _ = cc.compare_baseline(
        {"p/step": blind}, {"platform": "cpu", "programs": {
            "p/step": {"collective_count": 0, "collective_bytes": 0}}})
    assert len(failures) == 1 and "absence of evidence" in failures[0]


def _sharded_engine():
    from mxnet_tpu_torch import serving
    rs = np.random.RandomState(0)
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=8,
                                name="fc1")
    net = mt.sym.SoftmaxOutput(net, name="softmax")
    params = {"arg:fc1_weight": rs.randn(8, 6).astype(np.float32),
              "arg:fc1_bias": rs.randn(8).astype(np.float32)}
    return serving.ServingEngine(net, params, {"data": (6,)},
                                 buckets=(4,), device="cpu", contexts=2)


def test_serving_load_audit_by_mode(monkeypatch, caplog):
    """A sharded engine's load-time audit (its FC output gathered along
    'model', 128 B at bucket 4): with the replicated-large threshold below
    it, ``error`` raises at construction, ``warn`` logs and builds, ``off``
    runs no dry run; the comms-bound floor is never applied at load."""
    monkeypatch.setenv("MXTPU_COMMSCHECK_REPL_BYTES", "64")
    monkeypatch.setenv("MXTPU_COMMSCHECK_MIN_EFF", "0.9999")
    engine.set_commscheck("error")
    with pytest.raises(MXNetError, match="comms audit found 1 problem"):
        _sharded_engine()
    engine.set_commscheck("warn")
    with caplog.at_level(logging.WARNING):
        eng = _sharded_engine()
    assert "replicated-large" in caplog.text
    assert "comms-bound" not in caplog.text
    engine.set_commscheck("off")
    calls = []
    monkeypatch.setattr(type(eng), "comms_report",
                        lambda self: calls.append(1) or {})
    _sharded_engine()
    assert calls == []


# ---------------------------------------------------------------------------
# the report and the roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute",
                                  "collective-broadcast"])
def test_wire_bytes_model_matches_jax(kind):
    for payload, n in ((1 << 20, 8), (4096, 2), (12, 4), (100, 1),
                       (100, None)):
        assert cc._wire_bytes(kind, payload, n) == jcc._wire_bytes(
            kind, payload, n)


def test_report_totals_and_roofline_match_jax():
    """The same entries (in and out of the loop) in both packages' reports
    at the same link rate and peak: every ``as_dict`` figure equal."""
    def report(pkg):
        entries = [pkg.CollectiveEntry(
            "e%d" % i, kind, nbytes, pkg._wire_bytes(kind, nbytes, 4), 4,
            ("data",), None, in_loop, 3 if in_loop else 1, "p%d" % i, None)
            for i, (kind, nbytes, in_loop) in enumerate(
                (("all-reduce", 1 << 20, True), ("all-gather", 4096, False),
                 ("collective-permute", 512, True)))]
        return pkg.CommsReport("p", "cpu", 4, entries, loop_trips=3,
                               flops=2e9, link_bytes_per_s=1e10,
                               peak_flops_per_s=5e10)
    got, want = report(cc).as_dict(), report(jcc).as_dict()
    assert got == want
    assert 0.0 < got["predicted_efficiency"] < 1.0
    empty = cc.CommsReport("q", "cpu", 4, [], device="cpu")
    assert empty.predicted_efficiency == 1.0 and empty.comm_seconds == 0.0


# ---------------------------------------------------------------------------
# the baseline drift gate
# ---------------------------------------------------------------------------

def _fake(pkg, name, count=0, nbytes=0, prov=None):
    entries = [pkg.CollectiveEntry(
        "%s.%d" % ("all-reduce", i), "all-reduce", nbytes // max(1, count),
        nbytes // max(1, count), 8, ("data",), None, True, 1, "loop/op",
        prov) for i in range(count)]
    kw = {"device": "cpu"} if pkg is cc else {}
    return pkg.CommsReport(name, "cpu", 8, entries, flops=1e9, **kw)


def test_baseline_round_trip_matches_jax_format(tmp_path):
    files = {}
    for pkg in (cc, jcc):
        reports = {"a/scan[k=2]": _fake(pkg, "a/scan[k=2]", 3, 3000),
                   "b/step": _fake(pkg, "b/step")}
        path = str(tmp_path / ("%s.json" % pkg.__name__))
        pkg.write_baseline(reports, path)
        assert pkg.compare_baseline(reports, path) == ([], [])
        with open(path) as f:
            files[pkg] = json.load(f)
    assert files[cc] == files[jcc]


def test_baseline_zero_pinned_program_fails_on_first_collective(tmp_path):
    path = str(tmp_path / "b.json")
    cc.write_baseline({"mlp/step": _fake(cc, "mlp/step")}, path)
    failures, _ = cc.compare_baseline(
        {"mlp/step": _fake(cc, "mlp/step", 1, 8, prov="x.py:3")}, path,
        tol=10.0)
    assert len(failures) == 2          # count AND bytes grew past 0
    assert "Inventory:" in failures[0] and "x.py:3" in failures[0]


def test_baseline_missing_stale_shrink_collapse_and_platform(tmp_path):
    path = str(tmp_path / "b.json")
    cc.write_baseline({"a/step": _fake(cc, "a/step", 4, 4096)}, path)
    failures, notes = cc.compare_baseline(
        {"a/step": _fake(cc, "a/step", 4, 4096),
         "new/step": _fake(cc, "new/step", 1, 8)}, path)
    assert len(failures) == 1 and "new/step" in failures[0]
    assert "--write-baseline" in failures[0]
    failures, notes = cc.compare_baseline({}, path)
    assert failures == [] and "stale" in notes[0]
    failures, notes = cc.compare_baseline(
        {"a/step": _fake(cc, "a/step", 2, 2048)}, path)
    assert failures == [] and len(notes) == 2 and "shrank" in notes[0]
    failures, _ = cc.compare_baseline({"a/step": _fake(cc, "a/step")}, path)
    assert len(failures) == 2 and "collapsed" in failures[0]
    gpu = _fake(cc, "a/step", 9, 9999)
    gpu.platform = "gpu"
    failures, notes = cc.compare_baseline({"a/step": gpu}, path)
    assert failures == [] and "platform" in notes[0]


def test_baseline_tol_env_overrides_stored_band(tmp_path, monkeypatch):
    path = str(tmp_path / "b.json")
    cc.write_baseline({"a/step": _fake(cc, "a/step", 10, 1000)}, path,
                      tol=0.0)
    grown = {"a/step": _fake(cc, "a/step", 11, 1100)}
    assert len(cc.compare_baseline(grown, path)[0]) == 2
    monkeypatch.setenv("MXTPU_COMMSCHECK_TOL", "0.2")
    assert cc.compare_baseline(grown, path)[0] == []
    assert len(cc.compare_baseline(grown, path, tol=0.05)[0]) == 2


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_json_mlp_lenet(capsys):
    rc = cc.main(["--models", "mlp,lenet", "--json", "--no-guard",
                  "--device", "cpu"])
    data = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert data["platform"] == "cpu" and data["findings"] == []
    assert sorted(data["programs"]) == ["lenet/scan[k=2]", "lenet/step",
                                        "mlp/scan[k=2]", "mlp/step"]
    for rep in data["programs"].values():
        assert rep["collective_count"] == 0
        assert rep["predicted_efficiency"] == 1.0
        assert rep["hlo_unavailable"] is False
    assert set(data["comm_seconds"].values()) == {0.0}


def test_cli_list_and_bad_model(capsys):
    assert cc.main(["--list"]) == 0
    listed = capsys.readouterr().out.split()
    assert listed == sorted(tc.ZOO) == sorted(jcc.ZOO)
    with pytest.raises(MXNetError, match="unknown zoo model"):
        cc.main(["--models", "nope", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cc.main([])


def test_not_ported_entry_points_raise_and_struct_args():
    for fn in (cc.analyze_compiled, cc.parse_collectives):
        with pytest.raises(MXNetError, match="HLO"):
            fn()
    mesh = pm.data_parallel_mesh(2, devices=_cpu(2))
    arr = pm.split(torch.arange(8.0).reshape(4, 2), mesh, 0)
    st = cc.struct_args({"x": arr, "n": 3})
    assert st["n"] == 3 and st["x"].spec == arr.spec
    assert [tuple(p.shape) for p in st["x"].parts] == [(2, 2), (2, 2)]
    assert all(memcheck.shape_only(p) for p in st["x"].parts)


# ---------------------------------------------------------------------------
# recording changes nothing
# ---------------------------------------------------------------------------

class _Recorder(TorchDispatchMode):
    """A dispatch mode that records the collectives of a real run and
    passes every op through as it is."""

    def __init__(self):
        super().__init__()
        self.lock = threading.Lock()
        self.seq = 0
        self.collectives = []
        self.arg_keys = {}

    collective = memcheck.record_collective

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _parent(kind, parts, devices, *a):
    """The collectives' arithmetic as the code without the recorder
    computes it."""
    if kind == "all_reduce":
        acc = parts[0].to(devices[0])
        for p in parts[1:]:
            acc = acc + p.to(devices[0])
        return [acc] * len(devices)
    if kind == "all_gather":
        return [torch.cat([p.to(d) for p in parts], a[0])
                for d in devices[:1]] * len(devices)
    if kind == "ppermute":
        n = len(parts)
        return [parts[(j - 1) % n].to(devices[j]) for j in range(n)]
    n = len(parts)
    chunks = [torch.chunk(p, n, dim=a[0]) for p in parts]
    return [torch.cat([chunks[i][j].to(devices[j]) for i in range(n)], a[1])
            for j in range(n)]


def _program(impl, mesh, xs):
    """Every collective of ``parallel/mesh.py`` in a row, differentiable;
    ``impl(kind, parts, devices, *args)`` runs each of the four list
    collectives."""
    devs = mesh.replica_devices()
    a = impl("all_reduce", [x * (i + 1) for i, x in enumerate(xs)], devs)
    g = impl("all_gather", [t.sin() for t in a], devs, 0)
    p = impl("ppermute", [t * 1.5 for t in g], devs)
    t = impl("all_to_all", [v.cos() for v in p], devs, 0, 1)
    arr = pm.MeshArray(mesh, [v.reshape(-1, 8) for v in t], spec=("data",))
    whole = pm.gather_axis(arr, "data")
    rep = pm.replicate(whole.parts[0].tanh(), mesh)
    return sum((v * (r + 1)).sum() for r, v in enumerate(rep.parts))


def _mesh_impl(kind, parts, devices, *a):
    fn = getattr(pm, kind)
    if kind == "all_gather":
        return fn(parts, a[0], devices, ("data",))
    if kind == "ppermute":
        return fn(parts, devices, axes=("data",))
    if kind == "all_to_all":
        return fn(parts, devices, a[0], a[1], ("data",))
    return fn(parts, devices, ("data",))


def test_recording_leaves_values_and_gradients_bitwise_unchanged():
    """The same program through ``parallel/mesh.py`` unrecorded, recorded
    (a recording dispatch mode, whose gradient hooks record the
    transposes), and through the parent's arithmetic: loss and every
    input's gradient bit for bit. The recorder saw each collective and
    each transpose the backward ran."""
    mesh = pm.data_parallel_mesh(2, devices=_cpu(2))
    outs = []
    for impl, rec in ((_parent, None), (_mesh_impl, None),
                      (_mesh_impl, _Recorder())):
        g = torch.Generator().manual_seed(5)
        xs = [torch.randn(4, 6, generator=g).requires_grad_()
              for _ in range(2)]
        with rec if rec is not None else _null():
            loss = _program(impl, mesh, xs)
            loss.backward()
        outs.append((loss.detach(), [x.grad for x in xs], rec))
    for loss, grads, _ in outs[1:]:
        assert torch.equal(loss, outs[0][0])
        for got, want in zip(grads, outs[0][1]):
            assert torch.equal(got, want)
    kinds = [(r["kind"], r["transpose"]) for r in outs[2][2].collectives]
    forward = [k for k, t in kinds if not t]
    assert forward == ["all-reduce", "all-gather", "collective-permute",
                       "all-to-all", "all-gather", "collective-broadcast"]
    assert sorted(k for k, t in kinds if t) == sorted(
        ["all-reduce", "reduce-scatter", "collective-permute",
         "all-to-all", "reduce-scatter", "all-reduce"])
    assert all(r["axes"] == ("data",) for r in outs[2][2].collectives)
    assert re.search(r"test_torch_commscheck\.py:\d+$",
                     outs[2][2].collectives[0]["provenance"])


class _null(object):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
