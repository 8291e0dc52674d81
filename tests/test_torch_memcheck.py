"""The port's memory analyzer (``mxnet_tpu_torch.memcheck``) against the
JAX package's, and its lints, gate and CLI on their own.

The port prices a program by a shape-only dry run under
``FakeTensorMode`` (the module's note); the JAX package compiles it and
reads XLA's buffer assignment. So the two agree on what a program takes
(its program names, its argument bytes, the state's leaves) and not on
its temporaries: XLA plans and fuses buffers, an eager step frees each
one when its last reference dies. Temp and peak are held here only on the
port.

- the zoo's ``mlp`` and ``lenet``: the same four program names; each
  program's argument bytes equal the ``nbytes`` sum of its state and batch
  leaves, worked out here from the shapes; the parameter and
  optimizer-state leaves the JAX package donates equal the port's leaf by
  leaf (bytes exact);
- one seeded case per lint (``hbm-budget``, ``temp-blowup``,
  ``donation-waste``, ``resident-set``), suppression (programmatic and the
  inline marker), the byte-count and mode knobs, the baseline round trip,
  an injected temp regression, a missing program, a platform mismatch,
  and the CLI (``--json`` over ``mlp,lenet``; write a baseline, then gate
  against it);
- the dry run executes nothing (a real tensor the program writes in place
  is unchanged after it), names a host read, and on fake ``cuda:0``
  tensors an NHWC Conv1x1->BatchNorm pair and the NMS reach B1's and B2's
  shape-only routes with no launch counted; the ResNet-50 step does on
  shape-only ``meta`` tensors (autograd on fake CUDA tensors needs a CUDA
  build of torch, and ends the process in this CPU build, so
  ``train_step_programs`` refuses a CUDA step here);
- ``ServingEngine.memory_report`` (mlp and lenet, buckets 1 and 8) and a
  speculative ``DecodeLoop``'s: the JAX package's program names, argument
  bytes within 1% of the JAX report's (the port's slot vectors are int64
  where the JAX package's are int32); under ``MXTPU_MEMCHECK=error`` with a
  4K budget, construction raises before any bucket or step runs on real
  tensors.

Tolerances: bytes exact, except the serving reports' argument bytes (1%).
"""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, engine, memcheck as mc, tracecheck
from mxnet_tpu_torch import models as tmodels, serving
from mxnet_tpu_torch.autotune.harness import serve_model
from mxnet_tpu_torch.ops import matmul_stats as ms, multibox_nms as mnms

import mxnet_tpu.memcheck as jmc
from mxnet_tpu import serving as jserving
from mxnet_tpu.autotune.harness import serve_model as jserve_model

ZOO_TWO = ("mlp", "lenet")


@pytest.fixture(autouse=True)
def _clean_suppressions():
    tracecheck.clear_suppressions()
    yield
    tracecheck.clear_suppressions()


def _zoo(name):
    return mc.check_zoo([name], device="cpu")


def _keystr(label):
    """``state['opt']['w']`` / ``args[0]['opt']['w']`` -> ``['opt']['w']``."""
    return label[label.index("["):] if label.startswith("state") else \
        label[label.index("]") + 1:]


@pytest.fixture(scope="module")
def zoo_reports():
    return {m: (_zoo(m), jmc.check_zoo([m])) for m in ZOO_TWO}


@pytest.mark.parametrize("model", ZOO_TWO)
def test_zoo_program_names_match_jax(zoo_reports, model):
    (tf, trep), (jf, jrep) = zoo_reports[model]
    assert sorted(trep) == sorted(jrep) == sorted(
        "%s/%s" % (model, p) for p in ("step", "scan[k=2]", "guarded-step",
                                       "guarded-scan[k=2]"))
    assert not mc.unsuppressed(tf)
    assert all(r.platform == "cpu" for r in trep.values())


@pytest.mark.parametrize("model", ZOO_TWO)
def test_zoo_argument_bytes_are_the_state_and_batch(zoo_reports, model):
    """Worked out from the shapes: parameters f32, momentum f32 (one a
    parameter), aux f32, the int32 step counter, the f32 batch (k-deep in
    a scan)."""
    (_, trep), _ = zoo_reports[model]
    cfg = tracecheck.ZOO[model]
    sym = tmodels.get_symbol(model, **cfg["kwargs"])
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=cfg["data"], softmax_label=cfg["label"])
    names = sym.list_arguments()
    params = sum(4 * int(np.prod(s)) for n, s in zip(names, arg_shapes)
                 if n not in ("data", "softmax_label"))
    aux = sum(4 * int(np.prod(s)) for s in aux_shapes)
    state = 2 * params + aux + 4
    batch = 4 * (int(np.prod(cfg["data"])) + int(np.prod(cfg["label"])))
    for name, rep in trep.items():
        k = 2 if "scan" in name else 1
        assert rep.argument_bytes == state + k * batch, name
        assert rep.alias_bytes == rep.donated_bytes == state, name
        assert not rep.unaliased_donated
        assert rep.peak_bytes == (rep.argument_bytes + rep.output_bytes
                                  + rep.temp_bytes - rep.alias_bytes)


@pytest.mark.parametrize("model", ZOO_TWO)
def test_zoo_param_and_opt_leaves_match_jax(zoo_reports, model):
    (_, trep), (_, jrep) = zoo_reports[model]
    for name in trep:
        t = {_keystr(lab): b for lab, b in trep[name].donated
             if _keystr(lab).startswith(("['params']", "['opt']"))}
        j = {_keystr(lab): b for lab, b in jrep[name].donated
             if _keystr(lab).startswith(("['params']", "['opt']"))}
        assert t == j and len(t) >= 4, name


# ---------------------------------------------------------------------------
# one seeded case per lint, on the port
# ---------------------------------------------------------------------------

def _outer(a, b):
    return (a[:, None] * b[None, :]).sum()


def _replace(state):
    return {"w": state["w"] * 2.0, "b": state["b"]}


def _inplace(state):
    state["w"].mul_(2.0)
    return state


def test_hbm_budget_lint():
    rep = mc.analyze(_inplace, ({"w": torch.zeros(64, 64),
                                 "b": torch.zeros(64)},),
                     donate_argnums=(0,), name="tiny")
    assert rep.peak_bytes == 64 * 64 * 4 + 64 * 4
    assert [f.lint for f in mc.lint_report(rep, budget=4096)] == [
        "hbm-budget"]
    assert not mc.lint_report(rep, budget=rep.peak_bytes)


def test_temp_blowup_lint_names_the_op():
    rep = mc.analyze(_outer, (torch.zeros(1024), torch.zeros(1024)),
                     name="outer")
    assert rep.temp_bytes == 1024 * 1024 * 4
    fs = mc.lint_report(rep)
    assert [f.lint for f in fs] == ["temp-blowup"]
    assert rep.top_buffers[0]["opcode"] == "aten.mul"
    assert rep.top_buffers[0]["bytes"] == 1024 * 1024 * 4


def test_donation_waste_lint_on_a_replaced_leaf():
    st = {"w": torch.zeros(64, 64), "b": torch.zeros(64)}
    rep = mc.analyze(_replace, (st,), donate_argnums=(0,), name="replace")
    assert rep.unaliased_donated == [("args[0]['w']", 64 * 64 * 4)]
    assert rep.alias_bytes == 64 * 4
    assert [f.lint for f in mc.lint_report(rep)] == ["donation-waste"]
    rep = mc.analyze(_inplace, (st,), donate_argnums=(0,), name="inplace")
    assert not rep.unaliased_donated and not mc.lint_report(rep)
    assert rep.alias_bytes == rep.donated_bytes == 64 * 64 * 4 + 64 * 4


def test_resident_set_lint_over_the_four_programs(zoo_reports):
    (_, trep), _ = zoo_reports["mlp"]
    reps = list(trep.values())
    total = mc.resident_bytes(reps)
    assert total == (max(r.argument_bytes + r.output_bytes - r.alias_bytes
                         for r in reps) + sum(r.temp_bytes for r in reps))
    # every program fits alone, the set does not
    assert max(r.peak_bytes for r in reps) < total - 1
    assert not mc.lint_resident_set(reps, "mlp/resident-set", budget=total)
    fs = mc.lint_resident_set(reps, "mlp/resident-set", budget=total - 1)
    assert [f.lint for f in fs] == ["resident-set"]
    assert not [f for r in reps
                for f in mc.lint_report(r, budget=total - 1)
                if f.lint == "hbm-budget"]


def test_suppressions_programmatic_and_inline(tmp_path):
    rep = mc.analyze(_outer, (torch.zeros(1024), torch.zeros(1024)),
                     name="outer")
    tok = tracecheck.add_suppression("temp-blowup", "out")
    (f,) = mc.lint_report(rep)
    assert f.suppressed and not mc.unsuppressed([f])
    tracecheck.remove_suppression(tok)
    assert not mc.lint_report(rep)[0].suppressed
    with pytest.raises(MXNetError, match="unknown lint"):
        tracecheck.add_suppression("no-such-lint")
    src = tmp_path / "prog.py"
    src.write_text("x = 1\n# tracecheck: ignore[temp-blowup]\ny = x\n")
    for lint, line, want in (("temp-blowup", 3, True),
                             ("hbm-budget", 3, False),
                             ("temp-blowup", 1, False)):
        f = tracecheck.Finding(lint, "p", "m",
                               provenance="%s:%d" % (src, line))
        assert tracecheck._is_suppressed(f) is want


def test_byte_and_mode_knobs(monkeypatch):
    assert mc._parse_bytes("12G", "x") == 12 << 30
    assert mc._parse_bytes("4K", "x") == 4096
    assert mc._parse_bytes("1.5MiB", "x") == 3 << 19
    for junk in ("12Q", "-3", "lots"):
        with pytest.raises(MXNetError, match="MXTPU_MEMCHECK_BUDGET"):
            mc._parse_bytes(junk, "MXTPU_MEMCHECK_BUDGET")
    monkeypatch.setenv("MXTPU_MEMCHECK_BUDGET", "2M")
    assert mc.budget_bytes("cpu") == 2 << 20
    monkeypatch.delenv("MXTPU_MEMCHECK_BUDGET")
    assert mc.budget_bytes("cpu") == mc.device_budget("cpu") == 16 << 30
    monkeypatch.setenv("MXTPU_MEMCHECK_TEMP_MULT", "2.5")
    assert mc.temp_multiple() == 2.5
    monkeypatch.setenv("MXTPU_MEMCHECK_TOL", "0.2")
    assert mc.tolerance() == 0.2
    for v, mode in (("", "off"), ("1", "warn"), ("warn", "warn"),
                    ("off", "off"), ("error", "error")):
        monkeypatch.setenv("MXTPU_MEMCHECK", v)
        assert engine.memcheck_mode() == mode
    monkeypatch.setenv("MXTPU_MEMCHECK", "loud")
    with pytest.raises(MXNetError, match="MXTPU_MEMCHECK"):
        engine.memcheck_mode()
    monkeypatch.delenv("MXTPU_MEMCHECK")
    prev = engine.set_memcheck("error")
    try:
        assert prev == "off" and engine.memcheck_mode() == "error"
        with pytest.raises(MXNetError, match="warn\\|error\\|off"):
            engine.set_memcheck("sometimes")
    finally:
        engine.set_memcheck(None)
    assert engine.memcheck_mode() == "off"


def test_baseline_round_trip_regression_missing_and_platform(
        zoo_reports, tmp_path):
    (_, trep), _ = zoo_reports["mlp"]
    path = str(tmp_path / "base.json")
    data = mc.write_baseline(trep, path, tol=0.1)
    assert data["platform"] == "cpu" and len(data["programs"]) == 4
    assert mc.compare_baseline(trep, path) == ([], [])
    # an injected temp regression past the 10% + 64 KiB band
    name = "mlp/step"
    r = trep[name]
    grown = dict(trep)
    grown[name] = mc.MemoryReport(
        r.program, r.platform, r.argument_bytes, r.output_bytes,
        r.temp_bytes + (1 << 20), r.alias_bytes, top_buffers=r.top_buffers)
    fails, _ = mc.compare_baseline(grown, path)
    assert len(fails) == 2 and all(name in f for f in fails)
    assert any("temp_bytes grew" in f for f in fails)
    # a program missing from the baseline fails; a stale entry is a note
    extra = dict(trep)
    extra["mlp/new"] = r
    fails, _ = mc.compare_baseline(extra, path)
    assert fails == [f for f in fails if "mlp/new: not in the baseline" in f]
    less = {n: v for n, v in trep.items() if n != name}
    fails, notes = mc.compare_baseline(less, path)
    assert not fails and any("matches no audited program" in n
                             for n in notes)
    # another platform's baseline cannot judge this run
    with open(path) as f:
        base = json.load(f)
    base["platform"] = "gpu"
    fails, notes = mc.compare_baseline(grown, base)
    assert not fails and "skipping the regression gate" in notes[0]


def test_cli_json_and_write_then_gate(tmp_path, capsys):
    assert mc.main(["--models", "mlp,lenet", "--json", "--device",
                    "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["platform"] == "cpu" and out["budget_bytes"] == 16 << 30
    assert len(out["programs"]) == 8 and not out["findings"]
    rep = out["programs"]["lenet/step"]
    assert rep["peak_bytes"] == (rep["argument_bytes"] + rep["output_bytes"]
                                 + rep["temp_bytes"] - rep["alias_bytes"])
    path = str(tmp_path / "b.json")
    assert mc.main(["--models", "mlp", "--device", "cpu", "--quiet",
                    "--write-baseline", path]) == 0
    assert mc.main(["--models", "mlp", "--device", "cpu", "--quiet",
                    "--baseline", path]) == 0
    assert "0 baseline regression(s) over 4" in capsys.readouterr().out
    assert mc.main(["--models", "mlp", "--device", "cpu", "--quiet",
                    "--budget", "4K"]) == 1
    assert "[hbm-budget] mlp/step" in capsys.readouterr().out
    assert mc.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == sorted(tracecheck.ZOO)


def test_devspec_h100_row_and_fallback(monkeypatch):
    from mxnet_tpu import devspec as jdev
    from mxnet_tpu_torch import devspec
    assert devspec.DEFAULT_SPEC == tuple(jdev.DEFAULT_SPEC)
    assert devspec.lookup("cpu") == (devspec.DEFAULT_SPEC,
                                     "nominal-fallback")
    assert devspec.ridge_intensity("cpu") == jdev.DEFAULT_SPEC[0] \
        / jdev.DEFAULT_SPEC[1] == 10.0
    assert not [k for k in devspec.DEVICE_SPECS if "TPU" in k]
    for name, want in (("NVIDIA H100 80GB HBM3", "spec"),
                       ("NVIDIA A100-SXM4-80GB", "nominal-fallback")):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0, name=name: name)
        assert devspec.device_kind("cuda:0") == name
        assert devspec.peak_source("cuda:0") == want
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    assert devspec.peak_flops("cuda:0") == 989e12
    assert devspec.hbm_bandwidth("cuda:0") == 3.35e12
    assert devspec.link_bandwidth("cuda:0") == 450e9
    assert devspec.ridge_intensity("cuda:0") == 989e12 / 3.35e12
    assert devspec.PEAK_BY_DTYPE["NVIDIA H100"] == {
        "bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}


def test_not_ported_entry_points_raise():
    """The two entry points that read XLA's executable still raise;
    ``check_registered`` is ported (an empty tuple audits nothing, as in
    the JAX package)."""
    for fn in (mc.analyze_compiled, mc.parse_hlo_buffers):
        with pytest.raises(MXNetError, match="HLO|XLA"):
            fn()
    assert mc.check_registered(match=()) == jmc.check_registered(
        match=()) == ([], {})


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_dry_run_executes_nothing():
    w = torch.ones(8, 8)
    rep = mc.analyze(_inplace, ({"w": w, "b": torch.ones(8)},),
                     donate_argnums=(0,))
    assert torch.equal(w, torch.ones(8, 8))
    assert rep.alias_bytes == 8 * 8 * 4 + 8 * 4


def test_provenance_survives_a_path_that_is_not_normalized():
    """A module imported through ``.../tests/../mxnet_tpu_torch`` keeps
    that spelling in its code objects; the node and the line are still
    found."""
    import mxnet_tpu_torch.executor as ex
    real = ex.__file__
    odd = os.path.join(os.path.dirname(os.path.dirname(real)), "tests",
                       "..", "mxnet_tpu_torch", "executor.py")
    assert mc._file_kind(odd) == (os.path.realpath(real), True, True)
    assert mc._file_kind(mc.__file__)[1:] == (False, False)
    assert mc._file_kind(np.__file__)[1:] == (False, False)


def test_host_read_is_named():
    def reads(x):
        return int(x.sum())
    with pytest.raises(MXNetError, match="reads a value back to the host"):
        mc.analyze(reads, (torch.ones(4),), name="reads")


def _fake(shape, device, dtype=torch.float32):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as m:
        return torch.empty(shape, dtype=dtype, device=device), m


def test_conv1x1_bn_pair_on_fake_cuda_takes_the_shape_only_route(
        monkeypatch):
    from mxnet_tpu_torch.executor import _build_graph_runner
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    data = mt.sym.Variable("data")
    c = mt.sym.Convolution(data, num_filter=32, kernel=(1, 1), no_bias=True,
                           layout="NHWC", name="c")
    sym = mt.sym.Activation(mt.sym.BatchNorm(c, axis=3, name="bn"),
                            act_type="relu")
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(4, 8, 8, 16))
    run, _ = _build_graph_runner(sym)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        args = {n: torch.empty(s, device="cuda:0")
                for n, s in zip(sym.list_arguments(), arg_shapes)}
        aux = {n: torch.empty(s, device="cuda:0")
               for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    ms.reset_launches()
    rep = mc.analyze(lambda a, x: run(a, x, None, True), (args, aux),
                     name="pair")
    assert ms.SHAPE_ONLY_CALLS == 1 and ms.LAUNCHES == 0
    assert rep.platform == "gpu"
    y = [b for b in rep.top_buffers if b["op_path"] == c.name]
    # the kernel's y, (4*8*8, 32) float32, from the wrapper's shape-only
    # route; CUDA storages round up to the allocator's 512-byte granule
    assert y and y[0]["bytes"] == 4 * 8 * 8 * 32 * 4, rep.top_buffers
    assert "ops/matmul_stats.py" in y[0]["provenance"]
    assert rep.argument_bytes % 512 == 0


def test_nms_on_fake_cuda_takes_the_shape_only_route():
    mnms.reset_launches()
    for k, route in ((400, "smem"), (1300, "l2")):
        boxes, m = _fake((2, k, 4), "cuda:0")
        with m:
            score = torch.empty((2, k), device="cuda:0")
            cls = torch.empty((2, k), device="cuda:0")
        rep = mc.analyze(lambda b, s, c: mnms.nms_alive(b, s, c, 0.5),
                         (boxes, score, cls), name="nms")
        assert mnms.kernel_route(2, k) == route
        scratch = 2 * k * ((k + 63) // 64) * 8 if route == "l2" else 0
        mask = -(-2 * k * 4 // 512) * 512
        assert rep.output_bytes == mask
        assert rep.temp_bytes == -(-scratch // 512) * 512
    assert mnms.SHAPE_ONLY_CALLS == 2 and mnms.LAUNCHES == 0
    # a real CPU tensor still takes the plain version
    b = torch.tensor([[[0, 0, 1, 1], [0, 0, 1, 1.1]]])
    s = torch.tensor([[0.9, 0.8]])
    out = mnms.nms_alive(b, s, torch.zeros(1, 2), 0.5)
    assert out.tolist() == [[1.0, 0.0]] and mnms.SHAPE_ONLY_CALLS == 2


def test_resnet50_step_on_meta_takes_the_shape_only_route(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    sym = tmodels.resnet(num_classes=4, num_layers=50,
                         image_shape="3,32,32", layout="NHWC")
    ts = mt.TrainStep(sym, learning_rate=0.1, compute_dtype="bfloat16",
                      device="meta")
    (name, fn, args), = tracecheck.train_step_programs(
        ts, {"data": (2, 32, 32, 3)}, {"softmax_label": (2,)}, k=1,
        guard=False, name="r50")[:1]
    ms.reset_launches()
    rep = mc.analyze(fn, args, donate_argnums=(0,), name=name)
    assert ms.SHAPE_ONLY_CALLS == 33 and ms.LAUNCHES == 0
    assert rep.program == "r50/step" and not rep.unaliased_donated
    assert ts._opt.num_update == 0


def test_cuda_step_needs_a_cuda_build(monkeypatch):
    from mxnet_tpu_torch import train_step
    monkeypatch.setattr(train_step, "resolve_device",
                        lambda d, who: torch.device("cuda", 0))
    ts, data, label = tracecheck.zoo_train_step("mlp")
    assert ts.device.type == "cuda"
    with pytest.raises(MXNetError, match="CUDA backend"):
        tracecheck.train_step_programs(ts, data, label)


# ---------------------------------------------------------------------------
# the serving tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ZOO_TWO)
def test_engine_memory_report_matches_jax_names_and_args(model):
    _, sym, params, shape = serve_model(model)
    _, jsym, jparams, _ = jserve_model(model)
    eng = serving.ServingEngine(sym, params, {"data": shape},
                                buckets=(1, 8), device="cpu",
                                name="mc-%s" % model)
    jeng = jserving.ServingEngine(jsym, jparams, {"data": shape},
                                  buckets=(1, 8), name="mc-%s" % model)
    reps, jreps = eng.memory_report(), jeng.memory_report()
    assert sorted(reps) == sorted(jreps) == [1, 8]
    for b in (1, 8):
        assert reps[b].program == "%s/bucket[b=%d]" % (eng.name, b)
        assert jreps[b].program == "%s/bucket[b=%d]" % (jeng.name, b)
        assert reps[b].argument_bytes == pytest.approx(
            jreps[b].argument_bytes, rel=0.01)
        assert reps[b].alias_bytes == 0 and reps[b].temp_bytes > 0
    priced = serving.ServingEngine.priced(sym, params, {"data": shape},
                                          buckets=(1, 8), device="cpu")
    assert {b: r.peak_bytes for b, r in priced.items()} == {
        b: r.peak_bytes for b, r in reps.items()}


def _lm(layers, seed, heads=2):
    s = tmodels.transformer(vocab_size=32, embed=16, num_heads=heads,
                            num_layers=layers, seq_len=48)
    a, _, _ = s.infer_shape(data=(1, 48), softmax_label=(1, 48))
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(*sh) * 0.3).astype(np.float32)
            for n, sh in zip(s.list_arguments(), a)
            if n not in ("data", "softmax_label")}


def test_decode_memory_report_matches_jax_names_and_args():
    p, d = _lm(2, 0), _lm(1, 1)
    kw = dict(num_layers=2, num_heads=2, max_len=48, slots=4, spec_k=2,
              draft_params=d, draft_num_layers=1, name="mc-decode")
    loop = serving.DecodeLoop(p, device="cpu", **kw)
    jloop = jserving.DecodeLoop(p, **kw)
    try:
        reps, jreps = loop.memory_report(), jloop.memory_report()
    finally:
        loop.close()
        jloop.close()
    tags = ["verify[slots=4,win=3]", "draft[slots=4,len=48]",
            "prefix_get[target]", "prefix_put[target]",
            "prefix_get[draft]", "prefix_put[draft]"]
    assert sorted(reps) == sorted("%s/%s" % (loop.name, t) for t in tags)
    assert sorted(jreps) == sorted("%s/%s" % (jloop.name, t) for t in tags)
    for t in tags:
        rep = reps["%s/%s" % (loop.name, t)]
        assert rep.argument_bytes == pytest.approx(
            jreps["%s/%s" % (jloop.name, t)].argument_bytes, rel=0.01), t
        assert not rep.unaliased_donated
    # the caches are donated and updated in place
    assert reps["%s/verify[slots=4,win=3]" % loop.name].alias_bytes == \
        2 * 2 * 4 * 2 * 49 * 8 * 4 + 4 * 8


def test_memcheck_error_raises_before_any_bucket_runs(monkeypatch):
    from torch._subclasses.fake_tensor import is_fake
    real = []
    build = serving.engine._build_graph_runner

    def counting(*a, **kw):
        run, nodes = build(*a, **kw)

        def counted(args, aux, *r, **k):
            if not any(is_fake(v) for v in args.values()
                       if isinstance(v, torch.Tensor)):
                real.append(1)
            return run(args, aux, *r, **k)
        return counted, nodes

    monkeypatch.setattr(serving.engine, "_build_graph_runner", counting)
    _, sym, params, shape = serve_model("mlp")
    monkeypatch.setenv("MXTPU_MEMCHECK", "error")
    monkeypatch.setenv("MXTPU_MEMCHECK_BUDGET", "4K")
    with pytest.raises(MXNetError, match="hbm-budget"):
        serving.ServingEngine(sym, params, {"data": shape}, buckets=(1, 8),
                              device="cpu")
    assert real == []
    with pytest.raises(MXNetError, match="memory audit found"):
        serving.DecodeLoop(_lm(1, 0), num_layers=1, num_heads=2,
                           max_len=48, device="cpu")
    monkeypatch.setenv("MXTPU_MEMCHECK", "warn")
    eng = serving.ServingEngine(sym, params, {"data": shape},
                                buckets=(1, 8), device="cpu")
    assert len(real) == 2 and eng.infer({"data": np.zeros((1,) + shape,
                                                           np.float32)})
    monkeypatch.setenv("MXTPU_MEMCHECK_BUDGET", "lots")
    with pytest.raises(MXNetError, match="MXTPU_MEMCHECK_BUDGET"):
        serving.ServingEngine(sym, params, {"data": shape}, buckets=(1,),
                              device="cpu")
