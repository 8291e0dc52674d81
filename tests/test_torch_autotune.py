"""The port's tuning-DB tier of knob resolution against the JAX package's.

- the committed ``AUTOTUNE_db.json``: a ``Module.fit`` of
  ``models.mlp(num_classes=4, hidden=(32,))`` at batch 48 on the CPU that
  names no knob resolves ``steps_per_dispatch=8, dispatch_pipeline=2``
  from the entry ``mlp|cpu|b48|img_per_sec`` in the port, as in the JAX
  package (both read the same file);
- the precedence arg > env > DB > default per knob, ``MXTPU_AUTOTUNE=0``,
  a stale schema, an unreadable file, a foreign device kind, and the
  objective preference, each with the same outcome in both packages on
  the same DB file;
- the signatures (``symbol_signature``, ``param_signature``) are equal in
  both packages, ``TuningDB`` round-trips, and ``hotspot_report`` ranks
  a program's kernels by their roofline time;
- ``tune`` on the CPU: its result dict has the JAX package's keys, and
  with ``write_db`` it writes an entry that the port's
  ``resolve_train_knobs`` resolves and the JAX package's ``TuningDB.load``
  reads; each harness's pruner under ``MXTPU_AUTOTUNE_BUDGET=4K`` returns
  only ``hbm-budget``/``resident-set`` findings and runs no forward on a
  real tensor (counted), and a sweep there prunes every candidate.

Tolerance: none (knobs, sources and signatures are exact).
"""
import json
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autotune as jat
from mxnet_tpu import models as jmodels
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, autotune
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.autotune.harness import open_loop_run
from mxnet_tpu_torch.obs import REGISTRY

ZOO_MLP = dict(num_classes=4, hidden=(32,))


def _fit_data(pkg, batch=16, n=64, dim=64):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    y = rng.integers(0, 4, n).astype(np.float32)
    return pkg.io.NDArrayIter(x, y, batch_size=batch)


def _bound(pkg, sym, batch=16):
    it = _fit_data(pkg, batch)
    ctx = mt.cpu() if pkg is mt else mx.cpu()
    mod = pkg.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    return mod, it


def _both(batch=16):
    """(JAX module, iter), (port module, iter) over the zoo MLP."""
    with mx.symbol.NameManager():
        jsym = jmodels.mlp(**ZOO_MLP)
    with mt.symbol.NameManager():
        tsym = tmodels.mlp(**ZOO_MLP)
    return _bound(mx, jsym, batch), _bound(mt, tsym, batch)


def _write_train_entry(path, knobs, batch=16, schema=1, device_kind="cpu",
                       objective="img_per_sec"):
    sig = jat.symbol_signature(jmodels.mlp(**ZOO_MLP))
    key = "mlp|%s|b%d|%s" % (device_kind, batch, objective)
    entry = {"model": "mlp", "objective": objective, "kind": "train",
             "global_batch": batch, "device_kind": device_kind,
             "platform": "cpu" if device_kind == "cpu" else "gpu",
             "symbol": "softmax", "symbol_sig": sig, "knobs": dict(knobs),
             "score": 1.0, "unit": "images/sec"}
    with open(path, "w") as f:
        json.dump({"schema": schema, "entries": {key: entry}}, f)
    return key


def _resolve_both(batch=16, spd=None, dp=None):
    (jmod, jit), (tmod, tit) = _both(batch)
    return (jat.resolve_fit_knobs(jmod, jit, spd, dp),
            autotune.resolve_fit_knobs(tmod, tit, spd, dp))


def test_committed_db_sets_fit_knobs_as_in_jax(monkeypatch, caplog):
    monkeypatch.delenv("MXTPU_AUTOTUNE_DB", raising=False)
    monkeypatch.delenv("MXTPU_DISPATCH_PIPELINE", raising=False)
    monkeypatch.delenv("MXTPU_BULK_STEPS", raising=False)
    assert autotune.default_db_path().endswith("AUTOTUNE_db.json")
    jres, tres = _resolve_both(batch=48)
    assert tres == jres == (8, 2, {"steps_per_dispatch": "db",
                                   "dispatch_pipeline": "db"})
    # and a fit that names neither knob trains at them, saying so once
    before = REGISTRY.snapshot().get("autotune.db_resolutions", 0)
    with mt.symbol.NameManager():
        sym = tmodels.mlp(**ZOO_MLP)
    mod = mt.mod.Module(sym, context=mt.cpu())
    with caplog.at_level(logging.INFO):
        mod.fit(_fit_data(mt, batch=48, n=48 * 8), num_epoch=1,
                optimizer_params={"learning_rate": 0.1})
    assert ("steps_per_dispatch=8 (db), dispatch_pipeline=2 (db)"
            in caplog.text)
    assert "mlp|cpu|b48|img_per_sec" in caplog.text
    assert REGISTRY.snapshot()["autotune.db_resolutions"] == before + 1


def test_fit_resolution_precedence(tmp_path, monkeypatch):
    path = str(tmp_path / "tune_db.json")
    monkeypatch.setenv("MXTPU_AUTOTUNE_DB", path)
    _write_train_entry(path, {"steps_per_dispatch": 2,
                              "dispatch_pipeline": 0})
    jres, tres = _resolve_both()
    assert tres == jres == (2, 0, {"steps_per_dispatch": "db",
                                   "dispatch_pipeline": "db"})
    jres, tres = _resolve_both(spd=4, dp=2)
    assert tres == jres == (4, 2, {"steps_per_dispatch": "arg",
                                   "dispatch_pipeline": "arg"})
    monkeypatch.setenv("MXTPU_DISPATCH_PIPELINE", "3")
    with mx.engine.bulk(8), mt.engine.bulk(8):
        jres, tres = _resolve_both()
    assert tres == jres == (8, 3, {"steps_per_dispatch": "env",
                                   "dispatch_pipeline": "env"})
    monkeypatch.delenv("MXTPU_DISPATCH_PIPELINE")
    # an explicit bulk(1) is the operator's 1: the DB does not override it
    with mx.engine.bulk(1), mt.engine.bulk(1):
        jres, tres = _resolve_both()
    assert tres[0] == jres[0] == 1
    assert tres[2]["steps_per_dispatch"] == "env"
    jres, tres = _resolve_both()
    assert tres == jres and tres[2]["steps_per_dispatch"] == "db"
    monkeypatch.setenv("MXTPU_AUTOTUNE", "0")
    jres, tres = _resolve_both()
    assert tres == jres == (1, 1, {"steps_per_dispatch": "default",
                                   "dispatch_pipeline": "default"})


@pytest.mark.parametrize("what", ["schema", "unreadable", "device"])
def test_stale_or_foreign_db_falls_back(tmp_path, monkeypatch, caplog, what):
    path = str(tmp_path / "tune_db.json")
    monkeypatch.setenv("MXTPU_AUTOTUNE_DB", path)
    if what == "schema":
        _write_train_entry(path, {"steps_per_dispatch": 2}, schema=2)
    elif what == "unreadable":
        with open(path, "w") as f:
            f.write("{not json")
    else:
        _write_train_entry(path, {"steps_per_dispatch": 2},
                           device_kind="NVIDIA H100 80GB HBM3")
    mismatches = REGISTRY.snapshot().get("autotune.db_mismatches", 0)
    with caplog.at_level(logging.INFO):
        jres, tres = _resolve_both()
    assert tres == jres == (1, 1, {"steps_per_dispatch": "default",
                                   "dispatch_pipeline": "default"})
    if what == "schema":
        assert "schema" in caplog.text
    elif what == "unreadable":
        assert "unreadable" in caplog.text
    else:
        assert "NVIDIA H100 80GB HBM3" in caplog.text
        assert (REGISTRY.snapshot()["autotune.db_mismatches"]
                == mismatches + 1)


def test_objective_preference_and_serve_kind(tmp_path, monkeypatch):
    path = str(tmp_path / "tune_db.json")
    monkeypatch.setenv("MXTPU_AUTOTUNE_DB", path)
    sig = jat.symbol_signature(jmodels.mlp(**ZOO_MLP))
    entries = {}
    for objective, k in (("tokens_per_sec", 8), ("img_per_sec", 2)):
        entries["mlp|cpu|b16|%s" % objective] = {
            "model": "mlp", "objective": objective, "kind": "train",
            "global_batch": 16, "device_kind": "cpu", "platform": "cpu",
            "symbol": "softmax", "symbol_sig": sig,
            "knobs": {"steps_per_dispatch": k}, "score": 1.0, "unit": "x"}
    with open(path, "w") as f:
        json.dump({"schema": 1, "entries": entries}, f)
    tkey, tknobs = autotune.resolve_train_knobs(
        tmodels.mlp(**ZOO_MLP), 16, device="cpu")
    jkey, jknobs = jat.resolve_train_knobs(jmodels.mlp(**ZOO_MLP), 16)
    assert (tkey, tknobs) == (jkey, jknobs)
    assert tknobs["steps_per_dispatch"] == 2 and "img_per_sec" in tkey
    # a train entry is no serving entry
    assert autotune.resolve_serve_knobs(tmodels.mlp(**ZOO_MLP),
                                        device="cpu") == (None, None)


def test_signatures_equal_in_both_packages():
    for kw in (ZOO_MLP, dict(num_classes=7, hidden=(32,)), {}):
        assert (autotune.symbol_signature(tmodels.mlp(**kw))
                == jat.symbol_signature(jmodels.mlp(**kw)))
    assert (autotune.symbol_signature(tmodels.mlp(**ZOO_MLP))
            != autotune.symbol_signature(tmodels.mlp(num_classes=7,
                                                     hidden=(32,))))
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": np.zeros(4, np.float32)}
    tparams = {"w": mt.nd.array(params["w"], ctx=mt.cpu()).data,
               "b": mt.nd.array(params["b"], ctx=mt.cpu()).data}
    assert (autotune.param_signature(tparams)
            == autotune.param_signature(params)
            == jat.param_signature(params))


def test_db_round_trip_and_parse_buckets(tmp_path):
    path = str(tmp_path / "db.json")
    db = autotune.TuningDB(path)
    key = db.put("mlp", "serve_p99", 0, {"buckets": "1,4"}, -3.0, "ms",
                 kind="serve", symbol="softmax", symbol_sig="abcd1234",
                 device="cpu")
    assert key == "mlp|cpu|b0|serve_p99"
    db.save()
    again = autotune.TuningDB.load(path)
    assert not again.stale
    k, entry, note = again.lookup("serve", symbol_sig="abcd1234",
                                  global_batch=0, device="cpu")
    assert k == key and entry["platform"] == "cpu" and note is None
    assert autotune.load_cached(path) is autotune.load_cached(path)
    assert autotune.parse_buckets("8, 1,4") == (1, 4, 8)
    for bad in ("0,2", "x", ""):
        with pytest.raises(MXNetError, match="bucket spec"):
            autotune.parse_buckets(bad)


def test_unported_parts_raise():
    """Nothing of the tuner raises as unported any more: ``hotspot_report``
    (the roofline's ranked hot spots, ``flopcheck``) prices a program by
    its dry run. Here ``x @ w + b``: the matmul's 2*128**3 FLOPs first
    (compute bound at the CPU's nominal ridge of 10 FLOP/B), then the
    add, each with its share of the predicted time; memory-bound only,
    the add alone."""
    x, w, b = torch.zeros(128, 128), torch.zeros(128, 128), torch.zeros(128)
    entries = autotune.hotspot_report(lambda x, w, b: x @ w + b, (x, w, b),
                                      name="tune/fn", memory_only=False)
    assert [(e["opcode"], e["bound"]) for e in entries] == [
        ("aten.mm", "compute"), ("aten.add", "memory")]
    assert entries[0]["flops"] == 2.0 * 128 ** 3
    assert sum(e["step_time_frac"] for e in entries) == pytest.approx(1.0)
    (add,) = autotune.hotspot_report(lambda x, w, b: x @ w + b, (x, w, b))
    assert add["opcode"] == "aten.add" and add["provenance"].startswith(
        os.path.realpath(__file__) + ":")


def test_open_loop_run_serves_every_request_in_order_of_arrival():
    seen = []

    def infer(x):
        seen.append(x)
        return x

    lat, errs, wall = open_loop_run(infer, lambda i: i, qps=2000.0,
                                    nreq=40, nclients=4)
    assert len(lat) == 40 and not errs and sorted(seen) == list(range(40))
    assert wall > 0 and all(t >= 0 for t in lat)

    def fails(x):
        raise RuntimeError("no")

    lat, errs, _ = open_loop_run(fails, {"data": 0}, qps=2000.0, nreq=5,
                                 nclients=2)
    assert not lat and len(errs) == 5 and "no" in errs[0]


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

TUNE_KEYS = {"model", "objective", "kind", "global_batch", "unit",
             "symbol_sig", "counts", "trials", "default", "best",
             "speedup_vs_default", "db"}


def test_tune_writes_a_db_entry_both_packages_read(tmp_path, monkeypatch):
    # short and long runs six dispatches apart, best of three rounds: a
    # loaded host cannot invert every round's timing
    monkeypatch.setenv("MXTPU_AUTOTUNE_MEASURE", "4,24")
    path = str(tmp_path / "db.json")
    res = autotune.tune("mlp", "img_per_sec", budget=2, batch=16,
                        db_path=path, write_db=True, rounds=3, device="cpu")
    assert set(res) == TUNE_KEYS
    assert res["counts"] == {"ok": 2, "pruned": 0, "error": 0,
                             "timeout": 0}
    assert [t["knobs"] for t in res["trials"]] == [
        {"steps_per_dispatch": 1, "dispatch_pipeline": 1},
        {"steps_per_dispatch": 2, "dispatch_pipeline": 1}]
    assert res["db"]["entry"] == "mlp|cpu|b16|img_per_sec"
    # the port resolves the winner on the CPU
    monkeypatch.setenv("MXTPU_AUTOTUNE_DB", path)
    key, knobs = autotune.resolve_train_knobs(
        tmodels.mlp(**ZOO_MLP), 16, device="cpu")
    assert key == res["db"]["entry"] and knobs == res["best"]["knobs"]
    # the JAX package reads the same file and signature
    jdb = jat.TuningDB.load(path)
    assert not jdb.stale
    entry = jdb.entries[key]
    assert entry["symbol_sig"] == jat.symbol_signature(
        jmodels.mlp(**ZOO_MLP)) == res["symbol_sig"]
    assert entry["knobs"] == res["best"]["knobs"]
    assert entry["device_kind"] == "cpu" and entry["platform"] == "cpu"


def _fake_args(args, kw):
    from torch._subclasses.fake_tensor import is_fake
    vals = list(args) + list(kw.values())
    flat = []
    for v in vals:
        flat += list(v.values()) if isinstance(v, dict) else [v]
    return any(is_fake(t) for t in flat if hasattr(t, "shape"))


def _count_real_runs(monkeypatch):
    """Count graph-runner calls on real tensors (training and serving
    forwards) and decode-body calls on real tensors."""
    from mxnet_tpu_torch import executor, train_step
    from mxnet_tpu_torch.serving import decode, engine
    real = []
    build = executor._build_graph_runner

    def counting(*a, **kw):
        run, nodes = build(*a, **kw)

        def counted(*ra, **rk):
            if not _fake_args(ra[:2], rk):
                real.append("forward")
            return run(*ra, **rk)
        return counted, nodes
    for mod in (train_step, engine):
        monkeypatch.setattr(mod, "_build_graph_runner", counting)
    for name in ("_build_decode_fn", "_build_verify_fn"):
        orig = getattr(decode, name)

        def wrap(*a, _orig=orig, **kw):
            fn = _orig(*a, **kw)

            def counted(state, *r):
                from torch._subclasses.fake_tensor import is_fake
                if not is_fake(state["seed"]):
                    real.append("decode")
                return fn(state, *r)
            return counted
        monkeypatch.setattr(decode, name, wrap)
    return real


@pytest.mark.parametrize("objective,knobs", [
    ("img_per_sec", {"steps_per_dispatch": 4, "dispatch_pipeline": 1}),
    ("serve_p99", {"buckets": "1,8", "max_latency_ms": 5.0}),
    ("decode_tokens_per_sec", {"spec_k": 2, "prefix_cache": 1})])
def test_pruned_candidate_runs_no_forward(monkeypatch, objective, knobs):
    from mxnet_tpu_torch.autotune import harness
    real = _count_real_runs(monkeypatch)
    monkeypatch.setenv("MXTPU_AUTOTUNE_BUDGET", "4K")
    h = {"img_per_sec": lambda: harness.TrainHarness("mlp", device="cpu"),
         "serve_p99": lambda: harness.ServeHarness("mlp", device="cpu"),
         "decode_tokens_per_sec": lambda: harness.DecodeHarness(
             device="cpu")}[objective]()
    findings = h.prune(knobs)
    assert findings and {f.lint for f in findings} <= {"hbm-budget",
                                                      "resident-set"}
    assert real == []
    monkeypatch.delenv("MXTPU_AUTOTUNE_BUDGET")
    assert h.prune(knobs) == [] and real == []
    monkeypatch.setenv("MXTPU_AUTOTUNE_BUDGET", "4K")
    res = autotune.tune("mlp" if objective != "decode_tokens_per_sec"
                        else "lm", objective, budget=2, device="cpu")
    assert res["best"] is None and res["counts"]["pruned"] == 2
    assert real == []


def test_cli_prints_one_json_line_and_exits_2_without_a_success(
        monkeypatch, capsys):
    from mxnet_tpu_torch.autotune.__main__ import main
    monkeypatch.setenv("MXTPU_AUTOTUNE_BUDGET", "4K")
    assert main(["--budget", "3", "--device", "cpu", "--quiet",
                 "--spd", "1,2", "--pipeline", "1"]) == 2
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    res = json.loads(out[0])
    assert res["counts"]["pruned"] == 2 and res["best"] is None
    assert [t["knobs"]["steps_per_dispatch"] for t in res["trials"]] == [
        1, 2]
