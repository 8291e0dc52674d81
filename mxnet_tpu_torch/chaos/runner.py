"""Chaos scenario runner: four real workloads, each driven under a
:class:`~mxnet_tpu_torch.chaos.plan.ChaosPlan` in a SUBPROCESS with a hang
watchdog.

The port's own copy of ``mxnet_tpu/chaos/runner.py``. The workers run on
the device ``MXTPU_CHAOS_DEVICE`` names (``gpu``, the default: ``cuda:0``;
``cpu``), which ``python -m mxnet_tpu_torch.chaos --device`` sets; the dist
scenario's ranks launch through ``mxnet_tpu_torch/tools/launch.py`` and,
on a one-card machine, share ``cuda:0``.

Scenarios:

``train``  fused K-step ``Module.fit`` (k=2, pipelined dispatch) with
           async checkpointing + guard, then a faults-cleared resume
           from the same prefix, compared against an unfaulted
           reference run — the bitwise-resume contract under composed
           faults.
``data``   the device-fed data tier: JPEG records through
           ``ImageRecordIter`` + ``DecodeWorkerPool`` workers; the
           faulted stream must be byte-identical to the reference or
           fail typed (worker parallelism never reorders batches).
``dist``   a REAL 3-process ``dist_sync`` fit via the port's
           ``tools/launch.py`` local launcher; plans may SIGKILL a non-coordinator rank
           mid-collective (elastic re-form) or slow/partition the
           control plane.
``serve``  a 2-replica ``FleetRouter`` + a ``DecodeLoop`` under
           open-loop load; every submitted request must settle exactly
           once whatever dies.

Each scenario worker records FACTS into a result JSON (outcome, typed-
ness, health-counter deltas, fired-fault counts, hashes, the settlement
partition, flight-recorder state); judgment lives in
:mod:`~mxnet_tpu_torch.chaos.invariants`. The parent enforces a hard
wall-clock deadline per scenario (``MXTPU_CHAOS_DEADLINE``) and kills
the whole process group on expiry — a hang is an invariant violation,
not a timeout to shrug at.
"""
from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import sys
import time

from ..base import MXNetError, env_float

SCENARIOS = ("train", "data", "dist", "serve")

#: per-scenario watchdog defaults (seconds). Generous vs the healthy
#: wall time (a loaded CI host must not trip them), tiny vs a hang.
_DEADLINES = {"train": 300.0, "data": 240.0, "serve": 240.0,
              "dist": 480.0}

_DIST_NPROC = 3


def default_deadline(scenario):
    d = env_float("MXTPU_CHAOS_DEADLINE", 0.0)
    return d if d > 0 else _DEADLINES[scenario]


# ---------------------------------------------------------------------------
# parent side: subprocess + watchdog
# ---------------------------------------------------------------------------

def _worker_env(workdir, scenario):
    env = dict(os.environ)
    env.pop("MXTPU_FAULTS", None)       # plans arm through the plan file
    env["MXTPU_CHAOS_DEVICE"] = env.get("MXTPU_CHAOS_DEVICE") or "gpu"
    # the workers import this package from wherever the caller does
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["MXTPU_FLIGHT_RECORDER"] = "1"
    env["MXTPU_FLIGHT_RECORDER_PATH"] = os.path.join(
        workdir, "flight-%s.json" % scenario)
    return env


def _spawn_with_watchdog(cmd, env, deadline_s, log_path):
    """Run ``cmd`` in its own session; SIGKILL the whole process group at
    the deadline. Returns ``(rc, watchdog_fired, wall_s)``."""
    t0 = time.monotonic()
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(cmd, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=deadline_s)
            return rc, False, time.monotonic() - t0
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                proc.kill()
            proc.wait()
            return None, True, time.monotonic() - t0


def _read_result(path):
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def run_plan(plan, workdir, deadline=None):
    """Run one scenario under ``plan``; returns the outcome record the
    invariant suite consumes (``{"scenario", "watchdog_fired", "wall_s",
    "deadline_s", "rc", "result" | "rank_results", "expected_dead",
    "log"}``)."""
    os.makedirs(workdir, exist_ok=True)
    if plan.scenario not in SCENARIOS:
        raise MXNetError("unknown chaos scenario %r (have: %s)"
                         % (plan.scenario, ", ".join(SCENARIOS)))
    deadline_s = float(deadline) if deadline else \
        default_deadline(plan.scenario)
    plan_path = plan.save(os.path.join(workdir, "plan.json"))
    log_path = os.path.join(workdir, "worker.log")
    env = _worker_env(workdir, plan.scenario)
    if plan.scenario == "dist":
        return _run_dist(plan, plan_path, workdir, env, deadline_s,
                         log_path)
    out_path = os.path.join(workdir, "result.json")
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.chaos", "--scenario-worker",
           plan.scenario, "--plan", plan_path, "--out", out_path,
           "--workdir", workdir]
    rc, watchdog, wall = _spawn_with_watchdog(cmd, env, deadline_s,
                                              log_path)
    return {"scenario": plan.scenario, "watchdog_fired": watchdog,
            "wall_s": wall, "deadline_s": deadline_s, "rc": rc,
            "result": _read_result(out_path), "log": log_path}


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_dist(plan, plan_path, workdir, env, deadline_s, log_path):
    """3 ranks through the port's local launcher (the real multi-process
    rendezvous, not threads). Ranks carrying a ``die`` rule are EXPECTED
    to vanish without reporting."""
    env["MXTPU_TEST_TMPDIR"] = workdir
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch",
           "-n", str(_DIST_NPROC), "--coord-port", str(_free_port()),
           sys.executable, "-m", "mxnet_tpu_torch.chaos",
           "--scenario-worker", "dist-rank", "--plan", plan_path,
           "--out-dir", workdir, "--workdir", workdir]
    rc, watchdog, wall = _spawn_with_watchdog(cmd, env, deadline_s,
                                              log_path)
    rank_results = {
        r: _read_result(os.path.join(workdir, "rank%d.json" % r))
        for r in range(_DIST_NPROC)}
    expected_dead = sorted({int(r["rank"]) for r in plan.faults
                            if r["kind"] == "die"
                            and r.get("rank") is not None})
    return {"scenario": "dist", "watchdog_fired": watchdog,
            "wall_s": wall, "deadline_s": deadline_s, "rc": rc,
            "rank_results": rank_results, "expected_dead": expected_dead,
            "log": log_path}


# ---------------------------------------------------------------------------
# worker side: fact recording
# ---------------------------------------------------------------------------

def _context(mx):
    """The workers' context: ``MXTPU_CHAOS_DEVICE`` (``gpu``: cuda:0)."""
    dev = os.environ.get("MXTPU_CHAOS_DEVICE", "gpu")
    if dev not in ("gpu", "cpu"):
        raise MXNetError("MXTPU_CHAOS_DEVICE must be gpu or cpu, got %r"
                         % dev)
    return mx.gpu(0) if dev == "gpu" else mx.cpu()


def _health_snapshot():
    from ..io import DATA_HEALTH
    from ..guard import TRAINING_HEALTH
    from ..serving.health import SERVING_HEALTH
    from ..dist_ring import DIST_HEALTH
    return {"data": DATA_HEALTH.report(),
            "training": TRAINING_HEALTH.report(),
            "serving": SERVING_HEALTH.report(),
            "dist": DIST_HEALTH.report()}


def _health_delta(before, after):
    out = {}
    for view, now in after.items():
        d = {}
        for k, v in now.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            prev = before.get(view, {}).get(k, 0) or 0
            if v - prev:
                d[k] = v - prev
        out[view] = d
    return out


def _flight_facts():
    path = os.environ.get("MXTPU_FLIGHT_RECORDER_PATH", "")
    facts = {"path": path, "exists": bool(path) and os.path.exists(path),
             "parses": False, "detail": None}
    if facts["exists"]:
        try:
            with open(path) as f:
                doc = json.load(f)
            facts["parses"] = isinstance(doc, dict) and "reason" in doc
            if not facts["parses"]:
                facts["detail"] = "dump missing the 'reason' field"
        except ValueError as e:
            facts["detail"] = str(e)
    return facts


def _error_facts(exc):
    return {"outcome": "error", "error_type": type(exc).__name__,
            "error_msg": str(exc)[:500],
            "typed": isinstance(exc, MXNetError)}


def _hash_params(mod):
    arg, aux = mod.get_params()
    h = hashlib.sha256()
    for name in sorted(arg):
        h.update(name.encode())
        h.update(arg[name].asnumpy().tobytes())
    for name in sorted(aux or {}):
        h.update(name.encode())
        h.update(aux[name].asnumpy().tobytes())
    return h.hexdigest()


def _write_result(out_path, result):
    from ..model import atomic_write_bytes
    atomic_write_bytes(out_path,
                       json.dumps(result, sort_keys=True,
                                  indent=1).encode())


def _capture_faults(plan, result):
    """Record fired/call counters into ``result`` — MUST run before the
    worker's ``faults.clear()`` wipes them."""
    from .. import faults
    result["fault_fired"] = faults.fired_counts()
    result["fault_counts"] = {s: faults.count(s) for s in plan.sites()}


def _finish(out_path, plan, base_health, result):
    result.setdefault("outcome", "completed")
    result.setdefault("typed", True)
    result.setdefault("fault_fired", {})
    result.setdefault("fault_counts", {})
    result["health"] = _health_delta(base_health, _health_snapshot())
    result["flight"] = _flight_facts()
    _write_result(out_path, result)


# -- train ------------------------------------------------------------------

def _train_mgr(workdir, tag):
    from ..model import CheckpointManager
    prefix = os.path.join(workdir, tag, "ck")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    return CheckpointManager(prefix, keep=8)


def _train_fit(mx, mgr, resume=None, epochs=2):
    """One deterministic MLP fit on the fused k=2 path with guard + async
    checkpointing; returns the module. Identical data, seed and knobs
    every call — the bitwise-resume reference depends on it."""
    import numpy as np
    sym = mx.sym
    data = sym.Variable("data")
    net = sym.FullyConnected(data=data, num_hidden=16, name="fc1")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.FullyConnected(data=net, num_hidden=4, name="fc2")
    net = sym.SoftmaxOutput(data=net, name="softmax")
    rng = np.random.default_rng(3)
    X = rng.normal(size=(256, 10)).astype(np.float32)
    w = rng.normal(size=(10, 4)).astype(np.float32)
    y = np.argmax(X @ w, axis=1).astype(np.float32)
    train = mx.io.NDArrayIter(X, y, batch_size=16)  # 16 batches/epoch
    mx.random.seed(7)
    mod = mx.mod.Module(net, context=_context(mx))
    mod.fit(train, num_epoch=epochs, steps_per_dispatch=2,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            checkpoint_prefix=mgr, checkpoint_every_n_batches=4,
            checkpoint_async=True, guard=True, resume=resume)
    return mod


def worker_train(plan, out_path, workdir):
    import mxnet_tpu_torch as mx
    from .. import faults
    from ..guard import TRAINING_HEALTH

    result = {"scenario": "train"}
    base = _health_snapshot()

    # phase A: the unfaulted reference (same knobs, own prefix)
    mod_ref = _train_fit(mx, _train_mgr(workdir, "ref"))
    ref_hash = _hash_params(mod_ref)
    result["ref_hash"] = ref_hash

    # phase B: the same run under the plan
    guard_before = TRAINING_HEALTH.report()
    faults.arm(plan.faults)
    mgr_b = _train_mgr(workdir, "run")
    try:
        mod_b = _train_fit(mx, mgr_b)
        result["final_hash"] = _hash_params(mod_b)
    except Exception as exc:
        result.update(_error_facts(exc))
    finally:
        _capture_faults(plan, result)
        faults.clear()
    writer = mgr_b.last_async_writer or mgr_b.async_writer
    if writer is not None:
        result["async_ckpt"] = {"submitted": writer.submitted,
                                "written": writer.written,
                                "skipped": writer.skipped,
                                "errors": writer.errors,
                                "restarts": writer.restarts}
    guard_after = TRAINING_HEALTH.report()
    poisoned = any(faults.fired(s) for s in
                   ("guard.grad_nan", "guard.loss_spike",
                    "guard.param_nan"))
    preserving = (not poisoned
                  and guard_after["skipped"] == guard_before["skipped"]
                  and guard_after["rollbacks"] == guard_before["rollbacks"])
    result["trajectory_preserving"] = preserving

    # phase C: faults cleared, resume from the newest valid checkpoint.
    # Trajectory-preserving plans must land on the reference BITWISE;
    # poisoned trajectories degrade to the consistency form (resume
    # completes from a valid checkpoint, typed all the way).
    mode = "bitwise" if preserving else "consistency"
    try:
        mod_c = _train_fit(mx, _train_mgr(workdir, "run"), resume="auto")
        resume_hash = _hash_params(mod_c)
        ok = (resume_hash == ref_hash) if mode == "bitwise" else True
        detail = (None if ok else
                  "resume hash %s != reference %s (plan: %s)"
                  % (resume_hash[:12], ref_hash[:12], plan.describe()))
        result["resume"] = {"mode": mode, "ok": ok, "detail": detail,
                            "hash": resume_hash}
    except Exception as exc:
        result["resume"] = {
            "mode": mode, "ok": False,
            "detail": "resume raised %s: %s" % (type(exc).__name__, exc)}
    _finish(out_path, plan, base, result)


# -- data -------------------------------------------------------------------

def _make_rec(mx, path, n=64):
    """Tiny JPEG .rec (the test_data_tier recipe); None when PIL is
    unavailable (the scenario then degrades to raw-record streaming)."""
    try:
        from PIL import Image
    except ImportError:
        return None
    import io as _bio
    import numpy as np
    from .. import recordio
    rng = np.random.default_rng(0)
    colors = np.array([[200, 40, 40], [40, 200, 40], [40, 40, 200],
                       [200, 200, 40]], np.float32)
    idx = os.path.splitext(path)[0] + ".idx"
    rec = recordio.MXIndexedRecordIO(idx, path, "w")
    for i in range(n):
        k = i % 4
        img = (rng.normal(110, 25, (40, 40, 3))
               + 0.55 * (colors[k] - 110)).clip(0, 255).astype(np.uint8)
        buf = _bio.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=92)
        rec.write_idx(i, recordio.pack(
            recordio.IRHeader(0, float(k), i, 0), buf.getvalue()))
    rec.close()
    return path


def _stream_hash(mx, rec, batches=None):
    """Iterate the worker-pool record pipeline; chained sha256 over every
    batch's bytes IN ORDER (the reorder detector)."""
    import hashlib as _h
    it = mx.image.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                                  batch_size=16, resize=36, shuffle=False,
                                  num_workers=2,
                                  device=_context(mx).to_device())
    h = _h.sha256()
    n = 0
    try:
        for batch in it:
            h.update(batch.data[0].asnumpy().tobytes())
            n += 1
            if batches is not None and n >= batches:
                break
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    return h.hexdigest(), n


def worker_data(plan, out_path, workdir):
    import mxnet_tpu_torch as mx
    from .. import faults

    result = {"scenario": "data"}
    base = _health_snapshot()
    rec = _make_rec(mx, os.path.join(workdir, "chaos.rec"))
    if rec is None:
        result["stream"] = {"ok": None, "detail": "PIL unavailable"}
        _finish(out_path, plan, base, result)
        return
    ref_hash, ref_n = _stream_hash(mx, rec)
    faults.arm(plan.faults)
    try:
        got_hash, got_n = _stream_hash(mx, rec)
        ok = got_hash == ref_hash and got_n == ref_n
        result["stream"] = {
            "ok": ok,
            "detail": None if ok else
            "faulted stream hash/len %s/%d != reference %s/%d"
            % (got_hash[:12], got_n, ref_hash[:12], ref_n)}
    except Exception as exc:
        result.update(_error_facts(exc))
    finally:
        _capture_faults(plan, result)
        faults.clear()
    _finish(out_path, plan, base, result)


# -- serve ------------------------------------------------------------------

def _serve_lm_params():
    import numpy as np
    rs = np.random.RandomState(3)
    embed, vocab, max_len = 16, 32, 24
    p = {"tok_embed_weight": rs.randn(vocab, embed) * 0.3,
         "pos_embed_weight": rs.randn(max_len, embed) * 0.1,
         "final_ln_gamma": np.ones(embed),
         "final_ln_beta": np.zeros(embed),
         "lm_head_weight": rs.randn(vocab, embed) * 0.3,
         "lm_head_bias": np.zeros(vocab)}
    for i in range(2):
        pre = "layer%d" % i
        p[pre + "_ln1_gamma"] = np.ones(embed)
        p[pre + "_ln1_beta"] = np.zeros(embed)
        p[pre + "_ln2_gamma"] = np.ones(embed)
        p[pre + "_ln2_beta"] = np.zeros(embed)
        p[pre + "_attn_qkv_weight"] = rs.randn(3 * embed, embed) * 0.2
        p[pre + "_attn_qkv_bias"] = np.zeros(3 * embed)
        p[pre + "_attn_out_weight"] = rs.randn(embed, embed) * 0.2
        p[pre + "_attn_out_bias"] = np.zeros(embed)
        p[pre + "_ffn_fc1_weight"] = rs.randn(4 * embed, embed) * 0.2
        p[pre + "_ffn_fc1_bias"] = np.zeros(4 * embed)
        p[pre + "_ffn_fc2_weight"] = rs.randn(embed, 4 * embed) * 0.2
        p[pre + "_ffn_fc2_bias"] = np.zeros(embed)
    return {k: __import__("numpy").asarray(v, "float32")
            for k, v in p.items()}


def _serve_draft_params():
    """A 1-layer draft sibling of :func:`_serve_lm_params` (same vocab/
    embed) so the serve scenario exercises the speculative-decode round —
    the ``serve.spec_verify`` site only fires between a draft chain and
    its target verify pass."""
    import numpy as np
    rs = np.random.RandomState(7)
    embed, vocab, max_len = 16, 32, 24
    p = {"tok_embed_weight": rs.randn(vocab, embed) * 0.3,
         "pos_embed_weight": rs.randn(max_len, embed) * 0.1,
         "final_ln_gamma": np.ones(embed),
         "final_ln_beta": np.zeros(embed),
         "lm_head_weight": rs.randn(vocab, embed) * 0.3,
         "lm_head_bias": np.zeros(vocab),
         "layer0_ln1_gamma": np.ones(embed),
         "layer0_ln1_beta": np.zeros(embed),
         "layer0_ln2_gamma": np.ones(embed),
         "layer0_ln2_beta": np.zeros(embed),
         "layer0_attn_qkv_weight": rs.randn(3 * embed, embed) * 0.2,
         "layer0_attn_qkv_bias": np.zeros(3 * embed),
         "layer0_attn_out_weight": rs.randn(embed, embed) * 0.2,
         "layer0_attn_out_bias": np.zeros(embed),
         "layer0_ffn_fc1_weight": rs.randn(4 * embed, embed) * 0.2,
         "layer0_ffn_fc1_bias": np.zeros(4 * embed),
         "layer0_ffn_fc2_weight": rs.randn(embed, 4 * embed) * 0.2,
         "layer0_ffn_fc2_bias": np.zeros(embed)}
    return {k: np.asarray(v, "float32") for k, v in p.items()}


def worker_serve(plan, out_path, workdir):
    import numpy as np
    import mxnet_tpu_torch as mx
    from .. import faults, serving
    from ..serving.batcher import (ServingDeadlineError,
                                   ServingOverloadedError)

    result = {"scenario": "serve"}
    base = _health_snapshot()
    device = _context(mx).to_device()

    def _engine():
        rs = np.random.RandomState(0)
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=8,
                                    name="fc1")
        net = mx.sym.Activation(net, act_type="relu", name="relu1")
        net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
        net = mx.sym.SoftmaxOutput(net, name="softmax")
        params = {"arg:fc1_weight": rs.randn(8, 6).astype("float32") * .5,
                  "arg:fc1_bias": rs.randn(8).astype("float32") * .1,
                  "arg:fc2_weight": rs.randn(4, 8).astype("float32") * .5,
                  "arg:fc2_bias": rs.randn(4).astype("float32") * .1}
        return serving.ServingEngine(net, params, {"data": (6,)},
                                     buckets=(4, 8), device=device)

    settle = {"submitted": 0, "completed": 0, "expired": 0, "shed": 0,
              "failed": 0, "unsettled": 0}
    futures = []
    try:
        router = serving.FleetRouter(
            [serving.Batcher(_engine(), max_latency_ms=1.0),
             serving.Batcher(_engine(), max_latency_ms=1.0)])
        faults.arm(plan.faults)
        xs = np.random.RandomState(1).rand(64, 6).astype("float32")
        # open-loop: a paced submit burst the router must fully settle —
        # whatever the plan kills underneath it
        for i in range(40):
            pri = "interactive" if i % 3 else "batch"
            n = 1 + (i % 3)
            settle["submitted"] += 1
            try:
                futures.append(router.submit(
                    {"data": xs[i % 60:i % 60 + n]}, priority=pri,
                    deadline_ms=4000.0))
            except ServingOverloadedError:
                settle["shed"] += 1
            except MXNetError:
                settle["failed"] += 1
            time.sleep(0.002)
        # DecodeLoop leg: continuous-batching decode under the same plan
        loop = serving.DecodeLoop(_serve_lm_params(), 2, 4, 24, slots=2,
                                  device=device)
        for prompt in ([3, 5, 7], [2, 4], [9, 1, 6]):
            settle["submitted"] += 1
            try:
                futures.append(loop.generate(prompt, 4,
                                             temperature=0.7, seed=11))
            except MXNetError:
                settle["failed"] += 1
        # speculative leg: draft-K-then-verify rounds, so the
        # serve.sample / serve.spec_verify sites are both reachable
        sloop = serving.DecodeLoop(
            _serve_lm_params(), 2, 4, 24, slots=2, spec_k=2,
            draft_params=_serve_draft_params(), draft_num_layers=1,
            device=device)
        for prompt in ([4, 8, 2], [6, 3]):
            settle["submitted"] += 1
            try:
                futures.append(sloop.generate(prompt, 4))
            except MXNetError:
                settle["failed"] += 1
        for fut in futures:
            try:
                fut.result(timeout=20.0)
                settle["completed"] += 1
            except ServingDeadlineError:
                settle["expired"] += 1
            except ServingOverloadedError:
                settle["shed"] += 1
            except MXNetError as e:
                if "timed out" in str(e):
                    settle["unsettled"] += 1   # the future NEVER resolved
                else:
                    settle["failed"] += 1
        sloop.close()
        loop.close()
        router.close()
    except Exception as exc:
        result.update(_error_facts(exc))
    finally:
        _capture_faults(plan, result)
        faults.clear()
    result["settle"] = settle
    _finish(out_path, plan, base, result)


# -- dist -------------------------------------------------------------------

def worker_dist_rank(plan, out_dir, workdir):
    """One rank of the 3-process dist_sync fit (spawned by the port's
    launcher; MXTPU_RANK in env): full-dataset reshard hook, per-rank
    prefix, emergency checkpoint and ring re-form when the plan kills a
    peer. Records, for each ring generation, the seconds from the fit's
    start to its first and its last step (a re-form's recovery time is the
    new generation's first step less the old one's last: the victim dies
    at the top of the next collective)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from .. import faults, kvstore_server
    from ..io import NDArrayIter

    assert mx.tools_init_distributed(), "MXTPU_* env missing"
    rank = kvstore_server.plane()["rank"]
    nproc = kvstore_server.plane()["size"]
    out_path = os.path.join(out_dir, "rank%d.json" % rank)
    os.environ["MXTPU_FLIGHT_RECORDER_PATH"] = os.path.join(
        out_dir, "flight-dist-r%d.json" % rank)
    result = {"scenario": "dist", "rank": rank}
    base = _health_snapshot()

    n_class, dim, n_per = 4, 16, 96
    batch_size = 32
    rng = np.random.RandomState(7)  # same on all ranks
    templates = rng.randn(n_class, dim).astype(np.float32) * 3
    labels_all = np.arange(n_class * n_per) % n_class
    x_all = (templates[labels_all]
             + rng.randn(len(labels_all), dim).astype(np.float32) * 0.5)

    class ElasticIter(NDArrayIter):
        def reshard_workers(self, part_index, num_parts):
            ElasticIter.__init__(
                self, x_all[part_index::num_parts],
                labels_all[part_index::num_parts].astype(np.float32),
                batch_size=batch_size, shuffle=False)

    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, name="fc1", num_hidden=32)
    h = mx.sym.Activation(h, name="relu1", act_type="relu")
    h = mx.sym.FullyConnected(h, name="fc2", num_hidden=n_class)
    net = mx.sym.SoftmaxOutput(h, name="softmax")

    faults.arm(plan.rules_for_rank(rank))
    prefix = os.path.join(workdir, "r%d" % rank, "chaos")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    mod = mx.mod.Module(net, context=_context(mx))
    train = ElasticIter(x_all[rank::nproc],
                        labels_all[rank::nproc].astype(np.float32),
                        batch_size=batch_size, shuffle=False)
    t0 = time.time()
    steps = {}

    def _clock(param):
        gen = str(int(getattr(mod._kvstore, "reforms", 0) or 0))
        now = time.time() - t0
        steps.setdefault(gen, [now, now])[1] = now

    try:
        mod.fit(train, num_epoch=6, kvstore="dist_sync",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mx.initializer.Xavier(),
                checkpoint_prefix=prefix, checkpoint_keep=50,
                batch_end_callback=_clock)
        result["final_hash"] = _hash_params(mod)
        kv = mod._kvstore
        result["reforms"] = getattr(kv, "reforms", 0)
        result["num_workers"] = getattr(kv, "num_workers", nproc)
    except Exception as exc:
        result.update(_error_facts(exc))
    finally:
        _capture_faults(plan, result)
        faults.clear()
    result["generation_steps_s"] = steps
    _finish(out_path, plan, base, result)

    # rank 0 hosts the store, so it exits last (its wait skips the peers
    # whose heartbeat is stale); then skip the orderly shutdown, which a
    # dead peer would wedge
    from .. import kvstore_server
    kvstore_server._exit_sync()
    os._exit(0)
