"""The port's kvstore fault policy and dist modes
(``mxnet_tpu_torch.kvstore``) against the JAX package's
``mxnet_tpu.kvstore``, on the CPU.

- The fault policy: the same injected faults (``kvstore.push``,
  ``kvstore.pull``, ``kvstore.barrier``, ``kvstore.dead_node``) through
  each package's local store give the same values, the same retry and
  escalation messages, ``KVStoreTimeoutError.started`` and the same
  ``check_health`` strikes.
- ``KVStoreDistAsync`` on one in-memory plane (threads as workers, a fixed
  interleaving of pushes and pulls): the pulled values and the staleness
  lag equal the JAX package's exactly.
- The dist modes without the launcher's environment are one-worker
  stores in both packages; the server role is refused with the JAX
  package's message; a set ``MXTPU_COORD`` that cannot be reached raises.
- Two processes started by the port's launcher (``python -m
  mxnet_tpu_torch.tools.launch``, a free port each run): the dist_sync and
  dist_async closed forms, the legacy mesh transport, the four
  multi-process mesh helpers over gloo, and a ``dist_async`` fit. This file is also that worker
  (``python tests/test_torch_kvstore_dist.py worker OUT``).

Tolerance: exact (the values are small integers in float32, the messages
strings); each subprocess run has its own time limit.
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker(out_dir):
    """One rank of the two-process drill: writes rank<r>.json."""
    sys.path.insert(0, ROOT)
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    from mxnet_tpu_torch.parallel import mesh as tmesh

    assert mt.tools_init_distributed()
    plane = kvstore_server.plane()
    rank, n = plane["rank"], plane["size"]
    res = {"rank": rank, "size": n}
    with mt.cpu():
        kv = mt.kv.create("dist_sync")
        res["sync_workers"] = kv.num_workers
        kv.init(0, mt.nd.array(np.full(3, 10.0 * (rank + 1), np.float32)))
        out = mt.nd.zeros((3,))
        kv.pull(0, out=out)
        res["sync_init"] = out.asnumpy().tolist()      # rank 0's value
        kv.push(0, [mt.nd.ones((3,)) * (rank + 1)] * 2)
        kv.pull(0, out=out)
        res["sync_push"] = out.asnumpy().tolist()      # 2 * (1 + 2)
        kv.barrier()
        res["sync_dead"] = kv.num_dead_node(0)

        akv = mt.kv.create("dist_async")
        akv.init(5, mt.nd.array(np.full(2, 7.0 * (rank + 1), np.float32)))
        akv.push(5, mt.nd.ones((2,)) * (rank + 1))
        akv.barrier()
        akv.pull(5, out=(o := mt.nd.zeros((2,))))
        res["async_pull"] = o.asnumpy().tolist()       # 1 + 2

        mesh = tmesh.global_data_mesh(local_devices=["cpu"])
        res["mesh"] = [tmesh.is_multiprocess(mesh), mesh.nproc, mesh.rank]
        g = tmesh.host_to_global(mesh, tmesh.P("data"),
                                 np.full((2, 2), float(rank), np.float32))
        res["global"] = g.data.tolist()
        res["local"] = tmesh.local_view(g).tolist()
        res["bcast"] = tmesh.host_broadcast0(
            mesh, np.array([rank + 5], np.int64)).tolist()
        res["grad_sync"] = tmesh.grad_sync(
            {"w": torch.full((2,), float(rank + 1))})["w"].tolist()
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)


def _mesh_transport_worker(out_dir):
    """The legacy ``MXTPU_DIST_TRANSPORT=mesh`` push: summed over gloo."""
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    assert mt.tools_init_distributed()
    rank = kvstore_server.plane()["rank"]
    with mt.cpu():
        kv = mt.kv.create("dist_sync")
        kv.init(0, mt.nd.array(np.full(3, 4.0 * (rank + 1), np.float32)))
        out = mt.nd.zeros((3,))
        kv.pull(0, out=out)
        first = out.asnumpy().tolist()
        kv.push(0, mt.nd.ones((3,)) * (rank + 1))
        kv.pull(0, out=out)
        res = {"ring": kv._ring is None, "init": first,
               "push": out.asnumpy().tolist()}
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)


def _async_fit_worker(out_dir):
    """A ``fit(kvstore="dist_async")`` of the chaos dist scenario's MLP
    on this rank's shard of its (shuffled) data."""
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    assert mt.tools_init_distributed()
    rank, n = kvstore_server.plane()["rank"], kvstore_server.plane()["size"]
    rng = np.random.RandomState(7)
    templates = rng.randn(4, 16).astype(np.float32) * 3
    y = (np.arange(384) % 4).astype(np.float32)
    x = templates[y.astype(int)] + rng.randn(384, 16).astype(
        np.float32) * 0.5
    order = np.random.RandomState(0).permutation(384)
    x, y = x[order], y[order]
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=32,
                                name="fc1")
    net = mt.sym.Activation(net, act_type="relu", name="relu1")
    net = mt.sym.FullyConnected(net, num_hidden=4, name="fc2")
    net = mt.sym.SoftmaxOutput(net, name="softmax")
    mod = mt.mod.Module(net, context=mt.cpu())
    lags = []
    mod.fit(mt.io.NDArrayIter(x[rank::n], y[rank::n], batch_size=32),
            num_epoch=4, kvstore="dist_async",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mt.initializer.Xavier(),
            batch_end_callback=lambda p: lags.append(
                mod._kvstore.staleness_lag))
    acc = dict(mod.score(mt.io.NDArrayIter(x, y, batch_size=32), "acc"))
    res = {"fused": mod._fused is not None, "type": mod._kvstore.type,
           "workers": mod._kvstore.num_workers, "max_lag": max(lags),
           "staleness": mod._kvstore.staleness,
           "accuracy": acc["accuracy"],
           "versions": sorted(set(mod._kvstore._ver.values()))}
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)


if __name__ == "__main__" and len(sys.argv) > 1:
    {"worker": _worker, "mesh": _mesh_transport_worker,
     "async_fit": _async_fit_worker}[sys.argv[1]](sys.argv[2])
    sys.exit(0)

import pytest  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.faults as jfaults  # noqa: E402
import mxnet_tpu.kvstore as jkv  # noqa: E402
from mxnet_tpu import nd as jnd  # noqa: E402
from mxnet_tpu.dist_ring import LocalClient as JLocal  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
import mxnet_tpu_torch.faults as tfaults  # noqa: E402
import mxnet_tpu_torch.kvstore as tkv  # noqa: E402
from mxnet_tpu_torch.dist_ring import LocalClient as TLocal  # noqa: E402

PKGS = {"jax": (jkv, jfaults, lambda a: jnd.array(a), JLocal),
        "torch": (tkv, tfaults, lambda a: mt.nd.array(a, ctx=mt.cpu()),
                  TLocal)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for v in ("MXTPU_COORD", "MXTPU_RANK", "MXTPU_NPROC"):
        monkeypatch.delenv(v, raising=False)
    for _, faults, _, _ in PKGS.values():
        faults.clear()
    yield
    for _, faults, _, _ in PKGS.values():
        faults.clear()


def _both(scenario):
    return {name: scenario(*mods) for name, mods in PKGS.items()}


def _local(kv_mod, arr):
    kv = kv_mod.create("local")
    kv.set_fault_policy(retries=2, backoff=0.0)
    kv.init(0, arr(np.ones(3, np.float32)))
    return kv


def _pull(kv, arr, k=0, n=3):
    out = arr(np.zeros(n, np.float32))
    kv.pull(k, out=out)
    return out.asnumpy().tolist()


# -- the fault policy -----------------------------------------------------------

@pytest.mark.parametrize("case", ["push_transient", "push_budget",
                                  "pull_drop", "push_delay_deadline"])
def test_fault_policy_retries_match_jax(case, caplog):
    def scenario(kv_mod, faults, arr, _):
        kv = _local(kv_mod, arr)
        if case == "push_transient":
            faults.inject("kvstore.push", nth=1, kind="transient")
            kv.push(0, arr(np.full(3, 5.0, np.float32)))
            return _pull(kv, arr), faults.count("kvstore.push")
        if case == "push_budget":
            faults.inject("kvstore.push", nth=1, kind="transient", times=99)
            with pytest.raises(Exception) as ei:
                kv.push(0, arr(np.ones(3, np.float32)))
            return str(ei.value).split(":")[0], faults.count("kvstore.push")
        if case == "pull_drop":
            faults.inject("kvstore.pull", nth=1, kind="drop")
            return _pull(kv, arr), faults.fired("kvstore.pull")
        # a completed push past its deadline only warns, never retries
        kv.set_fault_policy(timeout=0.01)
        faults.inject("kvstore.push", nth=1, kind="delay", delay=0.05)
        kv.push(0, arr(np.full(3, 2.0, np.float32)))
        return _pull(kv, arr), faults.count("kvstore.push")

    got = _both(scenario)
    assert got["torch"] == got["jax"]
    if case == "push_budget":
        assert got["torch"][0] == "kvstore.push failed after 3 attempts " \
                                  "(retry budget 2 exhausted)"


def test_barrier_timeout_escalates_without_reentry():
    def scenario(kv_mod, faults, arr, _):
        kv = kv_mod.create("local")
        kv.set_fault_policy(timeout=0.05, retries=3, backoff=0.0)
        held = {"v": True}
        entries = []

        def slow_barrier():
            entries.append(1)
            t0 = time.monotonic()
            while held["v"] and time.monotonic() - t0 < 5:
                time.sleep(0.005)

        kv._barrier = slow_barrier
        try:
            with pytest.raises(Exception) as ei:
                kv.barrier()
        finally:
            held["v"] = False
        cause = ei.value.__cause__
        return (type(ei.value).__name__, str(ei.value).split(":")[0],
                type(cause).__name__, cause.started, len(entries))

    got = _both(scenario)
    assert got["torch"] == got["jax"]
    assert got["torch"] == ("MXNetError", "kvstore.barrier timed out after "
                            "it started (attempt 1)", "KVStoreTimeoutError",
                            True, 1)


def test_barrier_transient_is_retried():
    def scenario(kv_mod, faults, arr, _):
        kv = kv_mod.create("local")
        kv.set_fault_policy(retries=2, backoff=0.0)
        faults.inject("kvstore.barrier", nth=1, kind="transient")
        kv.barrier()
        return faults.count("kvstore.barrier"), faults.fired("kvstore.barrier")

    got = _both(scenario)
    assert got["torch"] == got["jax"] == (2, 1)


def test_timeout_error_started_attribute():
    for kv_mod in (jkv, tkv):
        assert kv_mod.KVStoreTimeoutError("x").started is False
        assert kv_mod.KVStoreTimeoutError("x", started=True).started is True
    assert issubclass(tkv.WorkerLostError, mt.base.MXNetError)
    assert issubclass(tkv.KVStoreTimeoutError, mt.base.MXNetError)


def test_check_health_strikes_under_dead_node_match_jax():
    def scenario(kv_mod, faults, arr, _):
        kv = kv_mod.create("local")
        kv.set_fault_policy(health_interval=0.0)
        faults.inject("kvstore.dead_node", nth=1, kind="dead:2", times=2)
        cps = []
        seen = [kv.check_health(on_degraded=lambda: cps.append(1),
                                force=True) for _ in range(2)]
        seen.append(kv.check_health(force=True))   # healthy: resets
        faults.inject("kvstore.dead_node", nth=1, kind="dead:1", times=99)
        seen += [kv.check_health(force=True) for _ in range(2)]
        with pytest.raises(kv_mod.WorkerLostError) as ei:
            kv.check_health(force=True)
        return seen, cps, kv._dead_strikes, str(ei.value)

    got = _both(scenario)
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == ([2, 2, 0, 1, 1], [1], 3)


def test_fault_policy_env_defaults_and_throttle_match_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_KV_TIMEOUT", "1.5")
    monkeypatch.setenv("MXTPU_KV_RETRIES", "5")
    monkeypatch.setenv("MXTPU_KV_BACKOFF", "0.01")
    monkeypatch.setenv("MXTPU_KV_BACKOFF_MAX", "0.25")
    monkeypatch.setenv("MXTPU_KV_HEALTH_INTERVAL", "3600")
    monkeypatch.setenv("MXTPU_KV_DEAD_TIMEOUT", "7")

    def scenario(kv_mod, faults, arr, _):
        kv = kv_mod.create("local")
        got = [kv._timeout, kv._retries, kv._backoff, kv._backoff_max,
               kv._health_interval, kv._dead_timeout]
        assert kv.check_health(force=True) == 0
        kv.num_dead_node = lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("scan not throttled"))
        got.append(kv.check_health())
        kv.set_fault_policy(timeout=None, retries=1)
        return got + [kv._timeout, kv._retries]

    got = _both(scenario)
    assert got["torch"] == got["jax"] == [1.5, 5, 0.01, 0.25, 3600.0, 7.0,
                                          0, None, 1]
    monkeypatch.setenv("MXTPU_KV_TIMEOUT", "soon")
    with pytest.raises(mt.base.MXNetError, match="MXTPU_KV_TIMEOUT"):
        tkv.create("local")


def test_heartbeat_grace_then_staleness():
    """A peer that never beat is not dead within the startup grace, a
    peer seen once and then silent is, and a stale stamp is."""
    client = TLocal()
    hb = tkv._Heartbeat(0, client_factory=lambda: client)
    hb.stop()
    assert hb.dead_nodes(2, timeout_sec=60) == 0
    client.set(tkv._Heartbeat.KEY % 1, repr(time.time()))
    assert hb.dead_nodes(2, timeout_sec=60) == 0
    client.delete(tkv._Heartbeat.KEY % 1)
    assert hb.dead_nodes(2, timeout_sec=60) == 1
    client.set(tkv._Heartbeat.KEY % 1, repr(time.time() - 120))
    assert hb.dead_nodes(2, timeout_sec=60) == 1
    late = tkv._Heartbeat(0, startup_grace=0.0,
                          client_factory=lambda: TLocal())
    late.stop()
    time.sleep(0.01)
    assert late.dead_nodes(2, timeout_sec=60) == 1
    assert tkv._Heartbeat(0, client_factory=lambda: None).dead_nodes(
        2, 60) == 0


# -- dist_async on one plane ------------------------------------------------------

def _async_pair(kv_mod, Local, staleness, timeout=30.0):
    c = Local()
    kvs = [kv_mod.KVStoreDistAsync(_plane=(c, r, 2)) for r in range(2)]
    for kv in kvs:
        kv.staleness = staleness
        kv._poll = 0.0
        kv._pull_timeout = timeout
    return c, kvs


def test_dist_async_fixed_interleaving_matches_jax():
    """Pushes and pulls in one fixed order on one plane, with an updater
    and without: every pulled value and lag equals the JAX package's."""
    rs = np.random.RandomState(5)
    pushes = [rs.randn(4).astype(np.float32) for _ in range(6)]
    order = [(0, "push", 0), (1, "pull", None), (0, "push", 1),
             (0, "pull", None), (1, "push", 2), (1, "pull", None),
             (0, "push", 3), (0, "pull", None), (1, "push", 4),
             (0, "pull", None), (1, "pull", None), (1, "push", 5),
             (0, "pull", None), (1, "pull", None)]

    def scenario(kv_mod, faults, arr, Local):
        got = []
        for updater in (False, True):
            c, kvs = _async_pair(kv_mod, Local, staleness=2)
            kvs[0].init(3, arr(np.full(4, 0.5, np.float32)))
            kvs[1].init(3, arr(np.zeros(4, np.float32)))
            if updater:
                for kv in kvs:
                    kv._set_updater(
                        lambda k, g, s: s._set_data(s.data - 0.1 * g.data))
            for r, op, i in order:
                if op == "push":
                    kvs[r].push(3, arr(pushes[i]))
                else:
                    got.append((_pull(kvs[r], arr, 3, 4),
                                kvs[r].staleness_lag))
        return got

    got = _both(scenario)
    assert got["torch"] == got["jax"]


def test_dist_async_window_gates_and_drops_dead_laggard():
    def scenario(kv_mod, faults, arr, Local):
        c, (kv0, kv1) = _async_pair(kv_mod, Local, staleness=1,
                                    timeout=0.05)
        kv0.init(3, arr(np.zeros(4, np.float32)))
        kv1.init(3, arr(np.zeros(4, np.float32)))
        kv1.push(3, arr(np.full(4, 9.0, np.float32)))
        for _ in range(3):
            kv0.push(3, arr(np.ones(4, np.float32)))
        with pytest.raises(Exception) as ei:
            _pull(kv0, arr, 3, 4)
        msg = str(ei.value)
        c.mark_dead(1)
        kv0._pull_timeout = 30.0
        return ("window S=1" in msg, _pull(kv0, arr, 3, 4), kv0.num_workers,
                kv0.num_dead_node(0))

    got = _both(scenario)
    assert got["torch"] == got["jax"] == (True, [10.0] * 4, 1, 1)


def test_dist_async_blocked_pull_unblocks_when_the_laggard_pushes():
    c, (kv0, kv1) = _async_pair(tkv, TLocal, staleness=1)
    arr = PKGS["torch"][2]
    kv0.init(3, arr(np.zeros(4, np.float32)))
    kv1.init(3, arr(np.zeros(4, np.float32)))
    kv0.push(3, arr(np.ones(4, np.float32)))
    kv0.push(3, arr(np.ones(4, np.float32)))
    t = threading.Thread(target=lambda: kv1.push(
        3, arr(np.full(4, 3.0, np.float32))), daemon=True)
    t.start()
    got = _pull(kv0, arr, 3, 4)
    t.join(30)
    assert got == [4.0] * 4 and kv0.staleness_lag <= 1


# -- the dist modes in one process, the server entry --------------------------

@pytest.mark.parametrize("name", ["dist_sync", "dist_device_sync",
                                  "dist_async"])
def test_dist_modes_without_a_launcher_are_one_worker_stores(name):
    def scenario(kv_mod, faults, arr, _):
        kv = kv_mod.create(name)
        kv.init(0, arr(np.zeros(2, np.float32)))
        kv.push(0, [arr(np.ones(2, np.float32)) * 3,
                    arr(np.ones(2, np.float32))])
        out = _pull(kv, arr, 0, 2)
        kv.barrier()
        return (type(kv).__name__, kv.type, kv.rank, kv.num_workers, out,
                kv.num_dead_node(0), kv.staleness_lag)

    got = _both(scenario)
    assert got["torch"] == got["jax"]
    assert got["torch"][4] == [4.0, 4.0]


def test_server_role_is_refused_with_the_jax_message(monkeypatch):
    import mxnet_tpu.kvstore_server as jserver
    from mxnet_tpu_torch import kvstore_server as tserver
    monkeypatch.setenv("DMLC_ROLE", "server")
    msgs = []
    for mod in (jserver, tserver):
        with pytest.raises(RuntimeError) as ei:
            mod._init_kvstore_server_module()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    monkeypatch.delenv("DMLC_ROLE")
    assert mt.tools_init_distributed() is False      # no launcher env
    assert tserver.plane() is None


def test_unreachable_coordinator_raises(monkeypatch):
    from mxnet_tpu_torch import kvstore_server as tserver
    monkeypatch.setenv("MXTPU_COORD", "127.0.0.1:%d" % _free_port())
    monkeypatch.setenv("MXTPU_RANK", "1")
    monkeypatch.setenv("MXTPU_NPROC", "2")
    monkeypatch.setenv("MXTPU_INIT_TIMEOUT", "1")
    t0 = time.monotonic()
    with pytest.raises(mt.base.MXNetError, match="could not reach"):
        tserver.init_distributed()
    assert time.monotonic() - t0 < 30
    assert tserver.plane() is None


# -- two processes through the port's launcher -----------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(mode, out_dir, n=2, env=None, timeout=120):
    e = dict(os.environ)
    e.update(env or {})
    e["PYTHONPATH"] = ROOT + os.pathsep + e.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
           str(n), "--coord-port", str(_free_port()),
           "%s %s %s %s" % (sys.executable, os.path.abspath(__file__), mode,
                            out_dir)]
    r = subprocess.run(cmd, env=e, capture_output=True, text=True,
                       timeout=timeout, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    return [json.load(open(os.path.join(out_dir, "rank%d.json" % k)))
            for k in range(n)]


def test_two_processes_closed_forms_and_mesh_helpers(tmp_path):
    res = _launch("worker", str(tmp_path))
    for rank, r in enumerate(res):
        assert r["rank"] == rank and r["size"] == 2
        assert r["sync_workers"] == 2
        assert r["sync_init"] == [10.0] * 3
        assert r["sync_push"] == [6.0] * 3
        assert r["sync_dead"] == 0
        assert r["async_pull"] == [3.0] * 2
        assert r["mesh"] == [True, 2, rank]
        assert r["global"] == [[0.0, 0.0], [0.0, 0.0], [1.0, 1.0],
                               [1.0, 1.0]]
        assert r["local"] == [[float(rank)] * 2] * 2
        assert r["bcast"] == [5]
        assert r["grad_sync"] == [3.0, 3.0]


def test_mesh_transport_sums_over_gloo(tmp_path):
    res = _launch("mesh", str(tmp_path),
                  env={"MXTPU_DIST_TRANSPORT": "mesh"})
    for r in res:
        assert r == {"ring": True, "init": [4.0] * 3, "push": [3.0] * 3}


def test_two_process_dist_async_fit_trains_through_the_store(tmp_path):
    """A ``dist_async`` fit across two processes trains through the
    kvstore's push and pull (the JAX package's fused step would sum over
    its global mesh instead, never reading the store): every push is
    versioned (4 epochs of 6 batches), the lag stays in the window, and
    each rank's model classifies the whole set at 0.95 or better."""
    res = _launch("async_fit", str(tmp_path),
                  env={"MXTPU_KV_STALENESS": "4"})
    for r in res:
        assert r["fused"] is False and r["type"] == "dist_async"
        assert r["workers"] == 2 and r["staleness"] == 4
        assert r["versions"] == [24]
        assert 0 <= r["max_lag"] <= 4
        assert r["accuracy"] >= 0.95
