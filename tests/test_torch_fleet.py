"""The port's fleet tier against the JAX package's.

Each test is the counterpart of one test of ``tests/test_fleet.py`` other
than the model-axis-sharded ones (a sharded engine needs several cards),
run on the port's ``FleetRouter`` and ``Batcher`` over CPU engines: the
integer env knobs, the batcher's close/submit race, deadline-faithful
``wait``, ``on_done`` and ``take_queued``; least-loaded dispatch, strict
priority with per-class deadlines and queue bounds, drain, join with its
signature check, death re-queue, close and the health rollup. Added:
``update_params`` across replicas, ``weight_report`` and the audits that
raise. The MLP and weights are the JAX tests'; served rows are held
bitwise against the port's own engine and within ``ATOL`` against the JAX
package's engine on the same rows (f32 matmuls of another library).
Threaded tests wait on gates (events), as the JAX ones do.
"""
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import faults, serving
from mxnet_tpu_torch.base import MXNetError, env_int

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _mlp_sym(pkg):
    net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=8,
                                 name="fc1")
    net = pkg.sym.Activation(net, act_type="relu", name="relu1")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _mlp_params(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "arg:fc1_weight": rs.randn(8, 6).astype(np.float32) * 0.5,
        "arg:fc1_bias": rs.randn(8).astype(np.float32) * 0.1,
        "arg:fc2_weight": rs.randn(4, 8).astype(np.float32) * 0.5,
        "arg:fc2_bias": rs.randn(4).astype(np.float32) * 0.1,
    }


def _engine(buckets=(4, 8), params=None, **kw):
    return serving.ServingEngine(_mlp_sym(mt),
                                 params or _mlp_params(), {"data": (6,)},
                                 buckets=buckets, device="cpu", **kw)


def _batcher(**kw):
    kw.setdefault("max_latency_ms", 1.0)
    return serving.Batcher(_engine(), **kw)


def _x(n, seed=1):
    return np.random.RandomState(seed).rand(n, 6).astype(np.float32)


def _jax_infer(x, params=None):
    eng = jserving.ServingEngine(_mlp_sym(mx), params or _mlp_params(),
                                 {"data": (6,)}, buckets=(4, 8))
    return eng.infer({"data": x})[0]


class _GatedEngine(object):
    """Engine proxy whose dispatches block until ``gate`` is set — lets a
    test hold a replica busy without sleeps."""

    def __init__(self, engine):
        self._engine = engine
        self.gate = threading.Event()

    def infer(self, inputs):
        self.gate.wait(10.0)
        return self._engine.infer(inputs)

    def __getattr__(self, name):
        return getattr(self._engine, name)


# ---------------------------------------------------------------------------
# env_int, close/submit race, wait() deadline fidelity
# ---------------------------------------------------------------------------

def test_env_int_rejects_non_integer_spellings(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_QUEUE", "64")
    assert env_int("MXTPU_SERVE_QUEUE", 256) == 64
    for bad in ("256.5", "junk", "1e3"):
        monkeypatch.setenv("MXTPU_SERVE_QUEUE", bad)
        with pytest.raises(MXNetError, match="MXTPU_SERVE_QUEUE"):
            env_int("MXTPU_SERVE_QUEUE", 256)
    monkeypatch.setenv("MXTPU_SERVE_QUEUE", "")
    assert env_int("MXTPU_SERVE_QUEUE", 256) == 256


def test_batcher_rejects_non_integer_queue_env(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_QUEUE", "12.7")
    with pytest.raises(MXNetError, match="MXTPU_SERVE_QUEUE"):
        _batcher(start=False)


def test_fleet_rejects_non_integer_queue_env(monkeypatch):
    monkeypatch.setenv("MXTPU_FLEET_QUEUE", "big")
    with pytest.raises(MXNetError, match="MXTPU_FLEET_QUEUE"):
        serving.FleetRouter([_batcher(start=False)])


def test_batcher_close_submit_race_never_orphans_a_request():
    """A submit that passed the _closed check can no longer enqueue AFTER
    close()'s final shed — every accepted request settles (shed or
    served), and post-close submits fail fast. Hammered across
    interleavings."""
    eng = _engine()
    for _ in range(30):
        b = serving.Batcher(eng, max_latency_ms=1.0, start=False)
        accepted = []
        errors = []

        def submitter():
            for _ in range(4):
                try:
                    accepted.append(b.submit({"data": _x(1)}))
                except serving.ServingClosedError:
                    errors.append("closed")

        t1 = threading.Thread(target=submitter)
        t2 = threading.Thread(target=b.close)
        t1.start(); t2.start()
        t1.join(5.0); t2.join(5.0)
        assert not t1.is_alive() and not t2.is_alive()
        deadline = time.monotonic() + 2.0
        for req in accepted:
            assert req.event.wait(max(0.0, deadline - time.monotonic())), \
                "request accepted by submit() was never settled"
        with pytest.raises(serving.ServingClosedError):
            b.submit({"data": _x(1)})


def test_batcher_wait_tracks_actual_deadline_not_poll_quantum():
    """wait() sleeps toward the request's real remaining deadline: a
    120 ms deadline resolves at ~120 ms, not rounded up to a poll grid."""
    b = _batcher(start=False)     # parked: nothing will serve it
    req = b.submit({"data": _x(1)}, deadline_ms=120.0)
    t0 = time.monotonic()
    with pytest.raises(serving.ServingDeadlineError):
        b.wait(req)
    elapsed = time.monotonic() - t0
    assert 0.10 <= elapsed < 0.17, elapsed
    b.close()


def test_batcher_on_done_fires_exactly_once():
    calls = []
    b = _batcher(start=False)
    req = b.submit({"data": _x(1)}, on_done=calls.append)
    b.close()                     # settles it (shed)
    assert calls == [req]
    assert req.error is not None
    # double-settle attempts are no-ops
    assert not req.fail(RuntimeError("late"))
    assert calls == [req]

    done = []
    b2 = _batcher()
    r2 = b2.submit({"data": _x(2)}, on_done=done.append)
    out = b2.wait(r2)
    assert out[0].shape == (2, 4)
    np.testing.assert_allclose(out[0], _jax_infer(_x(2)), rtol=0, atol=ATOL)
    assert done == [r2]
    b2.close()


def test_batcher_take_queued_returns_without_failing():
    b = _batcher(start=False)
    r1 = b.submit({"data": _x(1)})
    r2 = b.submit({"data": _x(1)})
    taken = b.take_queued()
    assert taken == [r1, r2]
    assert not r1.event.is_set() and not r2.event.is_set()
    assert b.backlog() == 0
    b.close()


def test_single_card_engine_and_the_audits_that_raise():
    """The JAX single-chip engine reports no collectives, and neither does
    the port's engine on one device: ``comms_report`` (a shape-only dry run
    of each bucket) holds zero collectives under the JAX package's program
    names, ``check(comms=True)`` finds nothing, and ``FleetRouter.check``
    (every in-rotation replica's ``check``) neither; ``memory_report`` (a
    shape-only dry run): each bucket's arguments are the weights plus a
    bucket of inputs. (The name predates the communication analyzer, when
    these audits raised.)"""
    eng = _engine()
    assert eng.model_devices == 1
    jeng = jserving.ServingEngine(_mlp_sym(mx), _mlp_params(),
                                  {"data": (6,)}, buckets=(4, 8))
    creps, jcreps = eng.comms_report(), jeng.comms_report()
    tags = [n.split("/", 1)[1] for n in sorted(creps)]
    assert tags == [n.split("/", 1)[1] for n in sorted(jcreps)] == [
        "bucket[b=4]", "bucket[b=8]"]
    for rep in list(creps.values()) + list(jcreps.values()):
        assert rep.collective_count == 0 and rep.entries == []
        assert rep.predicted_efficiency == 1.0
    assert eng.check(comms=True) == []
    reps = eng.memory_report()
    assert sorted(reps) == [4, 8]
    for b, rep in reps.items():
        assert rep.program == "%s/bucket[b=%d]" % (eng.name, b)
        assert rep.argument_bytes == eng.weight_bytes() + b * 6 * 4
    router = serving.FleetRouter([serving.Batcher(eng, max_latency_ms=1.0)])
    try:
        assert router.check() == []
        assert router.check(memory=True, comms=True) == []
    finally:
        router.close()


# ---------------------------------------------------------------------------
# FleetRouter: routing, priority, drain/join, death
# ---------------------------------------------------------------------------

def test_fleet_routes_and_matches_engine_output():
    router = serving.FleetRouter([_batcher(), _batcher()])
    try:
        x = _x(2)
        out = router.infer({"data": x})
        assert np.array_equal(out[0], _engine().infer({"data": x})[0])
        np.testing.assert_allclose(out[0], _jax_infer(x), rtol=0, atol=ATOL)
        rep = router.report()
        assert rep["fleet"]["requests"] == 1
        assert rep["classes"]["interactive"]["requests"] == 1
        assert rep["classes"]["batch"]["requests"] == 0
    finally:
        router.close()


def test_fleet_validates_at_submit():
    router = serving.FleetRouter([_batcher()])
    try:
        with pytest.raises(MXNetError, match="per-example shape"):
            router.submit({"data": np.zeros((1, 7), np.float32)})
        with pytest.raises(MXNetError, match="priority"):
            router.submit({"data": _x(1)}, priority="bulk")
        with pytest.raises(MXNetError, match="empty"):
            router.submit({"data": _x(0)})
    finally:
        router.close()


def test_fleet_least_loaded_dispatch_balances():
    """With both replicas parked, assignments alternate by in-flight
    depth — queue-depth-aware dispatch, not round-robin by accident."""
    b1, b2 = _batcher(start=False), _batcher(start=False)
    router = serving.FleetRouter({"a": b1, "b": b2})
    try:
        reqs = [router.submit({"data": _x(1)}, deadline_ms=5000)
                for _ in range(6)]
        t0 = time.monotonic()
        while time.monotonic() - t0 < 2.0:
            rep = router.replica_report()
            if (rep["a"]["assigned"] + rep["b"]["assigned"]) == 6:
                break
            time.sleep(0.01)
        rep = router.replica_report()
        assert rep["a"]["assigned"] == 3
        assert rep["b"]["assigned"] == 3
        b1.start(); b2.start()
        for r in reqs:
            assert len(r.result(timeout=10.0)) > 0
    finally:
        router.close()


def test_fleet_strict_priority_and_expired_batch_never_poisons():
    """With the single replica saturated, a later interactive request
    dispatches BEFORE an earlier batch request (strict priority), an
    expired batch request is failed at pop without occupying a dispatch,
    its expiry is attributed to the batch class, and the interactive
    co-riders all complete."""
    gated = _GatedEngine(_engine())
    b = serving.Batcher(gated, max_latency_ms=1.0, queue_size=1,
                        max_batch=4)
    router = serving.FleetRouter([b], tick_ms=5.0)
    order = []
    try:
        ra = router.submit({"data": _x(1)}, deadline_ms=8000,
                           on_done=lambda r: order.append("A"))
        t0 = time.monotonic()
        while b.backlog() == 0 and time.monotonic() - t0 < 2.0:
            time.sleep(0.005)
        rb = router.submit({"data": _x(1)}, priority="batch",
                           deadline_ms=30.0,
                           on_done=lambda r: order.append("B"))
        rc = router.submit({"data": _x(1)}, priority="batch",
                           deadline_ms=8000,
                           on_done=lambda r: order.append("C"))
        rd = router.submit({"data": _x(1)}, deadline_ms=8000,
                           on_done=lambda r: order.append("D"))
        time.sleep(0.06)          # let B's deadline lapse in the queue
        gated.gate.set()
        assert len(ra.result(timeout=10.0)) > 0
        assert len(rc.result(timeout=10.0)) > 0
        assert len(rd.result(timeout=10.0)) > 0
        with pytest.raises(serving.ServingDeadlineError):
            rb.result(timeout=10.0)
        assert order.index("D") < order.index("C")
        ch = router.class_health
        assert ch["batch"].expired == 1
        assert ch["interactive"].expired == 0
        assert ch["interactive"].errors == 0
    finally:
        gated.gate.set()
        router.close()


def test_fleet_class_default_deadlines(monkeypatch):
    monkeypatch.setenv("MXTPU_FLEET_INTERACTIVE_DEADLINE_MS", "750")
    monkeypatch.setenv("MXTPU_FLEET_BATCH_DEADLINE_MS", "9000")
    router = serving.FleetRouter([_batcher()])
    try:
        now = time.monotonic()
        ri = router.submit({"data": _x(1)})
        rb = router.submit({"data": _x(1)}, priority="batch")
        assert 0.4 < ri.deadline - now < 0.80
        assert 8.0 < rb.deadline - now < 9.05
        ri.result(timeout=10.0)
        rb.result(timeout=10.0)
    finally:
        router.close()


def test_fleet_backpressure_bounded_per_class():
    gated = _GatedEngine(_engine())
    b = serving.Batcher(gated, queue_size=1, max_latency_ms=1.0)
    router = serving.FleetRouter([b], queue_size=2)
    try:
        for _ in range(4):   # 1 in replica queue + 2 router + in-flight
            try:
                router.submit({"data": _x(1)}, priority="batch",
                              deadline_ms=5000)
            except serving.ServingOverloadedError:
                break
        with pytest.raises(serving.ServingOverloadedError):
            for _ in range(4):
                router.submit({"data": _x(1)}, priority="batch",
                              deadline_ms=5000)
        assert router.class_health["batch"].dropped >= 1
        assert router.class_health["interactive"].dropped == 0
    finally:
        gated.gate.set()
        router.close()


def test_fleet_drain_flushes_then_retires():
    """Drain under load: stop assigning, flush what the replica owns,
    retire — zero requests shed."""
    gated = _GatedEngine(_engine())
    b0 = serving.Batcher(gated, max_latency_ms=1.0)
    router = serving.FleetRouter({"r0": b0, "r1": _batcher()})
    try:
        reqs = [router.submit({"data": _x(1)}, deadline_ms=10000)
                for _ in range(8)]
        res = {}

        def do_drain():
            res["report"] = router.drain("r0", timeout=15.0)

        t = threading.Thread(target=do_drain)
        t.start()
        time.sleep(0.03)
        gated.gate.set()
        t.join(20.0)
        assert not t.is_alive()
        assert res["report"]["state"] == serving.fleet.RETIRED
        ref = _jax_infer(_x(1))
        for r in reqs:
            np.testing.assert_allclose(r.result(timeout=10.0)[0], ref,
                                       rtol=0, atol=ATOL)
        assert router.health.shed == 0
        assert "r0" not in router.replica_names()
        # a retired replica takes no further work but the fleet serves on
        out = router.infer({"data": _x(1)}, deadline_ms=5000)
        assert out[0].shape == (1, 4)
    finally:
        gated.gate.set()
        router.close()


def test_fleet_join_warms_and_enters_rotation():
    router = serving.FleetRouter([_batcher()])
    try:
        router.join("fresh", _batcher)
        assert "fresh" in router.replica_names()
        # warm-up ran one request per bucket through the new engine
        rep = router.replica_report()["fresh"]
        assert rep["engine_health"]["batches"] >= 2
        out = router.infer({"data": _x(2)})
        assert out[0].shape == (2, 4)
    finally:
        router.close()


def test_fleet_join_rejects_mismatched_signature():
    router = serving.FleetRouter([_batcher()])
    try:
        def bad():
            rs = np.random.RandomState(0)
            params = {
                "arg:fc1_weight": rs.randn(8, 7).astype(np.float32),
                "arg:fc1_bias": rs.randn(8).astype(np.float32),
                "arg:fc2_weight": rs.randn(4, 8).astype(np.float32),
                "arg:fc2_bias": rs.randn(4).astype(np.float32),
            }
            return serving.ServingEngine(
                _mlp_sym(mt), params,
                {"data": (7,)}, buckets=(4,), device="cpu")
        with pytest.raises(MXNetError, match="signature"):
            router.join("bad", bad)
        assert "bad" not in router.replica_names()
    finally:
        router.close()


@pytest.mark.faults
def test_fleet_replica_die_requeues_undispatched_onto_survivors():
    """A dead replica's queued-but-undispatched requests are re-queued
    onto survivors — every request completes, nothing hangs, nothing is
    silently shed. A row is bitwise the engine's answer for it in the
    bucket it rode: torch's CPU matmul picks its kernel by the batch, so
    the port is per-example independent within a bucket size (the JAX
    package's XLA programs are across sizes too)."""
    router = serving.FleetRouter([_batcher(), _batcher()], tick_ms=5.0)
    try:
        faults.inject("fleet.replica_die", nth=1, kind="die")
        x = _x(1)
        eng = _engine()
        refs = [eng.infer({"data": np.repeat(x, b, axis=0)})[0][:1]
                for b in eng.buckets]
        reqs = [router.submit({"data": x}, deadline_ms=15000)
                for _ in range(16)]
        for r in reqs:
            out = r.result(timeout=20.0)
            assert any(np.array_equal(out[0], ref) for ref in refs)
        for ref in refs:
            np.testing.assert_allclose(ref, _jax_infer(x), rtol=0, atol=ATOL)
        rep = router.report()
        assert rep["fleet"]["requeued"] >= 1
        assert rep["fleet"]["shed"] == 0
        states = sorted(r["state"] for r in rep["replicas"].values())
        assert states == [serving.fleet.ACTIVE, serving.fleet.DEAD]
        dead = [r for r in rep["replicas"].values()
                if r["state"] == serving.fleet.DEAD][0]
        assert "replica death" in dead["died"]
    finally:
        router.close()


@pytest.mark.faults
def test_fleet_single_replica_death_requeues_then_join_recovers():
    """With NO survivor, re-queued requests wait in the router (deadline-
    aware, not shed); a joining replica then serves them."""
    router = serving.FleetRouter([_batcher()], tick_ms=5.0)
    try:
        faults.inject("fleet.replica_die", nth=1, kind="die")
        reqs = [router.submit({"data": _x(1)}, deadline_ms=15000)
                for _ in range(6)]
        t0 = time.monotonic()
        while not router.replica_names(states=(serving.fleet.DEAD,)) \
                and time.monotonic() - t0 < 5.0:
            time.sleep(0.01)
        router.join("rescue", _batcher)
        for r in reqs:
            assert len(r.result(timeout=20.0)) > 0
        assert router.health.shed == 0
    finally:
        router.close()


def test_fleet_close_sheds_queued_with_clear_error():
    gated = _GatedEngine(_engine())
    b = serving.Batcher(gated, queue_size=1, max_latency_ms=1.0)
    router = serving.FleetRouter([b], queue_size=8)
    reqs = [router.submit({"data": _x(1)}, priority="batch",
                          deadline_ms=30000) for _ in range(5)]
    router.close()
    gated.gate.set()
    failed = 0
    for r in reqs:
        try:
            r.result(timeout=10.0)
        except serving.ServingClosedError:
            failed += 1
        except serving.ServingDeadlineError:
            pytest.fail("close must shed promptly, not leak to deadline")
    assert failed >= 1            # everything unserved failed with Closed
    with pytest.raises(serving.ServingClosedError):
        router.submit({"data": _x(1)})


def test_fleet_health_rollup_mirrors_to_process_global():
    base = serving.SERVING_HEALTH.report()["requests"]
    router = serving.FleetRouter([_batcher()])
    try:
        router.infer({"data": _x(1)})
        router.infer({"data": _x(1)}, priority="batch")
        assert serving.SERVING_HEALTH.report()["requests"] >= base + 2
        assert router.health.requests == 2
        assert router.class_health["interactive"].requests == 1
        assert router.class_health["batch"].requests == 1
    finally:
        router.close()


# ---------------------------------------------------------------------------
# hot reload and weight accounting across the fleet
# ---------------------------------------------------------------------------

def test_fleet_update_params_reloads_every_live_replica_once():
    """update_params fans out to every live engine once (a warm rejoin
    sharing an engine reloads once); afterwards every replica serves the
    new weights, equal to the JAX engine built from them."""
    eng = _engine()
    router = serving.FleetRouter({"a": serving.Batcher(eng, max_latency_ms=1),
                                  "b": _batcher()})
    try:
        router.add_replica("a2", serving.Batcher(eng, max_latency_ms=1))
        new = _mlp_params(seed=5)
        names = router.update_params({k[4:]: v for k, v in new.items()})
        assert len(names) == 2
        x = _x(3)
        ref = _jax_infer(x, params=new)
        for _ in range(4):
            np.testing.assert_allclose(router.infer({"data": x})[0], ref,
                                       rtol=0, atol=ATOL)
        wr = router.weight_report()
        assert len(wr) == 2
        assert all(v["weight_bytes"] == 4 * (48 + 8 + 32 + 4)
                   and v["quantize"] == "none" for v in wr.values())
    finally:
        router.close()


# ---------------------------------------------------------------------------
# the slice as a whole: a narrow SSD (B2's plain version on the CPU)
# ---------------------------------------------------------------------------

SSD_SHAPE = (3, 64, 64)
SSD_HEADS = ["cls_prob", "multibox_loc_pred", "multibox_anchors"]


def _ssd_checkpoint(tmp_path, seed, epoch):
    """A JAX-written checkpoint of ssd.get_symbol(num_classes=3, width=8)
    with weights from ``seed``."""
    from mxnet_tpu.models import ssd as jssd
    net = jssd.get_symbol(num_classes=3, width=8)
    shapes, _, _ = net.infer_shape(data=(1,) + SSD_SHAPE)
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in zip(net.list_arguments(), shapes):
        if name == "data":
            continue
        scale = (np.sqrt(2.0 / np.prod(shape[1:]))
                 if name.endswith("_weight") else 0.1)
        params[name] = mx.nd.array(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    prefix = str(tmp_path / "ssd")
    mx.model.save_checkpoint(prefix, epoch, net, params, {})
    return prefix + "-symbol.json", "%s-%04d.params" % (prefix, epoch)


def test_ssd_fleet_serves_across_drain_join_and_reload(tmp_path):
    """Two SSD replicas serve mixed interactive and batch requests of 1-3
    images; one drains and a third joins under load, then the fleet
    reloads a second checkpoint. No request fails; every answer equals,
    bit for bit, the port engine's answer at the bucket it rode, from the
    old weights or the new ones; after the reload, answers equal a fresh
    engine of the new checkpoint, whose heads lie within 1e-5 of the JAX
    engine's."""
    files = _ssd_checkpoint(tmp_path, seed=0, epoch=0)
    new_files = _ssd_checkpoint(tmp_path, seed=1, epoch=5)
    buckets = (1, 4)

    def engine(f=files):
        return serving.ServingEngine(*f, {"data": SSD_SHAPE},
                                     buckets=buckets, device="cpu")

    images = np.random.default_rng(3).random((6,) + SSD_SHAPE,
                                             dtype=np.float32)
    sizes = [1, 2, 3, 1, 2, 1]
    reqs_in = [images[i:i + n] for i, n in enumerate(sizes)]
    old_eng, new_eng = engine(), engine(new_files)

    def answers(eng, x):
        # the answer at each bucket the request can ride, with co-riders
        out = []
        for b in buckets:
            if b >= len(x):
                pad = np.concatenate([x, images[:b - len(x)]])
                out.append(eng.infer({"data": pad})[0][:len(x)])
        return out

    router = serving.FleetRouter({"r0": serving.Batcher(engine(),
                                                        max_latency_ms=5),
                                  "r1": serving.Batcher(engine(),
                                                        max_latency_ms=5)})
    try:
        first = [router.submit({"data": x}, priority=p, deadline_ms=60000)
                 for x, p in zip(reqs_in, ["interactive", "batch"] * 3)]
        router.drain("r0", timeout=60.0)
        router.join("r2", lambda: serving.Batcher(engine(),
                                                  max_latency_ms=5))
        second = [router.submit({"data": x}, priority="batch",
                                deadline_ms=60000) for x in reqs_in]
        for x, r in zip(reqs_in * 2, first + second):
            got = r.result(timeout=60.0)[0]
            assert any(np.array_equal(got, a) for a in answers(old_eng, x))
        router.update_params(new_files[1])
        for x in reqs_in:
            got = router.infer({"data": x}, deadline_ms=60000)[0]
            assert any(np.array_equal(got, a) for a in answers(new_eng, x))
        assert router.health.errors == router.health.shed == 0
        assert router.health.expired == 0
    finally:
        router.close()
    jheads = jserving.ServingEngine(*new_files, {"data": SSD_SHAPE},
                                    buckets=buckets, output_names=SSD_HEADS)
    theads = serving.ServingEngine(*new_files, {"data": SSD_SHAPE},
                                   buckets=buckets, output_names=SSD_HEADS,
                                   device="cpu")
    for j, t in zip(jheads.infer({"data": images[:3]}),
                    theads.infer({"data": images[:3]})):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)
