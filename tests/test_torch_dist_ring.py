"""The port's control-plane ring (``mxnet_tpu_torch.dist_ring``) against
the JAX package's ``mxnet_tpu.dist_ring``.

Threads stand in for worker processes. Each scenario runs twice, once
through each package's ``Ring`` over its own in-memory ``LocalClient``
(liveness explicit, polling at zero, faults at exact call counts), and
the two runs must agree exactly: the sums bit for bit, the broadcasts and
the barrier's effect, the ranks a ``WorkerLostError`` names, the
generation and members after a re-form or a join, the requeued reads
under ``kv.partition`` drops and ``DIST_HEALTH.report()``. The same ring
then runs over a real ``torch.distributed.TCPStore`` on localhost with
one ``StoreClient`` connection per thread (the heartbeat stamps written by
hand), held bit for bit to the JAX package's result on the same arrays.

Tolerance: exact everywhere (bytes and integers); the timing bounds are
upper bounds on a wait that must never hang.
"""
import datetime
import json
import socket
import threading
import time

import numpy as np
import pytest

import mxnet_tpu.dist_ring as jring
import mxnet_tpu.faults as jfaults
import mxnet_tpu.kvstore as jkv
import mxnet_tpu_torch.dist_ring as tring
import mxnet_tpu_torch.faults as tfaults
import mxnet_tpu_torch.kvstore as tkv

PKGS = {"jax": (jring, jfaults, jkv), "torch": (tring, tfaults, tkv)}


@pytest.fixture(autouse=True)
def _clean():
    for ring, faults, _ in PKGS.values():
        faults.clear()
        ring.DIST_HEALTH.reset()
    yield
    for ring, faults, _ in PKGS.values():
        faults.clear()
        ring.DIST_HEALTH.reset()


def _run(fns, limit=60):
    """One callable per worker on its own thread; re-raise the first
    failure. A thread still alive after ``limit`` seconds is a hang."""
    out, errs = {}, []

    def wrap(r, fn):
        try:
            out[r] = fn()
        except BaseException as e:  # noqa: BLE001 - reported to the test
            errs.append((r, e))

    ts = [threading.Thread(target=wrap, args=(r, fn), daemon=True)
          for r, fn in fns.items()]
    for t in ts:
        t.start()
    for t in ts:
        t.join(limit)
        assert not t.is_alive(), "ring op hung"
    if errs:
        raise errs[0][1]
    return out


def _rings(ring_mod, client, members, **kw):
    kw.setdefault("poll", 0.0)
    kw.setdefault("op_timeout", 30.0)
    return {r: ring_mod.Ring(client, r, members, **kw) for r in members}


def _arrays(dtype, members=(0, 1, 2), shape=(5, 7)):
    rs = np.random.RandomState(11)
    return {r: (rs.randn(*shape) * 10 ** rs.randint(-3, 4)).astype(dtype)
            for r in members}


def _both(scenario):
    """``scenario(ring_mod, faults, kv_mod)`` through each package."""
    return {name: scenario(*mods) for name, mods in PKGS.items()}


# -- codec and collectives ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64", "int64"])
def test_codec_bytes_equal(dtype):
    a = _arrays(dtype)[0]
    assert tring._encode_array(a) == jring._encode_array(a)
    assert np.array_equal(tring._decode_array(jring._encode_array(a)), a)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_allreduce_sum_bitwise_equal(dtype):
    vals = _arrays(dtype)

    def scenario(ring_mod, faults, kv):
        rings = _rings(ring_mod, ring_mod.LocalClient(), [0, 1, 2])
        out = _run({r: (lambda rr=r: rings[rr].allreduce_sum(vals[rr]))
                    for r in rings})
        assert len({out[r].tobytes() for r in out}) == 1
        return out[0]

    got = _both(scenario)
    assert got["torch"].tobytes() == got["jax"].tobytes()
    assert got["torch"].dtype == got["jax"].dtype


def test_broadcast_and_barrier_equal():
    payload = _arrays("float32")[1]

    def scenario(ring_mod, faults, kv):
        c = ring_mod.LocalClient()
        rings = _rings(ring_mod, c, [0, 1, 2])
        arr = _run({r: (lambda rr=r: rings[rr].broadcast(
            payload if rr == 1 else None, root_index=1)) for r in rings})
        raw = _run({r: (lambda rr=r: rings[rr].broadcast_bytes(
            b"ckpt-blob" if rr == 0 else b"")) for r in rings})
        _run({r: rings[r].barrier for r in rings})
        return ([arr[r].tobytes() for r in sorted(arr)],
                [raw[r] for r in sorted(raw)],
                [rings[r].seq for r in sorted(rings)])

    got = _both(scenario)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [payload.tobytes()] * 3


def test_single_member_short_circuits():
    def scenario(ring_mod, faults, kv):
        c = ring_mod.LocalClient()
        ring = ring_mod.Ring(c, 0, [0], poll=0.0)
        out = ring.allreduce_sum(np.ones(3)).tobytes()
        assert ring.broadcast_bytes(b"x") == b"x"
        ring.barrier()
        return out, c.dir("")

    got = _both(scenario)
    assert got["torch"] == got["jax"] == (np.ones(3).tobytes(), {})


# -- worker loss, re-form, join ----------------------------------------------

def test_dead_peer_names_the_same_ranks_in_bounded_time():
    def scenario(ring_mod, faults, kv):
        c = ring_mod.LocalClient()
        rings = _rings(ring_mod, c, [0, 1, 2])
        c.mark_dead(2)

        def survivor(r):
            with pytest.raises(kv.WorkerLostError) as ei:
                rings[r].allreduce_sum(np.ones(2))
            return str(ei.value).split(" lost")[0]

        t0 = time.monotonic()
        out = _run({0: lambda: survivor(0), 1: lambda: survivor(1)}, 30)
        assert time.monotonic() - t0 < 30
        return (out, rings[0].dead, rings[0].liveness_table(),
                ring_mod.DIST_HEALTH.worker_lost)

    got = _both(scenario)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == {0: "worker(s) [2]", 1: "worker(s) [2]"}


def test_reform_gives_the_same_generation_and_members():
    def scenario(ring_mod, faults, kv):
        c = ring_mod.LocalClient()
        rings = _rings(ring_mod, c, [0, 1, 2, 3])
        c.mark_dead(2)
        _run({r: (lambda rr=r: pytest.raises(
            kv.WorkerLostError, rings[rr].allreduce_sum, np.ones(1)))
            for r in (0, 1, 3)})
        members = _run({r: rings[r].reform for r in (0, 1, 3)})
        red = _run({r: (lambda rr=r: rings[rr].allreduce_sum(
            np.full(2, float(rr + 1), np.float32))) for r in (0, 1, 3)})
        return (members, {r: (rings[r].gen, rings[r].index)
                          for r in (0, 1, 3)},
                {r: red[r].tobytes() for r in red},
                ring_mod.DIST_HEALTH.report())

    got = _both(scenario)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == {r: [0, 1, 3] for r in (0, 1, 3)}
    assert got["torch"][1] == {0: (1, 0), 1: (1, 1), 3: (1, 2)}


def test_pending_reform_aborts_waiters_and_eviction_raises():
    def scenario(ring_mod, faults, kv):
        c = ring_mod.LocalClient()
        rings = _rings(ring_mod, c, [0, 1])
        c.set("mxring/reform/1/prop/0", '{"members": [0], "joiners": []}')
        with pytest.raises(kv.WorkerLostError) as e0:
            rings[0].allreduce_sum(np.ones(1))
        with pytest.raises(kv.WorkerLostError) as e1:
            rings[1].reform()
        return ("already proposed" in str(e0.value),
                "evicted" in str(e1.value))

    got = _both(scenario)
    assert got["torch"] == got["jax"] == (True, True)


def test_join_gives_the_same_members():
    def scenario(ring_mod, faults, kv):
        c = ring_mod.LocalClient()
        rings = _rings(ring_mod, c, [0, 1])
        joiner = ring_mod.Ring(c, 2, [2], poll=0.0, op_timeout=30.0)
        c.set("mxring/join/2", b"ok")
        polled = rings[0].poll_joiners()
        out = _run({0: rings[0].reform, 1: rings[1].reform,
                    2: lambda: joiner.request_join(timeout=30.0)})
        red = _run({0: lambda: rings[0].allreduce_sum(np.ones(1)),
                    1: lambda: rings[1].allreduce_sum(np.ones(1)),
                    2: lambda: joiner.allreduce_sum(np.ones(1))})
        return (polled, out, joiner.gen, rings[0].poll_joiners(),
                {r: v.tobytes() for r, v in red.items()},
                ring_mod.DIST_HEALTH.report()["joins"])

    got = _both(scenario)
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == {r: [0, 1, 2] for r in (0, 1, 2)}


# -- fault sites ----------------------------------------------------------------

def test_kv_partition_drops_give_equal_requeued_counts():
    def scenario(ring_mod, faults, kv):
        rings = _rings(ring_mod, ring_mod.LocalClient(), [0, 1])
        faults.inject("kv.partition", nth=1, kind="drop", times=3)
        out = _run({r: (lambda rr=r: rings[rr].allreduce_sum(
            np.full(1, float(rr)))) for r in rings})
        return ({r: v.tobytes() for r, v in out.items()},
                ring_mod.DIST_HEALTH.requeued, faults.fired("kv.partition"))

    got = _both(scenario)
    assert got["torch"] == got["jax"]
    assert got["torch"][1:] == (3, 3)


def test_persistent_partition_times_out_in_both():
    def scenario(ring_mod, faults, kv):
        c = ring_mod.LocalClient()
        ring = ring_mod.Ring(c, 0, [0, 1], poll=0.0, op_timeout=0.05)
        faults.inject("kv.partition", kind="drop", times=10 ** 9)
        c.set("mxring/g0/red/0/1", b"\x01")
        with pytest.raises(kv.KVStoreTimeoutError) as ei:
            ring.allreduce_sum(np.ones(1))
        return ei.value.started

    got = _both(scenario)
    assert got["torch"] == got["jax"] is True


def test_kv_worker_die_raising_kind_propagates_in_both():
    def scenario(ring_mod, faults, kv):
        c = ring_mod.LocalClient()
        ring = ring_mod.Ring(c, 0, [0, 1], poll=0.0)
        faults.inject("kv.worker_die", nth=1, kind="raise")
        with pytest.raises(faults.InjectedFault):
            ring.allreduce_sum(np.ones(1))
        return sorted(c.dir(""))

    got = _both(scenario)
    assert got["torch"] == got["jax"] == []


def test_reform_delay_slow_leader_converges_in_both():
    def scenario(ring_mod, faults, kv):
        c = ring_mod.LocalClient()
        rings = _rings(ring_mod, c, [0, 1, 2])
        c.mark_dead(2)
        faults.inject("kv.reform_delay", nth=1, kind="delay", delay=0.2)
        t0 = time.monotonic()
        out = _run({0: rings[0].reform, 1: rings[1].reform})
        assert time.monotonic() - t0 >= 0.2
        return out, faults.fired("kv.reform_delay"), rings[1].gen

    got = _both(scenario)
    assert got["torch"] == got["jax"] == ({0: [0, 1], 1: [0, 1]}, 1, 1)


def test_dist_health_report_equal_after_a_drill():
    def scenario(ring_mod, faults, kv):
        c = ring_mod.LocalClient()
        rings = _rings(ring_mod, c, [0, 1, 2])
        faults.inject("kv.partition", nth=2, kind="drop", times=2)
        _run({r: (lambda rr=r: rings[rr].allreduce_sum(np.ones(2)))
              for r in rings})
        c.mark_dead(1)
        _run({r: (lambda rr=r: pytest.raises(
            kv.WorkerLostError, rings[rr].barrier)) for r in (0, 2)})
        _run({r: rings[r].reform for r in (0, 2)})
        return ring_mod.DIST_HEALTH.report()

    got = _both(scenario)
    assert got["torch"] == got["jax"]
    assert got["torch"]["reforms"] == 2 and got["torch"]["workers"] == 2


# -- the same ring over a real TCPStore ----------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def store():
    import torch.distributed as dist
    port = _free_port()
    master = dist.TCPStore("127.0.0.1", port, 1, is_master=True,
                           timeout=datetime.timedelta(seconds=20),
                           wait_for_workers=False)

    def client(**kw):
        kw.setdefault("grace", 60.0)
        return tring.StoreClient.connect("127.0.0.1", port, 20, **kw)
    yield client
    del master


def _beat(client, ranks, age=0.0):
    for r in ranks:
        client.set(tring.HB_PREFIX + "%d" % r, repr(time.time() - age))


def test_store_client_matches_local_client_semantics(store):
    """``set``/``get``/``dir``/``delete`` and ``set(overwrite=False)`` give
    the LocalClient's answers, chunked values included."""
    big = np.random.RandomState(0).bytes(tring.CHUNK_BYTES * 2 + 17)
    answers = []
    for c in (tring.LocalClient(), store()):
        a = [c.set("d/x", b"1"), c.set("d/x", b"2", overwrite=False),
             c.get("d/x"), c.set("d/y", big), c.get("d/y") == big,
             c.set("d/y", b"small"), c.get("d/y"), c.get("d/none"),
             c.set("e/z", big, listed=False), c.get("e/z") == big]
        c.delete("d/x")
        c.delete("e/z")
        a += [c.get("d/x"), c.get("e/z"), sorted(c.dir("d/").items())]
        answers.append(a)
    assert answers[0] == answers[1]
    assert answers[1][-1] == [("d/y", b"small")]


def test_store_client_write_is_visible_to_another_connection(store):
    """Once ``set`` (and the tombstone of ``delete``) returns, a read on
    another connection sees it. The store sends no reply to a set or an
    append and serves its connections in no fixed order, so without the
    client's acknowledged round trip most of these reads of a 200 KB
    value miss it (and the joiner test's incumbents can miss the join
    request the test wrote just before them)."""
    a, b = store(), store()
    value = b"v" * 200_000
    missed = []
    for i in range(300):
        a.set("vis/%d" % i, value)
        if b.get("vis/%d" % i) is None:
            missed.append(i)
        a.delete("vis/%d" % i)
        if b.get("vis/%d" % i) is not None:
            missed.append(-i - 1)
    assert missed == []


def test_store_client_acknowledges_listed_writes_only(store):
    """A listed write ends with an answered ``check`` on its connection; an
    unlisted one (a ring payload, polled for by its readers) sends its
    chunks and head and nothing more."""
    class Recording(object):
        def __init__(self, inner):
            self.inner, self.calls = inner, []

        def __getattr__(self, name):
            fn = getattr(self.inner, name)

            def call(*a, **kw):
                self.calls.append(name)
                return fn(*a, **kw)
            return call

    rec = Recording(store()._s)
    c = tring.StoreClient(rec, grace=60.0)
    c.set("d/x", b"1")
    assert rec.calls == ["set", "append", "check"]
    rec.calls[:] = []
    c.set("d/x", b"2")
    assert rec.calls == ["set", "check"]
    rec.calls[:] = []
    c.set("mxring/g0/ar/0/0", b"p" * (tring.CHUNK_BYTES + 1), listed=False)
    assert rec.calls == ["set", "set", "set"]


def test_ring_over_tcpstore_bitwise_equal_to_jax(store):
    vals = _arrays("float32", shape=(3, tring.CHUNK_BYTES // 8))
    jr = _rings(jring, jring.LocalClient(), [0, 1, 2])
    want = _run({r: (lambda rr=r: jr[rr].allreduce_sum(vals[rr]))
                 for r in jr})[0]
    clients = {r: store() for r in (0, 1, 2)}
    _beat(clients[0], [0, 1, 2])
    rings = {r: tring.Ring(clients[r], r, [0, 1, 2], poll=0.001,
                           op_timeout=20.0) for r in clients}
    out = _run({r: (lambda rr=r: rings[rr].allreduce_sum(vals[rr]))
                for r in rings})
    for r in rings:
        assert out[r].tobytes() == want.tobytes()
    got = _run({r: (lambda rr=r: rings[rr].broadcast(
        vals[2] if rr == 2 else None, root_index=2)) for r in rings})
    assert all(got[r].tobytes() == vals[2].tobytes() for r in got)
    _run({r: rings[r].barrier for r in rings})


def test_ring_over_tcpstore_loses_a_worker_and_reforms(store):
    """A rank whose heartbeat is stale is named by a WorkerLostError in
    bounded time; the survivors re-form to the JAX package's generation
    and members, and the new ring sums exactly."""
    clients = {r: store(dead_for=1.0) for r in (0, 1, 2)}
    _beat(clients[0], [0, 1])
    _beat(clients[0], [2], age=10.0)
    rings = {r: tring.Ring(clients[r], r, [0, 1, 2], poll=0.001,
                           op_timeout=20.0) for r in clients}

    def survivor(r):
        with pytest.raises(tkv.WorkerLostError) as ei:
            rings[r].allreduce_sum(np.ones(2))
        return "[2]" in str(ei.value)

    t0 = time.monotonic()
    assert _run({0: lambda: survivor(0), 1: lambda: survivor(1)}) == {
        0: True, 1: True}
    assert time.monotonic() - t0 < 20
    _beat(clients[0], [0, 1])
    out = _run({0: rings[0].reform, 1: rings[1].reform})
    assert out == {0: [0, 1], 1: [0, 1]}
    assert rings[0].gen == rings[1].gen == 1
    red = _run({r: (lambda rr=r: rings[rr].allreduce_sum(
        np.full(2, float(rr + 1), np.float32))) for r in (0, 1)})
    assert red[0].tobytes() == red[1].tobytes() == np.full(
        2, 3.0, np.float32).tobytes()


def test_ring_over_tcpstore_admits_a_joiner(store):
    clients = {r: store() for r in (0, 1, 2)}
    _beat(clients[0], [0, 1, 2])
    rings = {r: tring.Ring(clients[r], r, [0, 1], poll=0.001,
                           op_timeout=20.0) for r in (0, 1)}
    joiner = tring.Ring(clients[2], 2, [2], poll=0.001, op_timeout=20.0)
    # the request is on the plane before the incumbents' epoch-boundary
    # re-form, as fit's admission makes it
    clients[2].set("mxring/join/2", b"ok")
    got = _run({0: rings[0].reform, 1: rings[1].reform,
                2: lambda: joiner.request_join(timeout=20.0)})
    assert got == {r: [0, 1, 2] for r in (0, 1, 2)}
    assert rings[0].poll_joiners() == []
    assert json.loads(clients[0].get("mxring/reform/1/prop/0"))[
        "joiners"] == [2]
