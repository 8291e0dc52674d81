"""The port's fault-injection registry against the JAX package's.

The registry tests of ``tests/test_faults.py`` (nth targeting, scoped
rules, pass-through kinds, the ``MXTPU_FAULTS`` spec and its malformed
form) run on both ``mxnet_tpu.faults`` and ``mxnet_tpu_torch.faults``
with the same call sequence, and every call must give the same outcome
(the returned action, or the raised fault's type name). Also held:
``arm`` validates sites against the port's registry (the sites the port
instruments: ``serve.enqueue_drop`` and ``fleet.replica_die``),
``fired``, ``delay``, and the registry under threads.
Tolerance: none.
"""
import sys
import threading

import pytest

from mxnet_tpu import faults as jfaults
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import faults as tfaults

pytestmark = pytest.mark.faults


@pytest.fixture(autouse=True)
def _clean_registry():
    for f in (jfaults, tfaults):
        f.clear()
    yield
    for f in (jfaults, tfaults):
        f.clear()


def _outcome(mod, site):
    try:
        return mod.fire(site)
    except Exception as e:             # the fault's class, by name
        return type(e).__name__


def _same(site, n):
    """Fire ``site`` n times in both packages; the outcomes must agree."""
    j = [_outcome(jfaults, site) for _ in range(n)]
    t = [_outcome(tfaults, site) for _ in range(n)]
    assert t == j
    return t


def test_fire_counts_and_nth_targeting():
    for f in (jfaults, tfaults):
        assert f.fire("t.site") is None
        f.inject("t.site", nth=2, kind="raise")
    out = _same("t.site", 3)
    assert out == [None, "InjectedFault", None]   # nth relative to arm time
    assert tfaults.count("t.site") == jfaults.count("t.site") == 4
    assert tfaults.fired("t.site") == jfaults.fired("t.site") == 1


def test_scoped_clears_on_exit():
    with jfaults.scoped("t.scoped", nth=1, kind="transient"), \
            tfaults.scoped("t.scoped", nth=1, kind="transient"):
        assert _same("t.scoped", 1) == ["InjectedTransientFault"]
    assert _same("t.scoped", 1) == [None]
    assert tfaults.count("t.scoped") == jfaults.count("t.scoped") == 1


@pytest.mark.parametrize("kind", ["drop", "die", "truncate"])
def test_action_kinds_pass_through(kind):
    for f in (jfaults, tfaults):
        f.inject("t.act", nth=1, kind=kind, times=2)
    assert _same("t.act", 3) == [kind, kind, None]


def test_env_spec_parsing(monkeypatch):
    monkeypatch.setenv("MXTPU_FAULTS",
                       "t.env@2=transient*2,serve.enqueue_drop=drop")
    for f in (jfaults, tfaults):
        f.clear()
        f._env_loaded = False
    assert _same("t.env", 4) == [None, "InjectedTransientFault",
                                 "InjectedTransientFault", None]
    assert _same("serve.enqueue_drop", 2) == ["drop", None]


def test_env_spec_malformed_raises(monkeypatch):
    monkeypatch.setenv("MXTPU_FAULTS", "not-a-spec")
    tfaults.clear()
    tfaults._env_loaded = False
    with pytest.raises(MXNetError, match="MXTPU_FAULTS"):
        tfaults.fire("t.env2")


def test_arm_validates_sites_and_delay_sleeps():
    train = ["checkpoint.write", "checkpoint.write.mid", "ckpt.async_die",
             "ckpt.async_write", "ckpt.disk_full", "guard.grad_nan",
             "guard.loss_spike", "guard.param_nan"]
    serve = ["fleet.replica_die", "serve.decode_die", "serve.enqueue_drop",
             "serve.sample", "serve.spec_verify"]
    both = ["io.batch_read", "io.h2d", "superbatch.producer"]
    data = ["data.decode_delay", "data.worker_die", "io.record_read"]
    dist = ["kv.partition", "kv.push_delay", "kv.reform_delay",
            "kv.worker_die", "kvstore.barrier", "kvstore.pull",
            "kvstore.push"]
    assert sorted(tfaults.sites()) == sorted(train + serve + both + data
                                             + dist + ["kvstore.dead_node"])
    assert sorted(tfaults.sites()) == sorted(jfaults.sites())
    assert sorted(tfaults.sites("dist")) == dist
    assert sorted(tfaults.sites("serve")) == serve
    assert sorted(tfaults.sites("train")) == sorted(train + both)
    assert sorted(tfaults.sites("data")) == sorted(both + data)
    # the port's sites are the JAX package's, with the same kinds and flags
    for name, info in tfaults.SITES.items():
        ref = jfaults.SITES[name]
        assert (info.kinds, info.flag) == (ref.kinds, ref.flag), name
    with pytest.raises(MXNetError, match="unregistered fault site"):
        tfaults.arm([{"site": "kvstore.pushed", "kind": "transient"}])
    tfaults.arm([{"site": "fleet.replica_die", "kind": "die", "nth": 2}])
    assert [tfaults.fire("fleet.replica_die") for _ in range(3)] == \
        [None, "die", None]
    assert tfaults.fired("fleet.replica_die") == 1
    tfaults.inject("t.slow", kind="delay", delay=0.0)
    assert tfaults.fire("t.slow") == "delay"
    tfaults.clear("fleet.replica_die")
    assert tfaults.count("fleet.replica_die") == 0
    assert tfaults.count("t.slow") == 1


def test_counts_are_exact_under_threads():
    """Threads fire one site against one clock: the count is exact and an
    armed window fires exactly ``times`` calls."""
    tfaults.inject("t.threads", nth=100, kind="drop", times=50)
    hits = []
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(500):
                if tfaults.fire("t.threads") == "drop":
                    hits.append(1)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(prev)
    assert tfaults.count("t.threads") == 4000
    assert len(hits) == tfaults.fired("t.threads") == 50
