"""The port's data tier (``mxnet_tpu_torch.data``) against the JAX
package's, on the CPU.

Same ``.rec`` files (made in ``tmp_path`` from a numpy seed with small
JPEGs), same calls, in both packages:

- ``PipelineStats``: the same stage counts and the mirror into
  ``PIPELINE_STATS`` (seconds are each process's own clock);
- ``ShardedRecordReader``: the same shards, epoch orders, records, corrupt
  classification and retry counts (exact);
- ``DecodeWorkerPool``: batches in order for any worker count, a slow
  worker never reorders, and a dead worker raises ``MXNetError`` naming
  ``data.worker_die`` in both packages within the pool's poll bound;
- ``SuperBatchIter`` over ``next_host()`` gives the stacked arrays it
  gives over ``next()`` and the JAX package's (exact); the
  ``DevicePrefetcher`` charges the iterator's own ``data_stats``;
- ``Module.fit`` of ``models.lenet`` for one epoch from
  ``ImageRecordIter(num_workers=2)``: parameters within
  ``tests/test_torch_module.py``'s tolerance (``rtol=1e-4, atol=1e-4``:
  float32 sums in different orders); accuracy counts equal;
- port only: a fit stopped after 8 of its 12 batches and resumed from its
  checkpoint (by ``set_epoch`` and fast-forward) equals the uninterrupted
  fit bit for bit, at 1 worker and 1 step a dispatch and at 3 workers and
  2 steps a dispatch.

Every pool, reader and prefetch thread is closed by the test that started
it; no queue is waited on without a timeout.
"""
import io as _bio
import os
import time
import zlib

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import data as jdata
from mxnet_tpu import faults as jfaults
from mxnet_tpu_torch import data as tdata
from mxnet_tpu_torch import faults as tfaults
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.obs.registry import REGISTRY

PIL = pytest.importorskip("PIL.Image")

TOL = dict(rtol=1e-4, atol=1e-4)
FAULTS = {mx: jfaults, mt: tfaults}
DATA = {mx: jdata, mt: tdata}


@pytest.fixture(autouse=True)
def _clean_slate():
    for f in FAULTS.values():
        f.clear()
    yield
    for f in FAULTS.values():
        f.clear()


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _make_rec(path, n=48, h=32, w=32, classes=4, name="tier"):
    rng = _rng(name)
    colors = np.array([[200, 40, 40], [40, 200, 40], [40, 40, 200],
                       [200, 200, 40]], np.float32)
    idx = os.path.splitext(path)[0] + ".idx"
    rec = mt.recordio.MXIndexedRecordIO(idx, path, "w")
    for i in range(n):
        k = i % classes
        img = (rng.normal(110, 25, (h, w, 3))
               + 0.55 * (colors[k] - 110)).clip(0, 255).astype(np.uint8)
        buf = _bio.BytesIO()
        PIL.fromarray(img).save(buf, format="JPEG", quality=90)
        rec.write_idx(i, mt.recordio.pack(
            mt.recordio.IRHeader(0, float(k), i, 0), buf.getvalue()))
    rec.close()
    return path


def _record_iter(pkg, rec, num_workers, **kw):
    kw.setdefault("data_shape", (3, 28, 28))
    kw.setdefault("batch_size", 8)
    kw.setdefault("resize", 30)
    if pkg is mt:
        kw.setdefault("device", "cpu")
    return pkg.image.ImageRecordIter(path_imgrec=rec, num_workers=num_workers,
                                     **kw)


# -- PipelineStats -----------------------------------------------------------

def test_pipeline_stats_stages_and_mirror():
    out = {}
    for pkg in (mx, mt):
        parent = DATA[pkg].PipelineStats()
        st = DATA[pkg].PipelineStats(parent=parent)
        st.add("read", 0.5, n=4)
        st.add("decode", 0.25)
        st.add("stall", 0.0)
        assert st.timed("stack", lambda: 7) == 7
        for d in (2, 0, 5):
            st.note_queue_depth(d)
        rep, prep = st.report(), parent.report()
        assert rep["read_s"] == prep["read_s"] == 0.5
        out[pkg] = {k: v for k, v in rep.items()
                    if k.endswith("_n") or k.startswith("queue")}
        st.reset()
        assert st.stage_seconds("read") == 0.0
        assert parent.stage_seconds("read") == 0.5
    assert out[mt] == out[mx]
    assert {"elapsed_s", "stall_frac"} <= set(tdata.PIPELINE_STATS.report())


# -- ShardedRecordReader ----------------------------------------------------

@pytest.mark.parametrize("part,sub", [((0, 1), (0, 1)), ((1, 2), (0, 1)),
                                      ((1, 2), (1, 3)), ((0, 3), (1, 2))])
def test_reader_shards_and_epoch_orders_match_reference(part, sub, tmp_path):
    rec = _make_rec(str(tmp_path / "r.rec"), n=30, name="shard")
    readers = {}
    for pkg in (mx, mt):
        readers[pkg] = DATA[pkg].ShardedRecordReader(
            rec, part_index=part[0], num_parts=part[1], sub_index=sub[0],
            sub_parts=sub[1], shuffle=True, seed=4)
    j, t = readers[mx], readers[mt]
    assert t.keys == j.keys and len(t) == len(j)
    for ep in range(3):
        assert t.epoch_order(ep) == j.epoch_order(ep)
    assert t.epoch_order(1) != t.epoch_order(2) or len(t) < 3
    for k in t.keys[:3]:
        (th, tp), (jh, jp) = t.read(k), j.read(k)
        assert tp == jp and th.label == jh.label and th.id == jh.id
    t.reshard_workers(0, 2)
    j.reshard_workers(0, 2)
    assert t.keys == j.keys
    for r in readers.values():
        r.close()
    with pytest.raises(MXNetError, match="out of range"):
        tdata.ShardedRecordReader(rec, part_index=2, num_parts=2)


def test_reader_corrupt_and_transient_match_reference(tmp_path):
    rec = _make_rec(str(tmp_path / "c.rec"), n=8, name="corrupt")
    idx = os.path.splitext(rec)[0] + ".idx"
    offsets = {}
    with open(idx) as f:
        for line in f:
            k, off = line.split("\t")
            offsets[int(k)] = int(off)
    with open(rec, "r+b") as f:       # break record 5's magic
        f.seek(offsets[5])
        f.write(b"\0\0\0\0")
    for pkg in (mx, mt):
        health = pkg.io.DataHealth()
        r = DATA[pkg].ShardedRecordReader(
            rec, data_health=health,
            retry_policy=pkg.io.RetryPolicy(base_delay=0.0))
        with pytest.raises(pkg.io.CorruptRecordError, match="corrupt record"):
            r.read(5)
        FAULTS[pkg].inject("io.record_read", nth=1, kind="transient",
                           times=2)
        r.read(1)
        assert health.report()["retries"] == 2
        FAULTS[pkg].inject("io.record_read", nth=1, kind="transient",
                           times=9)
        with pytest.raises(pkg.base.MXNetError, match="giving up after 4"):
            r.read(2)
        assert health.report()["failures"] == 1
        FAULTS[pkg].clear()
        r.close()


def test_reader_thread_local_handles_read_concurrently(tmp_path):
    import threading
    rec = _make_rec(str(tmp_path / "t.rec"), n=24, name="threads")
    r = tdata.ShardedRecordReader(rec)
    want = {k: r.read(k)[1] for k in r.keys}
    errors = []

    def work(keys):
        for _ in range(3):
            for k in keys:
                if r.read(k)[1] != want[k]:
                    errors.append(k)
    threads = [threading.Thread(target=work, args=(r.keys[i::4],))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads)
    r.close()
    with pytest.raises(MXNetError, match="closed"):
        r.read(0)


# -- DecodeWorkerPool -------------------------------------------------------

def _square_tasks(n):
    return [([i, i + 1], i * 10) for i in range(n)]


def _square(keys, seed):
    time.sleep(0.001 * (keys[0] % 3))
    return np.array(keys) * seed


@pytest.mark.parametrize("workers", [1, 3, 5])
def test_pool_emits_in_order_any_worker_count(workers):
    pool = tdata.DecodeWorkerPool(_square, _square_tasks(17), workers,
                                  queue_depth=2)
    got = []
    while True:
        try:
            got.append(pool.next_batch())
        except StopIteration:
            break
    pool.close()
    assert len(got) == 17
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, np.array([i, i + 1]) * i * 10)


@pytest.mark.faults
def test_pool_dead_worker_raises_naming_the_site_in_both():
    for pkg in (mx, mt):
        FAULTS[pkg].inject("data.worker_die", nth=3, kind="die")
        pool = DATA[pkg].DecodeWorkerPool(_square, _square_tasks(12), 2)
        t0 = time.perf_counter()
        with pytest.raises(pkg.base.MXNetError, match="data.worker_die"):
            for _ in range(12):
                pool.next_batch()
        assert time.perf_counter() - t0 < 10.0     # the poll, not a hang
        pool.close()
        FAULTS[pkg].clear()


@pytest.mark.faults
def test_pool_slow_worker_and_decode_error_keep_the_order():
    tfaults.inject("data.decode_delay", nth=2, kind="delay", delay=0.05)
    st = tdata.PipelineStats()
    pool = tdata.DecodeWorkerPool(_square, _square_tasks(6), 3, stats=st)
    got = [pool.next_batch() for _ in range(6)]
    pool.close()
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, np.array([i, i + 1]) * i * 10)
    assert st.report().get("wait_n", 0) >= 1

    def bad(keys, seed):
        if keys[0] == 3:
            raise ValueError("bad batch 3")
        return keys
    pool = tdata.DecodeWorkerPool(bad, _square_tasks(6), 2)
    assert [pool.next_batch() for _ in range(3)] == [[0, 1], [1, 2], [2, 3]]
    with pytest.raises(ValueError, match="bad batch 3"):
        pool.next_batch()
    pool.close()


def test_pool_and_counters_under_thread_stress():
    """More workers than cores and a short switch interval: the pool still
    emits every batch once and in order, and no retry or stage count of
    the shared DataHealth and PipelineStats is lost."""
    import sys
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        nworkers = 2 * (os.cpu_count() or 1) + 1
        health = mt.io.DataHealth(parent=mt.io.DataHealth())
        stats = tdata.PipelineStats(parent=tdata.PipelineStats())

        def batch(keys, seed):
            for _ in range(20):
                health.record_retry("io.record_read", "stress")
                stats.add("decode", 0.0)
            return keys[0]
        pool = tdata.DecodeWorkerPool(batch, [([i], i) for i in range(120)],
                                      nworkers, queue_depth=3, stats=stats)
        got = [pool.next_batch() for _ in range(120)]
        with pytest.raises(StopIteration):
            pool.next_batch()
        pool.close()
        assert not any(t.is_alive() for t in pool._threads)
        assert got == list(range(120))
        assert health.report()["retries"] == 2400
        assert health._parent.report()["retries"] == 2400
        assert stats.report()["decode_n"] == 2400
        assert stats._parent.report()["decode_n"] == 2400
    finally:
        sys.setswitchinterval(prev)


def test_pool_env_knobs(monkeypatch):
    monkeypatch.setenv("MXTPU_DATA_WORKERS", "3")
    monkeypatch.setenv("MXTPU_DATA_QUEUE", "5")
    assert tdata.default_num_workers() == 3
    assert tdata.workers.default_queue_depth(3) == 5
    monkeypatch.setenv("MXTPU_DATA_WORKERS", "x")
    with pytest.raises(MXNetError, match="MXTPU_DATA_WORKERS"):
        tdata.default_num_workers()
    monkeypatch.delenv("MXTPU_DATA_QUEUE")
    assert tdata.workers.default_queue_depth(3) == 6


# -- superbatches over next_host ---------------------------------------------

def _stacked(it):
    out = []
    for sb in it:
        out.append((sb.num_steps, list(sb.pads),
                    [a.asnumpy() for a in sb.data + sb.label]))
    return out


class _NextOnly(mt.io.DataIter):
    """An iterator's ``next()`` without its ``next_host()``."""

    def __init__(self, it):
        super().__init__(it.batch_size)
        self.it = it
        self.provide_data = it.provide_data
        self.provide_label = it.provide_label

    def reset(self):
        self.it.reset()

    def next(self):
        return self.it.next()


@pytest.mark.parametrize("nw", [0, 2])
def test_superbatch_over_next_host_matches_next_and_reference(nw, tmp_path):
    rec = _make_rec(str(tmp_path / "s.rec"), n=44, name="superbatch")
    kw = dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=9)
    out = {}
    for pkg, host in ((mx, True), (mt, True), (mt, False)):
        it = _record_iter(pkg, rec, nw, **kw)
        extra = {} if pkg is mx else {"device": "cpu"}
        # without the hook the superbatch stacks next()'s NDArrays
        sb = pkg.io.SuperBatchIter(it if host else _NextOnly(it), 2, **extra)
        out[pkg, host] = _stacked(sb)
        sb.close()
        it.close()
    want = out[mx, True]
    assert len(want) == 3 and want[-1][0] == 2 and want[-1][1] == [0, 4]
    for key in ((mt, True), (mt, False)):
        got = out[key]
        assert [g[:2] for g in got] == [w[:2] for w in want]
        for g, w in zip(got, want):
            for u, v in zip(g[2], w[2]):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


def test_device_prefetcher_charges_the_iterator_stats(tmp_path):
    rec = _make_rec(str(tmp_path / "p.rec"), n=32, name="prefetch")
    it = _record_iter(mt, rec, 2)
    pf = tdata.DevicePrefetcher(it, 2, depth=1, device="cpu")
    assert pf.stats is it.data_stats
    assert len(_stacked(pf)) == 2
    rep = it.data_stats.report()
    for stage in ("read", "decode", "stack", "h2d", "stall"):
        assert rep["%s_n" % stage] > 0, stage
    assert 0.0 <= rep["stall_frac"] <= 1.0
    assert tdata.PIPELINE_STATS.report()["decode_n"] >= rep["decode_n"]
    # set_epoch pins the base to that epoch's order
    ref = _record_iter(mt, rec, 1, shuffle=True, seed=3)
    ref.set_epoch(1)
    want = ref.next_host().data[0]
    ref.close()
    it2 = _record_iter(mt, rec, 2, shuffle=True, seed=3)
    pf2 = tdata.DevicePrefetcher(it2, 2, depth=1, device="cpu")
    pf2.set_epoch(1)
    np.testing.assert_array_equal(pf2.next().data[0].asnumpy()[0], want)
    for x in (pf, pf2, it, it2):
        x.close()


@pytest.mark.faults
def test_superbatch_transient_and_producer_faults(tmp_path):
    rec = _make_rec(str(tmp_path / "f.rec"), n=32, name="sbfaults")
    it = _record_iter(mt, rec, 2)
    clean = _stacked(mt.io.SuperBatchIter(it, 2, device="cpu"))
    it.close()
    it = _record_iter(mt, rec, 2)
    health = mt.io.DataHealth()
    tfaults.inject("io.batch_read", nth=2, kind="transient")
    tfaults.inject("io.h2d", nth=3, kind="transient")
    sb = mt.io.SuperBatchIter(it, 2, device="cpu", data_health=health,
                              retry_policy=mt.io.RetryPolicy(base_delay=0))
    got = _stacked(sb)
    sb.close()
    it.close()
    assert health.report()["retries"] == 2
    for g, w in zip(got, clean):
        for u, v in zip(g[2], w[2]):
            np.testing.assert_array_equal(u, v)
    tfaults.clear()
    tfaults.inject("superbatch.producer", nth=1, kind="die")
    it = _record_iter(mt, rec, 2)
    sb = mt.io.SuperBatchIter(it, 2, device="cpu")
    with pytest.raises(MXNetError, match="superbatch.producer"):
        sb.next()
    sb.close()
    it.close()


# -- Module.fit through the tier ----------------------------------------------

def _lenet(pkg):
    with pkg.symbol.NameManager():
        return pkg.models.lenet(num_classes=4)


def _lenet_params(seed=0):
    rng = _rng("lenet/%d" % seed)
    sym = _lenet(mx)
    shapes, _, _ = sym.infer_shape(data=(8, 3, 28, 28), softmax_label=(8,))
    out = {}
    for n, sh in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight"):
            fan = np.prod(sh[1:]) + sh[0]
            out[n] = rng.uniform(-1, 1, sh) * np.sqrt(6.0 / fan)
        else:
            out[n] = 0.1 * rng.standard_normal(sh)
    return {n: v.astype(np.float32) for n, v in out.items()}


OPT = (("learning_rate", 0.05), ("momentum", 0.9), ("wd", 1e-4))


@pytest.mark.parametrize("k", [1, 2])
def test_fit_lenet_from_image_record_iter_matches_reference(k, tmp_path):
    rec = _make_rec(str(tmp_path / "l.rec"), n=48, name="fit")
    params = _lenet_params()
    out = {}
    for pkg in (mx, mt):
        it = _record_iter(pkg, rec, 2, shuffle=True, rand_crop=True,
                          rand_mirror=True, mean_r=110.0, mean_g=110.0,
                          mean_b=110.0, std_r=40.0, std_g=40.0, std_b=40.0,
                          seed=5)
        metric = pkg.metric.Accuracy()
        mod = pkg.mod.Module(_lenet(pkg), context=pkg.cpu())
        mod.fit(it, num_epoch=1, eval_metric=metric,
                arg_params={n: pkg.nd.array(v, ctx=pkg.cpu())
                            for n, v in params.items()},
                optimizer="sgd", optimizer_params=OPT, steps_per_dispatch=k,
                dispatch_pipeline=1)
        it.close()
        arg, aux = mod.get_params()
        out[pkg] = ({n: v.asnumpy() for n, v in list(arg.items())
                     + list(aux.items())},
                    (int(round(metric.sum_metric)), metric.num_inst))
    assert out[mt][1] == out[mx][1] and out[mt][1][1] == 48
    assert sorted(out[mt][0]) == sorted(out[mx][0])
    for n, v in out[mx][0].items():
        np.testing.assert_allclose(out[mt][0][n], v, err_msg=n, **TOL)


class _Stop(Exception):
    pass


def _fit_port(rec, nw, k, stop_after=None, prefix=None):
    mt.random.seed(0)
    it = _record_iter(mt, rec, nw, shuffle=True, rand_crop=True,
                      rand_mirror=True, seed=5)
    mod = mt.mod.Module(_lenet(mt), context=mt.cpu())
    seen = []

    def cb(p):
        seen.append((p.epoch, p.nbatch))
        if stop_after is not None and p.epoch * 6 + p.nbatch + 1 >= stop_after:
            raise _Stop()
    try:
        mod.fit(it, num_epoch=2, optimizer="sgd", optimizer_params=OPT,
                arg_params={n: mt.nd.array(v, ctx=mt.cpu())
                            for n, v in _lenet_params().items()},
                steps_per_dispatch=k, batch_end_callback=cb,
                checkpoint_prefix=prefix,
                checkpoint_every_n_batches=2 if prefix else None,
                resume="auto" if prefix else None)
    except _Stop:
        pass
    finally:
        it.close()
    arg, aux = mod.get_params()
    return {n: v.asnumpy() for n, v in list(arg.items())
            + list(aux.items())}, seen


@pytest.mark.parametrize("nw,k", [(1, 1), (3, 2)])
def test_fit_stopped_and_resumed_equals_uninterrupted(nw, k, tmp_path):
    rec = _make_rec(str(tmp_path / "r.rec"), n=48, name="resume")
    ref, seen = _fit_port(rec, nw, k)
    assert seen[-1] == (1, 5)
    prefix = str(tmp_path / "ck")
    _fit_port(rec, nw, k, stop_after=8, prefix=prefix)
    got, seen = _fit_port(rec, nw, k, prefix=prefix)
    # the resumed run trains only the second epoch's batches after the
    # newest checkpoint
    assert seen[0][0] == 1 and seen[-1] == (1, 5)
    assert sorted(got) == sorted(ref)
    for n in ref:
        np.testing.assert_array_equal(got[n], ref[n], err_msg=n)


@pytest.mark.faults
def test_fit_dead_worker_surfaces_not_hangs(tmp_path):
    rec = _make_rec(str(tmp_path / "d.rec"), n=48, name="dead")
    tfaults.inject("data.worker_die", nth=3, kind="die")
    it = _record_iter(mt, rec, 2, shuffle=True, seed=5)
    mod = mt.mod.Module(_lenet(mt), context=mt.cpu())
    with pytest.raises(MXNetError, match="data.worker_die"):
        mod.fit(it, num_epoch=1, steps_per_dispatch=2,
                optimizer_params={"learning_rate": 0.1})
    it.close()


def test_registry_carries_the_data_views(tmp_path):
    rec = _make_rec(str(tmp_path / "v.rec"), n=16, name="views")
    tfaults.inject("io.record_read", nth=2, kind="transient")
    before = REGISTRY.snapshot()["data_health.retries"]
    it = _record_iter(mt, rec, 2, retry_policy=mt.io.RetryPolicy(
        base_delay=0.0))
    it.next_host()
    it.close()
    snap = REGISTRY.snapshot()
    assert snap["data_health.retries"] == before + 1
    assert snap["pipeline_stats.decode_n"] >= 8
    for view in ("data_health", "pipeline_stats", "training_health",
                 "serving_health"):
        assert any(k.startswith(view + ".") for k in snap), view
