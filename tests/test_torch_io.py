"""The port's data iterators against the JAX package's, on the CPU.

``NDArrayIter`` (batches, ``pad``, ``reset`` and each
``last_batch_handle``), ``ResizeIter``, ``PrefetchingIter`` and
``SuperBatchIter`` stacking (with and without its producer thread, partial
and discarded tails) read the same numpy arrays in both packages.
Tolerance: exact, since nothing is computed (the same float32 values are
sliced, padded and stacked). ``CSVIter`` and ``MNISTIter`` read files the
test writes (exact); ``RetryPolicy``'s backoff and ``retry_call``'s
counting and give-up match the JAX package's (exact).
"""
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _arrays(n=10, name="io"):
    rng = _rng(name)
    x = rng.standard_normal((n, 3, 2)).astype(np.float32)
    y = rng.integers(0, 5, n).astype(np.float32)
    return x, y


def _epoch(it):
    """[(data arrays, label arrays, pad)] of one pass over ``it``."""
    out = []
    for b in it:
        out.append(([d.asnumpy() for d in b.data],
                    [l.asnumpy() for l in (b.label or [])], b.pad))
    return out


def _assert_same_epochs(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for u, v in zip(da + la, db + lb):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("batch_size", [3, 4, 5])
def test_ndarrayiter_matches_reference(handle, batch_size):
    x, y = _arrays()
    jit = mx.io.NDArrayIter(x, y, batch_size=batch_size,
                            last_batch_handle=handle)
    tit = mt.io.NDArrayIter(x, y, batch_size=batch_size,
                            last_batch_handle=handle)
    assert [tuple(d) for d in tit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    assert [tuple(d) for d in tit.provide_label] == \
        [tuple(d) for d in jit.provide_label]
    for _ in range(3):      # reset (roll_over moves the cursor) twice
        _assert_same_epochs(_epoch(tit), _epoch(jit))
        jit.reset()
        tit.reset()


def test_ndarrayiter_dict_inputs_and_host_batches():
    x, y = _arrays()
    data = {"a": x, "b": x[:, :1]}
    jit = mx.io.NDArrayIter(data, {"lbl": y}, batch_size=4)
    tit = mt.io.NDArrayIter(data, {"lbl": y}, batch_size=4)
    assert [d.name for d in tit.provide_data] == ["a", "b"]
    _assert_same_epochs(_epoch(tit), _epoch(jit))
    tit.reset()
    b = tit.next()
    assert b.data[0].context == mt.cpu()   # numpy sources stay on the host


def test_ndarrayiter_over_ndarrays_slices_them_where_they_lie():
    x, y = _arrays()
    with mt.cpu():
        tit = mt.io.NDArrayIter(mt.nd.array(x), mt.nd.array(y),
                                batch_size=4)
    jit = mx.io.NDArrayIter(x, y, batch_size=4)
    _assert_same_epochs(_epoch(tit), _epoch(jit))


def test_ndarrayiter_shuffle_is_one_permutation():
    x, y = _arrays(12)
    x[:, 0, 0] = np.arange(12)
    y[:] = np.arange(12)
    mt.random.seed(3)
    it = mt.io.NDArrayIter(x, y, batch_size=4, shuffle=True)
    got = _epoch(it)
    xs = np.concatenate([d[0] for d, _, _ in got])[:, 0, 0]
    ys = np.concatenate([l[0] for _, l, _ in got])
    np.testing.assert_array_equal(xs, ys)
    assert sorted(ys.tolist()) == list(range(12))
    mt.random.seed(3)
    again = _epoch(mt.io.NDArrayIter(x, y, batch_size=4, shuffle=True))
    _assert_same_epochs(again, got)


def test_ndarrayiter_errors():
    x, y = _arrays(3)
    with pytest.raises(MXNetError, match="batch_size"):
        mt.io.NDArrayIter(x, y, batch_size=4)
    it = mt.io.NDArrayIter(x, y, batch_size=3)
    it.next()
    with pytest.raises(StopIteration):
        it.next()


def test_resizeiter_matches_reference():
    x, y = _arrays()
    jit = mx.io.ResizeIter(mx.io.NDArrayIter(x, y, batch_size=4), 7)
    tit = mt.io.ResizeIter(mt.io.NDArrayIter(x, y, batch_size=4), 7)
    for _ in range(2):
        _assert_same_epochs(_epoch(tit), _epoch(jit))
        jit.reset()
        tit.reset()


def test_prefetchingiter_matches_reference():
    x, y = _arrays()
    x2, y2 = _arrays(name="io2")
    jit = mx.io.PrefetchingIter(
        [mx.io.NDArrayIter(x, y, batch_size=4),
         mx.io.NDArrayIter(x2, y2, batch_size=4)],
        rename_data=[{"data": "d1"}, {"data": "d2"}])
    tit = mt.io.PrefetchingIter(
        [mt.io.NDArrayIter(x, y, batch_size=4),
         mt.io.NDArrayIter(x2, y2, batch_size=4)],
        rename_data=[{"data": "d1"}, {"data": "d2"}])
    assert [d.name for d in tit.provide_data] == ["d1", "d2"]
    for _ in range(2):
        _assert_same_epochs(_epoch(tit), _epoch(jit))
        jit.reset()
        tit.reset()
    tit.close()


def _super_epoch(it):
    out = []
    for sb in it:
        out.append((sb.num_steps, list(sb.pads),
                    [d.asnumpy() for d in sb.data],
                    [l.asnumpy() for l in sb.label]))
    return out


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("tail", ["partial", "discard"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_superbatchiter_stacking_matches_reference(k, tail, prefetch):
    x, y = _arrays(14)
    jit = mx.io.SuperBatchIter(mx.io.NDArrayIter(x, y, batch_size=4), k,
                               prefetch=prefetch, last_group_handle=tail)
    tit = mt.io.SuperBatchIter(mt.io.NDArrayIter(x, y, batch_size=4), k,
                               prefetch=prefetch, last_group_handle=tail,
                               device="cpu")
    assert [tuple(d) for d in tit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    for _ in range(2):
        got, want = _super_epoch(tit), _super_epoch(jit)
        assert [g[:2] for g in got] == [w[:2] for w in want]
        for g, w in zip(got, want):
            for u, v in zip(g[2] + g[3], w[2] + w[3]):
                np.testing.assert_array_equal(u, v)
        jit.reset()
        tit.reset()
    tit.close()
    jit.close()


def test_superbatch_unstack_gives_the_batches():
    x, y = _arrays(8)
    base = mt.io.NDArrayIter(x, y, batch_size=4)
    sb = base.superbatch(2, device="cpu").next()
    for i, b in enumerate(sb.unstack()):
        np.testing.assert_array_equal(b.data[0].asnumpy(), x[4 * i:4 * i + 4])
        np.testing.assert_array_equal(b.label[0].asnumpy(), y[4 * i:4 * i + 4])


def test_superbatch_defaults_to_the_card():
    x, y = _arrays(8)
    base = mt.io.NDArrayIter(x, y, batch_size=4)
    if torch.cuda.is_available():
        sb = base.superbatch(2).next()
        assert sb.data[0].context == mt.gpu(0)
        return
    with pytest.raises(MXNetError, match="CUDA is not available"):
        base.superbatch(2)


def test_device_prefetcher_charges_its_stats():
    x, y = _arrays(16)
    it = mt.data.DevicePrefetcher(mt.io.NDArrayIter(x, y, batch_size=4), 2,
                                  depth=1, device="cpu")
    assert it._depth == 2
    assert len(_super_epoch(it)) == 2
    rep = it.stats.report()
    # 2 superbatches x (data, label) x 2 batches landed; 3 waits (the last
    # one reads the end marker)
    assert rep["h2d_n"] == 8 and rep["stall_n"] == 3
    assert rep["queue_depth_avg"] >= 0
    it.set_epoch(0)     # NDArrayIter has no epoch-addressable order
    it.close()


@pytest.mark.parametrize("round_batch", [True, False])
@pytest.mark.parametrize("label_shape", [(1,), (2,)])
def test_csv_iter_matches_reference(round_batch, label_shape, tmp_path):
    rng = _rng("csv")
    x = rng.standard_normal((11, 6)).astype(np.float32)
    y = rng.integers(0, 5, (11,) + label_shape).astype(np.float32)
    np.savetxt(str(tmp_path / "d.csv"), x, delimiter=",")
    np.savetxt(str(tmp_path / "l.csv"), y.reshape(11, -1), delimiter=",")
    out = {}
    for pkg in (mx, mt):
        it = pkg.io.CSVIter(data_csv=str(tmp_path / "d.csv"),
                            data_shape=(2, 3),
                            label_csv=str(tmp_path / "l.csv"),
                            label_shape=label_shape, batch_size=4,
                            round_batch=round_batch)
        assert [tuple(d) for d in it.provide_data] == [("data", (4, 2, 3))]
        out[pkg] = _epoch(it) + (it.reset() or _epoch(it))
    assert len(out[mt]) == (6 if round_batch else 4)
    for (td, tl, tp), (jd, jl, jp) in zip(out[mt], out[mx]):
        assert tp == jp
        for u, v in zip(td + tl, jd + jl):
            np.testing.assert_array_equal(u, v)


def _write_idx(path, arr):
    import gzip
    import struct
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [True, False])
@pytest.mark.parametrize("flat", [True, False])
def test_mnist_iter_matches_reference(gz, flat, tmp_path):
    rng = _rng("mnist")
    imgs = rng.integers(0, 256, (20, 7, 5))
    labs = rng.integers(0, 10, 20)
    ext = ".gz" if gz else ""
    ipath, lpath = (str(tmp_path / ("img" + ext)),
                    str(tmp_path / ("lab" + ext)))
    _write_idx(ipath, imgs)
    _write_idx(lpath, labs)
    out = {}
    for pkg in (mx, mt):
        it = pkg.io.MNISTIter(image=ipath, label=lpath, batch_size=6,
                              shuffle=False, flat=flat, num_parts=2,
                              part_index=1)
        out[pkg] = _epoch(it)
    want_x = imgs[10:20].astype(np.float32) / 255.0
    got_x = np.concatenate([b[0][0] for b in out[mt]])[:10]
    np.testing.assert_array_equal(
        got_x, want_x.reshape(10, -1) if flat else want_x[:, None])
    for (td, tl, tp), (jd, jl, jp) in zip(out[mt], out[mx]):
        assert tp == jp
        for u, v in zip(td + tl, jd + jl):
            np.testing.assert_array_equal(u, v)
    # shuffled: the same images, in the port's own order
    it = mt.io.MNISTIter(image=ipath, label=lpath, batch_size=5, flat=True)
    rows = np.concatenate([b[0][0] for b in _epoch(it)])
    np.testing.assert_array_equal(
        np.sort(rows, axis=0),
        np.sort(imgs.reshape(20, -1).astype(np.float32) / 255.0, axis=0))


def test_retry_policy_and_retry_call_match_reference(monkeypatch):
    monkeypatch.setenv("MXTPU_RANK", "3")
    for attempt in range(1, 6):
        for site in ("io.record_read", "io.h2d"):
            t = mt.io.RetryPolicy(base_delay=0.01, max_delay=0.05)
            j = mx.io.RetryPolicy(base_delay=0.01, max_delay=0.05)
            assert t.delay(attempt, site) == j.delay(attempt, site)
    assert mt.io.RetryPolicy().delay(2, "x") != \
        mt.io.RetryPolicy(jitter=0).delay(2, "x")
    for pkg in (mx, mt):
        health = pkg.io.DataHealth(parent=pkg.io.DataHealth())
        policy = pkg.io.RetryPolicy(max_retries=2, base_delay=0.0)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("flaky read")
            return "ok"
        assert pkg.io.retry_call(flaky, "io.record_read", policy,
                                 health) == "ok"
        assert health.report()["retries"] == 2
        with pytest.raises(pkg.base.MXNetError, match="giving up after 3"):
            pkg.io.retry_call(lambda: (_ for _ in ()).throw(OSError("x")),
                              "io.record_read", policy, health)
        with pytest.raises(FileNotFoundError):
            pkg.io.retry_call(lambda: open("/nonexistent/file"), "s",
                              policy, health)
        rep = health.report()
        assert (rep["retries"], rep["failures"]) == (4, 1)
        assert health._parent.report()["failures"] == 1
        health.reset()
        assert health.report()["retries"] == 0
