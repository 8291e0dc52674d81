"""The port's dynamic batcher against the JAX package's.

Each test is the counterpart of one batcher test of
``tests/test_serving.py`` (the backlog coalescing, concurrent callers,
deadlines, back-pressure, oversized and malformed requests, close and the
``serve.enqueue_drop`` fault), run on the port's ``Batcher`` over a CPU
``ServingEngine``, plus the thread-death shed. The MLP and its weights are
the JAX tests' (numpy ``RandomState(0)``); where a test compares served
rows with a forward, the port's own engine or ``Predictor`` is held
bitwise (padding and co-riders never leak), and the JAX package's
``Predictor`` on the same rows within ``ATOL`` (f32 matmuls of another
library, summed in another order). Threaded tests wait on events and
requests, never on sleeps.
"""
import threading

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import faults, serving
from mxnet_tpu_torch.base import MXNetError

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


def _engine(buckets=(4, 8), **kw):
    return serving.ServingEngine(_mlp_sym(mt), _mlp_params(), {"data": (6,)},
                                 buckets=buckets, device="cpu", **kw)


def _x(n, seed=1):
    return np.random.RandomState(seed).rand(n, 6).astype(np.float32)


def _jax_forward(x):
    params = {k: mx.nd.array(v) for k, v in _mlp_params().items()}
    pred = mx.Predictor(_mlp_sym(mx), params, {"data": x.shape})
    return pred.forward(data=x).get_output(0).asnumpy()


def test_batcher_coalesces_backlog_into_one_bucket():
    eng = _engine(buckets=(4, 8))
    b = serving.Batcher(eng, max_latency_ms=50.0, start=False)
    x = _x(3)
    reqs = [b.submit({"data": x[i:i + 1]}) for i in range(3)]
    before = eng.health.batches
    b.start()
    outs = [b.wait(r) for r in reqs]
    got = np.concatenate([o[0] for o in outs])
    params = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in _mlp_params().items()}
    pred = mt.Predictor(_mlp_sym(mt), params, {"data": (3, 6)}, ctx=mt.cpu())
    assert np.array_equal(got, pred.forward(data=x).get_output(0).asnumpy())
    np.testing.assert_allclose(got, _jax_forward(x), rtol=0, atol=ATOL)
    # the backlog coalesced: one dispatch for all three requests
    assert eng.health.batches == before + 1
    assert b.health.requests == 3
    b.close()


def test_batcher_concurrent_callers_bitwise():
    eng = _engine(buckets=(4, 8))
    b = serving.Batcher(eng, max_latency_ms=20.0)
    x = _x(8)
    results = [None] * 8
    errs = []

    def call(i):
        try:
            results[i] = b.infer({"data": x[i:i + 1]})[0]
        except Exception as e:   # surface in the main thread
            errs.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
        assert not t.is_alive()
    assert not errs
    # the callers may arrive more than the window apart, so a row rides
    # bucket 4 or bucket 8, and torch's CPU matmul picks its kernel by the
    # batch: each row must equal, bit for bit, the engine's answer for it
    # at one of the two buckets (padding and co-riders never leak)
    at4 = [eng.infer({"data": x[i:i + 1]})[0][0] for i in range(8)]
    at8 = eng.infer({"data": x})[0]
    for i, row in enumerate(results):
        assert (np.array_equal(row[0], at4[i])
                or np.array_equal(row[0], at8[i])), i
    got = np.concatenate(results)
    np.testing.assert_allclose(got, _jax_forward(x), rtol=0, atol=ATOL)
    b.close()


def test_batcher_queued_callers_coalesce_into_bucket8_bitwise():
    # the strict claim without timing: eight one-row requests queued before
    # the batching thread starts ride one bucket-8 dispatch, and each row
    # equals the engine's answer for all eight rows at once, bit for bit
    eng = _engine(buckets=(4, 8))
    b = serving.Batcher(eng, max_latency_ms=20.0, start=False)
    x = _x(8)
    reqs = [b.submit({"data": x[i:i + 1]}) for i in range(8)]
    before = eng.health.batches
    b.start()
    got = np.concatenate([b.wait(r)[0] for r in reqs])
    assert eng.health.batches == before + 1
    assert np.array_equal(got, eng.infer({"data": x})[0])
    np.testing.assert_allclose(got, _jax_forward(x), rtol=0, atol=ATOL)
    b.close()


def test_batcher_request_deadline_expires():
    eng = _engine(buckets=(4,))
    b = serving.Batcher(eng, start=False)
    req = b.submit({"data": _x(1)}, deadline_ms=0.0)
    b.start()
    with pytest.raises(serving.ServingDeadlineError):
        b.wait(req)
    assert b.health.expired >= 1
    b.close()


def test_batcher_backpressure_bounded_queue():
    eng = _engine(buckets=(4,))
    b = serving.Batcher(eng, queue_size=1, start=False)
    b.submit({"data": _x(1)})
    with pytest.raises(serving.ServingOverloadedError):
        b.submit({"data": _x(1)})
    assert b.health.dropped == 1
    b.close()


def test_batcher_oversized_request_rejected():
    eng = _engine(buckets=(4,))
    b = serving.Batcher(eng, start=False)
    with pytest.raises(MXNetError, match="max_batch"):
        b.submit({"data": _x(5)})
    b.close()


def test_batcher_rejects_malformed_shape_at_submit():
    """A bad per-example shape is rejected ALONE at submit — once
    coalesced it would fail every innocent co-rider in its batch."""
    eng = _engine(buckets=(4,))
    b = serving.Batcher(eng, max_latency_ms=50.0, start=False)
    good = b.submit({"data": _x(1)})
    with pytest.raises(MXNetError, match="per-example shape"):
        b.submit({"data": np.zeros((1, 7), np.float32)})
    b.start()
    out = b.wait(good)[0]          # the valid request is unaffected
    assert out.shape == (1, 4)
    np.testing.assert_allclose(out, _jax_forward(_x(1)), rtol=0, atol=ATOL)
    b.close()


def test_batcher_close_sheds_queued_requests():
    eng = _engine(buckets=(4,))
    b = serving.Batcher(eng, start=False)
    r1 = b.submit({"data": _x(1)})
    r2 = b.submit({"data": _x(1)})
    b.close()
    for r in (r1, r2):
        with pytest.raises(serving.ServingClosedError):
            b.wait(r)
    assert b.health.shed == 2
    with pytest.raises(serving.ServingClosedError):
        b.submit({"data": _x(1)})


@pytest.mark.faults
def test_fault_enqueue_drop_rejects_with_clear_error():
    eng = _engine(buckets=(4,))
    b = serving.Batcher(eng, start=False)
    with faults.scoped("serve.enqueue_drop", nth=2, kind="drop"):
        b.submit({"data": _x(1)})              # call 1: clean
        with pytest.raises(serving.ServingOverloadedError,
                           match="enqueue"):
            b.submit({"data": _x(1)})          # call 2: dropped
    assert b.health.dropped == 1
    b.close()


@pytest.mark.faults
def test_batcher_thread_death_sheds_in_flight_and_dumps(tmp_path,
                                                        monkeypatch):
    """A batching thread killed by its per-batch fault site fails the
    popped batch with ServingClosedError (no hang), refuses later submits,
    and writes the flight recorder's post-mortem."""
    from mxnet_tpu_torch.obs import flight
    path = tmp_path / "flight.json"
    monkeypatch.setenv("MXTPU_FLIGHT_RECORDER_PATH", str(path))
    eng = _engine(buckets=(4,))
    b = serving.Batcher(eng, max_latency_ms=1.0, start=False,
                        fault_site="fleet.replica_die")
    faults.inject("fleet.replica_die", nth=1, kind="die")
    req = b.submit({"data": _x(1)})
    b.start()
    with pytest.raises(serving.ServingClosedError, match="died"):
        b.wait(req)
    b._thread.join(5.0)
    assert not b._thread.is_alive()
    assert "replica death" in repr(b.dead)
    assert b.health.shed == 1
    assert eng.health.batches == 0
    with pytest.raises(serving.ServingClosedError, match="died"):
        b.submit({"data": _x(1)})
    if flight.enabled():
        assert path.exists()
        assert "batcher thread died" in flight.FLIGHT.last_dump["reason"]
