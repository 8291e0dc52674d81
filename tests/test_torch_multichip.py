"""Data parallelism of the PyTorch port over a 'data' mesh of replicas
against the JAX package's over the conftest's 8 virtual CPU devices, and
against the port's own single-device runs, on the CPU.

The port's replicas of ``cpu(0)..cpu(7)`` all run on the host CPU device
(one process walks them in lock step); the JAX package's contexts are 8
XLA CPU devices. The same numpy inputs, seeds and weights go through both.
Tolerances, each with its reason:
- the MLP ``Module.fit`` over 8 contexts against the JAX package's
  8-context fit and the port's 1-context fit: ``rtol=1e-4, atol=1e-5``, as
  ``tests/test_multichip.py`` holds the JAX package's 8- and 1-device fits
  (float32 sums in other orders);
- the narrow ResNet (Conv1x1->BatchNorm fusion, B1's plain version) one
  ``TrainStep(mesh=)`` step at 4 replicas against the JAX package's
  ``TrainStep(mesh=data_parallel_mesh(4))``: parameters, momentum and
  moving statistics ``rtol=1e-4, atol=1e-5`` (the one-step tolerance of
  ``tests/test_torch_train.py``); two steps at lr 0.003 ``rtol=1e-3,
  atol=1e-5`` (BatchNorm over 2 rows a replica amplifies a step's last-bit
  differences in the next); bfloat16 compute in norm, as that file holds
  bf16 steps;
- Dropout, K=2 against K=1, the guard and resume: exact (the same code on
  the same tensors, or a checkpoint round trip);
- BucketingModule over 2 contexts: ``tests/test_torch_bucketing.py``'s run
  tolerance (parameters ``rtol=1e-3, atol=1e-5``, perplexity 1e-4);
- FeedForward and ``predict`` over contexts: ``rtol=1e-4, atol=1e-5``.
"""
import json
import logging
import os
import sys
import time
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.parallel.mesh import data_parallel_mesh as j_dp_mesh
from mxnet_tpu.train_step import TrainStep as JTrainStep
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert, faults
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import matmul_stats as tms
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh, P
from mxnet_tpu_torch.train_step import TrainStep

sys.path.insert(0, os.path.dirname(__file__))

FIT = dict(rtol=1e-4, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    mx.faults.clear()
    yield
    faults.clear()
    mx.faults.clear()


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _cpu_mesh(n):
    """A 'data' mesh of ``n`` positions on the CPU (without CUDA a mesh
    has no default devices)."""
    return data_parallel_mesh(n, devices=["cpu"] * n)


# ---------------------------------------------------------------------------
# the MLP of tests/test_multichip.py through Module.fit
# ---------------------------------------------------------------------------

def _mlp(pkg, dropout=0.0):
    with pkg.symbol.NameManager():
        data = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(data=data, num_hidden=16, name="fc1")
        net = pkg.sym.Activation(data=net, act_type="relu")
        if dropout:
            net = pkg.sym.Dropout(data=net, p=dropout)
        net = pkg.sym.FullyConnected(data=net, num_hidden=4, name="fc2")
        return pkg.sym.SoftmaxOutput(data=net, name="softmax")


def _fit_data(n=128):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(n, 10)).astype(np.float32)
    w = rng.normal(size=(10, 4)).astype(np.float32)
    y = np.argmax(X @ w, axis=1).astype(np.float32)
    return X, y


def _weights():
    rng = _rng("mlp-weights")
    return {"fc1_weight": (0.3 * rng.standard_normal((16, 10))),
            "fc1_bias": np.zeros(16),
            "fc2_weight": (0.3 * rng.standard_normal((4, 16))),
            "fc2_bias": np.zeros(4)}


def _fit(pkg, nctx, k=2, num_epoch=2, batch=32, **kw):
    X, y = _fit_data()
    it = pkg.io.NDArrayIter(X, y, batch_size=batch)
    ctx = [pkg.cpu(i) for i in range(nctx)] if nctx > 1 else pkg.cpu()
    mod = pkg.mod.Module(_mlp(pkg), context=ctx)
    c = pkg.cpu()
    mod.fit(it, num_epoch=num_epoch, steps_per_dispatch=k,
            arg_params={n: pkg.nd.array(v.astype(np.float32), ctx=c)
                        for n, v in _weights().items()},
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9}, **kw)
    return mod


def _params(mod):
    return {n: v.asnumpy() for n, v in mod.get_params()[0].items()}


def test_mlp_fit_over_8_contexts_matches_jax_and_one_context():
    """Module.fit over cpu(0)..cpu(7) (the K-step path over an 8-replica
    mesh) against the JAX package's 8-context fit and the port's 1-context
    fit: the summed gradient is the one-device batch's gradient."""
    j8 = _params(_fit(mx, 8))
    t8mod = _fit(mt, 8)
    assert t8mod._fused.mesh is not None
    assert tmesh.data_axis_size(t8mod._fused.mesh) == 8
    t8, t1 = _params(t8mod), _params(_fit(mt, 1))
    for n in j8:
        np.testing.assert_allclose(t8[n], j8[n], err_msg=n, **FIT)
        np.testing.assert_allclose(t8[n], t1[n], err_msg=n, **FIT)


def test_replicas_bitwise_identical_after_fit():
    """Every replica's parameters, moving statistics and optimizer states
    equal replica 0's bit for bit after a fit: one update, applied to the
    same summed gradient everywhere."""
    mod = _fit(mt, 8, k=4)
    reps = mod._fused.replica_states(mod._fused_state)
    assert len(reps) == 8
    for rep in reps[1:]:
        for key in ("params", "aux"):
            for n, v in reps[0][key].items():
                assert torch.equal(rep[key][n], v), (key, n)
        for n, s in reps[0]["opt"].items():
            for a, b in zip(s, rep["opt"][n]):
                assert torch.equal(a, b), n
        assert int(rep["step"]) == int(reps[0]["step"])


def test_sharded_fit_engages_mesh_and_superbatch_sharding():
    mod = _fit(mt, 8)
    sh = mod._superbatch_sharding()
    assert sh is not None and sh.spec == P(None, "data")
    assert _fit(mt, 1)._superbatch_sharding() is None


def test_superbatch_iter_lands_split():
    """With ``sharding=``, each stacked slot comes split per replica and
    the step over that mesh takes it as it is."""
    mesh = _cpu_mesh(8)
    sh = tmesh.superbatch_sharding(mesh)
    X, y = _fit_data()
    it = mt.io.NDArrayIter(X, y, batch_size=32)
    sb_it = it.superbatch(2, sharding=sh, device="cpu")
    try:
        batch = next(iter(sb_it))
        for arr in batch.data + batch.label:
            assert isinstance(arr, tmesh.MeshArray)
            assert arr.sharding.spec == P(None, "data")
            assert [tuple(p.shape[:2]) for p in arr.parts] == [(2, 4)] * 8
        np.testing.assert_array_equal(batch.data[0].gather().numpy(),
                                      np.stack([X[:32], X[32:64]]))
        ts = TrainStep(_mlp(mt), optimizer="sgd", mesh=mesh)
        placed = ts.shard_superbatch({"data": batch.data[0],
                                      "softmax_label": batch.label[0]})
        assert placed["data"] is batch.data[0]
    finally:
        sb_it.close()


def test_module_global_batch_scale_and_speedometer(caplog):
    """Speedometer reports global samples a second: the module's
    ``_global_batch_scale`` (1 in one process) times the iterator's."""
    from mxnet_tpu_torch.callback import Speedometer
    from mxnet_tpu_torch.module.base_module import BatchEndParam
    assert _fit(mt, 8, num_epoch=1)._global_batch_scale() == 1

    class Dist(object):
        def _global_batch_scale(self):
            return 4

    def fire(mod):
        spd = Speedometer(batch_size=16, frequent=2)
        spd(BatchEndParam(epoch=0, nbatch=0, eval_metric=None,
                          locals={"self": mod}))
        spd.tic = time.time() - 1.0
        spd(BatchEndParam(epoch=0, nbatch=2, eval_metric=None,
                          locals={"self": mod}))
        for rec in caplog.records:
            if "Speed:" in rec.getMessage():
                return float(rec.getMessage().split("Speed: ")[1]
                             .split(" ")[0])
        raise AssertionError("Speedometer did not fire")

    with caplog.at_level(logging.INFO):
        local = fire(object())
    caplog.clear()
    with caplog.at_level(logging.INFO):
        scaled = fire(Dist())
    assert 0.8 * 4 < scaled / local < 1.2 * 4, (local, scaled)


def test_predict_over_contexts_merges_outputs_in_batch_order():
    """``predict`` over 4 contexts returns the whole batch's outputs in
    batch order, as one context and the JAX package's 4 contexts do."""
    X, y = _fit_data(40)
    out = {}
    for pkg, nctx in ((mx, 4), (mt, 4), (mt, 1)):
        ctx = [pkg.cpu(i) for i in range(nctx)] if nctx > 1 else pkg.cpu()
        mod = pkg.mod.Module(_mlp(pkg), context=ctx)
        it = pkg.io.NDArrayIter(X, y, batch_size=8)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                 for_training=False)
        c = pkg.cpu()
        mod.init_params(arg_params={n: pkg.nd.array(v.astype(np.float32),
                                                    ctx=c)
                                    for n, v in _weights().items()})
        out[(pkg.__name__, nctx)] = mod.predict(it).asnumpy()
    got = out[("mxnet_tpu_torch", 4)]
    assert got.shape == (40, 4)
    np.testing.assert_allclose(got, out[("mxnet_tpu_torch", 1)], **FIT)
    np.testing.assert_allclose(got, out[("mxnet_tpu", 4)], **FIT)


def test_executor_path_over_contexts_matches_jax():
    """forward, backward and update by hand over 2 contexts (the bound
    executor splits the batch, sums the gradients over the replicas, the
    per-index updater steps once): outputs and parameters against the JAX
    package's."""
    X, y = _fit_data(16)
    res = {}
    for pkg in (mx, mt):
        mod = pkg.mod.Module(_mlp(pkg), context=[pkg.cpu(0), pkg.cpu(1)])
        it = pkg.io.NDArrayIter(X, y, batch_size=8)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        c = pkg.cpu()
        mod.init_params(arg_params={n: pkg.nd.array(v.astype(np.float32),
                                                    ctx=c)
                                    for n, v in _weights().items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        outs = []
        for b in it:
            mod.forward(b, is_train=True)
            outs.append(mod.get_outputs()[0].asnumpy())
            mod.backward()
            mod.update()
        res[pkg.__name__] = (outs, _params(mod))
    (jo, jp), (to, tp) = res["mxnet_tpu"], res["mxnet_tpu_torch"]
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, **FIT)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], err_msg=n, **FIT)


# ---------------------------------------------------------------------------
# a narrow ResNet with BatchNorm and the Conv1x1->BatchNorm fusion
# ---------------------------------------------------------------------------

B, HW = 8, 8


def _narrow_resnet(pkg):
    """A stem convolution, one bottleneck unit whose 1x1 NHWC convolutions
    feed BatchNorms (the fusion's pairs), a residual sum, pooling and a
    4-class head: every batch reduction of the ResNet path."""
    sym = pkg.sym
    with pkg.symbol.NameManager():
        data = sym.Variable("data")
        x = sym.Convolution(data=data, num_filter=8, kernel=(3, 3),
                            pad=(1, 1), no_bias=True, layout="NHWC",
                            name="stem")
        x = sym.BatchNorm(data=x, fix_gamma=False, axis=3, eps=2e-5,
                          name="stem_bn")
        x = sym.Activation(data=x, act_type="relu")
        y = sym.Convolution(data=x, num_filter=4, kernel=(1, 1),
                            no_bias=True, layout="NHWC", name="u1")
        y = sym.BatchNorm(data=y, fix_gamma=False, axis=3, eps=2e-5,
                          name="u1_bn")
        y = sym.Activation(data=y, act_type="relu")
        y = sym.Convolution(data=y, num_filter=8, kernel=(1, 1),
                            no_bias=True, layout="NHWC", name="u2")
        y = sym.BatchNorm(data=y, fix_gamma=False, axis=3, eps=2e-5,
                          name="u2_bn")
        x = sym.Activation(data=x + y, act_type="relu")
        x = sym.Pooling(data=x, kernel=(HW, HW), pool_type="avg",
                        global_pool=True, layout="NHWC")
        x = sym.Flatten(data=x)
        x = sym.FullyConnected(data=x, num_hidden=4, name="fc")
        return sym.SoftmaxOutput(data=x, name="softmax")


def _rn_batch(k=None, seed=0):
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    return {"data": rng.random(lead + (B, HW, HW, 3), dtype=np.float32),
            "softmax_label": rng.integers(0, 4, lead + (B,))
            .astype(np.float32)}


def _rn_steps(monkeypatch, compute_dtype=None, lr=0.01, n=4):
    kw = dict(optimizer="sgd", learning_rate=lr, momentum=0.9, wd=1e-4,
              compute_dtype=compute_dtype)
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "interpret")
    jstep = JTrainStep(_narrow_resnet(mx), mesh=j_dp_mesh(n), **kw)
    jst = jstep.init({"data": (B, HW, HW, 3)}, {"softmax_label": (B,)},
                     seed=3)
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    tstep = TrainStep(_narrow_resnet(mt), mesh=_cpu_mesh(n),
                      device="cpu", **kw)
    tst = tstep.replicate_state(convert.from_reference_state(jst, "cpu"))
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "interpret")
    return jstep, tstep, jst, tst


def _close(tst, jst, tol, keys=("params", "aux", "opt")):
    got = convert.to_reference_state(tst)
    for key in keys:
        for n, v in jst[key].items():
            np.testing.assert_allclose(got[key][n], np.asarray(v),
                                       err_msg="%s %s" % (key, n), **tol)


def test_narrow_resnet_mesh_step_matches_jax(monkeypatch):
    """One fused step at 4 replicas: parameters, momentum and the moving
    statistics against the JAX package's 4-device step. The fused pairs run
    B1's plain version on each replica's shard, its (s1, s2) summed across
    replicas."""
    jstep, tstep, jst, tst = _rn_steps(monkeypatch)
    assert len(tstep.replica_states(tst)) == 4
    tmesh.reset_counters()
    launches = tms.LAUNCHES
    batch = _rn_batch()
    jst, jouts = jstep.step(jst, batch)
    tst, touts = tstep.step(tst, batch)
    assert tms.LAUNCHES == launches          # CPU: B1's plain version
    assert tuple(touts[0].shape) == (B, 4)
    np.testing.assert_allclose(touts[0].numpy(), np.asarray(jouts[0]),
                               **STEP)
    _close(tst, jst, STEP)
    # 3 BatchNorms (f32 two-pass stem: 2 sums; 2 fused: s1 and s2 each),
    # and one gradient sum per parameter
    assert tmesh.COUNTERS["all_reduce"] == 2 + 2 * 2 + len(
        tstep.param_names)
    assert tmesh.COUNTERS["all_gather"] == 0


def test_narrow_resnet_per_replica_statistics_would_fail(monkeypatch):
    """The control: with BatchNorm's whole-batch rule taken away, each
    replica normalises by its own 2 rows (MXNet's per-device statistics)
    and the step no longer matches the JAX package's."""
    monkeypatch.setattr(treg.get("BatchNorm"), "mesh_fn", None)
    jstep, tstep, jst, tst = _rn_steps(monkeypatch)
    batch = _rn_batch()
    jst, _ = jstep.step(jst, batch)
    tst, _ = tstep.step(tst, batch)
    with pytest.raises(AssertionError):
        _close(tst, jst, STEP, keys=("aux",))


def test_narrow_resnet_mesh_run_steps_matches_jax(monkeypatch):
    """Two steps through ``run_steps`` at lr 0.003 and the packed metric
    sums, summed across replicas."""
    jstep, tstep, jst, tst = _rn_steps(monkeypatch, lr=0.003)
    sb = _rn_batch(k=2, seed=1)
    jst, jm = jstep.run_steps(jst, sb)
    tst, tm = tstep.run_steps(tst, sb)
    assert tm.num_samples == jm.num_samples == 2 * B
    assert tm.top1_correct == jm.top1_correct
    np.testing.assert_allclose(tm.loss_sum, jm.loss_sum, rtol=1e-4)
    _close(tst, jst, dict(rtol=1e-3, atol=1e-5))


def test_narrow_resnet_mesh_bf16_matches_jax(monkeypatch):
    """bfloat16 compute at 4 replicas: the one-pass 16-bit statistics
    summed across replicas. Held in norm, as tests/test_torch_train.py
    holds bf16 steps: the port's update as close to the JAX package's f32
    mesh update as the JAX package's bf16 mesh update is (within 25%), and
    the moving statistics to 2e-2 of their norm."""
    jstep, tstep, jst, tst = _rn_steps(monkeypatch, compute_dtype="bfloat16")
    j32, _, j32st, _ = _rn_steps(monkeypatch)
    init = convert.to_reference_state(tst)
    batch = _rn_batch(seed=2)
    ref, _ = j32.step(j32st, batch)
    jst, _ = jstep.step(jst, batch)
    tst, touts = tstep.step(tst, batch)
    assert touts[0].dtype == torch.bfloat16
    got = convert.to_reference_state(tst)
    f32 = {k: {n: np.asarray(v) for n, v in ref[k].items()}
           for k in ("params", "aux")}
    jb = {k: {n: np.asarray(v) for n, v in jst[k].items()}
          for k in ("params", "aux")}

    def dist(a, b, key):
        return np.sqrt(sum(np.sum(((a[key][n] - init[key][n])
                                   - (b[key][n] - init[key][n])) ** 2)
                           for n in init[key]))
    assert dist(got, f32, "params") <= 1.25 * dist(jb, f32, "params") + 1e-6
    num = np.sqrt(sum(np.sum((got["aux"][n] - jb["aux"][n]) ** 2)
                      for n in init["aux"]))
    den = np.sqrt(sum(np.sum(jb["aux"][n] ** 2) for n in init["aux"]))
    assert num <= 2e-2 * den


def test_mesh_k2_equals_k1(monkeypatch):
    """``run_steps`` over a K=2 superbatch and two single steps, each over
    the mesh: the same state, exactly."""
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    sb = _rn_batch(k=2, seed=4)
    states = []
    for k in (2, 1):
        ts = TrainStep(_narrow_resnet(mt), mesh=_cpu_mesh(4),
                       learning_rate=0.01, device="cpu")
        st = ts.init({"data": (B, HW, HW, 3)}, {"softmax_label": (B,)})
        if k == 2:
            st, m = ts.run_steps(st, sb)
            assert m.num_samples == 2 * B
        else:
            for i in range(2):
                st, _ = ts.step(st, {n: v[i] for n, v in sb.items()})
        states.append(st)
    for key in ("params", "aux"):
        for n, v in states[0][key].items():
            assert torch.equal(v, states[1][key][n]), (key, n)


def test_dropout_on_mesh_matches_single_device():
    """Dropout's mask is drawn at the whole batch's shape and sliced per
    replica, so a 4-replica step equals the port's one-device step from the
    same seed."""
    X, y = _fit_data(16)
    batch = {"data": X, "softmax_label": y}
    res = []
    for mesh in (None, _cpu_mesh(4)):
        mt.random.seed(11)
        ts = TrainStep(_mlp(mt, dropout=0.5), mesh=mesh, learning_rate=0.1,
                       device="cpu")
        st = ts.init({"data": (16, 10)}, {"softmax_label": (16,)})
        st, outs = ts.step(st, batch)
        st, outs = ts.step(st, batch)
        res.append((st, outs[0]))
    np.testing.assert_allclose(res[0][1].numpy(), res[1][1].numpy(),
                               rtol=1e-6, atol=1e-7)
    for n, v in res[0][0]["params"].items():
        np.testing.assert_allclose(v.numpy(), res[1][0]["params"][n].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_guard_on_mesh_takes_one_decision():
    """guard.grad_nan at 8 replicas: the poisoned step is a no-op on every
    replica (one decision, from the summed gradients), the skip rides the
    packed sums, and the replicas stay identical."""
    mesh = _cpu_mesh(8)
    ts = TrainStep(_mlp(mt), optimizer="sgd", learning_rate=0.1,
                   momentum=0.9, mesh=mesh, device="cpu")
    K, bs = 4, 16
    st = ts.init({"data": (bs, 10)}, {"softmax_label": (bs,)})
    rng = np.random.default_rng(0)
    sb = {"data": rng.normal(size=(K, bs, 10)).astype(np.float32),
          "softmax_label": rng.integers(0, 4, (K, bs)).astype(np.float32)}
    faults.inject("guard.grad_nan", nth=2)
    st, m = ts.run_steps(st, sb, guard=True)
    assert m.skipped == 1
    assert m.num_samples == (K - 1) * bs
    reps = ts.replica_states(st)
    assert [int(r["step"]) for r in reps] == [K - 1] * 8
    for n in ts.param_names:
        assert torch.isfinite(st["params"][n]).all(), n
        for r in reps[1:]:
            assert torch.equal(r["params"][n], st["params"][n]), n


def test_sharded_checkpoint_resume_bitwise(tmp_path):
    """Fit to an epoch-end checkpoint over 8 contexts, resume in a fresh
    module, finish: the parameters equal the uninterrupted 8-context run's
    bit for bit."""
    full = _fit(mt, 8, checkpoint_prefix=str(tmp_path / "a" / "ck"))
    _fit(mt, 8, num_epoch=1, checkpoint_prefix=str(tmp_path / "b" / "ck"))
    resumed = _fit(mt, 8, checkpoint_prefix=str(tmp_path / "b" / "ck"),
                   resume="auto")
    a, b = _params(full), _params(resumed)
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_shard_batch_rejects_indivisible_batch():
    """The JAX package's messages (tests/test_multichip.py)."""
    ts = TrainStep(_mlp(mt), optimizer="sgd", mesh=_cpu_mesh(8))
    with pytest.raises(MXNetError, match="does not divide"):
        ts.shard_batch({"data": np.zeros((6, 10), np.float32)})
    with pytest.raises(MXNetError, match="does not divide"):
        ts.shard_superbatch({"data": np.zeros((2, 6, 10), np.float32)})


def test_bulk_dispatch_precheck_rejects_indivisible_batch():
    for pkg in (mx, mt):
        mod = pkg.mod.Module(_mlp(pkg),
                             context=[pkg.cpu(i) for i in range(8)])
        it = pkg.io.NDArrayIter(np.zeros((36, 10), np.float32),
                                np.zeros((36,), np.float32), batch_size=36)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                 for_training=True)
        mod.init_params()
        mod.init_optimizer()
        ok, why = mod._can_bulk_dispatch()
        assert not ok and "does not divide" in why


def test_dp_devices_env(monkeypatch):
    """``MXTPU_DP_DEVICES=N`` spreads a context-less Module over N replicas
    of the current context's type; an over-ask raises naming how many are
    visible, a non-integer names the variable."""
    monkeypatch.setenv("MXTPU_DP_DEVICES", "4")
    with mt.cpu():
        mod = mt.mod.Module(_mlp(mt))
    assert mod._context == [mt.cpu(i) for i in range(4)]
    assert mt.context.num_devices("cpu") == os.cpu_count()
    monkeypatch.setenv("MXTPU_DP_DEVICES", "4096")
    with pytest.raises(MXNetError, match="visible"), mt.cpu():
        mt.mod.Module(_mlp(mt))
    monkeypatch.setenv("MXTPU_DP_DEVICES", "zoom")
    with pytest.raises(MXNetError, match="MXTPU_DP_DEVICES"), mt.cpu():
        mt.mod.Module(_mlp(mt))


def test_duplicate_contexts_build_no_mesh():
    """Contexts that repeat one another build no mesh, as the JAX
    package's duplicate devices: the group runs on one device."""
    mod = mt.mod.Module(_mlp(mt), context=[mt.cpu(0), mt.cpu(0)])
    mod.bind(data_shapes=[("data", (8, 10))],
             label_shapes=[("softmax_label", (8,))])
    assert mod._exec_group._mesh is None
    mod = mt.mod.Module(_mlp(mt), context=[mt.cpu(0), mt.cpu(1)])
    mod.bind(data_shapes=[("data", (8, 10))],
             label_shapes=[("softmax_label", (8,))])
    assert tmesh.data_axis_size(mod._exec_group._mesh) == 2


# ---------------------------------------------------------------------------
# BucketingModule and FeedForward over contexts
# ---------------------------------------------------------------------------

def test_bucketing_module_over_two_contexts_matches_jax():
    """The LSTM language model of tests/test_torch_bucketing.py fit over
    ``[cpu(0), cpu(1)]`` (K=4, superbatches cut by bucket switches, the
    begin states split along their batch axis) against the JAX package's
    2-context fit and the port's 1-context fit."""
    import test_torch_bucketing as tb
    batches = tb._batches("fit", tb.KEYS)
    w = tb._weights("fit")

    def fit(pkg, ctx):
        it = tb._replay_iter(pkg, batches)
        mod = pkg.mod.BucketingModule(
            tb._sym_gen(pkg), default_bucket_key=it.default_bucket_key,
            context=ctx)
        metric = pkg.metric.Perplexity(ignore_label=0)
        ppl = []
        c = pkg.cpu()
        mod.fit(it, eval_metric=metric, num_epoch=1,
                arg_params={n: pkg.nd.array(v, ctx=c) for n, v in w.items()},
                optimizer="adam", optimizer_params={"learning_rate": 0.01},
                steps_per_dispatch=4, dispatch_pipeline=1,
                epoch_end_callback=lambda *a: ppl.append(metric.get()[1]))
        return mod, tb._params(mod), ppl

    _, jp, jppl = fit(mx, [mx.cpu(0), mx.cpu(1)])
    tmod, tp, tppl = fit(mt, [mt.cpu(0), mt.cpu(1)])
    _, t1, t1ppl = fit(mt, mt.cpu())
    assert all(ts.mesh is not None for ts in tmod._bucket_fused.values())
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], err_msg=n, **tb.RUN)
        np.testing.assert_allclose(tp[n], t1[n], err_msg=n, **tb.RUN)
    np.testing.assert_allclose(tppl, jppl, rtol=1e-4)
    np.testing.assert_allclose(tppl, t1ppl, rtol=1e-4)


def _tn_sym_gen(pkg):
    """The LSTM language model in the TN layout, its embedded sequence
    reversed along time first (``SequenceReverse``: a flip of dim 0)."""
    import test_torch_bucketing as tb
    cell = pkg.rnn.FusedRNNCell(tb.H, num_layers=tb.L, mode="lstm",
                                prefix="lstm_")

    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        emb = pkg.sym.Embedding(data=data, input_dim=tb.V,
                                output_dim=tb.E, name="embed")
        emb = pkg.sym.SequenceReverse(data=emb)
        outputs, _ = cell.unroll(seq_len, inputs=emb, layout="TNC",
                                 merge_outputs=True)
        pred = pkg.sym.Reshape(data=outputs, shape=(-1, tb.H))
        pred = pkg.sym.FullyConnected(data=pred, num_hidden=tb.V,
                                      name="pred")
        label_flat = pkg.sym.Reshape(data=label, shape=(-1,))
        pred = pkg.sym.SoftmaxOutput(data=pred, label=label_flat,
                                     name="softmax")
        return pred, ("data", "lstm_begin_state_0",
                      "lstm_begin_state_1"), ("softmax_label",)
    return sym_gen


def _tn_iter(pkg, batches):
    """A DataIter over ``batches`` (NT arrays) in the TN layout, with the
    LSTM's zero begin states ``(layers, batch, hidden)``."""
    import test_torch_bucketing as tb
    ctx = pkg.cpu()
    state = (tb.L, tb.B, tb.H)
    top = max(k for k, _, _ in batches)

    def descs(t):
        return ([pkg.io.DataDesc("data", (t, tb.B), layout="TN"),
                 pkg.io.DataDesc("lstm_begin_state_0", state),
                 pkg.io.DataDesc("lstm_begin_state_1", state)],
                [pkg.io.DataDesc("softmax_label", (t, tb.B), layout="TN")])

    class Replay(pkg.io.DataIter):
        def __init__(self):
            super().__init__(tb.B)
            self.default_bucket_key = top
            self.provide_data, self.provide_label = descs(top)
            self.i = 0

        def reset(self):
            self.i = 0

        def next(self):
            if self.i == len(batches):
                raise StopIteration
            key, d, lab = batches[self.i]
            self.i += 1
            z = np.zeros(state, np.float32)
            pd, pl = descs(key)
            return pkg.io.DataBatch(
                [pkg.nd.array(d.T.copy(), ctx=ctx), pkg.nd.array(z, ctx=ctx),
                 pkg.nd.array(z, ctx=ctx)],
                [pkg.nd.array(lab.T.copy(), ctx=ctx)], pad=0,
                bucket_key=key, provide_data=pd, provide_label=pl)

    return Replay()


@pytest.mark.parametrize("k", [1, 4])
def test_bucketing_module_tn_layout_over_two_contexts_matches_jax(k):
    """The LSTM in the TN layout, its sequence reversed along time, fit over
    ``[cpu(0), cpu(1)]`` (K=1: the executor path's bind and superbatch
    tails; K=4: the fused path): the batch splits along dim 1, the 'N' of
    the layout, so each replica reverses whole sequences. Against the JAX
    package's 2-context fit and the port's 1-context fit (buckets 6 and 8,
    which the JAX package's dim-0 sharding needs even)."""
    import test_torch_bucketing as tb
    batches = tb._batches("tn", [8, 8, 6, 8, 6, 6, 8, 6, 8, 8])
    w = tb._weights("tn")

    def fit(pkg, ctx):
        it = _tn_iter(pkg, batches)
        mod = pkg.mod.BucketingModule(
            _tn_sym_gen(pkg), default_bucket_key=it.default_bucket_key,
            context=ctx)
        metric = pkg.metric.Perplexity(ignore_label=0)
        ppl = []
        c = pkg.cpu()
        mod.fit(it, eval_metric=metric, num_epoch=1,
                arg_params={n: pkg.nd.array(v, ctx=c) for n, v in w.items()},
                optimizer="adam", optimizer_params={"learning_rate": 0.01},
                steps_per_dispatch=k, dispatch_pipeline=1,
                epoch_end_callback=lambda *a: ppl.append(metric.get()[1]))
        return mod, tb._params(mod), ppl

    _, jp, jppl = fit(mx, [mx.cpu(0), mx.cpu(1)])
    tmesh.reset_counters()
    tmod, tp, tppl = fit(mt, [mt.cpu(0), mt.cpu(1)])
    _, t1, t1ppl = fit(mt, mt.cpu())
    assert tmod._base_module._exec_group.batch_axes["data"] == 1
    assert tmesh.COUNTERS["all_reduce"] > 0
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], err_msg=n, **tb.RUN)
        np.testing.assert_allclose(tp[n], t1[n], err_msg=n, **tb.RUN)
    np.testing.assert_allclose(tppl, jppl, rtol=1e-4)
    np.testing.assert_allclose(tppl, t1ppl, rtol=1e-4)


def test_tn_superbatch_and_shard_batch_split_along_the_layouts_n():
    """A TN input whose time and batch sizes are equal splits along dim 1
    (its layout's 'N'), in ``SuperBatchIter(sharding=)``, in
    ``TrainStep.shard_batch`` with ``batch_axes`` and on the bind path."""
    mesh = _cpu_mesh(2)
    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    desc = mt.io.DataDesc("data", (4, 4), layout="TN")

    class One(mt.io.DataIter):
        def __init__(self):
            super().__init__(4)
            self.provide_data = [desc]
            self.provide_label = []
            self.n = 0

        def reset(self):
            self.n = 0

        def next(self):
            if self.n:
                raise StopIteration
            self.n = 1
            return mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())], [],
                                   pad=0)

    sb = next(iter(mt.io.SuperBatchIter(
        One(), 1, prefetch=False, device="cpu",
        sharding=tmesh.superbatch_sharding(mesh))))
    arr = sb.data[0]
    assert arr.axis == 2
    np.testing.assert_array_equal(arr.parts[0].numpy()[0], x[:, :2])
    ts = TrainStep(_mlp(mt), mesh=mesh, device="cpu",
                   batch_axes=tmesh.layout_axes([desc]))
    placed = ts.shard_batch({"data": x})
    assert placed["data"].axis == 1
    assert tmesh.batch_axes({"data": (4, 4)}, {"data": 1}) == (4,
                                                               {"data": 1})
    ex = mt.executor.simple_bind(
        mt.sym.SequenceReverse(data=mt.sym.Variable("data")), mt.cpu(),
        grad_req="null", mesh=mesh, batch_names=["data"],
        batch_axes={"data": 1}, data=(4, 4))
    out = ex.forward(data=mt.nd.array(x, ctx=mt.cpu()))[0].asnumpy()
    np.testing.assert_array_equal(out, x[::-1])


def test_feedforward_over_contexts_matches_jax():
    """``FeedForward(ctx=[cpu(0), cpu(1)])``: fit and predict against the
    JAX package's."""
    X, y = _fit_data(64)
    out = {}
    for pkg in (mx, mt):
        arg = {n: pkg.nd.array(v.astype(np.float32), ctx=pkg.cpu())
               for n, v in _weights().items()}
        model = pkg.model.FeedForward(
            _mlp(pkg), ctx=[pkg.cpu(0), pkg.cpu(1)], num_epoch=2,
            optimizer="sgd", numpy_batch_size=16, arg_params=arg,
            learning_rate=0.1, momentum=0.9)
        # an iterator in order: each package shuffles numpy input its own way
        model.fit(pkg.io.NDArrayIter(X, y, batch_size=16))
        out[pkg.__name__] = ({n: v.asnumpy()
                              for n, v in model.arg_params.items()},
                             model.predict(X))
    (jp, jpred), (tp, tpred) = out["mxnet_tpu"], out["mxnet_tpu_torch"]
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], err_msg=n, **FIT)
    np.testing.assert_allclose(tpred, jpred, **FIT)


@pytest.mark.parametrize("batch,work", [(10, [1, 1]), (10, [1, 2, 2]),
                                        (7, [3, 1]), (3, [1, 1, 1, 1])])
def test_split_input_slice_matches_jax(batch, work):
    def call(pkg):
        try:
            return pkg.executor_manager._split_input_slice(batch, work)
        except ValueError as e:
            return str(e)
    assert call(mt) == call(mx)


def test_executor_manager_drives_the_group_over_contexts():
    """The legacy ``DataParallelExecutorManager`` over 2 contexts runs the
    group's mesh: forward and backward against the JAX package's."""
    X, y = _fit_data(16)
    res = {}
    for pkg in (mx, mt):
        it = pkg.io.NDArrayIter(X, y, batch_size=8)
        mgr = pkg.executor_manager.DataParallelExecutorManager(
            _mlp(pkg), [pkg.cpu(0), pkg.cpu(1)], it)
        mgr.set_params({n: pkg.nd.array(v.astype(np.float32), ctx=pkg.cpu())
                        for n, v in _weights().items()}, {})
        mgr.load_data_batch(next(iter(it)))
        mgr.forward(is_train=True)
        mgr.backward()
        res[pkg.__name__] = [g.asnumpy() for g in mgr.grad_arrays]
    for a, b in zip(res["mxnet_tpu_torch"], res["mxnet_tpu"]):
        np.testing.assert_allclose(a, b, **FIT)


def _update_error(upd, ref):
    """(norm of upd - ref over all tensors / norm of ref, worst tensor's
    max |upd - ref| / max |ref|)."""
    num = sum(float(torch.sum((upd[n] - ref[n]) ** 2)) for n in ref)
    den = sum(float(torch.sum(ref[n] ** 2)) for n in ref)
    worst = max(float((upd[n] - ref[n]).abs().max())
                / max(float(ref[n].abs().max()), 1e-300) for n in ref)
    return (num / den) ** 0.5, worst


def _precision_study(image, batch, replicas=2, seed=0):
    """How far one ResNet-50 NHWC ``TrainStep`` step (SGD lr 0.1, momentum
    0.9, wd 1e-4, the Conv1x1->BatchNorm fusion on, random images and
    labels, one Xavier state) lies from its float64 update on one device,
    in float32 on one device and on a mesh, and in float64 on the mesh:
    ``{run: (norm error, worst tensor's error)}`` (``_update_error``).
    ``chip_smoke.py`` phase 18 sets its float32 tolerance from it (one
    float32 step 1.78% off at image 64, batch 16)."""
    from mxnet_tpu_torch import models
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=1000, num_layers=50,
                            image_shape="3,%d,%d" % (image, image),
                            layout="NHWC")
    opt = dict(optimizer="sgd", learning_rate=0.1, momentum=0.9, wd=1e-4)
    base = TrainStep(sym, device="cpu", **opt).init(
        {"data": (batch, image, image, 3)}, {"softmax_label": (batch,)},
        seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    sb = {"data": torch.rand((1, batch, image, image, 3), generator=gen),
          "softmax_label": torch.randint(0, 1000, (1, batch),
                                         generator=gen).float()}
    mesh = _cpu_mesh(replicas)

    def update(on_mesh, dtype):
        ts = TrainStep(sym, mesh=mesh if on_mesh else None,
                       device=None if on_mesh else "cpu", dtype=dtype, **opt)
        tdt = torch.float64 if dtype == np.float64 else torch.float32
        st = {k: {n: v.to(tdt, copy=True) for n, v in base[k].items()}
              for k in ("params", "aux", "opt")}
        st["step"] = base["step"].clone()
        st = ts.replicate_state(st)
        st, _ = ts.run_steps(st, ts.shard_superbatch(
            {"data": sb["data"].to(tdt),
             "softmax_label": sb["softmax_label"]}))
        return {n: v.double() - base["params"][n].double()
                for n, v in st["params"].items()}

    ref = update(False, np.float64)
    return {name: _update_error(update(on_mesh, dtype), ref)
            for name, on_mesh, dtype in (
                ("one device f32", False, np.float32),
                ("mesh f32", True, np.float32),
                ("mesh f64", True, np.float64))}


def test_mesh_exact_in_float64_and_f32_off_float64(monkeypatch):
    """In float64 a ResNet-50 step on a 2-replica mesh equals one device's
    (the mesh reorders only sums), while each float32 run lies a
    measurable distance from float64: the error any two float32 runs of
    the step, such as a mesh and one device, differ by."""
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    errs = _precision_study(32, 4)
    logging.info("update errors against one device f64: %s", errs)
    assert errs["mesh f64"][0] < 1e-10
    assert errs["mesh f64"][1] < 1e-9
    assert 0 < errs["one device f32"][0] < 1.0
    assert 0 < errs["mesh f32"][0] < 1.0
