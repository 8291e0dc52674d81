"""The port's training guard against the JAX package's contract (the
counterparts of ``tests/test_guard.py``, but its trace-cache test, which
walks jaxprs), on the CPU.

Pins: sentinels computed in the step make a poisoned step a no-op on the
device, bit for bit (every other step identical to a run that never saw
the bad batch, the step counter included); a clean guarded run equals the
unguarded one bit for bit; skipped batches stay out of the metric's sums;
the sentinels (loss, correct, samples, skipped) equal the JAX package's
from a shared state and the gradient norm is within ``rtol=1e-5``
(XLA:CPU and PyTorch sum the squares in different orders); sustained loss
spikes roll back to the newest known-good checkpoint bit for bit with the
lr scaled; ``max_rollbacks`` and a skip storm end in
``TrainingDivergedError``; checkpoints are marked known-good; the
``MXTPU_GUARD*`` knobs.
"""
import json
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import faults as jfaults
from mxnet_tpu.train_step import TrainStep as JTrainStep
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert, faults, guard as guard_mod
from mxnet_tpu_torch import optimizer as opt, sym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.guard import TrainingDivergedError, TrainingGuard
from mxnet_tpu_torch.model import CheckpointManager, atomic_write_bytes
from mxnet_tpu_torch.train_step import TrainStep


@pytest.fixture(autouse=True)
def _clean_slate():
    faults.clear()
    jfaults.clear()
    guard_mod.TRAINING_HEALTH.reset()
    yield
    faults.clear()
    jfaults.clear()
    guard_mod.TRAINING_HEALTH.reset()


def _mlp(pkg=mt):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data=data, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(data=net, act_type="tanh")
    net = pkg.sym.FullyConnected(data=net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(data=net, name="softmax")


def _stacked(k=4, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    Xs = rng.normal(size=(k, batch, 10)).astype(np.float32)
    ys = rng.integers(0, 4, (k, batch)).astype(np.float32)
    return Xs, ys


def _mk_step(momentum=0.9, **kw):
    o = opt.create("sgd", learning_rate=0.05, momentum=momentum,
                   rescale_grad=1.0 / 8, **kw)
    return TrainStep(_mlp(), optimizer=o, device="cpu")


def _init(step, B=8, seed=1):
    return step.init({"data": (B, 10)}, {"softmax_label": (B,)}, seed=seed)


def _toy_data(n=128, dim=10, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, dim)).astype(np.float32)
    w = rng.normal(size=(dim, classes)).astype(np.float32)
    y = np.argmax(X @ w, axis=1).astype(np.float32)
    return X, y


def _np(state, n):
    return state["params"][n].numpy().copy()


# -- sentinels in the step: parity and the bitwise no-op ---------------------

def test_guarded_run_matches_unguarded_bitwise():
    K, B = 4, 8
    Xs, ys = _stacked(K, B)
    sb = {"data": Xs, "softmax_label": ys}
    a = _mk_step()
    sa = _init(a)
    sa, ma = a.run_steps(sa, sb)
    b = _mk_step()
    sg = _init(b)
    sg, mb = b.run_steps(sg, sb, guard=True)
    for n in a.param_names:
        assert torch.equal(sa["params"][n], sg["params"][n]), n
        assert torch.equal(sa["opt"][n], sg["opt"][n]), n
    assert mb.skipped == 0 and mb.guarded and not ma.guarded
    assert mb.num_samples == ma.num_samples == K * B
    assert mb.loss_sum == ma.loss_sum
    assert np.isfinite(mb.last_grad_norm) and ma.last_grad_norm is None
    # and a guarded single step equals an unguarded one
    s1, s2 = _mk_step(), _mk_step()
    st1, st2 = _init(s1), _init(s2)
    batch = {"data": Xs[0], "softmax_label": ys[0]}
    st1, o1 = s1.step(st1, batch)
    st2, o2, packed = s2.step(st2, batch, guard=True)
    assert torch.equal(o1[0], o2[0])
    for n in s1.param_names:
        assert torch.equal(st1["params"][n], st2["params"][n]), n
    assert int(st1["step"]) == int(st2["step"]) == 1


def test_grad_nan_step_is_bitwise_noop():
    K, B = 4, 8
    Xs, ys = _stacked(K, B)
    faults.inject("guard.grad_nan", nth=2)        # poison step index 1
    f = _mk_step()
    sf = _init(f)
    sf, mf = f.run_steps(sf, {"data": Xs, "softmax_label": ys}, guard=True)
    faults.clear()
    assert mf.skipped == 1
    assert mf.num_samples == (K - 1) * B
    assert int(sf["step"]) == K - 1               # the clock too
    for n in f.param_names:
        assert torch.isfinite(sf["params"][n]).all(), n
    idx = [0, 2, 3]                               # the same run less batch 1
    r = _mk_step()
    sr = _init(r)
    sr, mr = r.run_steps(sr, {"data": Xs[idx], "softmax_label": ys[idx]},
                         guard=True)
    for n in f.param_names:
        assert torch.equal(sf["params"][n], sr["params"][n]), n
        assert torch.equal(sf["opt"][n], sr["opt"][n]), n
    for n in f.aux_names:
        assert torch.equal(sf["aux"][n], sr["aux"][n]), n
    assert mf.loss_sum == mr.loss_sum
    assert mf.top1_correct == mr.top1_correct


def test_guarded_single_step_skip_and_sentinels():
    B = 8
    Xs, ys = _stacked(2, B)
    s = _mk_step()
    st = _init(s)
    st, outs, packed = s.step(st, {"data": Xs[0], "softmax_label": ys[0]},
                              guard=True)
    sent = packed.numpy()
    assert sent[2] == B and sent[3] == 0 and np.isfinite(sent[4])
    faults.inject("guard.grad_nan", nth=1)
    before = {n: _np(st, n) for n in s.param_names}
    mom = {n: st["opt"][n].clone() for n in s.param_names}
    st, outs, packed = s.step(st, {"data": Xs[1], "softmax_label": ys[1]},
                              guard=True)
    sent = packed.numpy()
    assert sent[3] == 1 and sent[2] == 0 and sent[0] == 0
    assert not np.isfinite(sent[4])
    for n in s.param_names:
        np.testing.assert_array_equal(before[n], _np(st, n), err_msg=n)
        assert torch.equal(mom[n], st["opt"][n]), n
    assert int(st["step"]) == 1


@pytest.mark.parametrize("clip", [None, 0.05])
def test_sentinels_match_jax(clip):
    """From one state, a guarded step in each package: the same skipped
    flag, sample count and correct count, the loss and gradient norm
    within rtol 1e-5, and the state within rtol 1e-5, atol 1e-6; a
    poisoned step in each leaves its state as it was."""
    B = 8
    Xs, ys = _stacked(2, B, seed=4)
    kw = dict(learning_rate=0.05, momentum=0.9, rescale_grad=1.0 / 8)
    if clip is not None:
        kw["clip_global_norm"] = clip
    jstep = JTrainStep(_mlp(mx), optimizer=mx.optimizer.create("sgd", **kw))
    tstep = TrainStep(_mlp(), optimizer=opt.create("sgd", **kw),
                      device="cpu")
    jst = jstep.init({"data": (B, 10)}, {"softmax_label": (B,)}, seed=2)
    tst = convert.from_reference_state(jst, "cpu")
    batch = {"data": Xs[0], "softmax_label": ys[0]}
    jst, _, jp = jstep.step(jst, batch, guard=True)
    tst, _, tp = tstep.step(tst, batch, guard=True)
    jp, tp = np.asarray(jp), tp.numpy()
    assert tp[1:4].tolist() == jp[1:4].tolist()
    np.testing.assert_allclose(tp[[0, 4]], jp[[0, 4]], rtol=1e-5)
    got = convert.to_reference_state(tst)
    for n, v in jst["params"].items():
        np.testing.assert_allclose(got["params"][n], np.asarray(v),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    # a poisoned step: skipped in both, state unchanged in both
    jfaults.inject("guard.grad_nan", nth=1)
    faults.inject("guard.grad_nan", nth=1)
    jbefore = {n: np.asarray(v).copy() for n, v in jst["params"].items()}
    tbefore = {n: _np(tst, n) for n in tstep.param_names}
    batch = {"data": Xs[1], "softmax_label": ys[1]}
    jst, _, jp = jstep.step(jst, batch, guard=True)
    tst, _, tp = tstep.step(tst, batch, guard=True)
    assert np.asarray(jp)[3] == tp.numpy()[3] == 1
    for n in tbefore:
        np.testing.assert_array_equal(np.asarray(jst["params"][n]),
                                      jbefore[n])
        np.testing.assert_array_equal(_np(tst, n), tbefore[n])
    assert int(tst["step"]) == int(np.asarray(jst["step"])) == 1


def test_clip_global_norm_fused_matches_imperative():
    B, c = 8, 0.05
    Xs, ys = _stacked(3, B, seed=7)
    fused = _mk_step(clip_global_norm=c)
    state = _init(fused, seed=2)
    ex = _mlp().simple_bind(mt.cpu(), grad_req="write", data=(B, 10),
                            softmax_label=(B,))
    for n in fused.param_names:
        ex.arg_dict[n][:] = state["params"][n].numpy()
    upd = opt.get_updater(opt.create("sgd", learning_rate=0.05,
                                     momentum=0.9, rescale_grad=1.0))
    names = list(fused.param_names)
    for i in range(3):
        state, _ = fused.step(state, {"data": Xs[i], "softmax_label": ys[i]})
        ex.forward(is_train=True, data=Xs[i], softmax_label=ys[i])
        ex.backward()
        grads = [ex.grad_dict[n] * (1.0 / B) for n in names]
        opt.clip_by_global_norm(grads, c)
        for j, n in enumerate(names):
            upd(j, grads[j], ex.arg_dict[n])
    for n in names:
        np.testing.assert_allclose(_np(state, n), ex.arg_dict[n].asnumpy(),
                                   atol=2e-5, rtol=2e-5, err_msg=n)


# -- fit's guard: skip, health, metric denominators ---------------------------

def _guarded_fit(X, y, k, guard, num_epoch=1, prefix=None, every=None,
                 lr=0.1, seed=3):
    mt.random.seed(seed)
    train = mt.io.NDArrayIter(X, y, batch_size=16)
    mod = mt.mod.Module(_mlp(), context=mt.cpu())
    metric = mt.metric.create(["acc", "ce"])
    mod.fit(train, num_epoch=num_epoch, eval_metric=metric,
            optimizer_params={"learning_rate": lr, "momentum": 0.9},
            steps_per_dispatch=k, guard=guard, checkpoint_prefix=prefix,
            checkpoint_every_n_batches=every, checkpoint_keep=10)
    return mod, metric


@pytest.mark.parametrize("k", [1, 4])
def test_fit_guard_skips_nan_batch_and_stays_finite(k):
    X, y = _toy_data()
    faults.inject("guard.grad_nan", nth=3)
    g = TrainingGuard(max_skips_per_window=100)
    mod, metric = _guarded_fit(X, y, k, g)
    assert g.health.skipped == 1
    assert g.health.steps == 8
    arg, _ = mod.get_params()
    for n, v in arg.items():
        assert np.isfinite(v.asnumpy()).all(), n
    for m in metric.metrics:
        assert m.num_inst == 128 - 16
    assert guard_mod.TRAINING_HEALTH.report()["skipped"] == 1
    # the step counter trails the optimizer's clock by the skip
    assert mod._optimizer.num_update == 8
    assert mod._fused_step_count() == int(mod._fused_state["step"]) == 7


def test_fit_guard_true_and_env_default(caplog, monkeypatch):
    X, y = _toy_data(64)

    def run():
        mt.random.seed(0)
        train = mt.io.NDArrayIter(X, y, batch_size=16)
        mod = mt.mod.Module(_mlp(), context=mt.cpu())
        with caplog.at_level(logging.WARNING):
            mod.fit(train, num_epoch=1,
                    optimizer_params={"learning_rate": 0.1}, guard=None)

    run()
    assert not any("checkpoint_prefix" in r.message for r in caplog.records)
    assert guard_mod.TRAINING_HEALTH.report()["steps"] == 0
    monkeypatch.setenv("MXTPU_GUARD", "1")
    run()
    assert any("no checkpoint_prefix" in r.message for r in caplog.records)
    assert guard_mod.TRAINING_HEALTH.report()["steps"] == 4


def test_guard_env_disable_spellings(monkeypatch):
    X, y = _toy_data(32)
    for spelling in ("False", "OFF", "no", "0"):
        monkeypatch.setenv("MXTPU_GUARD", spelling)
        mt.random.seed(0)
        mod = mt.mod.Module(_mlp(), context=mt.cpu())
        mod.fit(mt.io.NDArrayIter(X, y, batch_size=16), num_epoch=1,
                optimizer_params={"learning_rate": 0.1})
        assert guard_mod.TRAINING_HEALTH.report()["steps"] == 0, spelling


def test_fit_guard_ineligible_warns_and_trains_unguarded(caplog):
    data = sym.Variable("data")
    net = sym.FullyConnected(data=data, num_hidden=8, name="fc1")
    a = sym.SoftmaxOutput(sym.FullyConnected(net, num_hidden=4, name="ha"),
                          name="sa")
    b = sym.SoftmaxOutput(sym.FullyConnected(net, num_hidden=4, name="hb"),
                          name="sb")
    X, y = _toy_data(32)
    train = mt.io.NDArrayIter(X, {"sa_label": y, "sb_label": y},
                              batch_size=16)
    mod = mt.mod.Module(sym.Group([a, b]), label_names=("sa_label",
                                                        "sb_label"),
                        context=mt.cpu())
    g = TrainingGuard()
    with caplog.at_level(logging.WARNING):
        mod.fit(train, num_epoch=1, optimizer_params={"learning_rate": 0.1},
                guard=g)
    assert any("UNGUARDED" in r.message for r in caplog.records)
    assert g.health.steps == 0


# -- divergence -> rollback -> TrainingDivergedError --------------------------

def test_loss_spike_triggers_rollback_and_lr_reduction(tmp_path):
    X, y = _toy_data()
    g = TrainingGuard(patience=2, max_rollbacks=1, lr_factor=0.5)
    faults.inject("guard.loss_spike", nth=6, times=2)
    mod, _ = _guarded_fit(X, y, 1, g, num_epoch=2,
                          prefix=str(tmp_path / "ck"), every=3)
    assert g.health.rollbacks == 1 and g.health.divergences == 1
    assert abs(mod._optimizer.lr - 0.05) < 1e-12
    arg, _ = mod.get_params()
    assert all(np.isfinite(v.asnumpy()).all() for v in arg.values())


def test_rollback_restores_checkpoint_bitwise(tmp_path):
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    g = TrainingGuard(lr_factor=0.25)
    mod, _ = _guarded_fit(X, y, 1, g, prefix=prefix, every=4)
    mgr = CheckpointManager(prefix, keep=10)
    want = mgr.load_latest()
    assert want is not None and want.known_good is True
    clock_before = mod._optimizer.num_update
    train = mt.io.NDArrayIter(X, y, batch_size=16)
    for batch in train:
        assert mod._try_fused_fit_step(batch)
    drifted, _ = mod.get_params()
    assert any(not np.array_equal(drifted[n].asnumpy(),
                                  want.arg_params[n].asnumpy())
               for n in drifted)
    g.diverged = True
    g.diverged_reason = "test"
    st = mod._guard_rollback(g, mgr)
    assert st.tag == want.tag
    arg, _ = mod.get_params()
    for n in arg:
        np.testing.assert_array_equal(arg[n].asnumpy(),
                                      want.arg_params[n].asnumpy(),
                                      err_msg=n)
    assert mod._optimizer.num_update == want.num_update != clock_before + 8
    assert abs(mod._optimizer.lr - 0.1 * 0.25) < 1e-12
    assert g.health.rollbacks == 1 and not g.diverged
    # the momentum comes back too: the next fused step reseeds from the
    # checkpoint's states and continues its step counter
    states = CheckpointManager(prefix)._file(want.tag, "states")
    import pickle
    mom = pickle.loads(open(states, "rb").read())
    train.reset()
    mod._try_fused_fit_step(next(iter(train)))
    assert int(mod._fused_state["step"]) == want.num_update + 1
    mod2 = mt.mod.Module(_mlp(), context=mt.cpu())
    mod2.bind(data_shapes=train.provide_data,
              label_shapes=train.provide_label)
    mod2.init_params(arg_params=want.arg_params, aux_params=want.aux_params)
    mod2.init_optimizer(optimizer_params={"learning_rate": 0.025,
                                          "momentum": 0.9})
    mod2.load_optimizer_states(states)
    mod2._restore_trainer_clock(want.num_update, want.fused_step)
    assert sorted(mom) == sorted(mod2._updater.states)
    train.reset()
    mod2._try_fused_fit_step(next(iter(train)))
    for n, v in mod.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(),
                                      mod2.get_params()[0][n].asnumpy())


def test_rollback_under_dispatch_bulking(tmp_path):
    X, y = _toy_data()
    g = TrainingGuard(patience=1, max_rollbacks=1, lr_factor=0.5)
    faults.inject("guard.loss_spike", nth=2)       # the 2nd dispatch's
    mod, _ = _guarded_fit(X, y, 4, g, num_epoch=2,
                          prefix=str(tmp_path / "ck"), every=4)
    assert g.health.rollbacks == 1
    assert abs(mod._optimizer.lr - 0.05) < 1e-12
    arg, _ = mod.get_params()
    assert all(np.isfinite(v.asnumpy()).all() for v in arg.values())
    assert int(mod._fused_state["step"]) == 16


def test_max_rollbacks_exhausted_raises_diverged(tmp_path):
    X, y = _toy_data()
    g = TrainingGuard(patience=2, max_rollbacks=0)
    faults.inject("guard.loss_spike", nth=6, times=2)
    with pytest.raises(TrainingDivergedError, match="max_rollbacks"):
        _guarded_fit(X, y, 1, g, num_epoch=2, prefix=str(tmp_path / "ck"),
                     every=3)
    assert g.health.divergences == 1 and g.health.rollbacks == 0


def test_divergence_without_checkpoint_raises():
    X, y = _toy_data()
    g = TrainingGuard(patience=2)
    faults.inject("guard.loss_spike", nth=4, times=2)
    with pytest.raises(TrainingDivergedError, match="checkpoint_prefix"):
        _guarded_fit(X, y, 1, g, num_epoch=1)


def test_skip_storm_triggers_divergence():
    X, y = _toy_data()
    g = TrainingGuard(max_skips_per_window=2, window=50)
    faults.inject("guard.grad_nan", nth=3, times=2)
    with pytest.raises(TrainingDivergedError, match="skipped"):
        _guarded_fit(X, y, 1, g, num_epoch=1)
    assert g.health.skipped == 2


def test_checkpoints_deferred_while_spiking(tmp_path):
    X, y = _toy_data()
    g = TrainingGuard(patience=3, max_rollbacks=1)
    faults.inject("guard.loss_spike", nth=5, times=3)   # observations 5-7
    _guarded_fit(X, y, 1, g, num_epoch=1, prefix=str(tmp_path / "ck"),
                 every=2)
    assert g.health.rollbacks == 1
    assert g.health.last_event == "rolled back to checkpoint e0000-b00000004"


class _Stop(Exception):
    pass


def test_guarded_resume_restores_noise_clock_after_skip(tmp_path):
    """A skipped step leaves the step counter one behind num_update; resume
    restores the counter (Adam's t) from the manifest's fused_step:
    bitwise parity of an interrupted and resumed guarded Adam run."""
    X, y = _toy_data(64)

    def run(prefix, interrupt_after=None, resume=None, inject=True):
        faults.clear()
        if inject:
            faults.inject("guard.grad_nan", nth=2)
        mt.random.seed(3)
        train = mt.io.NDArrayIter(X, y, batch_size=16)
        mod = mt.mod.Module(_mlp(), context=mt.cpu())
        g = TrainingGuard(max_skips_per_window=100)
        cb = None
        if interrupt_after is not None:
            def cb(p):
                if p.nbatch + 1 >= interrupt_after:
                    raise _Stop()
        try:
            mod.fit(train, num_epoch=1, optimizer="adam",
                    optimizer_params={"learning_rate": 0.01}, guard=g,
                    batch_end_callback=cb, checkpoint_prefix=prefix,
                    checkpoint_every_n_batches=3, resume=resume)
        except _Stop:
            pass
        faults.clear()
        arg, _ = mod.get_params()
        return {n: v.asnumpy() for n, v in arg.items()}

    ref = run(str(tmp_path / "ref"))
    run(str(tmp_path / "vic"), interrupt_after=3)
    st = CheckpointManager(str(tmp_path / "vic")).load_latest()
    assert st.num_update == 3 and st.fused_step == 2
    got = run(str(tmp_path / "vic"), resume="auto", inject=False)
    for n in ref:
        np.testing.assert_array_equal(ref[n], got[n], err_msg=n)


# -- known-good manifests -----------------------------------------------------

def _fit_with_ckpt(X, y, prefix, every=4):
    mt.random.seed(0)
    train = mt.io.NDArrayIter(X, y, batch_size=16)
    mod = mt.mod.Module(_mlp(), context=mt.cpu())
    mod.fit(train, num_epoch=1, optimizer_params={"learning_rate": 0.1,
                                                  "momentum": 0.9},
            checkpoint_prefix=prefix, checkpoint_every_n_batches=every,
            checkpoint_keep=10)
    return mod


def test_checkpoints_marked_known_good(tmp_path):
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    _fit_with_ckpt(X, y, prefix)
    mgr = CheckpointManager(prefix)
    for tag in mgr.list_tags():
        man = json.loads(open(mgr._file(tag, "manifest.json")).read())
        assert man["known_good"] is True and man["version"] == 2


def test_nonfinite_params_not_marked_known_good(tmp_path, caplog):
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    mod = _fit_with_ckpt(X, y, prefix)
    mgr = CheckpointManager(prefix, keep=10)
    good = mgr.load_latest()
    arg, aux = mod.get_params()
    bad = arg["fc1_weight"].asnumpy().copy()
    bad[0, 0] = np.nan
    arg["fc1_weight"] = mt.nd.array(bad, ctx=mt.cpu())
    mod.set_params(arg, aux)
    with caplog.at_level(logging.WARNING):
        tag = mgr.save(mod, 7, 0)
    man = json.loads(open(mgr._file(tag, "manifest.json")).read())
    assert man["known_good"] is False
    assert any("NOT all finite" in r.message for r in caplog.records)
    with caplog.at_level(logging.WARNING):
        st = mgr.load_latest()
    assert st.tag == good.tag
    assert any("known-good" in r.message for r in caplog.records)
    assert mgr.load_latest(require_known_good=False).tag == tag


def test_param_nan_fault_site_unmarks_checkpoint(tmp_path):
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    mod = _fit_with_ckpt(X, y, prefix)
    mgr = CheckpointManager(prefix, keep=10)
    faults.inject("guard.param_nan", nth=1)
    tag = mgr.save(mod, 8, 0)
    man = json.loads(open(mgr._file(tag, "manifest.json")).read())
    assert man["known_good"] is False


def test_prune_never_deletes_newest_known_good(tmp_path):
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    mod = _fit_with_ckpt(X, y, prefix, every=None)
    mgr = CheckpointManager(prefix, keep=2)
    good = mgr.load_latest()
    for i in range(3):
        faults.inject("guard.param_nan", nth=1)
        mgr.save(mod, 10 + i, 0)
    tags = mgr.list_tags()
    assert good.tag in tags and len(tags) == 3
    assert mgr.load_latest().tag == good.tag


def test_resume_refuses_manifest_without_known_good_bit(tmp_path, caplog):
    X, y = _toy_data()
    prefix = str(tmp_path / "ck")
    _fit_with_ckpt(X, y, prefix)
    mgr = CheckpointManager(prefix, keep=10)
    tags = mgr.list_tags()
    man_f = mgr._file(tags[-1], "manifest.json")
    man = json.loads(open(man_f).read())
    del man["known_good"]
    atomic_write_bytes(man_f, json.dumps(man, indent=1).encode())
    with caplog.at_level(logging.WARNING):
        st = mgr.load_latest()
    assert st is not None and st.tag == tags[-2]
    assert any("known-good" in r.message for r in caplog.records)


# -- observability ------------------------------------------------------------

def _fire_speedometer(locals_):
    from mxnet_tpu_torch.callback import Speedometer
    from mxnet_tpu_torch.model import BatchEndParam
    sp = Speedometer(batch_size=16, frequent=10)
    fired = []
    orig = logging.info
    logging.info = lambda *a: fired.append(a)
    try:
        for nbatch in (5, 15):
            sp(BatchEndParam(epoch=0, nbatch=nbatch, eval_metric=None,
                             locals=locals_))
    finally:
        logging.info = orig
    assert fired, "speedometer never fired"
    return " ".join(str(x) for call in fired for x in call)


def test_speedometer_surfaces_training_health():
    g = TrainingGuard(logger=logging.getLogger("quiet"))
    g.health.record_steps(100, 2, 0.43)
    g.health.record_rollback("e0001-b00000004")
    joined = _fire_speedometer({"guard": g})
    assert "skipped=2" in joined and "rollbacks=1" in joined \
        and "grad_norm=0.43" in joined


def test_speedometer_strictly_per_run():
    guard_mod.TRAINING_HEALTH.record_steps(100, 2, 0.43)
    guard_mod.TRAINING_HEALTH.record_rollback("e0001-b00000004")
    assert "Guard:" not in _fire_speedometer({"guard": None})
    assert "Guard:" not in _fire_speedometer({"other": 1})
    assert "Guard:" not in _fire_speedometer(None)
    assert "Guard:" not in _fire_speedometer({"guard": TrainingGuard()})


# -- policy knobs -------------------------------------------------------------

def test_guard_env_knobs(monkeypatch):
    monkeypatch.setenv("MXTPU_GUARD_WINDOW", "25")
    monkeypatch.setenv("MXTPU_GUARD_SPIKE_FACTOR", "3.5")
    monkeypatch.setenv("MXTPU_GUARD_PATIENCE", "7")
    monkeypatch.setenv("MXTPU_GUARD_MAX_SKIPS", "9")
    monkeypatch.setenv("MXTPU_GUARD_LR_FACTOR", "0.25")
    monkeypatch.setenv("MXTPU_GUARD_MAX_ROLLBACKS", "4")
    monkeypatch.setenv("MXTPU_GUARD_EMA_DECAY", "0.5")
    g = TrainingGuard()
    assert (g.window, g.spike_factor, g.patience, g.max_skips_per_window,
            g.lr_factor, g.max_rollbacks, g.ema_decay) == \
        (25, 3.5, 7, 9, 0.25, 4, 0.5)
    assert TrainingGuard(patience=2).patience == 2
    j = mx.guard.TrainingGuard()
    assert (j.window, j.spike_factor, j.patience, j.lr_factor) == \
        (g.window, g.spike_factor, g.patience, g.lr_factor)
    monkeypatch.setenv("MXTPU_GUARD_WINDOW", "bogus")
    with pytest.raises(MXNetError, match="MXTPU_GUARD_WINDOW"):
        TrainingGuard()


def test_nonfinite_loss_observation_skipped_with_warning():
    g = TrainingGuard(patience=2, spike_factor=2.0,
                      logger=logging.getLogger("capture"))
    g.on_dispatch(loss_sum=1.0, nsamp=1, skipped=0, grad_norm=0.1)
    ema = g._ema
    g.on_dispatch(loss_sum=float("nan"), nsamp=1, skipped=0, grad_norm=0.1)
    assert g._ema == ema and g._warned_nonfinite_loss
    for _ in range(2):
        g.on_dispatch(loss_sum=100.0, nsamp=1, skipped=0, grad_norm=0.1)
    assert g.diverged


def test_guard_rejects_bad_policy():
    with pytest.raises(MXNetError, match="lr_factor"):
        TrainingGuard(lr_factor=0.0)
    with pytest.raises(MXNetError, match="patience"):
        TrainingGuard(patience=0)


def test_guard_policy_matches_jax_on_the_same_observations():
    """The same stream of observations drives both packages' policies to
    the same EMA, spike run, divergence and reason."""
    rng = np.random.default_rng(5)
    losses = list(rng.uniform(0.5, 1.5, 12)) + [50.0] * 3 + [1.0, 80.0]
    skips = [0] * 5 + [1] + [0] * 11
    t = TrainingGuard(patience=3, spike_factor=3.0, max_skips_per_window=2,
                      logger=logging.getLogger("quiet"))
    j = mx.guard.TrainingGuard(patience=3, spike_factor=3.0,
                               max_skips_per_window=2,
                               logger=logging.getLogger("quiet"))
    for loss, skip in zip(losses, skips):
        a = t.on_dispatch(loss_sum=loss * 16, nsamp=16, skipped=skip,
                          grad_norm=0.5)
        b = j.on_dispatch(loss_sum=loss * 16, nsamp=16, skipped=skip,
                          grad_norm=0.5)
        assert a == b
        assert (t._ema, t._spike_run, t.diverged) == \
            (j._ema, j._spike_run, j.diverged)
    assert t.diverged and t.diverged_reason == j.diverged_reason
    # the whole report, the retrace count included
    assert t.health.report() == j.health.report()
    assert t.ok_to_checkpoint() is j.ok_to_checkpoint() is False


def test_spiked_observation_never_updates_ema():
    g = TrainingGuard(patience=3, spike_factor=2.0,
                      logger=logging.getLogger("quiet"))
    for _ in range(3):
        g.on_dispatch(loss_sum=1.0, nsamp=1, skipped=0, grad_norm=0.1)
    ema = g._ema
    g.on_dispatch(loss_sum=100.0, nsamp=1, skipped=0, grad_norm=0.1)
    assert g._ema == ema and g._spike_run == 1 and not g.diverged
    g.on_dispatch(loss_sum=1.0, nsamp=1, skipped=0, grad_norm=0.1)
    assert g._spike_run == 0
