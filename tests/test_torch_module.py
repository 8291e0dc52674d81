"""The Module API of the PyTorch port against the JAX package's, on the CPU.

The same numpy ``arg_params``, data and labels go through
``mxnet_tpu.mod.Module.fit`` and ``mxnet_tpu_torch.mod.Module.fit(
context=mt.cpu())``: ``models.mlp`` on 4-class synthetic data (10
features, batch 8, 6 batches an epoch) and ``models.lenet`` at 1x28x28
(batch 8, 4 batches), for two epochs, at ``steps_per_dispatch`` 1 and 4
(the K-step path, with the metric's sums kept on the device), with
``dispatch_pipeline`` passed explicitly. The per-step executor path
(``forward``/``backward``/``update`` by hand through the per-index
updater) is held the same way.

Tolerances, each with its reason:
- parameters, momentum and outputs after training: ``rtol=1e-4,
  atol=1e-4`` (float32; XLA:CPU and PyTorch sum in different orders, and
  over 8-12 steps at lr 0.1 with momentum 0.9 LeNet's 500-term sums carry
  the last-bit differences up to some 3e-5 on weights of order 0.1);
- the accuracy after each epoch, from the host metric (k=1) and from the
  device sums (k=4): equal counts;
- ``score``: equal accuracy; ``predict``: the output tolerance above.

A checkpoint with its ``.states`` written by either package's
``save_checkpoint`` opens in the other's ``Module.load(...,
load_optimizer_states=True)``: same ``predict`` (output tolerance) and the
same momentum, exactly.
"""
import logging
import zlib

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-4, atol=1e-4)
NUM_CLASSES = 4
BATCH = 8
OPT = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _symbols(model):
    """(JAX symbol, port symbol) of the same model, with the same names."""
    kw = dict(num_classes=NUM_CLASSES)
    if model == "mlp":
        kw["hidden"] = (32, 16)
    builders = {"mlp": (jmodels.mlp, tmodels.mlp),
                "lenet": (jmodels.lenet, tmodels.lenet)}[model]
    with mx.symbol.NameManager():
        jsym = builders[0](**kw)
    with mt.symbol.NameManager():
        tsym = builders[1](**kw)
    return jsym, tsym


def _data(model, name):
    """Class templates plus noise: (X, y) as numpy."""
    rng = _rng(name)
    shape = (10,) if model == "mlp" else (1, 28, 28)
    n = BATCH * (6 if model == "mlp" else 4)
    templates = rng.standard_normal((NUM_CLASSES,) + shape)
    y = rng.integers(0, NUM_CLASSES, n)
    x = templates[y] + 0.7 * rng.standard_normal((n,) + shape)
    return x.astype(np.float32), y.astype(np.float32)


def _arg_params(jsym, x, name):
    """Xavier-like numpy parameters from a seed."""
    rng = _rng(name + "/params")
    shapes, _, _ = jsym.infer_shape(data=(BATCH,) + x.shape[1:],
                                    softmax_label=(BATCH,))
    out = {}
    for n, sh in zip(jsym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight"):
            fan = np.prod(sh[1:]) + sh[0]
            out[n] = rng.uniform(-1, 1, sh) * np.sqrt(6.0 / fan)
        else:
            out[n] = 0.1 * rng.standard_normal(sh)
    return {n: v.astype(np.float32) for n, v in out.items()}


def _host(params):
    return {n: v.asnumpy() for n, v in params.items()}


def _fit(pkg, sym, x, y, params, k, ctx, num_epoch=2):
    """fit in one package; returns (module, accuracy after each epoch as
    (correct, count))."""
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH)
    metric = pkg.metric.Accuracy()
    per_epoch = []

    def on_epoch(epoch, *_):
        per_epoch.append((int(round(metric.sum_metric)), metric.num_inst))

    mod = pkg.mod.Module(sym, context=ctx)
    mod.fit(it, num_epoch=num_epoch, eval_metric=metric,
            arg_params={n: pkg.nd.array(v, ctx=ctx)
                        for n, v in params.items()},
            optimizer="sgd", optimizer_params=OPT, steps_per_dispatch=k,
            dispatch_pipeline=1, epoch_end_callback=on_epoch)
    return mod, per_epoch


def _both_fit(model, k, name):
    jsym, tsym = _symbols(model)
    x, y = _data(model, name)
    params = _arg_params(jsym, x, name)
    jmod, jacc = _fit(mx, jsym, x, y, params, k, mx.cpu())
    tmod, tacc = _fit(mt, tsym, x, y, params, k, mt.cpu())
    return (jmod, jacc), (tmod, tacc), x, y


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("model", ["mlp", "lenet"])
def test_fit_matches_reference(model, k):
    (jmod, jacc), (tmod, tacc), x, y = _both_fit(model, k, "fit")
    assert tacc == jacc
    jarg, jaux = jmod.get_params()
    targ, taux = tmod.get_params()
    assert sorted(targ) == sorted(jarg)
    for n in jarg:
        np.testing.assert_allclose(targ[n].asnumpy(), jarg[n].asnumpy(),
                                   err_msg=n, **TOL)
    # the trained weights are where score and predict read them
    jit = mx.io.NDArrayIter(x, y, batch_size=BATCH)
    tit = mt.io.NDArrayIter(x, y, batch_size=BATCH)
    assert tmod.score(tit, "acc") == jmod.score(jit, "acc")
    np.testing.assert_allclose(tmod.predict(tit).asnumpy(),
                               jmod.predict(jit).asnumpy(), **TOL)


@pytest.mark.parametrize("k", [1, 4])
def test_fit_kstep_equals_per_step(k):
    """The port's k=4 fit (packed device sums) against its own k=1 fit."""
    jsym, tsym = _symbols("mlp")
    x, y = _data("mlp", "kstep")
    params = _arg_params(jsym, x, "kstep")
    ref, ref_acc = _fit(mt, tsym, x, y, params, 1, mt.cpu())
    mod, acc = _fit(mt, tsym, x, y, params, k, mt.cpu())
    assert acc == ref_acc
    for n, v in ref.get_params()[0].items():
        np.testing.assert_allclose(mod.get_params()[0][n].asnumpy(),
                                   v.asnumpy(), err_msg=n, **TOL)


def _by_hand(pkg, sym, x, y, params, ctx, nbatch):
    """bind, init, then forward/backward/update by hand (the per-step
    executor path and the per-index updater)."""
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = pkg.mod.Module(sym, context=ctx)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={n: pkg.nd.array(v, ctx=ctx)
                                for n, v in params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    metric = pkg.metric.Accuracy()
    for i, batch in enumerate(it):
        if i == nbatch:
            break
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric, batch.label)
    return mod, metric.get()


@pytest.mark.parametrize("model", ["mlp", "lenet"])
def test_per_step_executor_path_matches_reference(model):
    jsym, tsym = _symbols(model)
    x, y = _data(model, "hand")
    params = _arg_params(jsym, x, "hand")
    jmod, jm = _by_hand(mx, jsym, x, y, params, mx.cpu(), 4)
    tmod, tm = _by_hand(mt, tsym, x, y, params, mt.cpu(), 4)
    assert tm == jm
    for n, v in _host(jmod.get_params()[0]).items():
        np.testing.assert_allclose(tmod.get_params()[0][n].asnumpy(), v,
                                   err_msg=n, **TOL)
    jst, tst = jmod._updater.states, tmod._updater.states
    assert sorted(tst) == sorted(jst)
    for i in jst:
        np.testing.assert_allclose(tst[i].asnumpy(), jst[i].asnumpy(),
                                   err_msg=str(i), **TOL)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_and_states_cross_open(writer, tmp_path):
    """A checkpoint and .states written by one package open in the other's
    Module.load(load_optimizer_states=True): the same predict, the same
    momentum, and the same next epoch of training."""
    (jmod, _), (tmod, _), x, y = _both_fit("mlp", 4, "ckpt")
    prefix = str(tmp_path / "mlp")
    src, dst_pkg, dst_ctx = ((jmod, mt, mt.cpu()) if writer == "jax"
                             else (tmod, mx, mx.cpu()))
    src.save_checkpoint(prefix, 2, save_optimizer_states=True)
    dst = dst_pkg.mod.Module.load(prefix, 2, load_optimizer_states=True,
                                  context=dst_ctx)
    it = dst_pkg.io.NDArrayIter(x, y, batch_size=BATCH)
    dst.bind(it.provide_data, it.provide_label)
    dst.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    src_it = (mx if writer == "jax" else mt).io.NDArrayIter(
        x, y, batch_size=BATCH)
    np.testing.assert_allclose(dst.predict(it).asnumpy(),
                               src.predict(src_it).asnumpy(), **TOL)
    src._sync_fused_opt_states()
    want = src._updater.states
    got = dst._updater.states
    assert sorted(got) == sorted(want)
    for i in want:
        np.testing.assert_array_equal(got[i].asnumpy(), want[i].asnumpy())
    # one more epoch from the loaded state equals one from the source's
    dst.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=OPT,
            steps_per_dispatch=1, dispatch_pipeline=0)
    src.fit(src_it, num_epoch=1, optimizer="sgd", optimizer_params=OPT,
            steps_per_dispatch=1, dispatch_pipeline=0)
    for n, v in _host(src.get_params()[0]).items():
        np.testing.assert_allclose(dst.get_params()[0][n].asnumpy(), v,
                                   err_msg=n, **TOL)


def test_entry_points_default_to_the_card():
    """Without a context, Module runs on cuda:0; without CUDA it raises and
    does not train on the CPU."""
    _, tsym = _symbols("mlp")
    import torch
    if torch.cuda.is_available():
        assert mt.mod.Module(tsym)._device == torch.device("cuda", 0)
        return
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mt.mod.Module(tsym)


def test_kstep_falls_back_with_a_reason(caplog):
    """A metric without a device-sum layout (F1) trains the K-step fit per
    step, with a warning naming the metric."""
    _, tsym = _symbols("mlp")
    x, y = _data("mlp", "fallback")
    y = (y > 1).astype(np.float32)
    it = mt.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = mt.mod.Module(tsym, context=mt.cpu())
    with caplog.at_level(logging.WARNING):
        mod.fit(it, num_epoch=1, eval_metric="f1", steps_per_dispatch=4,
                dispatch_pipeline=1)
    assert "steps_per_dispatch=4 unavailable" in caplog.text
    assert "'f1'" in caplog.text


def test_fit_logs_each_knob_source(caplog, monkeypatch):
    _, tsym = _symbols("mlp")
    x, y = _data("mlp", "knobs")
    monkeypatch.setenv("MXTPU_DISPATCH_PIPELINE", "2")
    mod = mt.mod.Module(tsym, context=mt.cpu())
    with caplog.at_level(logging.INFO):
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
                steps_per_dispatch=4)
    assert ("steps_per_dispatch=4 (arg), dispatch_pipeline=2 (env)"
            in caplog.text)
    with caplog.at_level(logging.INFO), mt.engine.bulk(2):
        monkeypatch.delenv("MXTPU_DISPATCH_PIPELINE")
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
                force_rebind=True)
    assert ("steps_per_dispatch=2 (env), dispatch_pipeline=1 (default)"
            in caplog.text)



@pytest.mark.parametrize("what,call", [
    ("dist_sync", lambda m, it: m.fit(it, num_epoch=1,
                                      kvstore="dist_sync")),
    ("dist_async", lambda m, it: mt.kv.create("dist_async")),
])
def test_options_not_ported_raise(what, call):
    _, tsym = _symbols("mlp")
    x, y = _data("mlp", "opts")
    mod = mt.mod.Module(tsym, context=mt.cpu())
    with pytest.raises(MXNetError, match=what):
        call(mod, mt.io.NDArrayIter(x, y, batch_size=BATCH))


@pytest.mark.parametrize("what,env,kw", [
    ("MXTPU_LM_MESH", {"MXTPU_LM_MESH": "data=2"}, None),
    ("mesh_axes", {}, dict(mesh_axes="data=2")),
    ("param_shardings", {}, dict(param_shardings={"fc1_weight": None})),
])
def test_environment_and_constructor_options_raise(what, env, kw,
                                                   monkeypatch):
    """The multi-axis options are ported: ``MXTPU_LM_MESH`` and
    ``mesh_axes`` fit over a 2-way 'data' mesh built over the module's two
    contexts, ``param_shardings`` without a mesh leaves the fit as it is;
    each fit's parameters equal the one-device fit's (``rtol=1e-5``)."""
    _, tsym = _symbols("mlp")
    x, y = _data("mlp", "opts")

    def fit(ctx, **kw):
        mt.random.seed(3)
        mod = mt.mod.Module(tsym, context=ctx, **kw)
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
                initializer=mt.initializer.Xavier(), steps_per_dispatch=2)
        return mod
    ref = fit(mt.cpu())
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mod = fit([mt.cpu(0), mt.cpu(1)], **(kw or {}))
    if what != "param_shardings":
        assert dict(mod._fused.mesh.shape) == {"data": 2}
    want = ref.get_params()[0]
    for n, v in mod.get_params()[0].items():
        np.testing.assert_allclose(v.asnumpy(), want[n].asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("what", ["MXTPU_DP_DEVICES", "context",
                                  "work_load_list"])
@pytest.mark.parametrize("k", [1, 4])
def test_environment_and_constructor_options_match_jax(what, k,
                                                       monkeypatch):
    """The data-parallel options train over two replicas as the JAX
    package's do over two of its devices: ``MXTPU_DP_DEVICES=2`` without a
    context (the current context's type), ``context=[cpu(0), cpu(1)]``, and
    with it ``work_load_list`` (kept, the batch split evenly, as the JAX
    package does). Accuracy counts equal, parameters to the fit
    tolerance."""
    jsym, tsym = _symbols("mlp")
    x, y = _data("mlp", "dp")
    params = _arg_params(jsym, x, "dp")
    res = {}
    for pkg, sym in ((mx, jsym), (mt, tsym)):
        kw = {}
        if what == "MXTPU_DP_DEVICES":
            monkeypatch.setenv("MXTPU_DP_DEVICES", "2")
        else:
            kw["context"] = [pkg.cpu(0), pkg.cpu(1)]
        if what == "work_load_list":
            kw["work_load_list"] = [1, 3]
        with pkg.cpu():
            mod = pkg.mod.Module(sym, **kw)
        monkeypatch.delenv("MXTPU_DP_DEVICES", raising=False)
        assert len(mod._context) == 2
        metric = pkg.metric.Accuracy()
        acc = []
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=2,
                eval_metric=metric,
                arg_params={n: pkg.nd.array(v, ctx=pkg.cpu())
                            for n, v in params.items()},
                optimizer="sgd", optimizer_params=OPT, steps_per_dispatch=k,
                epoch_end_callback=lambda *a: acc.append(
                    (int(round(metric.sum_metric)), metric.num_inst)))
        res[pkg.__name__] = (acc, _host(mod.get_params()[0]))
    (jacc, jp), (tacc, tp) = res["mxnet_tpu"], res["mxnet_tpu_torch"]
    assert tacc == jacc
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=1e-4, atol=1e-4,
                                   err_msg=n)


@pytest.mark.parametrize("updater", [False, True])
def test_local_kvstore_matches_reference(updater, tmp_path):
    """init, push of a device list (summed), pull into several outputs,
    and with set_optimizer the SGD update and its .states file."""
    rng = _rng("kv")
    w = rng.standard_normal((3, 4)).astype(np.float32)
    grads = [rng.standard_normal((3, 4)).astype(np.float32)
             for _ in range(2)]
    out = {}
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        kv = pkg.kv.create("local")
        assert kv.type == "local" and kv.num_workers == 1
        kv.init(3, pkg.nd.array(w, ctx=ctx))
        if updater:
            kv.set_optimizer(pkg.optimizer.create(
                "sgd", learning_rate=0.1, momentum=0.9, wd=1e-4,
                rescale_grad=0.5))
        for _ in range(2):
            kv.push(3, [pkg.nd.array(g, ctx=ctx) for g in grads])
        outs = [pkg.nd.zeros((3, 4), ctx=ctx) for _ in range(2)]
        kv.pull(3, out=outs)
        out[pkg] = [o.asnumpy() for o in outs]
        if updater:
            fname = str(tmp_path / (pkg.__name__ + ".states"))
            kv.save_optimizer_states(fname)
            with open(fname, "rb") as f:
                out[pkg, "states"] = f.read()
            out[pkg, "mom"] = kv._updater.states[3].asnumpy()
    for a, b in zip(out[mt], out[mx]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    if updater:
        # each package's .states file loads in the other's store
        for src, dst, ctx in ((mx, mt, mt.cpu()), (mt, mx, mx.cpu())):
            kv = dst.kv.create("local")
            kv.init(3, dst.nd.array(w, ctx=ctx))
            kv.set_optimizer(dst.optimizer.create("sgd", momentum=0.9))
            fname = str(tmp_path / "x.states")
            with open(fname, "wb") as f:
                f.write(out[src, "states"])
            kv.load_optimizer_states(fname)
            np.testing.assert_array_equal(kv._updater.states[3].asnumpy(),
                                          out[src, "mom"])
    with pytest.raises(MXNetError, match="not initialized"):
        mt.kv.create("local").push(1, mt.nd.zeros((2,), ctx=mt.cpu()))


def test_fit_traces_its_dispatches(tmp_path):
    """With the tracer armed, a K-step fit records its dispatch, assembly,
    copy and read-back spans under one correlation index per superbatch,
    the flight recorder notes each retired dispatch, and save writes
    Chrome trace JSON."""
    import json
    from mxnet_tpu_torch.obs import flight, trace
    _, tsym = _symbols("mlp")
    x, y = _data("mlp", "trace")
    trace.clear()
    trace.start()
    try:
        mt.mod.Module(tsym, context=mt.cpu()).fit(
            mt.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
            steps_per_dispatch=3, dispatch_pipeline=1)
    finally:
        trace.stop()
    evs = trace.events()
    by_name = {}
    for ev in evs:
        if ev["ph"] == "X":
            by_name.setdefault(ev["name"], []).append(ev["args"].get(
                "dispatch"))
    for name in ("dispatch", "superbatch_assemble", "h2d",
                 "readback_stall", "data_wait"):
        assert sorted({i for i in by_name[name] if i is not None}) \
            == [0, 1], name
    marks = [m for m in flight.FLIGHT.marks()
             if m["marker"] == "dispatch_retired"][-2:]
    assert [(m["dispatch"], m["nbatch"]) for m in marks] == [(0, 2), (1, 5)]
    path = trace.save(str(tmp_path / "trace.json"))
    with open(path) as f:
        assert len(json.load(f)["traceEvents"]) >= len(evs)
    trace.clear()


def test_set_params_after_a_synced_get_params_reaches_the_executor():
    """After fused steps, get_params syncs the fused state into copies; a
    set_params (a guard rollback's restore, an epoch end) must then reach
    the executor's arrays and the fused state seeded from them. The JAX
    package writes into the copies and keeps computing with the old
    values; the oracle is a JAX module bound with the new values."""
    jsym, tsym = _symbols("mlp")
    x, y = _data("mlp", "setp")
    mod = mt.mod.Module(tsym, context=mt.cpu())
    it = mt.io.NDArrayIter(x, y, batch_size=BATCH)
    mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1})
    it.reset()
    assert mod._try_fused_fit_step(next(iter(it)))
    arg, aux = mod.get_params()
    new = _arg_params(jsym, x, "setp")
    mod.set_params({n: mt.nd.array(v, ctx=mt.cpu()) for n, v in new.items()},
                   aux)
    jmod = mx.mod.Module(jsym, context=mx.cpu())
    jmod.bind(data_shapes=[("data", (BATCH,) + x.shape[1:])],
              label_shapes=[("softmax_label", (BATCH,))],
              for_training=False)
    jmod.set_params({n: mx.nd.array(v) for n, v in new.items()}, {})
    batch = (x[:BATCH], y[:BATCH])
    mod.forward(mt.io.DataBatch(data=[mt.nd.array(batch[0], ctx=mt.cpu())],
                                label=[mt.nd.array(batch[1], ctx=mt.cpu())]),
                is_train=False)
    jmod.forward(mx.io.DataBatch(data=[mx.nd.array(batch[0])],
                                 label=[mx.nd.array(batch[1])]),
                 is_train=False)
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(),
                               jmod.get_outputs()[0].asnumpy(),
                               rtol=1e-5, atol=1e-6)
    # and the next fused step starts from the new values: one step away
    # from them, not from the trained ones
    old = {n: v.asnumpy() for n, v in arg.items()}
    it.reset()
    assert mod._try_fused_fit_step(next(iter(it)))
    for n, v in mod.get_params()[0].items():
        p = v.asnumpy()
        assert np.abs(p - new[n]).max() < np.abs(p - old[n]).max(), n
