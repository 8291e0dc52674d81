"""SSD training in the PyTorch port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages:

- ``MultiBoxTarget`` on hand-built anchors (a grid, one ground truth and a
  padded label) and on random anchors and labels (padded rows included),
  with and without hard negative mining: ``loc_mask`` and ``cls_target``
  exactly equal, ``loc_target`` within ``atol=1e-5`` (float32 ``log`` of
  XLA and of PyTorch may differ by an ulp);
- ``MakeLoss``: forward and the gradient into its input for ``grad_scale``
  0, 1 and 0.5 under ``normalization`` null, batch and valid, exactly;
- ``L2Normalization`` in each mode: forward and gradient, ``rtol=1e-6``
  (forward) and ``rtol=1e-5, atol=1e-7`` (gradient: float32 sums of
  squares in another order);
- ``models.ssd.get_symbol_train``: argument and output names, output
  shapes;
- one training step of the width-8 net at 3x96x96, batch 4, with the same
  weights: the cross-entropy and smooth-L1 sums within ``rtol=1e-4``,
  ``cls_target`` equal on at least 99.9% of the anchors (a near-tie at the
  hard-negative cut may flip an anchor when the two packages' convolutions
  differ in the last bits) and each parameter gradient within a relative L2
  error of 1e-3, through the bind path (``Executor.backward``) and through
  ``TrainStep`` (the ``Test`` optimizer, whose update adds the gradient);
- ``MultiBoxMetric``: host ``update`` and the device sums against the JAX
  metric's over the same outputs, ``rtol=1e-6``;
- a ``TrainStep`` state of the SSD train net with Adam carried from the JAX
  package (``convert.from_reference_state``) and back, exactly, and the
  first step's outputs from it within ``rtol=1e-4, atol=1e-5``.

The JAX smoke test's loss-decrease check (``tests/test_ssd.py``) runs
through the port's ``Module`` (Adam through the per-index updater), seeded
explicitly; and ``Module.fit(optimizer="adam")`` at one and at four steps
a dispatch gives the same parameters (``rtol=1e-6, atol=1e-7``) and the
same metric (``rtol=1e-5``) on the CPU.
"""
import os
import sys
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import ssd as jssd
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import ssd as tssd

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "example", "ssd"))
from train import synth_det_batch  # noqa: E402

MBT_KW = dict(overlap_threshold=0.5, variances="0.1,0.1,0.2,0.2")
STEP_BATCH, STEP_SIZE, STEP_CLASSES, STEP_WIDTH = 4, 96, 3, 8


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _mbt_both(anc, lab, cls_pred, **kw):
    kw = dict(MBT_KW, **kw)
    j = [x.asnumpy() for x in mx.nd.MultiBoxTarget(
        mx.nd.array(anc), mx.nd.array(lab), mx.nd.array(cls_pred), **kw)]
    with mt.cpu():
        t = [x.asnumpy() for x in mt.nd.MultiBoxTarget(
            mt.nd.array(anc), mt.nd.array(lab), mt.nd.array(cls_pred), **kw)]
    return j, t


def _assert_mbt_equal(j, t):
    np.testing.assert_array_equal(t[1], j[1])      # loc_mask
    np.testing.assert_array_equal(t[2], j[2])      # cls_target
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-5)


def _grid_anchors():
    anc = []
    for cy in np.linspace(0.1, 0.9, 8):
        for cx in np.linspace(0.1, 0.9, 8):
            for s in (0.2, 0.4):
                anc.append([cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2])
    return np.array(anc, np.float32)[None]


@pytest.mark.parametrize("ratio", [-1.0, 3.0])
def test_multibox_target_hand_built(ratio):
    anc = _grid_anchors()
    A = anc.shape[1]
    gt = np.array([[[1, 0.3, 0.3, 0.62, 0.58], [-1, 0, 0, 0, 0]],
                   [[-1, 0, 0, 0, 0], [-1, 0, 0, 0, 0]],
                   [[0, 0.05, 0.05, 0.2, 0.3], [2, 0.5, 0.5, 0.95, 0.9]]],
                  np.float32)
    cls_pred = _rng("hand/cls").standard_normal((3, 3, A)).astype(
        np.float32)
    j, t = _mbt_both(anc, gt, cls_pred, negative_mining_ratio=ratio)
    _assert_mbt_equal(j, t)
    assert (t[2][0] > 0).sum() >= 1 and (t[2][1] > 0).sum() == 0
    if ratio > 0:
        # an image with no object still keeps one mined negative
        assert (t[2][1] == 0).sum() == 1 and (t[2][1] == -1).sum() == A - 1


def _random_case(seed, B=4, A=300, O=5, zero_pred=False):
    rng = np.random.default_rng(seed)
    c = rng.random((A, 2))
    wh = rng.uniform(0.05, 0.5, (A, 2))
    anc = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    lab = -np.ones((B, O, 5), np.float32)
    for b in range(B):
        for o in range(int(rng.integers(0, O + 1))):
            c = rng.random(2)
            wh = rng.uniform(0.05, 0.6, 2)
            lab[b, o] = [rng.integers(0, 3), *(c - wh / 2), *(c + wh / 2)]
    cls_pred = (np.zeros((B, 4, A), np.float32) if zero_pred else
                rng.standard_normal((B, 4, A)).astype(np.float32))
    return anc[None], lab, cls_pred


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ratio", [-1.0, 3.0])
def test_multibox_target_random(seed, ratio):
    j, t = _mbt_both(*_random_case(seed), negative_mining_ratio=ratio)
    _assert_mbt_equal(j, t)


def test_multibox_target_ties_and_many_anchors():
    # all-zero predictions: every background probability ties, and the
    # stable sort keeps anchor order in both packages
    j, t = _mbt_both(*_random_case(7, zero_pred=True),
                     negative_mining_ratio=3.0)
    _assert_mbt_equal(j, t)
    j, t = _mbt_both(*_random_case(8, B=2, A=3000, O=8),
                     negative_mining_ratio=3.0)
    _assert_mbt_equal(j, t)


def test_multibox_target_outputs_carry_no_gradient():
    anc, lab, cls_pred = _random_case(9)
    cp = torch.from_numpy(cls_pred).requires_grad_()
    from mxnet_tpu_torch.ops import contrib
    outs = contrib.multibox_target(torch.from_numpy(anc),
                                   torch.from_numpy(lab), cp,
                                   negative_mining_ratio=3.0)
    assert not any(o.requires_grad for o in outs)


# ---------------------------------------------------------------------------
# MakeLoss and L2Normalization
# ---------------------------------------------------------------------------

def _bind_grad(pkg, sym, x, head):
    """Forward (train) and backward of ``sym`` over ``data`` = ``x`` with
    head gradient ``head``: (output, data gradient) as numpy."""
    ctx = pkg.cpu()
    ex = sym.simple_bind(ctx, data=x.shape)
    ex.arg_dict["data"][:] = x
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward([pkg.nd.array(head, ctx=ctx)])
    return out, ex.grad_dict["data"].asnumpy()


@pytest.mark.parametrize("grad_scale", [0.0, 1.0, 0.5])
@pytest.mark.parametrize("norm", ["null", "batch", "valid"])
def test_make_loss_forward_and_gradient(grad_scale, norm):
    rng = _rng("makeloss")
    x = rng.standard_normal((4, 3, 5)).astype(np.float32)
    head = rng.standard_normal(x.shape).astype(np.float32)
    got = []
    for pkg in (mx, mt):
        sym = pkg.sym.MakeLoss(pkg.sym.Variable("data"),
                               grad_scale=grad_scale, normalization=norm)
        got.append(_bind_grad(pkg, sym, x, head))
    (jo, jg), (to, tg) = got
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(to, x)
    np.testing.assert_array_equal(tg, jg)
    want = grad_scale / (x.shape[0] if norm == "batch" else 1)
    np.testing.assert_array_equal(tg, np.full(x.shape, want, np.float32))


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization(mode):
    rng = _rng("l2norm/" + mode)
    x = rng.standard_normal((2, 5, 4, 3)).astype(np.float32)
    head = rng.standard_normal(x.shape).astype(np.float32)
    got = []
    for pkg in (mx, mt):
        sym = pkg.sym.L2Normalization(pkg.sym.Variable("data"), mode=mode)
        got.append(_bind_grad(pkg, sym, x, head))
    (jo, jg), (to, tg) = got
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-7)


def test_multibox_layer_normalization_builds_l2norm():
    with mt.symbol.NameManager():
        data = mt.sym.Variable("data")
        loc, cls, anc = tssd.multibox_layer(
            [data], 3, [[0.2, 0.27]], [[1.0, 2.0]], normalization=20)
    with mx.symbol.NameManager():
        jdata = mx.sym.Variable("data")
        jloc, jcls, janc = jssd.multibox_layer(
            [jdata], 3, [[0.2, 0.27]], [[1.0, 2.0]], normalization=20)
    assert mt.sym.Group([loc, cls, anc]).list_arguments() == \
        mx.sym.Group([jloc, jcls, janc]).list_arguments()
    _, out, _ = loc.infer_shape(data=(2, 8, 6, 6))
    assert out == [(2, 6 * 6 * 3 * 4)]


# ---------------------------------------------------------------------------
# the training symbol
# ---------------------------------------------------------------------------

def test_train_symbol_names_and_shapes():
    with mt.symbol.NameManager():
        net = tssd.get_symbol_train(num_classes=3, width=16)
    with mx.symbol.NameManager():
        jnet = jssd.get_symbol_train(num_classes=3, width=16)
    assert net.list_outputs() == jnet.list_outputs() == [
        "cls_prob_output", "loc_loss_output", "cls_label_output",
        "det_out_output"]
    assert net.list_arguments() == jnet.list_arguments()
    _, out, _ = net.infer_shape(data=(2, 3, 128, 128), label=(2, 4, 5))
    _, jout, _ = jnet.infer_shape(data=(2, 3, 128, 128), label=(2, 4, 5))
    shapes = dict(zip(net.list_outputs(), out))
    A = shapes["cls_label_output"][1]
    assert shapes["cls_prob_output"] == (2, 4, A)        # 3 classes + bg
    assert shapes["loc_loss_output"] == (2, 4 * A)
    assert shapes["det_out_output"] == (2, A, 6)
    assert [tuple(s) for s in out] == [tuple(s) for s in jout]


# ---------------------------------------------------------------------------
# one training step, both packages, the same weights
# ---------------------------------------------------------------------------

def _step_setup():
    with mt.symbol.NameManager():
        net = tssd.get_symbol_train(num_classes=STEP_CLASSES,
                                    width=STEP_WIDTH)
    with mx.symbol.NameManager():
        jnet = jssd.get_symbol_train(num_classes=STEP_CLASSES,
                                     width=STEP_WIDTH)
    imgs, labels = synth_det_batch(_rng("step/data"), STEP_BATCH, STEP_SIZE,
                                   STEP_CLASSES)
    shapes, _, _ = net.infer_shape(data=imgs.shape, label=labels.shape)
    rng = _rng("step/params")
    params = {}
    for n, s in zip(net.list_arguments(), shapes):
        if n in ("data", "label"):
            continue
        if n.endswith("_weight"):
            v = rng.standard_normal(s) * np.sqrt(2.0 / np.prod(s[1:]))
        else:
            v = 0.01 * rng.standard_normal(s)
        params[n] = v.astype(np.float32)
    return net, jnet, imgs, labels, params


def _bind_step(pkg, sym, imgs, labels, params):
    ctx = pkg.cpu()
    ex = sym.simple_bind(ctx, data=imgs.shape, label=labels.shape)
    for n, v in params.items():
        ex.arg_dict[n][:] = v
    ex.arg_dict["data"][:] = imgs
    ex.arg_dict["label"][:] = labels
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward()
    return outs, {n: ex.grad_dict[n].asnumpy() for n in params}


def _losses(outs):
    """(cross-entropy sum over valid anchors, smooth-L1 sum), float64."""
    cls_prob, loc_loss, cls_label = (o.astype(np.float64) for o in outs[:3])
    lab = cls_label.astype(np.int64)
    valid = lab >= 0
    n, _, A = cls_prob.shape
    p = cls_prob[np.arange(n)[:, None], np.maximum(lab, 0),
                 np.arange(A)[None, :]]
    return float((-np.log(p + 1e-8) * valid).sum()), float(loc_loss.sum())


@pytest.fixture(scope="module")
def ssd_step():
    net, jnet, imgs, labels, params = _step_setup()
    jouts, jgrads = _bind_step(mx, jnet, imgs, labels, params)
    touts, tgrads = _bind_step(mt, net, imgs, labels, params)
    return dict(net=net, jnet=jnet, imgs=imgs, labels=labels, params=params,
                jouts=jouts, jgrads=jgrads, touts=touts, tgrads=tgrads)


def _assert_grads_close(got, want):
    for n, w in want.items():
        err = np.linalg.norm(got[n] - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 1e-3, "%s: relative L2 error %g" % (n, err)


def test_train_step_losses_and_targets(ssd_step):
    j, t = ssd_step["jouts"], ssd_step["touts"]
    agree = float(np.mean(j[2] == t[2]))
    assert agree >= 0.999, "cls_target agrees on %.5f of anchors" % agree
    jce, jl1 = _losses(j)
    tce, tl1 = _losses(t)
    assert tce == pytest.approx(jce, rel=1e-4)
    assert tl1 == pytest.approx(jl1, rel=1e-4)
    assert np.isfinite(t[3]).all() and t[3].shape == j[3].shape


def test_train_step_gradients_bind_path(ssd_step):
    _assert_grads_close(ssd_step["tgrads"], ssd_step["jgrads"])


def test_train_step_gradients_train_step(ssd_step):
    # the Test optimizer adds the gradient: w1 - w0 is the step's gradient
    net, params = ssd_step["net"], ssd_step["params"]
    opt = mt.optimizer.create("test", rescale_grad=1.0, sym=net)
    step = mt.TrainStep(net, data_names=("data",), label_names=("label",),
                        optimizer=opt, device="cpu")
    state = step.init({"data": ssd_step["imgs"].shape},
                      {"label": ssd_step["labels"].shape})
    for n, v in params.items():
        state["params"][n].copy_(torch.from_numpy(v))
    state, outs = step.step(state, {"data": ssd_step["imgs"],
                                    "label": ssd_step["labels"]})
    got = {n: state["params"][n].double().numpy() - params[n].astype(
        np.float64) for n in params}
    _assert_grads_close(got, ssd_step["jgrads"])
    for o, want in zip(outs[:2], ssd_step["touts"][:2]):
        np.testing.assert_array_equal(o.numpy(), want)


# ---------------------------------------------------------------------------
# MultiBoxMetric
# ---------------------------------------------------------------------------

def test_multibox_metric_host_and_device_sums(ssd_step):
    import jax.numpy as jnp
    outs = ssd_step["touts"]
    jm = mx.metric.create("multibox")
    jm.update([], [mx.nd.array(o) for o in outs])
    tm = mt.metric.create("multibox")
    assert isinstance(tm, mt.metric.MultiBoxMetric)
    tm.update([], [mt.nd.array(o, ctx=mt.cpu()) for o in outs])
    np.testing.assert_allclose(tm.sum_metric, jm.sum_metric, rtol=1e-6)
    assert tm.num_inst == jm.num_inst
    assert tm.get() == (["multibox_0", "multibox_1"], tm.get()[1])

    shapes = [o.shape for o in outs]
    lshape = [ssd_step["labels"].shape]
    jspec = jm.device_sum_spec(shapes, lshape)
    tspec = mt.metric.device_sum_spec(tm, shapes, lshape)
    assert tspec.slots == jspec.slots and tspec.signature == jspec.signature
    jv = [float(v) for v in jspec.step_sums([jnp.asarray(o) for o in outs],
                                            [])]
    tv = [float(v) for v in tspec.step_sums([torch.from_numpy(o)
                                             for o in outs], [])]
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    folded = mt.metric.MultiBoxMetric()
    tspec.fold(folded, dict(zip(tspec.slots, tv)))
    np.testing.assert_allclose(folded.sum_metric, jm.sum_metric, rtol=1e-6)
    assert folded.num_inst == jm.num_inst
    assert mt.metric.device_sum_spec(tm, shapes[:2], lshape) is None


# ---------------------------------------------------------------------------
# a TrainStep state with Adam carried across
# ---------------------------------------------------------------------------

def test_adam_state_carried_across(ssd_step):
    net, jnet = ssd_step["net"], ssd_step["jnet"]
    imgs, labels, params = (ssd_step[k] for k in ("imgs", "labels",
                                                  "params"))
    jstep = mx.train_step.TrainStep(jnet, data_names=("data",),
                                    label_names=("label",),
                                    optimizer="adam", learning_rate=1e-3)
    jstate = jstep.init({"data": imgs.shape}, {"label": labels.shape})
    jstate["params"] = {n: mx.nd.array(params[n]).data
                        for n in jstate["params"]}
    # one JAX step, so that the Adam moments are not zero
    jstate, _ = jstep.step(jstate, {"data": imgs, "label": labels})
    state = convert.from_reference_state(jstate, "cpu")
    assert all(isinstance(v, tuple) and len(v) == 2
               for v in state["opt"].values())
    back = convert.to_reference_state(state)
    for n, v in jstate["params"].items():
        np.testing.assert_array_equal(back["params"][n], np.asarray(v))
    for n, (mean, var) in jstate["opt"].items():
        np.testing.assert_array_equal(back["opt"][n][0], np.asarray(mean))
        np.testing.assert_array_equal(back["opt"][n][1], np.asarray(var))
    assert int(back["step"]) == int(jstate["step"]) == 1

    step = mt.TrainStep(net, data_names=("data",), label_names=("label",),
                        optimizer="adam", learning_rate=1e-3, device="cpu")
    jstate, jouts = jstep.step(jstate, {"data": imgs, "label": labels})
    state, outs = step.step(state, {"data": imgs, "label": labels})
    for o, j in zip(outs[:2], jouts[:2]):
        np.testing.assert_allclose(o.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5)
    assert int(state["step"]) == 2


# ---------------------------------------------------------------------------
# Module
# ---------------------------------------------------------------------------

def test_ssd_training_smoke_loss_decreases():
    """tests/test_ssd.py's smoke gate through the port's Module on the CPU
    (forward_backward, the per-index Adam updater), seeded explicitly."""
    mt.random.seed(0)
    rng = np.random.default_rng(0)
    imgs, labels = synth_det_batch(rng, 32, 96, 3)
    it = mt.io.NDArrayIter(imgs, labels, batch_size=16, shuffle=True,
                           label_name="label")
    net = tssd.get_symbol_train(num_classes=3, width=8)
    mod = mt.mod.Module(net, data_names=("data",), label_names=("label",),
                        context=mt.cpu())
    metric = mt.metric.MultiBoxMetric()
    losses = []
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 1e-3,
                                         "rescale_grad": 1.0})
    for _epoch in range(16):
        it.reset()
        metric.reset()
        for b in it:
            mod.forward_backward(b)
            mod.update()
            mod.update_metric(metric, b.label)
        losses.append(metric.get()[1][0])      # cross-entropy
    assert losses[-1] < losses[0] * 0.8, \
        "SSD cls loss did not decrease: %s" % losses
    assert all(np.isfinite(losses)), losses


def test_module_fit_adam_one_and_four_steps_a_dispatch():
    imgs, labels = synth_det_batch(_rng("fit/data"), 16, 64, 3)
    with mt.symbol.NameManager():
        net = tssd.get_symbol_train(num_classes=3, width=8)
    shapes, _, _ = net.infer_shape(data=(4, 3, 64, 64), label=(4, 3, 5))
    rng = _rng("fit/params")
    arg_params = {
        n: mt.nd.array((rng.standard_normal(s) * np.sqrt(
            2.0 / np.prod(s[1:])) if n.endswith("_weight")
            else np.zeros(s)).astype(np.float32), ctx=mt.cpu())
        for n, s in zip(net.list_arguments(), shapes)
        if n not in ("data", "label")}
    fits = {}
    for k in (1, 4):
        metric = mt.metric.MultiBoxMetric()
        mod = mt.mod.Module(net, data_names=("data",),
                            label_names=("label",), context=mt.cpu())
        mod.fit(mt.io.NDArrayIter(imgs, labels, batch_size=4,
                                  label_name="label"),
                num_epoch=2, eval_metric=metric, optimizer="adam",
                optimizer_params={"learning_rate": 1e-3,
                                  "rescale_grad": 1.0},
                arg_params=arg_params, steps_per_dispatch=k,
                dispatch_pipeline=1)
        assert mod._fused is not None
        assert isinstance(mod._fused._opt, mt.optimizer.Adam)
        spec = mod._fused_metric_spec
        assert (spec is not None and spec.tag == "multibox") == (k == 4)
        fits[k] = (mod.get_params()[0], list(metric.sum_metric),
                   list(metric.num_inst))
    (p1, s1, n1), (p4, s4, n4) = fits[1], fits[4]
    for n, v in p1.items():
        np.testing.assert_allclose(p4[n].asnumpy(), v.asnumpy(), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(s4, s1, rtol=1e-5)
    assert n4 == n1


def test_module_runs_on_the_card_unless_given_the_cpu():
    """Without a context, Module(get_symbol_train()) runs on cuda:0;
    without CUDA it raises instead of falling back."""
    from mxnet_tpu_torch.base import MXNetError
    net = tssd.get_symbol_train()
    if torch.cuda.is_available():
        assert mt.mod.Module(net, label_names=("label",))._device == \
            torch.device("cuda", 0)
        return
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mt.mod.Module(net, label_names=("label",))
    assert mt.mod.Module(net, label_names=("label",),
                         context=mt.cpu())._device == torch.device("cpu")
