"""One SSD training step on the card: MultiBox NMS (B2) runs in it.

The width-8 SSD training net (``models.ssd.get_symbol_train``, 3 classes,
3x96x96, batch 4, ``nms_topk`` 400 of 3,024 anchors) with Xavier weights:

- ``TrainStep.step`` with Adam on ``cuda:0`` launches the NMS kernel once,
  on its ``smem`` route, and leaves finite parameters;
- the ``det_out`` head of a training forward (``Executor.forward(
  is_train=True)`` on ``gpu(0)``) equals ``MultiBoxDetection`` with the
  plain NMS (``multibox_nms.nms_alive_reference``) on the same
  ``cls_prob``, ``loc_preds`` and anchors, exactly.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ssd_train_card.py -q

Without CUDA each test skips, with its reason.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import ssd
from mxnet_tpu_torch.ops import contrib, multibox_nms as mnms
from mxnet_tpu_torch.symbol import _topo

BATCH, SIZE = 4, 96


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: SSD training on cuda:0 "
                    "(chip_smoke.py runs phase 12 there)")


def _setup():
    with mt.symbol.NameManager():
        net = ssd.get_symbol_train(num_classes=3, width=8)
    rng = np.random.default_rng(12)
    imgs = rng.standard_normal((BATCH, 3, SIZE, SIZE)).astype(np.float32)
    labels = -np.ones((BATCH, 3, 5), np.float32)
    for i in range(BATCH):
        for o in range(1 + i % 3):
            x1, y1 = rng.uniform(0, 0.5, 2)
            w, h = rng.uniform(0.25, 0.5, 2)
            labels[i, o] = [rng.integers(0, 3), x1, y1, x1 + w, y1 + h]
    return net, imgs, labels


@pytest.mark.gpu
def test_train_step_launches_nms_on_smem():
    _need_card()
    net, imgs, labels = _setup()
    step = mt.TrainStep(net, data_names=("data",), label_names=("label",),
                        optimizer="adam", learning_rate=1e-3)
    assert step.device.type == "cuda"
    state = step.init({"data": imgs.shape}, {"label": labels.shape}, seed=3)
    before = dict(mnms.LAUNCHES_BY_ROUTE)
    launches = mnms.LAUNCHES
    state, outs = step.step(state, {"data": imgs, "label": labels})
    torch.cuda.synchronize()
    assert mnms.LAUNCHES - launches == 1
    assert {r: mnms.LAUNCHES_BY_ROUTE[r] - before[r] for r in before} == {
        "smem": 1, "l2": 0}
    assert outs[3].shape == (BATCH, 3024, 6)
    assert all(bool(torch.isfinite(v).all())
               for v in state["params"].values())


@pytest.mark.gpu
def test_det_out_equals_plain_nms():
    _need_card()
    net, imgs, labels = _setup()
    ex = net.simple_bind(mt.gpu(0), data=imgs.shape, label=labels.shape)
    init = mt.initializer.Xavier()
    mt.random.seed(4)
    for n, arr in ex.arg_dict.items():
        if n not in ("data", "label"):
            init(mt.initializer.InitDesc(n), arr)
    ex.arg_dict["data"][:] = imgs
    ex.arg_dict["label"][:] = labels
    seen = {}
    wanted = ("cls_prob_output", "multibox_loc_pred_output",
              "multibox_anchors_output")
    ex.set_monitor_callback(
        lambda name, arr: seen.__setitem__(name, arr.data.clone())
        if name in wanted else None)
    det = ex.forward(is_train=True)[3].data
    ex.backward()
    assert det.is_cuda
    attrs = contrib._mbd_attrs([n for n in _topo(net._out_nodes())
                                if n.name == "detection"][0].attrs)
    plain = contrib.multibox_detection(
        seen["cls_prob_output"], seen["multibox_loc_pred_output"],
        seen["multibox_anchors_output"], nms=mnms.nms_alive_reference,
        **attrs)
    assert torch.equal(det, plain)
    assert int((det[:, :, 0] >= 0).sum()) > 0
