"""The communication analyzer on the card: ``chip_smoke.py`` phase 27 (a)
at a smaller batch.

A ResNet-50 bf16 training step (NHWC, 224x224, 1000 classes,
``MXTPU_FUSE_CONV_BN=1``) over phase 18's two-position 'data' mesh on
``cuda:0``, at a global batch of 32 (16 a position; the phase runs 128):

- ``commscheck.check_train_step`` on fake ``cuda:0`` tensors: the
  gradient sums are one all-reduce a parameter along 'data' over two
  positions, 102,228,128 bytes in all (the f32 gradients of the model's
  25,557,032 parameters: the bytes a rank sent a step in phase 22, which
  no batch changes);
- one real dispatch of the same step: its ``parallel.mesh.COUNTERS`` by
  kind equal the inventory's forward collectives by kind, and B1 launched
  66 times (33 a position).

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_commscheck_card.py -q

Without CUDA the test skips, with its reason. The counts and bytes are
exact.
"""
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import commscheck as cc, models
from mxnet_tpu_torch.ops import matmul_stats as ms
from mxnet_tpu_torch.parallel import mesh as pm
from mxnet_tpu_torch.train_step import TrainStep

pytestmark = pytest.mark.gpu

#: the f32 gradients of ResNet-50 (1000 classes), one position's
GRAD_BYTES = 102228128

#: ``COUNTERS``' keys as the inventory's kinds
KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
        "broadcast": "collective-broadcast", "ppermute": "collective-permute",
        "all_to_all": "all-to-all"}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step is priced on fake "
                    "cuda:0 tensors, which autograd needs a CUDA build of "
                    "torch for, and held against a real dispatch "
                    "(chip_smoke.py phase 27 runs the full-size case)")


def test_dp2_resnet50_bf16_inventory_against_a_real_dispatch(monkeypatch):
    _need_card()
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    bsz, img = 32, 224
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=1000, num_layers=50,
                            image_shape="3,%d,%d" % (img, img),
                            layout="NHWC")
    mesh = pm.make_mesh({"data": 2}, ["cuda:0"] * 2)
    ts = TrainStep(sym, mesh=mesh, optimizer="sgd", learning_rate=0.1,
                   momentum=0.9, wd=1e-4, compute_dtype="bfloat16")
    shapes = ({"data": (bsz, img, img, 3)}, {"softmax_label": (bsz,)})
    findings, reports = cc.check_train_step(ts, *shapes, k=1, guard=False,
                                            name="dp2-r50")
    rep = reports["dp2-r50/step"]
    assert not rep.hlo_unavailable and rep.device == "cuda:0"
    grads = [e for e in rep.entries
             if (e.op_path or "").startswith("gradient/")]
    assert len(grads) == len(ts.param_names)
    assert all((e.kind, e.axes, e.group_size, e.multiplier)
               == ("all-reduce", ("data",), 2, 1) for e in grads)
    assert sum(e.bytes for e in grads) == GRAD_BYTES
    assert rep.flops > 0 and 0.0 < rep.predicted_efficiency < 1.0
    assert cc.unsuppressed(findings) == []

    state = ts.init(*shapes, seed=0)
    gen = torch.Generator(device="cuda:0")
    gen.manual_seed(27)
    batch = {"data": torch.randn(shapes[0]["data"], generator=gen,
                                 device="cuda:0"),
             "softmax_label": torch.randint(0, 1000, (bsz,), generator=gen,
                                            device="cuda:0").float()}
    torch.cuda.synchronize()
    pm.reset_counters()
    ms.reset_launches()
    ts.step(state, batch)
    torch.cuda.synchronize()
    counted = {KIND[k]: v for k, v in pm.COUNTERS.items() if v}
    forward = {}
    for e in rep.entries:
        if not e.transpose:
            forward[e.kind] = forward.get(e.kind, 0) + e.multiplier
    assert forward == counted
    assert ms.LAUNCHES == 66
