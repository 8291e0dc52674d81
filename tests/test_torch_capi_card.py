"""The C ABI's three kernel paths on the card, at small widths:
``chip_smoke.capi_phase`` (phase 23) with ResNet-50 at 32x32, batch 4,
and the SSD at 3x96x96: ``card_client``'s code in this process through
``ctypes`` (B1 through MXExecutorBind, B2 through MXPredCreate from two C
threads, B3 through MXRtcPush) with the launches counted, held against the
Python API and each kernel against its plain version, and the client as a
child process. Also ``TorchModule`` on ``cuda:0``: its parameters move to
the card and its output and input gradient match the CPU's.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_capi_card.py -q

Without CUDA each test skips, with its reason. Tolerances: those of
``chip_smoke.capi_phase``; the plugin's ``rtol=1e-5`` (cuBLAS and the CPU
sum the products in other orders; TF32 off).
"""
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn as tnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.plugin.torch_module import TorchModule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the C ABI's kernel paths launch "
                    "only on the card (chip_smoke.py phase 23 runs them)")


@pytest.mark.gpu
def test_capi_phase_at_small_widths(monkeypatch):
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mxnet_tpu_torch import cuda_build
    cuda_build.build(["multibox_nms", "matmul_stats", "rtc_launch"])
    for name, value in (("CAPI_BATCH", 4), ("RESNET_IMAGE", 32),
                        ("RESNET_CLASSES", 10), ("SSD_INPUT", (3, 96, 96)),
                        ("CAPI_SSD_BATCH", 2), ("CAPI_HOST_ROUNDS", 2)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    got = cs.capi_phase(0, cs.gpu_name_and_power())
    launches = got["launches"]
    assert launches["B1"] == launches["B1 tf32x3"] > 0
    assert launches["B2"] == 2
    assert launches["B3"] == 161
    assert got["b2_err"] == 0.0


@pytest.mark.gpu
def test_torch_module_runs_on_the_card():
    _need_card()
    torch.manual_seed(0)
    lin = tnn.Linear(4, 3)
    ref = tnn.Linear(4, 3)
    ref.load_state_dict(lin.state_dict())
    op = TorchModule(lin)
    x = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    s = op.get_symbol(mt.sym.Variable("data"))
    g = mt.nd.zeros((5, 4), ctx=mt.gpu(0))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ex = s.bind(mt.gpu(0), {"data": mt.nd.array(x, ctx=mt.gpu(0))},
                    args_grad={"data": g})
        y = ex.forward(is_train=True)[0]
        ex.backward(out_grads=mt.nd.ones((5, 3), ctx=mt.gpu(0)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert y.context == mt.gpu(0) and g.context == mt.gpu(0)
    assert lin.weight.device.type == "cuda"
    xt = torch.from_numpy(x).requires_grad_(True)
    want = ref(xt)
    want.backward(torch.ones(5, 3))
    np.testing.assert_allclose(y.asnumpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g.asnumpy(), xt.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
