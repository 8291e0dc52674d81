"""``Module.fit`` on the card against the port's own CPU fit.

``models.mlp`` (4 classes, 10 features, hidden (32, 16)) fits 6 batches of
8 for two epochs on ``cuda:0`` with no context given, at
``steps_per_dispatch`` 1 and 4 (the K-step path through the
``DevicePrefetcher``'s pinned copies), and the same on the CPU with
``context=mt.cpu()``, from the same numpy parameters and data. Also a
checkpoint written on the card opens on the CPU. Tolerances: parameters
``rtol=1e-4, atol=1e-5`` (float32 products summed in different orders by
cuBLAS and the CPU, with TF32 off); the accuracy counts equal.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_module_card.py -q

Without CUDA each test skips, with its reason.
"""
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt

TOL = dict(rtol=1e-4, atol=1e-5)
OPT = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: Module.fit on cuda:0 (chip_smoke.py "
                    "runs the module phase there)")


@pytest.fixture
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _setup():
    rng = np.random.default_rng(zlib.crc32(b"module_card"))
    templates = rng.standard_normal((4, 10))
    y = rng.integers(0, 4, 48)
    x = (templates[y] + 0.7 * rng.standard_normal((48, 10))).astype(
        np.float32)
    with mt.symbol.NameManager():
        sym = mt.models.mlp(num_classes=4, hidden=(32, 16))
    shapes, _, _ = sym.infer_shape(data=(8, 10), softmax_label=(8,))
    params = {n: (0.3 * rng.standard_normal(s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    return sym, x, y.astype(np.float32), params


def _fit(sym, x, y, params, k, ctx):
    metric = mt.metric.Accuracy()
    mod = (mt.mod.Module(sym) if ctx is None
           else mt.mod.Module(sym, context=ctx))
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=8), num_epoch=2,
            eval_metric=metric, optimizer_params=OPT,
            arg_params={n: mt.nd.array(v, ctx=mt.cpu())
                        for n, v in params.items()},
            steps_per_dispatch=k, dispatch_pipeline=1)
    return mod, (metric.sum_metric, metric.num_inst)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_fit_on_the_card_matches_the_cpu(k, no_tf32):
    _need_card()
    sym, x, y, params = _setup()
    card, card_acc = _fit(sym, x, y, params, k, None)
    assert card._device == torch.device("cuda", 0)
    host, host_acc = _fit(sym, x, y, params, k, mt.cpu())
    assert card_acc == host_acc
    for n, v in host.get_params()[0].items():
        got = card.get_params()[0][n]
        assert got.context == mt.gpu(0)
        np.testing.assert_allclose(got.asnumpy(), v.asnumpy(), err_msg=n,
                                   **TOL)


@pytest.mark.gpu
def test_checkpoint_from_the_card_opens_on_the_cpu(tmp_path, no_tf32):
    _need_card()
    sym, x, y, params = _setup()
    card, _ = _fit(sym, x, y, params, 4, None)
    prefix = str(tmp_path / "mlp")
    card.save_checkpoint(prefix, 2, save_optimizer_states=True)
    host = mt.mod.Module.load(prefix, 2, load_optimizer_states=True,
                              context=mt.cpu())
    it = mt.io.NDArrayIter(x, y, batch_size=8)
    host.bind(it.provide_data, it.provide_label)
    host.init_optimizer(optimizer_params=OPT)
    np.testing.assert_allclose(host.predict(it).asnumpy(),
                               card.predict(it).asnumpy(), **TOL)
    card._sync_fused_opt_states()
    for i, st in card._updater.states.items():
        np.testing.assert_array_equal(host._updater.states[i].asnumpy(),
                                      st.asnumpy())
