"""The port's standalone ``Predictor`` against the JAX package's.

LeNet (``models.lenet``, 10 classes), written by the JAX package's
``save_checkpoint`` with weights from a numpy seed,
go through ``mxnet_tpu.Predictor`` and ``mxnet_tpu_torch.Predictor``
(``ctx=cpu()``) on the same images. Tolerance: outputs within ``ATOL``
(f32 convolutions and matmuls summed in another order). Also held:
``reshape`` over batch sizes reuses a cached executor per shape, the
cache keeps 16, ``output_names``, the errors, the
port's serving engine bitwise equal to its Predictor row by row, and the
default context ``gpu(0)``, which without CUDA raises instead of falling
back to the CPU.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.serving import ServingEngine

ATOL = 1e-5
SHAPE = (1, 28, 28)


@pytest.fixture(scope="module")
def lenet(tmp_path_factory):
    with mx.symbol.NameManager():
        net = mx.models.lenet(num_classes=10)
    arg_shapes, _, _ = net.infer_shape(data=(1,) + SHAPE)
    rng = np.random.default_rng(11)
    arg = {}
    for name, s in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        scale = np.sqrt(2.0 / np.prod(s[1:])) if len(s) > 1 else 0.1
        arg[name] = (rng.standard_normal(s) * scale).astype(np.float32)
    prefix = str(tmp_path_factory.mktemp("lenet") / "lenet")
    mx.model.save_checkpoint(prefix, 0, net,
                             {k: mx.nd.array(v) for k, v in arg.items()}, {})
    images = rng.random((8,) + SHAPE, dtype=np.float32)
    return (prefix + "-symbol.json", prefix + "-0000.params"), arg, images


def _pair(files, n, **kw):
    return (mx.Predictor(*files, {"data": (n,) + SHAPE}, **kw),
            mt.Predictor(*files, {"data": (n,) + SHAPE}, ctx=mt.cpu(), **kw))


@pytest.mark.parametrize("n", [1, 3, 8])
def test_forward_matches_jax(lenet, n):
    files, _, images = lenet
    jp, tp = _pair(files, n)
    want = jp.forward(data=images[:n]).get_output(0).asnumpy()
    got = tp.forward(data=images[:n]).get_output(0).asnumpy()
    assert got.shape == want.shape == (n, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert len(tp.outputs) == 1


def test_reshape_caches_one_executor_per_shape(lenet):
    files, _, images = lenet
    jp, tp = _pair(files, 1)
    for n in (1, 8, 3, 8, 1):
        jp.reshape({"data": (n,) + SHAPE})
        tp.reshape({"data": (n,) + SHAPE})
        got = tp.forward(data=images[:n]).get_output(0).asnumpy()
        want = jp.forward(data=images[:n]).get_output(0).asnumpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert len(tp._exec_cache) == len(jp._exec_cache) == 3
    # the same executor comes back for a shape seen before
    exe = tp._executor
    tp.reshape({"data": (3,) + SHAPE}).reshape({"data": (1,) + SHAPE})
    assert tp._executor is exe


def test_executor_cache_keeps_sixteen(lenet):
    files, _, _ = lenet
    tp = mt.Predictor(*files, {"data": (1,) + SHAPE}, ctx=mt.cpu())
    for n in range(1, 21):
        tp.reshape({"data": (n,) + SHAPE})
    assert len(tp._exec_cache) == mt.Predictor._EXEC_CACHE_CAP == 16
    keys = [dict(k)["data"][0] for k in tp._exec_cache]
    assert keys == list(range(5, 21))


def test_serving_engine_equals_predictor_rows(lenet):
    """Batched serving equals the Predictor on the same rows, bit for bit,
    in the port as in the JAX package (the bucket is the batch)."""
    files, _, images = lenet
    eng = ServingEngine(*files, {"data": SHAPE}, buckets=(4,), device="cpu")
    tp = mt.Predictor(*files, {"data": (4,) + SHAPE}, ctx=mt.cpu())
    want = tp.forward(data=images[:4]).get_output(0).asnumpy()
    np.testing.assert_array_equal(eng.infer({"data": images[:4]})[0], want)
    np.testing.assert_array_equal(eng.infer({"data": images[:3]})[0],
                                  want[:3])


def test_output_names_and_param_dict(lenet):
    files, arg, images = lenet
    params = {"arg:" + k: mt.nd.array(v, ctx=mt.cpu()) for k, v in arg.items()}
    jp = mx.Predictor(files[0], {"arg:" + k: mx.nd.array(v)
                                 for k, v in arg.items()},
                      {"data": (2,) + SHAPE}, output_names=["fc1"])
    tp = mt.Predictor(files[0], params, {"data": (2,) + SHAPE},
                      ctx=mt.cpu(), output_names=["fc1"])
    got = tp.forward(data=images[:2]).get_output(0).asnumpy()
    want = jp.forward(data=images[:2]).get_output(0).asnumpy()
    assert got.shape == (2, 500)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_errors(lenet):
    files, arg, images = lenet
    partial = {k: v for k, v in arg.items() if k != "fc2_bias"}
    with pytest.raises(MXNetError, match="fc2_bias"):
        mt.Predictor(files[0], partial, {"data": (1,) + SHAPE}, ctx=mt.cpu())
    tp = mt.Predictor(*files, {"data": (1,) + SHAPE}, ctx=mt.cpu())
    with pytest.raises(MXNetError, match="unknown inputs"):
        tp.reshape({"label": (1,)})
    with pytest.raises(MXNetError, match="reshape changes parameter"):
        tp.reshape({"data": (1, 1, 32, 32)})
    with pytest.raises(MXNetError, match="unknown input"):
        tp.forward(label=np.zeros(1, np.float32))
    with pytest.raises(MXNetError, match="shape"):
        tp.forward(data=images[:2])


def test_default_context_is_the_card(lenet, monkeypatch):
    files, _, images = lenet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mt.Predictor(*files, {"data": (1,) + SHAPE})
    # an explicit CPU context serves
    tp = mt.Predictor(*files, {"data": (1,) + SHAPE}, ctx=mt.cpu())
    assert tp.forward(data=images[:1]).get_output(0).shape == (1, 10)
