"""ResNet-50 served by the JAX package's ``ServingEngine`` and by the
port's, from one checkpoint, on the CPU.

``models.resnet(num_layers=50, image_shape="3,32,32")`` (NCHW, 10 classes)
with weights from a numpy seed (He-normal convolutions, BatchNorm
statistics and affine terms near identity, the last BatchNorm of each
residual branch scaled to 0.2 and the classifier to 0.05 of He-normal, so
that the activations stay of order one through the 16 blocks and the
softmax is not one-hot), written by the JAX package's
``save_checkpoint``; both engines serve 5 images with buckets (1, 8), one
image at a time and as one padded batch. Tolerance: the softmax outputs
within ``atol=1e-5`` (float32 convolutions summed in different orders
through 50 layers), and the same argmax for every image.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu.serving import ServingEngine as JaxEngine
from mxnet_tpu_torch.serving import ServingEngine

SHAPE = (3, 32, 32)
BUCKETS = (1, 8)
ATOL = 1e-5


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    with mx.symbol.NameManager():
        net = jmodels.resnet(num_layers=50, num_classes=10,
                             image_shape="3,32,32")
    arg_shapes, _, aux_shapes = net.infer_shape(data=(1,) + SHAPE)
    rng = np.random.default_rng(50)
    arg = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
            if name.startswith("fc"):
                v *= 0.05
        elif name.endswith("_gamma"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
            if name.endswith("_3_bn_gamma"):
                v *= 0.2
        else:
            v = 0.1 * rng.standard_normal(shape)
        arg[name] = mx.nd.array(v.astype(np.float32))
    aux = {}
    for name, shape in zip(net.list_auxiliary_states(), aux_shapes):
        v = (rng.uniform(0.5, 1.5, shape) if name.endswith("_var")
             else 0.1 * rng.standard_normal(shape))
        aux[name] = mx.nd.array(v.astype(np.float32))
    prefix = str(tmp_path_factory.mktemp("resnet50") / "resnet50")
    mx.model.save_checkpoint(prefix, 0, net, arg, aux)
    files = (prefix + "-symbol.json", prefix + "-0000.params")
    images = rng.random((5,) + SHAPE, dtype=np.float32)
    out = {}
    for side, eng in (
            ("jax", JaxEngine(*files, {"data": SHAPE}, buckets=BUCKETS)),
            ("torch", ServingEngine(*files, {"data": SHAPE},
                                    buckets=BUCKETS, device="cpu"))):
        out[side, "batch"] = eng.infer({"data": images})[0]
        out[side, "single"] = np.concatenate(
            [eng.infer({"data": images[i:i + 1]})[0] for i in range(5)])
    return out


@pytest.mark.parametrize("how", ["batch", "single"])
def test_resnet50_served_outputs_agree(served, how):
    jp, tp = served["jax", how], served["torch", how]
    assert tp.shape == jp.shape == (5, 10)
    assert np.isfinite(tp).all()
    assert 0.01 < jp.min() and jp.max() < 0.99    # not one-hot
    np.testing.assert_allclose(tp, jp, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tp.argmax(axis=1), jp.argmax(axis=1))


def test_resnet50_buckets_agree_with_each_other(served):
    np.testing.assert_allclose(served["torch", "batch"],
                               served["torch", "single"], rtol=0, atol=ATOL)
