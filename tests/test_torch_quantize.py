"""The port's weight-only quantization against the JAX package's.

The same float32 parameters (numpy seeds) of the MLP and LeNet of the
serving tests and of a narrow SSD (``ssd.get_symbol(num_classes=3,
width=8)``) go through ``mxnet_tpu.serving.quantize`` and
``mxnet_tpu_torch.serving.quantize``. Tolerance: none. The stored arrays
(bf16 payloads, int8 payloads and their f32 scales), the dequantized f32
views, ``tree_bytes`` and ``quality_report`` are equal bit for bit;
``check_quality`` raises below the same floor in both packages.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu.models import ssd as jssd
from mxnet_tpu.serving import quantize as jq
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.serving import quantize as tq


def _params(net, dshape, seed):
    shapes, _, _ = net.infer_shape(data=dshape)
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in zip(net.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        v = rng.standard_normal(shape) * rng.uniform(0.01, 3.0)
        out[name] = v.astype(np.float32)
    # an all-zero output channel takes the scale 1 in both packages
    w = next(k for k, v in out.items() if v.ndim >= 2)
    out[w][0] = 0.0
    return out


def _mlp():
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=8,
                                name="fc1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


MODELS = {
    "mlp": lambda: _params(_mlp(), (1, 6), 0),
    "lenet": lambda: _params(jmodels.lenet(num_classes=10), (1, 1, 28, 28),
                             1),
    "ssd": lambda: _params(jssd.get_symbol(num_classes=3, width=8),
                           (1, 3, 64, 64), 2),
}


def _bits(a):
    """An array's bytes as unsigned integers (bf16 and f32 alike)."""
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32, 1: np.uint8}[a.itemsize])


def _torch_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_stored_arrays_equal_bit_for_bit(model, mode):
    params = MODELS[model]()
    jtree = jq.quantize_tree(params, mode)
    ttree = tq.quantize_tree(params, mode)
    assert sorted(jtree) == sorted(ttree)
    for k, j in jtree.items():
        t = ttree[k]
        assert jq.is_quantized_leaf(j) == tq.is_quantized_leaf(t), k
        if jq.is_quantized_leaf(j):
            assert t["q"].dtype == torch.int8 and t["s"].dtype == torch.float32
            np.testing.assert_array_equal(t["q"].numpy(), j["q"])
            np.testing.assert_array_equal(_torch_bits(t["s"]), _bits(j["s"]))
        else:
            np.testing.assert_array_equal(_torch_bits(t), _bits(j))
        # the f32 views: the same IEEE operations in both packages
        jd = np.asarray(jq.dequant_leaf(j))
        td = tq.dequant_leaf(t)
        assert td.dtype == torch.float32
        np.testing.assert_array_equal(_bits(td.numpy()), _bits(jd))


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_tree_bytes_equal(model, mode):
    params = MODELS[model]()
    assert (tq.tree_bytes(tq.quantize_tree(params, mode))
            == jq.tree_bytes(jq.quantize_tree(params, mode)))


def test_int8_rules_and_ratio():
    """1-D parameters stay f32 under int8, and int8 holds about a quarter
    of the f32 bytes of a convolutional net (scales and biases in f32)."""
    params = MODELS["ssd"]()
    tree = tq.quantize_tree(params, "int8")
    for k, v in params.items():
        assert tq.is_quantized_leaf(tree[k]) == (v.ndim >= 2), k
    ratio = (tq.tree_bytes(tree)
             / tq.tree_bytes(tq.quantize_tree(params, "none")))
    assert 0.25 < ratio < 0.30
    # integers pass through every mode untouched
    ints = np.arange(12, dtype=np.int32).reshape(3, 4)
    for mode in ("bf16", "int8"):
        assert tq.quantize_array(ints, mode).dtype == torch.int32


def test_quality_report_equal_and_gate_raises(monkeypatch):
    rng = np.random.default_rng(3)
    ref = rng.standard_normal((64, 10)).astype(np.float32)
    got = ref + 0.3 * rng.standard_normal((64, 10)).astype(np.float32)
    jr, tr = jq.quality_report(ref, got), tq.quality_report(ref, got)
    assert tr == jr
    assert 0.5 < tr["top1_agreement"] < 1.0
    for mod, err in ((jq, mx.base.MXNetError), (tq, MXNetError)):
        with pytest.raises(err, match="quality gate FAILED"):
            mod.check_quality(tr)           # default floor 0.98
        assert mod.check_quality(tr, min_agree=0.5) == tr["top1_agreement"]
        monkeypatch.setenv("MXTPU_SERVE_QUANT_MIN_AGREE", "0.4")
        assert mod.check_quality(tr) == tr["top1_agreement"]
        monkeypatch.delenv("MXTPU_SERVE_QUANT_MIN_AGREE")
    with pytest.raises(MXNetError, match="shape mismatch"):
        tq.quality_report(ref, got[:3])


def test_modes_resolve_like_the_reference():
    for m in ("none", "BF16", "int8", None):
        assert tq.resolve_mode(m) == jq.resolve_mode(m)
    with pytest.raises(MXNetError, match="quantize mode"):
        tq.resolve_mode("int4")
    assert tq.QUANT_MODES == jq.QUANT_MODES
