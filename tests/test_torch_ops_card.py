"""The slice's 23 ops on the card, in small form: each op forward and
backward on ``cuda:0`` against the same op on the CPU from the same inputs
(``chip_smoke.py`` phase 20 runs them at their users' widths against the
CPU in float64).

Checks: every output and gradient stays on the card, and each lies within
1e-4 of the CPU's largest magnitude (float32 on both, TF32 off: the card
sums convolutions, atomics and reductions in other orders); quantize's
levels are equal, and rrelu's card slopes lie in their range with the
gradient equal to them. ``test_utils.check_consistency`` holds a bound
symbol of the new ops on the CPU against ``gpu(0)`` (its own tolerance,
1e-3).

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ops_card.py -q

Without CUDA each test skips, with its reason.
"""
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import test_utils
from mxnet_tpu_torch.ops import registry as treg

TOL = 1e-4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ops run on cuda:0 here "
                    "(chip_smoke.py phase 20 runs them at full width)")


def _n(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def _cases():
    """(id, op, inputs, attrs, gradient inputs), small."""
    r = np.random.default_rng(16)
    img = _n(r, 2, 3, 9, 8)
    # the last roi's last bin ends at 3 * (7 / 3) = 7 in float32, and at
    # 3 * (7 * (1 / 3)) = 7.0000005, which ceils to 8, where CUDA would
    # multiply by the reciprocal of a Python divisor
    rois = np.array([[0, 0, 0, 7, 8], [1, 2, 1, 6, 5], [1, 3, 3, 3, 4],
                     [0, 0, 0, 6, 6]], np.float32)
    label = np.array([[1, 2, 2], [3, 0, 0], [0, 0, 0]], np.float32)
    theta = (np.tile(np.array([0.9, 0.1, 0.0, -0.1, 0.9, 0.05], np.float32),
                     (2, 1)) + 0.02 * _n(r, 2, 6)).astype(np.float32)
    return [
        ("log_softmax", "log_softmax", [_n(r, 4, 50)], {}, [0]),
        ("leaky", "LeakyReLU", [img], dict(slope=0.1), [0]),
        ("elu", "LeakyReLU", [img], dict(act_type="elu"), [0]),
        ("prelu", "LeakyReLU", [img, _n(r, 3)], dict(act_type="prelu"),
         [0, 1]),
        ("instance_norm", "InstanceNorm", [img, _n(r, 3), _n(r, 3)], {},
         [0, 1, 2]),
        ("deconv", "Deconvolution", [_n(r, 1, 4, 5, 5), _n(r, 4, 3, 8, 8)],
         dict(kernel=(8, 8), stride=(4, 4), num_filter=3, no_bias=True),
         [0, 1]),
        ("crop", "Crop", [img, _n(r, 2, 1, 4, 5)],
         dict(num_args=2, offset=(2, 1)), [0]),
        ("pad_reflect", "Pad", [img],
         dict(mode="reflect", pad_width=(0, 0, 0, 0, 3, 3, 3, 3)), [0]),
        ("pad_edge", "Pad", [img],
         dict(mode="edge", pad_width=(0, 0, 0, 0, 3, 3, 3, 3)), [0]),
        ("pad_constant", "Pad", [img],
         dict(mode="constant", pad_width=(0, 0, 0, 0, 3, 3, 3, 3)), [0]),
        ("upsampling", "UpSampling", [img, img * 2],
         dict(scale=2, num_args=2), [0, 1]),
        ("linear_regression", "LinearRegressionOutput",
         [_n(r, 8, 5), _n(r, 8, 5)], {}, [0]),
        ("logistic_regression", "LogisticRegressionOutput",
         [_n(r, 8, 5), (r.random((8, 5)) > 0.5).astype(np.float32)], {},
         [0]),
        ("mae_regression", "MAERegressionOutput", [_n(r, 8, 5), _n(r, 8, 5)],
         {}, [0]),
        ("svm", "SVMOutput", [_n(r, 8, 5), r.integers(0, 5, 8).astype(
            np.float32)], {}, [0]),
        ("identity_kl", "IdentityAttachKLSparseReg", [img], {}, [0]),
        ("ctc", "CTCLoss", [_n(r, 12, 3, 5), label], {}, [0]),
        ("fft", "fft", [_n(r, 4, 16)], {}, [0]),
        ("ifft", "ifft", [_n(r, 4, 32)], {}, [0]),
        ("count_sketch", "count_sketch",
         [_n(r, 6, 10), r.integers(0, 7, 10).astype(np.float32),
          r.choice([-1.0, 1.0], 10).astype(np.float32)], dict(out_dim=7),
         [0]),
        ("grid_affine", "GridGenerator", [theta],
         dict(transform_type="affine", target_shape=(6, 7)), [0]),
        ("grid_warp", "GridGenerator", [_n(r, 2, 2, 5, 6)],
         dict(transform_type="warp"), [0]),
        ("bilinear", "BilinearSampler",
         [img, (r.uniform(-1.1, 1.1, (2, 2, 5, 6))).astype(np.float32)], {},
         [0]),
        ("spatial_transformer", "SpatialTransformer", [img, theta],
         dict(target_shape=(6, 6), transform_type="affine",
              sampler_type="bilinear"), [0]),
        ("roi_pooling", "ROIPooling", [img, rois],
         dict(pooled_size=(3, 3), spatial_scale=1.0), [0]),
        ("correlation", "Correlation", [img, _n(r, 2, 3, 9, 8)],
         dict(kernel_size=3, max_displacement=2, stride2=2, pad_size=2),
         [0, 1]),
    ]


CASES = _cases()


def _run(op, xs, attrs, wrt, dev, cot_seed):
    ts = [torch.tensor(x, device=dev, requires_grad=i in wrt)
          for i, x in enumerate(xs)]
    outs, _ = treg.get(op).apply(treg.OpContext(is_train=True, device=dev),
                                 attrs, ts, [])
    out = outs[0]
    cot = torch.tensor(np.random.default_rng(cot_seed).standard_normal(
        tuple(out.shape)), dtype=out.dtype, device=dev)
    grads = torch.autograd.grad(out, [ts[i] for i in wrt], cot)
    return out.detach(), [g.detach() for g in grads]


def _err(got, want):
    got, want = got.cpu().double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_card_matches_cpu(case):
    _need_card()
    name, op, xs, attrs, wrt = case
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        seed = zlib.crc32(name.encode())
        out, grads = _run(op, xs, attrs, wrt, torch.device("cuda", 0), seed)
        rout, rgrads = _run(op, xs, attrs, wrt, torch.device("cpu"), seed)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    assert all(t.device.type == "cuda" for t in [out] + grads)
    assert out.shape == rout.shape
    assert _err(out, rout) <= TOL
    for g, rg in zip(grads, rgrads):
        assert _err(g, rg) <= TOL


@pytest.mark.gpu
def test_quantize_card_equals_cpu():
    _need_card()
    r = np.random.default_rng(17)
    w = r.standard_normal((64, 128)).astype(np.float32)
    lo = np.array([w.min()], np.float32)
    hi = np.array([w.max()], np.float32)
    res = []
    for dev in ("cuda:0", "cpu"):
        t = [torch.tensor(a, device=dev) for a in (w, lo, hi)]
        q, qlo, qhi = treg.get("quantize").apply(treg.OpContext(), {}, t,
                                                 [])[0]
        deq = treg.get("dequantize").apply(treg.OpContext(), {},
                                           [q, qlo, qhi], [])[0][0]
        res.append((q, deq))
    (qc, dc), (qh, dh) = res
    assert qc.device.type == dc.device.type == "cuda"
    assert qc.dtype == torch.uint8
    assert torch.equal(qc.cpu(), qh)
    assert _err(dc, dh) <= 1e-6


@pytest.mark.gpu
def test_rrelu_draws_on_the_card_in_range():
    _need_card()
    dev = torch.device("cuda", 0)
    x = torch.randn(16, 8, 6, 6, device=dev, requires_grad=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    (out,), _ = treg.get("LeakyReLU").apply(
        treg.OpContext(is_train=True, rng=gen, device=dev),
        dict(act_type="rrelu"), [x], [])
    assert out.device.type == "cuda"
    (g,) = torch.autograd.grad(out, [x], torch.ones_like(out))
    neg = x.detach() < 0
    slope = out.detach()[neg] / x.detach()[neg]
    assert float(slope.min()) >= 0.125 - 1e-6
    assert float(slope.max()) < 0.334 + 1e-6
    assert float((g[neg] - slope).abs().max()) <= 1e-6


@pytest.mark.gpu
def test_check_consistency_cpu_against_the_card():
    _need_card()
    s = mt.sym
    x = s.Deconvolution(s.Variable("data"), kernel=(4, 4), stride=(2, 2),
                        num_filter=3, name="up")
    x = s.LeakyReLU(s.InstanceNorm(x, name="inorm"), act_type="elu")
    net = s.Correlation(x, x, max_displacement=1, pad_size=1)
    spec = dict(data=(2, 3, 6, 6), inorm_gamma=(3,), inorm_beta=(3,))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = test_utils.check_consistency(net, [
            dict(ctx=mt.cpu(), **spec), dict(ctx=mt.gpu(0), **spec)])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert out[0][0].shape == (2, 9, 14, 14)
