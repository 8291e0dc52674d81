"""The roofline analyzer on the card: ``chip_smoke.py`` phase 26 (a) and
(b) at smaller sizes.

- a ResNet-50 bf16 training step (NHWC, batch 32, 224x224,
  ``MXTPU_FUSE_CONV_BN=1``: B1 on its wgmma route 33 times a step) priced
  by ``flopcheck.analyze`` on fake ``cuda:0`` tensors: its B1 entries are
  one a launch, 33 in all, each priced by ``ops/matmul_stats`` at the
  bf16 arithmetic (``launch_cost``, ``bound_seconds``), and the predicted
  step is at most one real step's time on CUDA events (its activations,
  some 50 MB a tensor in the first stage, do not stay in the 50 MB L2);
- an SSD serving bucket (``models/ssd.py`` ``get_symbol()`` defaults,
  3x300x300, bucket 8) priced from ``tracecheck``'s registry: B2 one entry
  priced by ``ops/multibox_nms.bound_seconds``; the prediction and the
  bucket program's measured forward are logged.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flopcheck_card.py -q

Without CUDA each test skips, with its reason. Tolerances: a B1 or B2
entry's price equals its formula's within 1e-12 relative; the predicted
step is at most the measured one.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import flopcheck as fc, models, tracecheck as tc
from mxnet_tpu_torch.ops import matmul_stats as ms, multibox_nms as mnms

pytestmark = pytest.mark.gpu

REL = 1e-12


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the roofline is priced for the "
                    "card's row of devspec and held against real steps "
                    "(chip_smoke.py phase 26 runs the full-size case)")


def _event_ms(fn, reps=5, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def test_resnet50_bf16_step_roofline(monkeypatch):
    _need_card()
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    bsz, img = 32, 224
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=1000, num_layers=50,
                            image_shape="3,%d,%d" % (img, img),
                            layout="NHWC")
    ts = mt.TrainStep(sym, optimizer="sgd", learning_rate=0.1,
                      momentum=0.9, wd=1e-4, compute_dtype="bfloat16")
    shapes = ({"data": (bsz, img, img, 3)}, {"softmax_label": (bsz,)})
    (name, fn, args), = tc.train_step_programs(ts, *shapes, k=1,
                                               guard=False, name="r50")[:1]
    ms.reset_launches()
    rep = fc.analyze(fn, args, name=name)
    assert ms.LAUNCHES == 0 and ms.SHAPE_ONLY_CALLS == 33
    assert rep.peak_source == "spec" and rep.device == "cuda:0"
    kind = torch.cuda.get_device_name(0)
    b1 = [k for k in rep.kernels if k.opcode == "matmul_stats"]
    assert len(b1) == 33 and sum(k.multiplier for k in b1) == 33
    for k in b1:
        ((m, kk), _), ((n, _), _) = k.inputs
        flops, nbytes, compute, passes = ms.launch_cost(m, kk, n, "bf16")
        assert (k.flops, k.bytes, k.compute, k.passes) == (
            flops, nbytes, "bfloat16", passes)
        want = ms.bound_seconds(m, kk, n, "bf16", kind)[0]
        assert abs(k.seconds - want) <= REL * want
    state = ts.init(*shapes, seed=0)
    gen = torch.Generator(device="cuda:0")
    gen.manual_seed(0)
    batch = {"data": torch.randn((bsz, img, img, 3), generator=gen,
                                 device="cuda:0"),
             "softmax_label": torch.randint(0, 1000, (bsz,), generator=gen,
                                            device="cuda:0").float()}
    ms.reset_launches()
    measured = _event_ms(lambda: ts.step(state, batch))
    assert ms.LAUNCHES_BY_ROUTE["wgmma"] == 7 * 33
    print("r50 b=%d: predicted %.4f ms, measured %.4f ms, MFU %.4f"
          % (bsz, rep.predicted_step_ms, measured, rep.predicted_mfu))
    assert 0 < rep.predicted_step_ms <= measured


def _ssd_engine(buckets):
    """The full-width SSD (``get_symbol()`` defaults) with random weights,
    served from a checkpoint dict on cuda:0."""
    from mxnet_tpu_torch.models import ssd
    from mxnet_tpu_torch.serving import ServingEngine
    with mt.symbol.NameManager():
        net = ssd.get_symbol()
    shapes, _, _ = net.infer_shape(data=(1, 3, 300, 300))
    rng = np.random.default_rng(0)
    params = {}
    for name, shape in zip(net.list_arguments(), shapes):
        if name == "data":
            continue
        scale = (np.sqrt(2.0 / np.prod(shape[1:]))
                 if name.endswith("_weight") else 0.1)
        params["arg:" + name] = mt.nd.array(
            (rng.standard_normal(shape) * scale).astype(np.float32),
            ctx=mt.cpu())
    return ServingEngine(net.tojson(), params, {"data": (3, 300, 300)},
                         buckets=buckets)


def test_ssd_bucket_prices_b2_by_its_formula():
    _need_card()
    eng = _ssd_engine((8,))
    (rec,) = [r for r in tc.registered_programs()
              if r.name == "%s/bucket[b=8]" % eng.name]
    mnms.reset_launches()
    rep = fc.analyze(rec.fn_ref(), rec.arg_structs, name=rec.name)
    assert mnms.LAUNCHES == 0
    (b2,) = [k for k in rep.kernels if k.opcode == "multibox_nms"]
    (b, k), _ = b2.inputs[1]
    assert b == 8 and b2.multiplier == 1
    ops, nbytes = mnms.launch_cost(b, k)
    assert (b2.flops, b2.bytes, b2.compute) == (ops, nbytes, "float32")
    want = mnms.bound_seconds(b, k, torch.cuda.get_device_name(0))[0]
    assert abs(b2.seconds - want) <= REL * want
    params, aux = eng._state
    x = torch.rand((8, 3, 300, 300), device="cuda:0")
    measured = _event_ms(lambda: eng._device_forward(params, aux,
                                                     {"data": x}))
    assert mnms.LAUNCHES == 7
    print("ssd bucket 8: predicted %.4f ms, measured %.4f ms, B2 k=%d "
          "priced %.6f ms" % (rep.predicted_step_ms, measured, k,
                              1e3 * b2.seconds))
    assert rep.predicted_step_ms > 0
