"""The serving tier on the card: quantized engines, concurrent replicas,
and B2's launch count under threads.

A narrow SSD (``models/ssd.get_symbol(num_classes=3, width=8)``, 3x64x64,
weights from a numpy seed) served on ``cuda:0`` with float32 convolutions
in full FP32 and cuDNN deterministic:

- the ``bf16`` and ``int8`` engines' detections equal, bit for bit, an f32
  engine loaded with the same weights dequantized on the host (the f32
  views are the same numbers, and the same deterministic algorithms run);
- two replicas (two engines, each behind its own ``Batcher`` thread) serve
  concurrently while the caller has ``cudnn.allow_tf32`` on: every answer
  equals the engine's answer for that image at bucket 1 or in some
  position of bucket 4, bit for bit (a TF32 convolution would change it),
  and ``allow_tf32`` is still on after;
- two threads dispatching at once count B2's launches exactly: one a
  dispatch, each on the ``smem`` route.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_card.py -q

Without CUDA each test skips, with its reason. Tolerance: exact.
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import ssd
from mxnet_tpu_torch.ops import multibox_nms as mnms
from mxnet_tpu_torch.serving import Batcher, ServingEngine
from mxnet_tpu_torch.serving import quantize as tq

SHAPE = (3, 64, 64)
BUCKETS = (1, 4)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the serving tier's engines run "
                    "on the card (chip_smoke.py phase 13 drives it)")


@pytest.fixture
def fp32_deterministic():
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield
    (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = prev


def _checkpoint(seed=0):
    with mt.symbol.NameManager():
        net = ssd.get_symbol(num_classes=3, width=8)
    shapes, _, _ = net.infer_shape(data=(1,) + SHAPE)
    rng = np.random.default_rng(seed)
    params = {}
    for name, s in zip(net.list_arguments(), shapes):
        if name == "data":
            continue
        scale = np.sqrt(2.0 / np.prod(s[1:])) if len(s) > 1 else 0.1
        params[name] = (rng.standard_normal(s) * scale).astype(np.float32)
    return net, params


def _images(n, seed=5):
    return np.random.default_rng(seed).random((n,) + SHAPE,
                                              dtype=np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_quantized_engine_equals_host_dequantized_f32(mode,
                                                      fp32_deterministic):
    _need_card()
    net, params = _checkpoint()
    eng = ServingEngine(net, params, {"data": SHAPE}, buckets=BUCKETS,
                        quantize=mode)
    host = {k: tq.dequant_leaf(tq.quantize_array(v, mode)).numpy()
            for k, v in params.items()}
    ref = ServingEngine(net, host, {"data": SHAPE}, buckets=BUCKETS)
    assert eng.device.type == "cuda"
    for n in (1, 3, 4, 6):
        x = {"data": _images(n, seed=n)}
        np.testing.assert_array_equal(eng.infer(x)[0], ref.infer(x)[0])
    ratio = eng.weight_bytes() / ref.weight_bytes()
    assert ratio <= (0.51 if mode == "bf16" else 0.30), ratio


@pytest.mark.gpu
def test_two_replicas_concurrently_keep_fp32_and_the_callers_tf32(
        fp32_deterministic):
    _need_card()
    net, params = _checkpoint(seed=1)
    engines = [ServingEngine(net, params, {"data": SHAPE}, buckets=BUCKETS)
               for _ in range(2)]
    images = _images(16)
    torch.backends.cudnn.allow_tf32 = True          # the caller's choice
    # each image's answer at bucket 1, and at bucket 4 in every position
    refs = []
    for i in range(len(images)):
        r = [engines[0].infer({"data": images[i:i + 1]})[0]]
        for pos in range(4):
            batch = images[(i + 1) % 16:(i + 1) % 16 + 4].copy()
            if len(batch) < 4:
                batch = images[:4].copy()
            batch[pos] = images[i]
            r.append(engines[0].infer({"data": batch})[0][pos:pos + 1])
        refs.append(r)
    batchers = [Batcher(e, max_latency_ms=2.0) for e in engines]
    outs, errs = {}, []

    def client(c):
        try:
            for i in range(c, len(images), 4):
                outs[i] = batchers[c % 2].infer(
                    {"data": images[i:i + 1]}, deadline_ms=60000)[0]
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
            assert not t.is_alive()
    finally:
        for b in batchers:
            b.close()
    assert not errs, errs
    assert torch.backends.cudnn.allow_tf32 is True
    for i, got in outs.items():
        assert any(np.array_equal(got, r) for r in refs[i]), i
    assert len(outs) == len(images)


@pytest.mark.gpu
def test_b2_launches_counted_exactly_under_two_threads(fp32_deterministic):
    _need_card()
    net, params = _checkpoint(seed=2)
    engines = [ServingEngine(net, params, {"data": SHAPE}, buckets=BUCKETS)
               for _ in range(2)]
    images = _images(4)
    before = [e.health.batches for e in engines]
    mnms.reset_launches()
    errs = []

    def worker(eng):
        try:
            for n in (1, 4, 3, 1, 2) * 4:
                eng.infer({"data": images[:n]})
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(e,)) for e in engines]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
        assert not t.is_alive()
    assert not errs, errs
    dispatches = sum(e.health.batches - b for e, b in zip(engines, before))
    assert dispatches == 2 * 20
    assert mnms.LAUNCHES == dispatches
    assert mnms.LAUNCHES_BY_ROUTE == {"smem": dispatches, "l2": 0}
