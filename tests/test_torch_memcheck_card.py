"""The memory analyzer's shape-only routes and its peak on the card.

- B1 (``matmul_stats``) and B2 (``nms_alive``) on fake ``cuda:0`` tensors
  take the shape-only route (outputs of the right shape, dtype and device,
  no launch counted), while real CUDA tensors of the same shapes still
  launch the kernel, held against the plain version;
- the static peak of a small ResNet's bf16 training step (ResNet-50,
  NHWC, batch 32, 64x64, ``MXTPU_FUSE_CONV_BN=1``: B1 on its shape-only
  route 33 times), priced by ``memcheck.analyze``, against
  ``torch.cuda.max_memory_allocated`` over one real step from a fresh
  state (B1 launched 33 times): within 25% (the band of
  ``chip_smoke.py`` phase 24); the dry run moves the allocator's peak by
  nothing;
- an SSD bucket (``models/ssd.py`` ``get_symbol()`` defaults, 3x300x300,
  bucket 8, float32 convolutions, whose cuDNN plans take gigabytes of
  workspace): ``ServingEngine.memory_report()``, every convolution's
  workspace priced as the engine's warm-up took it, against the
  allocator's peak over one real forward plus the weights: within 25%.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_memcheck_card.py -q

Without CUDA each test skips, with its reason. Tolerances: y within 1e-5
of sum |x||w| and the statistics within 1e-5 of their magnitude sums
(bf16: one bf16 ulp more), the NMS mask exact, the peak within 25%.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import memcheck as mc, models
from mxnet_tpu_torch.ops import matmul_stats as ms, multibox_nms as mnms
from mxnet_tpu_torch.tracecheck import train_step_programs

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the dry run is held against real "
                    "launches and the caching allocator on the card "
                    "(chip_smoke.py phase 24 runs the full-size case)")


def _unmoved(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.max_memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def _r512(n):
    """``n`` bytes as the caching allocator counts them."""
    return -(-n // 512) * 512


def _warm_fake_cuda():
    with mc.fake_mode() as mode:
        mode.from_tensor(torch.zeros(1, device="cuda:0"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_b1_fake_takes_the_shape_only_route_and_real_launches(dtype):
    _need_card()
    _warm_fake_cuda()
    g = torch.Generator(device="cuda:0")
    g.manual_seed(0)
    x = torch.randn(1000, 72, generator=g, device="cuda:0").to(dtype)
    w = torch.randn(264, 72, generator=g, device="cuda:0").to(dtype)
    ms.reset_launches()
    rep, moved = _unmoved(lambda: mc.analyze(ms.matmul_stats, (x, w)))
    assert ms.SHAPE_ONLY_CALLS == 1 and ms.LAUNCHES == 0 and moved == 0
    # y, and the (2, N) statistics (s1 and s2 are views of one storage)
    assert rep.output_bytes == (_r512(1000 * 264 * x.element_size())
                                + _r512(2 * 264 * 4))
    y, s1, s2 = ms.matmul_stats(x, w)
    torch.cuda.synchronize()
    assert ms.LAUNCHES == 1 and ms.SHAPE_ONLY_CALLS == 1
    ry, r1, r2 = ms.matmul_stats_reference(x, w)
    p = x.float().abs() @ w.float().abs().t()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    assert ((y.float() - ry.float()).abs()
            <= 1e-5 * p + ulp * ry.float().abs()).all()
    assert ((s1 - r1).abs() <= 1e-5 * p.sum(0)).all()
    assert ((s2 - r2).abs() <= 1e-5 * (p * p).sum(0) + 1e-5).all()


@pytest.mark.parametrize("k", [400, 1300])
def test_b2_fake_takes_the_shape_only_route_and_real_launches(k):
    _need_card()
    _warm_fake_cuda()
    g = torch.Generator(device="cuda:0")
    g.manual_seed(k)
    lo = torch.rand(2, k, 2, generator=g, device="cuda:0")
    boxes = torch.cat([lo, lo + 0.2], dim=2).contiguous()
    score = torch.sort(torch.rand(2, k, generator=g, device="cuda:0"),
                       dim=1, descending=True)[0].contiguous()
    cls = torch.randint(0, 3, (2, k), generator=g,
                        device="cuda:0").float()
    mnms.reset_launches()
    _, moved = _unmoved(lambda: mc.analyze(
        lambda b, s, c: mnms.nms_alive(b, s, c, 0.5), (boxes, score, cls)))
    assert mnms.SHAPE_ONLY_CALLS == 1 and mnms.LAUNCHES == 0 and moved == 0
    got = mnms.nms_alive(boxes, score, cls, 0.5)
    torch.cuda.synchronize()
    assert mnms.LAUNCHES == 1 and mnms.SHAPE_ONLY_CALLS == 1
    want = mnms.nms_alive_reference(boxes.cpu(), score.cpu(), cls.cpu(), 0.5)
    assert torch.equal(got.cpu(), want)


def test_small_resnet_static_peak_against_the_allocator():
    _need_card()
    _warm_fake_cuda()
    os.environ["MXTPU_FUSE_CONV_BN"] = "1"
    bsz, img = 32, 64
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=10, num_layers=50,
                            image_shape="3,%d,%d" % (img, img),
                            layout="NHWC")
    ts = mt.TrainStep(sym, learning_rate=0.1, momentum=0.9,
                      compute_dtype="bfloat16")
    shapes = ({"data": (bsz, img, img, 3)}, {"softmax_label": (bsz,)})

    def price():
        (name, fn, args), = train_step_programs(ts, *shapes, k=1,
                                                guard=False)[:1]
        return mc.analyze(fn, args, donate_argnums=(0,), name=name)
    ms.reset_launches()
    static, moved = _unmoved(price)
    assert moved == 0 and ms.LAUNCHES == 0 and ms.SHAPE_ONLY_CALLS == 33
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    state = ts.init(*shapes, seed=0)
    batch = {"data": torch.randn(shapes[0]["data"], device="cuda:0"),
             "softmax_label": torch.randint(0, 10, (bsz,),
                                            device="cuda:0").float()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ts.step(state, batch)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    assert ms.LAUNCHES_BY_ROUTE["wgmma"] == 33
    assert abs(static.peak_bytes / measured - 1.0) <= 0.25, (
        static.format(), measured)


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


def test_ssd_bucket_static_peak_prices_the_conv_workspace():
    _need_card()
    _warm_fake_cuda()
    eng = _ssd_engine((8,))
    rep, moved = _unmoved(lambda: eng.memory_report()[8])
    assert moved == 0 and rep.unpriced_workspaces == 0, rep.format()
    assert any(b["opcode"] == "workspace" for b in rep.top_buffers)
    x = np.random.default_rng(1).random((8, 3, 300, 300), dtype=np.float32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng.infer({"data": x})
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base + eng.weight_bytes()
    assert abs(rep.peak_bytes / measured - 1.0) <= 0.25, (rep.format(),
                                                          measured)
