"""tracecheck's program registry, the retrace watch and the check methods
on the card, at small sizes (``chip_smoke.py`` phase 25 runs them at full
size).

- a ResNet-50 bf16 TrainStep (NHWC, batch 8, 64x64,
  ``MXTPU_FUSE_CONV_BN=1``: B1 on its wgmma route 33 times a step)
  dispatches ``step`` and ``run_steps`` (K=2), guarded and unguarded: its
  four registered programs audit on fake ``cuda:0`` tensors with no
  unsuppressed finding and no launch; a float32 -> float16 flip of
  ``data`` is one retrace event naming ``data``; under
  ``set_tracecheck("error")`` the same flip on the guarded step raises
  ``RetraceError``, whose result's step counter advanced;
- a small SSD engine (width 8, 3x96x96, buckets 1 and 4) on the card:
  ``check(memory=True)`` gives no ``hbm-budget`` finding, and each
  bucket's static peak is within 25% of the allocator's peak over one
  real forward plus the weights (``chip_smoke.py``'s band).

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracecheck_card.py -q

Without CUDA each test skips, with its reason.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import engine, memcheck as mc, models
from mxnet_tpu_torch import tracecheck as tc
from mxnet_tpu_torch.ops import matmul_stats as ms, multibox_nms as mnms

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the programs run on cuda:0 and are "
                    "audited on fake cuda:0 tensors (chip_smoke.py phase 25 "
                    "runs the full-size case)")
    with mc.fake_mode() as mode:
        mode.from_tensor(torch.zeros(1, device="cuda:0"))


def test_resnet_step_registers_audits_and_watches():
    _need_card()
    os.environ["MXTPU_FUSE_CONV_BN"] = "1"
    bsz, img = 8, 64
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=10, num_layers=50,
                            image_shape="3,%d,%d" % (img, img),
                            layout="NHWC")
    ts = mt.TrainStep(sym, learning_rate=0.1, momentum=0.9,
                      compute_dtype="bfloat16")
    state = ts.init({"data": (bsz, img, img, 3)}, {"softmax_label": (bsz,)},
                    seed=0)
    batch = {"data": torch.randn((bsz, img, img, 3), device="cuda:0"),
             "softmax_label": torch.randint(0, 10, (bsz,),
                                            device="cuda:0").float()}
    sb = {k: torch.stack([v, v]) for k, v in batch.items()}
    n0 = tc.retrace_count()
    ms.reset_launches()
    ts.step(state, batch)
    ts.step(state, batch, guard=True)
    ts.run_steps(state, sb)[1].fetch()
    ts.run_steps(state, sb, guard=True)[1].fetch()
    assert ms.LAUNCHES_BY_ROUTE["wgmma"] == ms.LAUNCHES == 6 * 33
    name = ts._watcher.name
    names = sorted(r.name[len(name) + 1:] for r in tc.registered_programs()
                   if r.name.startswith(name + "/"))
    assert names == ["guard-scan[bs=8,k=2]", "guard-step[bs=8]",
                     "scan[bs=8,k=2]", "step[bs=8]"]
    findings = tc.check_registered(match=name + "/")
    assert tc.unsuppressed(findings) == [], [f.format() for f in findings]
    assert ms.LAUNCHES == 6 * 33            # the audit launched nothing
    half = dict(batch, data=batch["data"].half())
    ts.step(state, half)
    (ev,) = tc.RETRACE_EVENTS[n0:]
    assert ev.site == name + "/step[bs=8]"
    assert ev.diff == ("argument [0][1]['data']: dtype float32 -> float16",)
    engine.set_tracecheck("error")
    try:
        step0 = int(state["step"])
        with pytest.raises(tc.RetraceError, match="float32 -> float16") as e:
            ts.step(state, half, guard=True)
        assert int(e.value.result[0]["step"]) == step0 + 1
    finally:
        engine.set_tracecheck(None)


def test_small_ssd_engine_check_and_its_buckets_peaks():
    _need_card()
    from mxnet_tpu_torch.models import ssd
    from mxnet_tpu_torch.serving import ServingEngine
    with mt.symbol.NameManager():
        net = ssd.get_symbol(width=8)
    shapes, _, _ = net.infer_shape(data=(1, 3, 96, 96))
    rng = np.random.default_rng(0)
    params = {"arg:" + n: mt.nd.array(
        (rng.standard_normal(s) * 0.1).astype(np.float32), ctx=mt.cpu())
        for n, s in zip(net.list_arguments(), shapes) if n != "data"}
    mnms.reset_launches()
    eng = ServingEngine(net.tojson(), params, {"data": (3, 96, 96)},
                        buckets=(1, 4))
    assert mnms.LAUNCHES == 2                # one a bucket at load
    findings = eng.check(memory=True)
    assert "hbm-budget" not in {f.lint for f in findings}
    assert mnms.LAUNCHES == 2                # the audit launched nothing
    reports = eng.memory_report()
    for b, rep in reports.items():
        assert rep.unpriced_workspaces == 0, rep.format()
        x = rng.random((b, 3, 96, 96), dtype=np.float32)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng.infer({"data": x})
        torch.cuda.synchronize()
        measured = (torch.cuda.max_memory_allocated() - base
                    + eng.weight_bytes())
        assert abs(rep.peak_bytes / measured - 1.0) <= 0.25, (
            rep.format(), measured)
