#!/usr/bin/env python3
"""Drive the PyTorch port (mxnet_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--reps N]

Phases, each of which must pass (nothing is caught; any failure exits
non-zero):

1. device: requires CUDA; prints the card's name and power limit
   (nvidia-smi) and the float32 convolution precision the port uses.
2. build: compiles every CUDA kernel of the port from the sources in the
   checkout (one nvcc per source, all started together) and prints each
   ptxas report.
3. nms kernel: holds the MultiBox NMS kernel against its plain PyTorch
   version on the same CUDA tensors (the masks must be exactly equal) and
   times both with CUDA events at the shapes the served path gives it.
4. matmul_stats kernel: holds the matmul-with-BatchNorm-statistics kernel
   against its plain version (TF32 off) at the 12 shapes of ResNet-50's 33
   fused Conv1x1->BatchNorm pairs (batch 128, 224x224, NHWC, bf16) and at
   edge shapes in float32 and bfloat16; checks that the statistics are
   bitwise reproducible; times kernel, plain version and torch.matmul (the
   product alone, cuBLAS) per shape beside the bound, and sums one step's
   33 launches.
5. serve: builds the SSD detector at its full width (models/ssd.py
   get_symbol() defaults, 3x300x300 input) with weights from --seed,
   writes symbol JSON and .params through the port, loads them in
   ServingEngine on cuda:0 with buckets (1, 8, 32) and serves requests of
   1, 5, 8, 32 and 40 images. Checks shapes, finiteness, that the NMS
   kernel ran, and that the detections equal MultiBoxDetection with the
   plain NMS on the same heads. Then times p50 latency per bucket.
6. train: ResNet-50 (NHWC, 224x224, batch 128, 1000 classes) through
   TrainStep on cuda:0, f32 master weights with bf16 compute,
   SGD(lr 0.1, momentum 0.9, wd 1e-4), weights from --seed, random data and
   labels made on the card. One step with MXTPU_FUSE_CONV_BN=1 must launch
   matmul_stats 33 times with no layout copy, and agree with the same step
   unfused (loss sum within 1%, every BatchNorm moving statistic within
   rtol 2e-2, atol 1e-3). Then run_steps with K=4 (all losses finite),
   step times and images/s fused, unfused and run_steps, and a
   torch.profiler table of one fused step.

The line before the last is {"kernels": [...]} (per kernel: launches on
its main path, max error against the plain version, times and bound);
the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s,
#: float32 operations/s outside the tensor cores, dense bf16 tensor-core
#: operations/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

#: the training configuration bench.py main() runs (ResNet-50, NHWC)
RESNET_BATCH = 128
RESNET_IMAGE = 224
RESNET_CLASSES = 1000
#: (M, K, N) of the fused Conv1x1->BatchNorm pairs of one such step and how
#: many pairs have each; the train phase checks it against the symbol
B1_STEP_SHAPES = {
    (401408, 64, 64): 1, (401408, 64, 256): 4, (401408, 256, 64): 2,
    (401408, 256, 128): 1, (100352, 128, 512): 4, (100352, 512, 128): 3,
    (100352, 512, 256): 1, (25088, 256, 1024): 6, (25088, 1024, 256): 5,
    (25088, 1024, 512): 1, (6272, 512, 2048): 3, (6272, 2048, 512): 2}
B1_EDGE_SHAPES = [(m, k, n) for m in (1, 17, 1000) for k in (1, 3, 64)
                  for n in (1, 64, 65)]

SSD_INPUT = (3, 300, 300)
BUCKETS = (1, 8, 32)
REQUESTS = (1, 5, 8, 32, 40)


def log(*a):
    print(*a, flush=True)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(fn, reps, warmup=3):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events around the whole run."""
    import torch
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


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def nms_inputs(rng, b, k, dup=0, zeros=0, ncls=3):
    """Score-sorted boxes for the NMS kernel: corners in [0, 1], ``dup``
    rows copied from earlier rows, the last ``zeros`` scores 0."""
    c = rng.random((b, k, 2), dtype=np.float32)
    wh = rng.random((b, k, 2), dtype=np.float32) * np.float32(0.3)
    boxes = np.clip(np.concatenate([c - wh / 2, c + wh / 2], axis=2), 0, 1)
    score = -np.sort(-rng.random((b, k), dtype=np.float32), axis=1)
    cls = rng.integers(0, ncls, (b, k)).astype(np.float32)
    if dup and k > 1:
        src = rng.integers(0, k - 1, dup)
        dst = np.minimum(src + 1 + rng.integers(0, 5, dup), k - 1)
        boxes[:, dst] = boxes[:, src]
        cls[:, dst] = cls[:, src]
    if zeros:
        score[:, k - zeros:] = 0.0
    return boxes.astype(np.float32), score, cls


def nms_bound_ms(b, k):
    """Least time for the mask: each input read once, the output written
    once, and ~15 FP32 operations for each of the k(k-1)/2 pairs."""
    nbytes = b * k * (16 + 4 + 4) + b * k * 4
    ops = 15 * b * k * (k - 1) / 2
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def kernel_phase(rng, reps, card):
    import torch
    from mxnet_tpu_torch.ops import multibox_nms as mnms
    dev = torch.device("cuda", 0)
    cases = [(32, 400, False, 0, 0), (32, 400, True, 0, 0)]
    cases += [(4, k, False, 0, 0) for k in (1, 63, 64, 65, 400, 2000)]
    cases += [(4, 400, False, 40, 100), (4, 400, True, 40, 100),
              (2, 2000, False, 200, 500)]
    max_err = 0.0
    for b, k, force, dup, zeros in cases:
        boxes, score, cls = (torch.from_numpy(a).to(dev) for a in
                             nms_inputs(rng, b, k, dup, zeros))
        got = mnms.nms_alive(boxes, score, cls, 0.5, force)
        want = mnms.nms_alive_reference(boxes, score, cls, 0.5, force)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        log("nms case B=%d k=%d force=%s dup=%d zero_scores=%d: kept %d/%d, "
            "max |kernel - plain| = %g" % (b, k, force, dup, zeros,
                                           int(want.sum()), b * k, err))
        if not torch.equal(got, want):
            raise SystemExit("NMS kernel disagrees with its plain version "
                             "at B=%d k=%d force=%s" % (b, k, force))
        max_err = max(max_err, err)

    b, k = 32, 400
    boxes, score, cls = (torch.from_numpy(a).to(dev)
                         for a in nms_inputs(rng, b, k))
    ms = cuda_time_ms(lambda: mnms.nms_alive(boxes, score, cls, 0.5), reps)
    plain_ms = cuda_time_ms(
        lambda: mnms.nms_alive_reference(boxes, score, cls, 0.5),
        max(3, reps // 20), warmup=1)
    bound_ms, bound_by = nms_bound_ms(b, k)
    log("nms timing B=%d k=%d: kernel %.6f ms, plain %.6f ms, bound %.6f ms "
        "(%s) [%s]" % (b, k, ms, plain_ms, bound_ms, bound_by, card))
    return {"name": "multibox_nms", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/multibox_nms.cu",
            "replaces": "mxnet_tpu/ops/pallas_multibox.py:29",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# ---------------------------------------------------------------------------
# matmul_stats kernel phase
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def no_tf32():
    """Float32 products and convolutions in full FP32 (cuBLAS's and
    cuDNN's TF32 off), restored after."""
    import torch
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def b1_bound_ms(m, k, n, itemsize):
    """Least time for one launch: x, w read once, y and the (2, N) f32
    statistics written once; 2MNK operations at the tensor-core bf16 peak
    (float32: the FP32 peak)."""
    nbytes = (m * k + n * k + m * n) * itemsize + 2 * n * 4
    ops = 2.0 * m * n * k
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (BF16_OPS_PER_S if itemsize == 2 else FP32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def b1_check(ms, x, w):
    """Kernel against plain version on x, w: returns (max |y - y_plain|,
    worst s1 and s2 error relative to their scales below); raises on a miss
    of the tolerances or on results that differ between two runs.

    The two sum the K products of each element in different orders in f32,
    so their accumulators differ by up to some 1e-5 of P = |x| @ |w|.T, the
    sum of the products' magnitudes (not of |acc|: where the sum cancels,
    acc is far smaller than its terms). Tolerances: y float32 1e-5 P;
    bfloat16 one ulp of the larger magnitude plus 1e-5 P; s1 1e-5 sum_m P,
    s2 1e-5 sum_m P^2, per column."""
    import torch
    y, s1, s2 = ms.matmul_stats(x, w)
    y2, t1, t2 = ms.matmul_stats(x, w)
    yr, r1, r2 = ms.matmul_stats_reference(x, w)
    torch.cuda.synchronize()
    shape = (x.shape[0], x.shape[1], w.shape[0], str(x.dtype))
    if not (torch.equal(y, y2) and torch.equal(s1, t1)
            and torch.equal(s2, t2)):
        raise SystemExit("matmul_stats %s: two runs differ" % (shape,))
    p = x.float().abs() @ w.float().abs().t()
    yf, yrf = y.float(), yr.float()
    diff = (yf - yrf).abs()
    allowed = 1e-5 * p
    if x.dtype == torch.bfloat16:
        mag = torch.maximum(yf.abs(), yrf.abs())
        allowed += torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(
            mag.clamp_min(1e-30))) - 7), torch.zeros_like(mag))
    if bool((diff > allowed).any()):
        raise SystemExit("matmul_stats %s: y off by %g, beyond tolerance"
                         % (shape, float(diff.max())))
    e1 = float(((s1 - r1).abs() / p.sum(0).clamp_min(1e-30)).max())
    e2 = float(((s2 - r2).abs() / (p * p).sum(0).clamp_min(1e-30)).max())
    if e1 > 1e-5 or e2 > 1e-5:
        raise SystemExit("matmul_stats %s: statistics off by %g, %g of "
                         "sum P, sum P^2" % (shape, e1, e2))
    return float(diff.max()), e1, e2


def b1_phase(seed, reps, card):
    import torch
    from mxnet_tpu_torch.ops import matmul_stats as ms
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def operands(m, k, n, dtype):
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        w = (torch.randn((n, k), generator=gen, device=dev)
             / k ** 0.5).to(dtype)
        return x, w

    max_err = 0.0
    with no_tf32():
        for dtype in (torch.float32, torch.bfloat16):
            worst = (0.0, 0.0, 0.0)
            for m, k, n in B1_EDGE_SHAPES:
                errs = b1_check(ms, *operands(m, k, n, dtype))
                worst = tuple(max(a, b) for a, b in zip(worst, errs))
            max_err = max(max_err, worst[0])
            log("matmul_stats edge shapes %s, M in (1, 17, 1000), K in "
                "(1, 3, 64), N in (1, 64, 65): max |y - plain| %g, s1 %g, "
                "s2 %g (of sum P, sum P^2), bitwise repeatable"
                % (str(dtype).replace("torch.", ""), *worst))
        step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "bound_ms": 0.0, "bytes_ms": 0.0}
        for (m, k, n), count in B1_STEP_SHAPES.items():
            x, w = operands(m, k, n, torch.bfloat16)
            err, e1, e2 = b1_check(ms, x, w)
            max_err = max(max_err, err)
            t = cuda_time_ms(lambda: ms.matmul_stats(x, w), reps)
            t_plain = cuda_time_ms(lambda: ms.matmul_stats_reference(x, w),
                                   max(3, reps // 4))
            t_lib = cuda_time_ms(lambda: torch.matmul(x, w.t()), reps)
            bound, by = b1_bound_ms(m, k, n, 2)
            log("matmul_stats bf16 (M, K, N) = (%d, %d, %d) x%d: max |y - "
                "plain| %g, s1 %.3g, s2 %.3g (of sum P, sum P^2); kernel "
                "%.6f ms, plain %.6f ms, "
                "torch.matmul alone %.6f ms, bound %.6f ms (%s), kernel/"
                "bound %.1f [%s]" % (m, k, n, count, err, e1, e2, t, t_plain,
                                     t_lib, bound, by, t / bound, card))
            step["ms"] += count * t
            step["plain_ms"] += count * t_plain
            step["library_ms"] += count * t_lib
            step["bound_ms"] += count * bound
            if by == "bytes":
                step["bytes_ms"] += count * bound
            del x, w
    launches = sum(B1_STEP_SHAPES.values())
    log("matmul_stats per ResNet-50 step (%d launches): kernel %.6f ms, "
        "plain %.6f ms, torch.matmul alone %.6f ms, bound %.6f ms [%s]"
        % (launches, step["ms"], step["plain_ms"], step["library_ms"],
           step["bound_ms"], card))
    return {"name": "matmul_stats", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/matmul_stats.cu",
            "replaces": "mxnet_tpu/ops/pallas_fused.py:49",
            "launches": None, "max_abs_err": max_err, "ms": step["ms"],
            "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
            "bound_by": ("bytes" if 2 * step["bytes_ms"] >= step["bound_ms"]
                         else "operations"),
            "library_ms": step["library_ms"]}


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def ssd_checkpoint(prefix, seed):
    """Full-width SSD inference symbol + random weights from ``seed``,
    written through the port as prefix-symbol.json / prefix-0000.params."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import ssd
    with mt.symbol.NameManager():
        net = ssd.get_symbol()
    arg_shapes, out_shapes, _ = net.infer_shape(data=(1,) + SSD_INPUT)
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name == "data":
            continue
        if name.endswith("_weight"):
            fan_in = int(np.prod(shape[1:]))
            v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        else:
            v = rng.standard_normal(shape) * 0.1
        params["arg:" + name] = mt.nd.array(v.astype(np.float32),
                                            ctx=mt.cpu())
    net.save(prefix + "-symbol.json")
    mt.nd.save(prefix + "-0000.params", params)
    nparam = sum(int(np.prod(v.shape)) for v in params.values())
    return net, nparam, out_shapes[0]


def serve_phase(seed, reps, card):
    import torch
    from mxnet_tpu_torch.ops import contrib, multibox_nms as mnms
    from mxnet_tpu_torch.serving import ServingEngine
    rng = np.random.default_rng(seed + 1)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "ssd")
        net, nparam, out_shape = ssd_checkpoint(prefix, seed)
        A = out_shape[1]
        log("ssd: get_symbol() defaults, input %s, %d parameters, %d anchors"
            % (SSD_INPUT, nparam, A))
        t0 = time.perf_counter()
        eng = ServingEngine(prefix + "-symbol.json", prefix + "-0000.params",
                            {"data": SSD_INPUT}, buckets=BUCKETS)
        heads = ServingEngine(
            prefix + "-symbol.json", prefix + "-0000.params",
            {"data": SSD_INPUT}, buckets=BUCKETS,
            output_names=["cls_prob", "multibox_loc_pred",
                          "multibox_anchors"])
        log("serve: two engines loaded on %s in %.3f s"
            % (eng.device, time.perf_counter() - t0))
        det_node = [n for n in _nodes(net) if n.name == "detection"][0]
        attrs = contrib._mbd_attrs(det_node.attrs)
        requests = {n: rng.random((n,) + SSD_INPUT, dtype=np.float32)
                    for n in REQUESTS}

        # the main path: counts at 0 just before, read just after
        mnms.LAUNCHES = 0
        batches0 = eng.health.batches
        served = {n: eng.infer({"data": x})[0] for n, x in requests.items()}
        launches = mnms.LAUNCHES
        dispatched = eng.health.batches - batches0
        log("serve: requests %s -> %d bucket dispatches, multibox_nms "
            "launches %d" % (list(REQUESTS), dispatched, launches))
        if launches != dispatched:
            raise SystemExit("multibox_nms ran %d times for %d dispatches"
                             % (launches, dispatched))

        for n, det in served.items():
            if det.shape != (n, A, 6):
                raise SystemExit("request n=%d: detections %s, expected %s"
                                 % (n, det.shape, (n, A, 6)))
            if not np.isfinite(det).all():
                raise SystemExit("request n=%d: non-finite detections" % n)
            kept = int((det[:, :, 0] >= 0).sum())
            if kept == 0:
                raise SystemExit("request n=%d: no detection kept" % n)
            cls_prob, loc, anc = (torch.from_numpy(h).cuda() for h in
                                  heads.infer({"data": requests[n]}))
            with torch.inference_mode():
                plain = contrib.multibox_detection(
                    cls_prob, loc, anc[:1], nms=mnms.nms_alive_reference,
                    **attrs).cpu().numpy()
            if not np.array_equal(det, plain):
                bad = np.argwhere((det != plain).any(axis=2))
                raise SystemExit(
                    "request n=%d: served detections differ from the plain "
                    "NMS path in %d rows, first %s" % (n, len(bad),
                                                       bad[:5].tolist()))
            log("serve n=%d: output %s, %d rows kept, equal to the plain "
                "NMS path" % (n, det.shape, kept))

        lat = {}
        for b in BUCKETS:
            x = {"data": rng.random((b,) + SSD_INPUT, dtype=np.float32)}
            eng.infer(x)
            ts = []
            for _ in range(reps):
                t = time.perf_counter()
                eng.infer(x)
                ts.append(time.perf_counter() - t)
            lat[b] = 1e3 * float(np.median(ts))
            log("serve latency bucket %d: p50 %.3f ms over %d requests "
                "(host clock, input copy and output copy included) [%s]"
                % (b, lat[b], reps, card))
        log("serve throughput at b=32: %.1f images/s [%s]"
            % (32e3 / lat[32], card))
    return launches


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def fused_shapes(sym, dshape):
    """(M, K, N) -> count over the Conv1x1->BatchNorm pairs the port's
    fusion pass selects in ``sym`` at input shape ``dshape``."""
    from collections import Counter
    from mxnet_tpu_torch import executor
    inter = sym.get_internals()
    _, outs, _ = inter.infer_shape(data=dshape,
                                   softmax_label=(dshape[0],))
    shape_of = dict(zip(inter.list_outputs(), outs))
    convs, _ = executor.fusion_pairs(_nodes(sym))
    shapes = Counter()
    for node in convs.values():
        src, idx = node.inputs[0]
        b, h, w, c = shape_of[src.output_names()[idx]]
        shapes[(b * h * w, c, int(node.attrs["num_filter"]))] += 1
    return dict(shapes)


def clone_state(state):
    return {"params": {n: v.clone() for n, v in state["params"].items()},
            "aux": {n: v.clone() for n, v in state["aux"].items()},
            "opt": {n: (None if v is None else v.clone())
                    for n, v in state["opt"].items()},
            "step": state["step"].clone()}


def time_steps(fn, n):
    """Median host-clock seconds of ``n`` calls of ``fn``, each ended by a
    synchronize, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


def profile_step(fn, card):
    """torch.profiler over one call of ``fn``: prints the ten CUDA kernels
    with the most device time and matmul_stats's share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev_us(e) > 0]
    total = sum(dev_us(e) for e in kernels)
    if total == 0:
        log("profile: torch.profiler recorded no device time")
        return
    b1 = sum(dev_us(e) for e in kernels
             if "mm_stats" in e.key or "reduce_partials" in e.key)
    log("profile of one fused step: %d kernel names, %.3f ms of device "
        "time; matmul_stats %.3f ms (%.1f%%) [%s]"
        % (len(kernels), total / 1e3, b1 / 1e3, 100.0 * b1 / total, card))
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        log("  %8.3f ms %5.1f%% x%-5d %s" % (dev_us(e) / 1e3,
                                            100.0 * dev_us(e) / total,
                                            e.count, e.key[:100]))


def train_phase(seed, card):
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.ops import matmul_stats as ms
    from mxnet_tpu_torch.train_step import TrainStep, _metric_step_sums
    bsz, img = RESNET_BATCH, RESNET_IMAGE
    dshape = (bsz, img, img, 3)
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=RESNET_CLASSES, num_layers=50,
                            image_shape="3,%d,%d" % (img, img),
                            layout="NHWC")
    shapes = fused_shapes(sym, dshape)
    if shapes != B1_STEP_SHAPES:
        raise SystemExit("fusion pass selected %s, expected %s"
                         % (shapes, B1_STEP_SHAPES))
    steps = {}
    for mode in ("1", "0"):
        os.environ["MXTPU_FUSE_CONV_BN"] = mode
        steps[mode] = TrainStep(sym, optimizer="sgd", learning_rate=0.1,
                                momentum=0.9, wd=1e-4,
                                compute_dtype="bfloat16")
    os.environ["MXTPU_FUSE_CONV_BN"] = "1"
    fused, unfused = steps["1"], steps["0"]
    dev = fused.device
    t0 = time.perf_counter()
    state = fused.init({"data": dshape}, {"softmax_label": (bsz,)},
                       seed=seed)
    torch.cuda.synchronize()
    nparam = sum(v.numel() for v in state["params"].values())
    log("train: resnet-50 NHWC %dx%d, %d classes, %d parameters, state "
        "initialised on %s in %.2f s" % (img, img, RESNET_CLASSES, nparam,
                                         fused.device,
                                         time.perf_counter() - t0))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)

    def batch():
        return {"data": torch.randn(dshape, generator=gen, device=dev),
                "softmax_label": torch.randint(
                    0, RESNET_CLASSES, (bsz,), generator=gen,
                    device=dev).float()}

    def loss_sum(outs, b):
        zero = torch.zeros((), device=dev)
        return float(_metric_step_sums(outs, [b["softmax_label"]], zero)[0])

    b0 = batch()
    twin = clone_state(state)
    # the main path: counts at 0 just before, read just after
    ms.LAUNCHES = 0
    ms.LAYOUT_COPIES = 0
    state, outs_f = fused.step(state, b0)
    torch.cuda.synchronize()
    launches, copies = ms.LAUNCHES, ms.LAYOUT_COPIES
    log("train: one fused step launched matmul_stats %d times, %d layout "
        "copies" % (launches, copies))
    # checks are collected and raised at the end of the phase, so that a
    # failing run still prints its timings and profile
    problems = []
    if launches != sum(B1_STEP_SHAPES.values()) or copies:
        problems.append("fused step: %d launches (expected %d), %d copies"
                        % (launches, sum(B1_STEP_SHAPES.values()), copies))
    twin, outs_u = unfused.step(twin, b0)
    torch.cuda.synchronize()
    if ms.LAUNCHES != launches:
        problems.append("the unfused step launched matmul_stats")
    lf, lu = loss_sum(outs_f, b0), loss_sum(outs_u, b0)
    excess = {n: float(((v - twin["aux"][n]).abs()
                        - (1e-3 + 2e-2 * twin["aux"][n].abs())).max())
              for n, v in state["aux"].items()}
    worst = max(excess, key=excess.get)
    max_err = max(float((v - twin["aux"][n]).abs().max())
                  for n, v in state["aux"].items())
    log("train: fused vs unfused step: loss sum %.6f vs %.6f (%.4f%% apart); "
        "BatchNorm moving statistics: max |fused - unfused| %g, closest to "
        "the tolerance (rtol 2e-2, atol 1e-3) %s with margin %g"
        % (lf, lu, 100 * abs(lf - lu) / abs(lu), max_err, worst,
           -excess[worst]))
    if not (np.isfinite(lf) and abs(lf - lu) <= 0.01 * abs(lu)):
        problems.append("fused and unfused loss sums disagree")
    if excess[worst] > 0:
        problems.append("fused and unfused moving statistics disagree")
    for st in (state, twin):
        for n, v in st["params"].items():
            if not bool(torch.isfinite(v).all()):
                problems.append("non-finite parameter %s" % n)

    k = 4
    sb = [batch() for _ in range(k)]
    superbatch = {n: torch.stack([b[n] for b in sb]) for n in sb[0]}
    for i in range(3):
        state, metrics = fused.run_steps(state, superbatch)
        log("train: run_steps K=%d dispatch %d: loss_avg %.4f, top-1 %d/%d"
            % (k, i, metrics.loss_avg, metrics.top1_correct,
               metrics.num_samples))
        if not np.isfinite(metrics.loss_sum):
            problems.append("run_steps: non-finite loss")

    b1 = batch()
    reps = 5
    timings = (("fused step", reps, time_steps(lambda: fused.step(state, b1),
                                                reps)),
               ("unfused step", reps,
                time_steps(lambda: unfused.step(twin, b1), reps)),
               ("fused run_steps K=%d, per step" % k, 2,
                time_steps(lambda: fused.run_steps(state, superbatch)[1]
                           .fetch(), 2) / k))
    for what, n, t in timings:
        log("train: %s %.3f ms, %.1f images/s (host clock, median of %d) "
            "[%s]" % (what, 1e3 * t, bsz / t, n, card))
    log("train: peak device memory %.2f GiB"
        % (torch.cuda.max_memory_allocated() / 2 ** 30))
    profile_step(lambda: fused.step(state, b1), card)
    if problems:
        raise SystemExit("train phase failed: " + "; ".join(problems))
    return launches


def _nodes(sym):
    from mxnet_tpu_torch.symbol import _topo
    return _topo(sym._out_nodes())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20,
                    help="timed repetitions per measurement")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mxnet_tpu_torch  # noqa: F401  (fails outside a checkout)
    from mxnet_tpu_torch import cuda_build
    from mxnet_tpu_torch.ops import nn as _nn

    card = gpu_name_and_power()
    log("device: %s | torch %s, CUDA %s" % (card, torch.__version__,
                                           torch.version.cuda))
    log("float32 convolutions: ServingEngine and TrainStep run them with "
        "TF32 %s (PyTorch's default cudnn.allow_tf32 here is %s)"
        % ("on" if _nn.CONV_TF32 else "off",
           torch.backends.cudnn.allow_tf32))

    t0 = time.perf_counter()
    cuda_build.build(["multibox_nms", "matmul_stats"])
    log("build: %.2f s" % (time.perf_counter() - t0))
    for name, text in cuda_build.BUILD_LOG.items():
        for line in text.splitlines():
            log("  nvcc %s: %s" % (name, line))

    rng = np.random.default_rng(args.seed)
    nms = kernel_phase(rng, max(20, 10 * args.reps), card)
    b1 = b1_phase(args.seed, args.reps, card)
    nms["launches"] = serve_phase(args.seed, args.reps, card)
    b1["launches"] = train_phase(args.seed, card)

    log(card)
    log(json.dumps({"kernels": [nms, b1]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
