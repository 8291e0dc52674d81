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
   version on the same CUDA tensors (the masks must be exactly equal), on
   the route the wrapper picks and on the l2 route: the served shapes, the
   route boundary (k_max - 1, k_max, k_max + 1), B in {1, 8, 32} with and
   without force, duplicates, zero scores, IoUs exactly at the threshold
   and degenerate boxes. Then times the smem and l2 routes in turns on the
   same tensors at B=32 and B=1 (k=400): profiler device time by kernel,
   back to back on CUDA events, host cost a call, beside the bound; the
   smem route must be the faster at B=32.
4. matmul_stats kernel: holds the matmul-with-BatchNorm-statistics kernel
   against its plain version (TF32 off) at the 12 shapes of ResNet-50's 33
   fused Conv1x1->BatchNorm pairs (batch 128, 224x224, NHWC, bf16), all on
   the wgmma route, at edge shapes in float32 (the SIMT f32 kernel,
   forced) and bfloat16, and at the wgmma and tf32x3 routes' edge shapes
   (every launch on that route); checks that the results are bitwise
   reproducible; per shape, times the wgmma kernel, the wmma kernel (the
   wrapper's route entry, same tensors), torch.matmul (the product alone,
   cuBLAS) and the plain version, in turns, as device time summed by the
   profiler and back to back on CUDA events, beside the bound, and sums one
   step's 33 launches.
5. serve: builds the SSD detector at its full width (models/ssd.py
   get_symbol() defaults, 3x300x300 input) with weights from --seed,
   writes symbol JSON and .params through the port, loads them in
   ServingEngine on cuda:0 with buckets (1, 8, 32) and serves requests of
   1, 5, 8, 32 and 40 images. Checks shapes, finiteness, that the NMS
   kernel ran once per bucket dispatch, each on its smem route, and that
   the detections equal MultiBoxDetection with the plain NMS on the same
   heads. Then times p50 latency per bucket.
6. train: ResNet-50 (NHWC, 224x224, batch 128, 1000 classes) through
   TrainStep on cuda:0, f32 master weights with bf16 compute,
   SGD(lr 0.1, momentum 0.9, wd 1e-4), weights from --seed, random data and
   labels made on the card. One step with MXTPU_FUSE_CONV_BN=1 must launch
   matmul_stats 33 times, all on the wgmma route, with no layout copy, and
   agree with the same step unfused (loss sum within 1%, every BatchNorm
   moving statistic within rtol 2e-2, atol 1e-3). Then run_steps with K=4 (all losses finite),
   step times and images/s fused, unfused and run_steps, and
   torch.profiler tables of one fused step and of one fused float32 step
   (TF32 off, cuDNN deterministic; the step Module.fit runs in phase 10),
   each printed only when two profiles in a row record the same kernel
   counts (the profiler has been seen to drop kernel records).

7. rtc: the user-kernel wrappers (B3). The JAX package's two PallasKernel
   test kernels, scale (o = 2x) and addmul (o = a*b + a), as user Triton
   kernels through rtc.TritonKernel and as CUDA bodies through rtc.Rtc
   (NVRTC), at (8, 128), at a ragged 1,000,003 and at 25,557,032 float32
   values: scale equal to its plain version, addmul within one float32 ulp
   of |a*b| + |a| (a compiler may contract it into one fused multiply-add).
   Rtc writing into a first-axis slice changes exactly that slice of the
   parent; a float16 array, a CPU array and a 2048-thread block raise.
   Times at 25.5M beside the bound, torch.mul/torch.addcmul and the plain
   version; the host cost of each wrapper beside a direct launch, in turns
   (with the ways of reading the stream handle, and a push whose arrays
   change every call, whose results must land in those arrays).
8. bind: ResNet-50 (NCHW, 224x224, batch 128, float32, TF32 off) through
   simple_bind on gpu(0), weights from --seed (Xavier), random data and
   labels made on the card. The main path is two hand-written steps:
   forward(is_train=True), backward(), then the SGD-momentum update of all
   161 parameter arrays as a user kernel: step 1 through Rtc (161 pushes),
   step 2 through TritonKernel (161 launches). Each update is held
   against nd.sgd_mom_update on the same tensors; the two steps against two
   TrainStep(compute_dtype=None) steps from the same state and batches;
   grad_req="add" over two backward passes against twice the gradient.
   The Rtc update is also captured once into a CUDA graph and replayed
   from step 1's start: it must equal the eager Rtc update bit for bit.
   Times: the bind step and the TrainStep step (images/s), the update's
   device time and back-to-back time (the graph replay among them) beside
   its bound, nd.sgd_mom_update and torch._fused_sgd_, and peak device
   memory.
9. imperative: nd arithmetic and reductions on the card against the CPU;
   an autograd gradient of a two-layer network written with nd ops
   against Executor.backward of the same symbol; a CustomOp whose forward
   and backward push Rtc kernels, inside a bound symbol, against the same
   network with nd's _mul_scalar.
10. module: ResNet-50 (NHWC, 224x224, batch 128, float32, TF32 off,
   cuDNN deterministic, MXTPU_FUSE_CONV_BN=1) trained through
   Module(context=gpu(0)).fit, 2 epochs of 8 host batches from --seed, Xavier
   arg_params from --seed, SGD(lr 0.1, momentum 0.9, wd 1e-4): (a) one
   step a dispatch, (b) 4 steps a dispatch with dispatch_pipeline=1. Each
   fit must launch matmul_stats 33 x 16 times, all on its tf32x3 route.
   Checks: the parameters and moving statistics after each fit against a
   TrainStep driven by hand over the same batches (rtol 1e-4, atol 1e-5
   elementwise, and finite); the metric, Accuracy and CrossEntropy, from
   (a) (host) and (b) (device sums) against the sums of the hand-driven
   step's outputs (correct to the count, cross-entropy within rtol 1e-5); a
   checkpoint with its .states saved and loaded by Module on the card
   scores as the trained module and carries its momentum; at each of the
   12 shapes the tf32x3 route and the SIMT f32 kernel (forced) against the
   plain version. Prints images/s of each fit beside TrainStep.step alone;
   on CUDA events, in turns, the tf32x3 route's time a step beside the
   SIMT kernel's, torch.matmul f32 (TF32 off) and the plain version, with
   the tf32x3 bound (3 x 2MNK at the TF32 peak) and the FP32 SIMT bound
   (the tf32x3 route must be below the SIMT kernel and the plain version);
   and a fused step's time against unfused.
11. resnet serve: ResNet-50 (NCHW, 3x224x224, 1000 classes, Xavier from
   --seed) served through ServingEngine with buckets (1, 8, 32): finite
   probabilities for requests of 1, 5, 8 and 32 images, p50 latency per
   bucket.

The line before the last is {"kernels": [...]} (per kernel: launches on
its main path, max error against the plain version, times and bound);
the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s,
#: float32 operations/s outside the tensor cores, dense bf16 and TF32
#: tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12

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
#: bfloat16 shapes at the edges of the wgmma route: ragged M-tiles, fewer
#: tiles than SMs and many tiles a block (M); one partial K box and a ragged
#: last box (K); a ragged N-tile and a change of N-tile width (N)
B1_WGMMA_EDGE_SHAPES = [(m, k, n) for m in (1, 17, 1000, 100003)
                        for k in (8, 72) for n in (8, 264, 520)]
#: float32 shapes at the edges of the tf32x3 route: ragged M-tiles and many
#: tiles a block (M); one partial K box and a ragged last box (K); a ragged
#: N-tile and more than one N-tile (N)
B1_F32_TMA_EDGE_SHAPES = [(m, k, n) for m in (1, 17, 1000, 100003)
                          for k in (4, 36) for n in (4, 132, 260)]
#: B1's arithmetic -> (products of 2MNK it issues, the peak that bounds
#: them): bf16 wgmma/wmma, FP32 SIMT (the f32 route), 3xTF32 (tf32x3)
B1_ARITH = {"bf16": (1, BF16_OPS_PER_S), "f32": (1, FP32_OPS_PER_S),
            "tf32x3": (3, TF32_OPS_PER_S)}

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


def profiled_kernels(fn, reps):
    """torch.profiler over ``reps`` calls of ``fn``: the CUDA kernels with
    device time, or None when the profiler lost records. Every call
    launches the same kernels, so a kernel recorded a number of times that
    ``reps`` does not divide was dropped from the trace (late in a long
    run the profiler on the chip machine has been seen to keep 2 of 5
    launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and _device_us(e) > 0]
    lost = [e.key for e in kernels if e.count % reps
            and not e.key.startswith(("Memset", "Memcpy"))]
    if lost:
        log("profile: kernel records lost over %d calls (%s); not used"
            % (reps, ", ".join(_kernel_name(k) for k in lost[:3])))
        return None
    return kernels


def device_ms_by_kernel(fn, reps=5):
    """{kernel name: device ms per call of ``fn``} summed by
    torch.profiler over ``reps`` calls (host gaps excluded); empty when
    the profiler records no device time, or lost records
    (:func:`profiled_kernels`)."""
    fn()
    kernels = profiled_kernels(fn, reps) or []
    return {e.key: _device_us(e) / 1e3 / reps for e in kernels}


def _kernel_name(key):
    """A profiler key's function name (``nms_mask_kernel`` of
    ``(anonymous namespace)::nms_mask_kernel(float4 const*, ...)``)."""
    m = re.search(r"(\w+)\(", key)
    return m.group(1) if m else key[:60]


def nms_times(fn, reps):
    """One NMS call ``fn`` timed three ways: device ms by kernel and in
    total (profiler), back-to-back ms (CUDA events) and the host us a call
    (enqueue only). Raises when the profiler records no device time in
    three tries: the routes are compared by device time only."""
    split = {}
    for _ in range(3):
        split = device_ms_by_kernel(fn)
        if split:
            break
    if not split:
        raise SystemExit("nms: the profiler recorded no device time")
    return {"ms": sum(split.values()),
            "by_kernel": {_kernel_name(k): v for k, v in split.items()},
            "event_ms": cuda_time_ms(fn, reps),
            "host_us": host_us(fn, 500)}


def nms_grid_inputs(rng, b, k, degenerate=False):
    """Score-sorted boxes with corners on a 1/8 grid, so that many IoUs
    fall exactly on simple fractions (0.5 among them), two classes;
    ``degenerate`` gives every tenth box zero width (area 0)."""
    c = rng.integers(0, 8, (b, k, 2)).astype(np.float32) / 8
    wh = rng.integers(1, 5, (b, k, 2)).astype(np.float32) / 8
    boxes = np.concatenate([c, c + wh], axis=2).astype(np.float32)
    if degenerate:
        boxes[:, ::10, 2] = boxes[:, ::10, 0]
    score = -np.sort(-rng.random((b, k), dtype=np.float32), axis=1)
    cls = rng.integers(0, 2, (b, k)).astype(np.float32)
    return boxes, score, cls


def kernel_phase(rng, reps, card):
    """B2 against its plain version, exactly, on the wrapper's route and
    on the l2 route; then both routes timed in turns."""
    import torch
    from mxnet_tpu_torch.ops import multibox_nms as mnms
    dev = torch.device("cuda", 0)
    kmax = mnms.SMEM_MAX_K
    # (B, k, force, duplicates, zero scores, inputs, threshold)
    cases = [(32, 400, False, 0, 0, "rand", 0.5),
             (32, 400, True, 0, 0, "rand", 0.5)]
    cases += [(4, k, False, 0, 0, "rand", 0.5)
              for k in (1, 63, 64, 65, 400, 2000)]
    cases += [(4, 400, False, 40, 100, "rand", 0.5),
              (4, 400, True, 40, 100, "rand", 0.5),
              (2, 2000, False, 200, 500, "rand", 0.5)]
    # the route boundary, and the served batches with duplicates and zero
    # scores, with and without force
    cases += [(2, k, f, k // 10, k // 5, "rand", 0.5)
              for k in (kmax - 1, kmax, kmax + 1) for f in (False, True)]
    cases += [(b, 400, f, 40, 80, "rand", 0.5)
              for b in (1, 8, 32) for f in (False, True)]
    # IoUs exactly at the threshold (the exact redo of the fast test), and
    # degenerate boxes (the correctly rounded division for every pair)
    cases += [(4, 400, f, 0, 0, kind, th) for kind in ("grid", "degenerate")
              for f in (False, True) for th in (0.5, 0.25)]
    max_err = 0.0
    for b, k, force, dup, zeros, kind, th in cases:
        arrs = (nms_inputs(rng, b, k, dup, zeros) if kind == "rand" else
                nms_grid_inputs(rng, b, k, kind == "degenerate"))
        boxes, score, cls = (torch.from_numpy(a).to(dev) for a in arrs)
        route = mnms.kernel_route(b, k)
        before = dict(mnms.LAUNCHES_BY_ROUTE)
        got = mnms.nms_alive(boxes, score, cls, th, force)
        other = mnms._launch(boxes, score, cls, th, force, "l2")
        want = mnms.nms_alive_reference(boxes, score, cls, th, force)
        torch.cuda.synchronize()
        took = {r: mnms.LAUNCHES_BY_ROUTE[r] - before[r] for r in before}
        err = float((got - want).abs().max())
        log("nms case B=%d k=%d force=%s dup=%d zero_scores=%d %s "
            "thresh=%g: kept %d/%d; %s route max |kernel - plain| = %g, l2 "
            "route equal: %s" % (b, k, force, dup, zeros, kind, th,
                                 int(want.sum()), b * k, route, err,
                                 torch.equal(other, want)))
        if took != ({"smem": 1, "l2": 1} if route == "smem" else
                    {"smem": 0, "l2": 2}):
            raise SystemExit("NMS kernel took routes %s at k=%d" % (took, k))
        if not (torch.equal(got, want) and torch.equal(other, want)):
            raise SystemExit("NMS kernel disagrees with its plain version "
                             "at B=%d k=%d force=%s %s" % (b, k, force, kind))
        max_err = max(max_err, err)

    # the routes in turns on the same tensors (smem, l2, l2, smem): device
    # time by the profiler, back to back on CUDA events, host cost a call
    times = {}
    for b, k in ((32, 400), (1, 400)):
        boxes, score, cls = (torch.from_numpy(a).to(dev)
                             for a in nms_inputs(rng, b, k, 40, 80))
        got = {}
        for route in ("smem", "l2", "l2", "smem"):
            t = nms_times(lambda: mnms._launch(boxes, score, cls, 0.5, False,
                                               route), reps)
            for key, v in t.items():
                if key == "by_kernel":
                    got.setdefault((route, key), {}).update(v)
                else:
                    got.setdefault((route, key), []).append(v)
        bound_ms, bound_by = nms_bound_ms(b, k)
        for route in ("smem", "l2"):
            times[(b, route)] = {
                key: float(np.mean(got[(route, key)]))
                for key in ("ms", "event_ms", "host_us")}
            times[(b, route)]["by_kernel"] = got[(route, "by_kernel")]
            t = times[(b, route)]
            log("nms timing B=%d k=%d route %s: device %.6f ms (profiler; by "
                "kernel %s), back to back %.6f ms (CUDA events), host %.2f "
                "us a call; bound %.6f ms (%s) [%s]"
                % (b, k, route, t["ms"], {n: round(v, 6) for n, v in
                                    t["by_kernel"].items()},
                   t["event_ms"], t["host_us"], bound_ms, bound_by, card))
        if b == 32:
            plain_ms = cuda_time_ms(
                lambda: mnms.nms_alive_reference(boxes, score, cls, 0.5),
                max(3, reps // 20), warmup=1)
            bound32 = (bound_ms, bound_by)
    smem, l2 = times[(32, "smem")], times[(32, "l2")]
    if not smem["ms"] < l2["ms"]:
        raise SystemExit("NMS smem route %.6f ms is not below the l2 route's "
                         "%.6f ms at B=32, k=400" % (smem["ms"], l2["ms"]))
    log("nms plain version B=32 k=400: %.6f ms [%s]" % (plain_ms, card))
    return {"name": "multibox_nms", "route": "cuda", "kernel_route": "smem",
            "source": "mxnet_tpu_torch/csrc/multibox_nms.cu",
            "replaces": "mxnet_tpu/ops/pallas_multibox.py:29",
            "launches": None, "max_abs_err": max_err,
            "ms": smem["ms"], "ms_source": "profiler",
            "event_ms": smem["event_ms"], "host_us": smem["host_us"],
            "plain_ms": plain_ms, "bound_ms": bound32[0],
            "bound_by": bound32[1], "library_ms": None,
            "l2_ms": l2["ms"], "l2_event_ms": l2["event_ms"],
            "b1_ms": times[(1, "smem")]["ms"],
            "b1_l2_ms": times[(1, "l2")]["ms"]}


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


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms (its default weight-gradient
    algorithms may sum in another order on every call), restored after."""
    import torch
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def b1_bound_ms(m, k, n, arith):
    """Least time for one launch: x, w read once, y and the (2, N) f32
    statistics written once; the operations of ``arith`` (B1_ARITH) at
    their peak: 2MNK at the bf16 tensor-core peak (bf16), at the FP32 peak
    (f32), 3 x 2MNK at the TF32 peak (tf32x3)."""
    itemsize = 2 if arith == "bf16" else 4
    passes, peak = B1_ARITH[arith]
    nbytes = (m * k + n * k + m * n) * itemsize + 2 * n * 4
    ops = passes * 2.0 * m * n * k
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def b1_check(ms, x, w, route=None):
    """Kernel against plain version on x, w: returns (max |y - y_plain|,
    worst s1 and s2 error relative to their scales below); raises on a miss
    of the tolerances or on results that differ between two runs. ``route``
    forces a kernel (matmul_stats._launch); None takes the wrapper's.

    The two sum the K products of each element in different orders in f32
    (and tf32x3 drops terms of some 2^-22 of each product), so their
    accumulators differ by up to some 1e-5 of P = |x| @ |w|.T, the sum of
    the products' magnitudes (not of |acc|: where the sum cancels, acc is
    far smaller than its terms). Tolerances: y float32 1e-5 P; bfloat16 one
    ulp of the larger magnitude plus 1e-5 P; s1 1e-5 sum_m P, s2 1e-5
    sum_m P^2, per column."""
    import torch

    def call():
        return (ms.matmul_stats(x, w) if route is None
                else ms._launch(x, w, route))
    y, s1, s2 = call()
    y2, t1, t2 = call()
    yr, r1, r2 = ms.matmul_stats_reference(x, w)
    torch.cuda.synchronize()
    shape = (x.shape[0], x.shape[1], w.shape[0], str(x.dtype), route)
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


def device_ms(fn, what):
    """Device milliseconds per call of ``fn`` summed by torch.profiler
    (kernel_ms); the profiler is asked up to three times. None, with a log
    line, when it records no device time."""
    for _ in range(3):
        t = kernel_ms(fn, reps=5)
        if t is not None:
            return t
    log("profile: no device time recorded for %s" % what)
    return None


def b1_routes_since(ms, before):
    return {r: ms.LAUNCHES_BY_ROUTE[r] - before[r] for r in before}


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
        # (dtype, shapes, route forced, the route every launch must take):
        # the float32 edge shapes on the SIMT kernel, forced where tf32x3
        # would take them
        edge_sets = [(torch.float32, B1_EDGE_SHAPES, "f32", "f32"),
                     (torch.bfloat16, B1_EDGE_SHAPES, None, None),
                     (torch.bfloat16, B1_WGMMA_EDGE_SHAPES, None, "wgmma"),
                     (torch.float32, B1_F32_TMA_EDGE_SHAPES, None, "tf32x3")]
        for dtype, shapes, force, want in edge_sets:
            worst = (0.0, 0.0, 0.0)
            before = dict(ms.LAUNCHES_BY_ROUTE)
            for m, k, n in shapes:
                errs = b1_check(ms, *operands(m, k, n, dtype), force)
                worst = tuple(max(a, b) for a, b in zip(worst, errs))
            routes = b1_routes_since(ms, before)
            max_err = max(max_err, worst[0])
            log("matmul_stats edge shapes %s, M in %s, K in %s, N in %s: "
                "max |y - plain| %g, s1 %g, s2 %g (of sum P, sum P^2), "
                "bitwise repeatable; launches by route %s"
                % (str(dtype).replace("torch.", ""),
                   sorted({sh[0] for sh in shapes}),
                   sorted({sh[1] for sh in shapes}),
                   sorted({sh[2] for sh in shapes}), *worst, routes))
            if want is not None and routes[want] != 2 * len(shapes):
                raise SystemExit("matmul_stats: %s edge shapes took routes "
                                 "%s" % (want, routes))
        keys = ("wgmma", "wmma", "torch.matmul", "plain")
        step = {"event": dict.fromkeys(keys, 0.0),
                "device": dict.fromkeys(keys, 0.0),
                "bound_ms": 0.0, "bytes_ms": 0.0}
        fell_back = []      # device times the profiler did not record
        for (m, k, n), count in B1_STEP_SHAPES.items():
            x, w = operands(m, k, n, torch.bfloat16)
            before = dict(ms.LAUNCHES_BY_ROUTE)
            err, e1, e2 = b1_check(ms, x, w)
            if b1_routes_since(ms, before)["wgmma"] != 2:
                raise SystemExit("matmul_stats (%d, %d, %d) did not take the "
                                 "wgmma route" % (m, k, n))
            max_err = max(max_err, err)
            fns = {"wgmma": lambda: ms.matmul_stats(x, w),
                   "wmma": lambda: ms._launch(x, w, "wmma"),
                   "torch.matmul": lambda: torch.matmul(x, w.t()),
                   "plain": lambda: ms.matmul_stats_reference(x, w)}
            # CUDA events around back-to-back calls, in turns (each kernel
            # timed twice, in the order a b c d d c b a); then the device
            # time the profiler sums over the calls' kernels
            event = dict.fromkeys(keys, 0.0)
            for name in keys + keys[::-1]:
                event[name] += cuda_time_ms(
                    fns[name], max(3, reps // 4) if name == "plain"
                    else reps) / 2
            device = {name: device_ms(fns[name], "%s at %s" % (
                name, (m, k, n))) for name in keys}
            for name in keys:
                if device[name] is None:
                    device[name] = event[name]
                    fell_back.append("%s at %s" % (name, (m, k, n)))
            bound, by = b1_bound_ms(m, k, n, "bf16")
            log("matmul_stats bf16 (M, K, N) = (%d, %d, %d) x%d: max |y - "
                "plain| %g, s1 %.3g, s2 %.3g (of sum P, sum P^2); device ms "
                "(profiler): wgmma %.6f, wmma %.6f, torch.matmul alone %.6f, "
                "plain %.6f; back to back (CUDA events): wgmma %.6f, wmma "
                "%.6f, torch.matmul %.6f, plain %.6f; bound %.6f ms (%s); "
                "wgmma/bound %.2f, roofline share bound/wgmma %.3f, "
                "wmma/bound %.2f [%s]"
                % (m, k, n, count, err, e1, e2, device["wgmma"],
                   device["wmma"], device["torch.matmul"], device["plain"],
                   event["wgmma"], event["wmma"], event["torch.matmul"],
                   event["plain"], bound, by, device["wgmma"] / bound,
                   bound / device["wgmma"], device["wmma"] / bound, card))
            for name in keys:
                step["event"][name] += count * event[name]
                step["device"][name] += count * device[name]
            step["bound_ms"] += count * bound
            if by == "bytes":
                step["bytes_ms"] += count * bound
            del x, w
    launches = sum(B1_STEP_SHAPES.values())
    dv, ev = step["device"], step["event"]
    log("matmul_stats per ResNet-50 step (%d launches), device ms: wgmma "
        "%.6f, wmma %.6f, torch.matmul alone %.6f, plain %.6f; back to "
        "back: wgmma %.6f, wmma %.6f, torch.matmul %.6f, plain %.6f; bound "
        "%.6f ms, roofline share of the wgmma kernel %.3f [%s]"
        % (launches, dv["wgmma"], dv["wmma"], dv["torch.matmul"],
           dv["plain"], ev["wgmma"], ev["wmma"], ev["torch.matmul"],
           ev["plain"], step["bound_ms"], step["bound_ms"] / dv["wgmma"],
           card))
    return {"name": "matmul_stats", "route": "cuda", "kernel_route": "wgmma",
            "source": "mxnet_tpu_torch/csrc/matmul_stats.cu",
            "replaces": "mxnet_tpu/ops/pallas_fused.py:49",
            "launches": None, "max_abs_err": max_err, "ms": dv["wgmma"],
            "ms_source": ("profiler" if not fell_back else
                          "profiler; CUDA events for " + ", ".join(fell_back)),
            "plain_ms": dv["plain"], "bound_ms": step["bound_ms"],
            "bound_by": ("bytes" if 2 * step["bytes_ms"] >= step["bound_ms"]
                         else "operations"),
            "library_ms": dv["torch.matmul"], "wmma_ms": dv["wmma"],
            "event_ms": ev["wgmma"], "wmma_event_ms": ev["wmma"],
            "library_event_ms": ev["torch.matmul"],
            "plain_event_ms": ev["plain"]}


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
        for r in mnms.LAUNCHES_BY_ROUTE:
            mnms.LAUNCHES_BY_ROUTE[r] = 0
        batches0 = eng.health.batches
        served = {n: eng.infer({"data": x})[0] for n, x in requests.items()}
        launches = mnms.LAUNCHES
        routes = dict(mnms.LAUNCHES_BY_ROUTE)
        dispatched = eng.health.batches - batches0
        log("serve: requests %s -> %d bucket dispatches, multibox_nms "
            "launches %d (by route %s)" % (list(REQUESTS), dispatched,
                                           launches, routes))
        if launches != dispatched or routes["smem"] != dispatched:
            raise SystemExit("multibox_nms ran %d times (by route %s) for %d "
                             "dispatches; each should take the smem route"
                             % (launches, routes, dispatched))

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


def _device_us(e):
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


def kernel_ms(fn, reps=3):
    """Milliseconds of device time per call of ``fn``, summed over its
    kernels by torch.profiler (host gaps between launches excluded); None
    when the profiler records no device time."""
    split = device_ms_by_kernel(fn, reps)
    return sum(split.values()) if split else None


def profile_step(fn, card, what="one fused step",
                 share=("matmul_stats", ("mm_stats", "reduce_partials",
                                         "split_tf32")),
                 tries=4):
    """torch.profiler over one call of ``fn``: prints the ten CUDA kernels
    with the most device time and the share of the kernels named by
    ``share`` (a label and substrings of their names). A dropped kernel
    record (:func:`profiled_kernels`) changes the counts, so the call is
    profiled until two profiles in a row record every kernel the same
    number of times, at most ``tries`` times, and else prints no
    breakdown. (A profile of several calls cannot be held to the count
    rule: a step's first calls launch a copy or a convolution kernel once
    more or less than later ones.)"""
    fn()
    fn()
    prev = None
    for _ in range(tries):
        kernels = profiled_kernels(fn, 1)
        counts = {e.key: e.count for e in kernels}
        if counts == prev:
            break
        prev = counts
    else:
        log("profile of %s: no two profiles in a row of %d recorded the "
            "same kernel counts; no breakdown [%s]" % (what, tries, card))
        return
    total = sum(_device_us(e) for e in kernels)
    if total == 0:
        log("profile: torch.profiler recorded no device time")
        return
    part = sum(_device_us(e) for e in kernels
               if any(k in e.key for k in share[1]))
    log("profile of %s (the same %d kernel launches as the profile "
        "before it): %d kernel names, %.3f ms of device time; %s %.3f ms "
        "(%.1f%%) [%s]" % (what, sum(counts.values()), len(kernels),
                           total / 1e3, share[0], part / 1e3,
                           100.0 * part / total, card))
    for e in sorted(kernels, key=_device_us, reverse=True)[:10]:
        log("  %8.3f ms %5.1f%% x%-5d %s" % (_device_us(e) / 1e3,
                                            100.0 * _device_us(e) / total,
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
    for r in ms.LAUNCHES_BY_ROUTE:
        ms.LAUNCHES_BY_ROUTE[r] = 0
    state, outs_f = fused.step(state, b0)
    torch.cuda.synchronize()
    launches, copies = ms.LAUNCHES, ms.LAYOUT_COPIES
    routes = dict(ms.LAUNCHES_BY_ROUTE)
    log("train: one fused step launched matmul_stats %d times (by route "
        "%s), %d layout copies" % (launches, routes, copies))
    # checks are collected and raised at the end of the phase, so that a
    # failing run still prints its timings and profile
    problems = []
    expected = sum(B1_STEP_SHAPES.values())
    if launches != expected or copies or routes["wgmma"] != expected:
        problems.append("fused step: %d launches, %d on the wgmma route "
                        "(expected %d), %d copies"
                        % (launches, routes["wgmma"], expected, copies))
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
    # the float32 step that Module.fit runs (phase 10), profiled here:
    # after phase 8 the profiler has dropped kernel records
    f32 = TrainStep(sym, optimizer="sgd", learning_rate=0.1, momentum=0.9,
                    wd=1e-4)
    st32 = f32.init({"data": dshape}, {"softmax_label": (bsz,)}, seed=seed)
    with no_tf32(), deterministic_cudnn():
        profile_step(lambda: f32.step(st32, b1), card,
                     "one fused float32 step (TF32 off)")
    if problems:
        raise SystemExit("train phase failed: " + "; ".join(problems))
    return launches


# ---------------------------------------------------------------------------
# rtc phase (B3): user kernels through TritonKernel and Rtc
# ---------------------------------------------------------------------------

#: sizes phase 7 runs the user kernels at: the JAX package's test shape, a
#: ragged size and ResNet-50's parameter count
RTC_SIZES = ((8, 128), (1000003,), (25557032,))
RTC_BLOCK = 256

#: CUDA bodies for Rtc (decorated with the arrays' names and dims)
_RTC_N = ("int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
          "int n = 1;\n"
          "for (int d = 0; d < {x}_ndim; ++d) n *= {x}_dims[d];\n")
RTC_SCALE = _RTC_N.format(x="x") + "if (i < n) y[i] = 2.0f * x[i];"
RTC_ADDMUL = _RTC_N.format(x="a") + "if (i < n) o[i] = a[i] * b[i] + a[i];"
#: MXNet's SGD with momentum, hp = [lr, momentum, wd, rescale_grad, size]:
#: the size is data, so one kernel serves arrays of every shape
RTC_SGD = ("int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
           "const int n = (int)hp[4];\n"
           "if (i < n) {\n"
           "  float m = hp[1] * mom[i] - hp[0] * (hp[3] * g[i] + hp[2] * w[i]);\n"
           "  mom[i] = m;\n"
           "  w[i] = w[i] + m;\n"
           "}")

#: the bind phase's update (MXNet's sgd_mom_update)
SGD = dict(lr=0.1, momentum=0.9, wd=1e-4, rescale_grad=1.0 / RESNET_BATCH)
#: two backward passes over the same state agree within this fraction of
#: the array's largest gradient: with cuDNN's deterministic algorithms the
#: max-pooling backward's atomic adds may still sum in another order
GRAD_TOL = 1e-4

_TRITON = {}


def triton_kernels():
    """The user Triton kernels, wrapped in rtc.TritonKernel (built once,
    at the first call): scale(x, n) -> 2x, addmul(a, b, n) -> a*b + a,
    sgd_mom(w, g, m, n, lr, momentum, wd, rescale) -> (w', m'); and the
    raw scale kernel with its grid, for a direct launch."""
    if _TRITON:
        return _TRITON
    import triton
    import triton.language as tl
    from mxnet_tpu_torch import rtc

    @triton.jit
    def scale(x_ptr, n, o_ptr, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        tl.store(o_ptr + offs, tl.load(x_ptr + offs, mask=m) * 2.0, mask=m)

    @triton.jit
    def addmul(a_ptr, b_ptr, n, o_ptr, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        a = tl.load(a_ptr + offs, mask=m)
        b = tl.load(b_ptr + offs, mask=m)
        tl.store(o_ptr + offs, a * b + a, mask=m)

    @triton.jit
    def sgd_mom(w_ptr, g_ptr, m_ptr, n, lr, momentum, wd, rescale,
                w_out, m_out, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        msk = offs < n
        w = tl.load(w_ptr + offs, mask=msk)
        g = tl.load(g_ptr + offs, mask=msk)
        mom = tl.load(m_ptr + offs, mask=msk)
        new = momentum * mom - lr * (rescale * g + wd * w)
        tl.store(m_out + offs, new, mask=msk)
        tl.store(w_out + offs, w + new, mask=msk)

    def grid(meta):
        return (triton.cdiv(meta["n"], meta["BLOCK"]),)

    _TRITON.update(
        scale=rtc.TritonKernel(scale, out_like=0, grid=grid, BLOCK=1024),
        addmul=rtc.TritonKernel(addmul, out_like=0, grid=grid, BLOCK=1024),
        sgd_mom=rtc.TritonKernel(sgd_mom, out_like=[0, 2], grid=grid,
                                 BLOCK=1024),
        raw_scale=scale, grid=grid)
    return _TRITON


def rtc_grid(n):
    return ((n + RTC_BLOCK - 1) // RTC_BLOCK,), (RTC_BLOCK,)


def addmul_excess(got, a, b):
    """How far |got - (a*b + a)| exceeds one float32 ulp of |a*b| + |a|
    (<= 0 within the tolerance): fma contraction rounds once where the
    plain version rounds twice. Returns (excess, max |diff|)."""
    import torch
    diff = (got - (a * b + a)).abs()
    allowed = 2.0 ** -23 * ((a * b).abs() + a.abs())
    return float((diff - allowed).max()), float(diff.max())


def must_raise(fn, what):
    """``fn`` must raise MXNetError; prints its message."""
    from mxnet_tpu_torch.base import MXNetError
    try:
        fn()
    except MXNetError as e:
        log("rtc: %s raises: %s" % (what, str(e).splitlines()[0][:160]))
        return
    raise SystemExit("rtc: %s did not raise" % what)


def host_us(fn, n=2000):
    """Host microseconds per call of ``fn`` (enqueue only: no synchronize
    inside the loop), after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * dt / n


def rtc_phase(seed, reps, card):
    import ctypes
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import rtc
    nd = mt.nd
    dev = mt.gpu(0).to_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    tk = triton_kernels()
    err = {"cuda": 0.0, "triton": 0.0}
    t0 = time.perf_counter()
    for shape in RTC_SIZES:
        n = int(np.prod(shape))
        x, a, b = (torch.randn(shape, generator=gen, device=dev)
                   for _ in range(3))
        X, A, B = nd.NDArray(x), nd.NDArray(a), nd.NDArray(b)
        y = nd.zeros(shape, ctx=mt.gpu(0))
        o = nd.zeros(shape, ctx=mt.gpu(0))
        grid, block = rtc_grid(n)
        rtc.Rtc("scale", [("x", X)], [("y", y)], RTC_SCALE).push(
            [X], [y], grid, block)
        rtc.Rtc("addmul", [("a", A), ("b", B)], [("o", o)],
                RTC_ADDMUL).push([A, B], [o], grid, block)
        ty = tk["scale"](X, n)
        to = tk["addmul"](A, B, n)
        torch.cuda.synchronize()
        for route, ys, os_ in (("cuda", y, o), ("triton", ty, to)):
            if not torch.equal(ys.data, x * 2.0):
                raise SystemExit("rtc %s scale %s differs from 2x" % (route,
                                                                      shape))
            excess, diff = addmul_excess(os_.data, a, b)
            if excess > 0:
                raise SystemExit("rtc %s addmul %s: off by %g, past one ulp "
                                 "of |a*b| + |a|" % (route, shape, diff))
            err[route] = max(err[route], diff)
            log("rtc %s %s: scale equal to 2x; addmul max |kernel - plain| "
                "%g, within one ulp of |a*b| + |a|" % (route, shape, diff))
    log("rtc: first calls (NVRTC and Triton builds included) %.2f s"
        % (time.perf_counter() - t0))

    # a write into a first-axis slice changes that slice of the parent only
    parent = nd.NDArray(torch.randn((6, 1000), generator=gen, device=dev))
    before = parent.data.clone()
    src = nd.NDArray(torch.randn((2, 1000), generator=gen, device=dev))
    view = parent[2:4]
    grid, block = rtc_grid(2000)
    rtc.Rtc("scale", [("x", src)], [("y", view)], RTC_SCALE).push(
        [src], [view], grid, block)
    torch.cuda.synchronize()
    want = before.clone()
    want[2:4] = 2.0 * src.data
    if not torch.equal(parent.data, want):
        raise SystemExit("rtc: a push into parent[2:4] did not change "
                         "exactly rows 2:4 of the parent")
    log("rtc: a push into parent[2:4] of a (6, 1000) array changed exactly "
        "those rows")

    x = nd.NDArray(torch.randn((8, 128), generator=gen, device=dev))
    y = nd.zeros((8, 128), ctx=mt.gpu(0))
    k = rtc.Rtc("scale", [("x", x)], [("y", y)], RTC_SCALE)
    must_raise(lambda: k.push([x.astype("float16")], [y], (4,), (256,)),
               "a float16 array")
    must_raise(lambda: k.push([x.copyto(mt.cpu())], [y], (4,), (256,)),
               "a CPU array")
    must_raise(lambda: k.push([x], [y], (1,), (2048,)),
               "a 2048-thread block")
    must_raise(lambda: tk["scale"](x.copyto(mt.cpu()), 1024),
               "TritonKernel on a CPU array without a reference")

    # times at ResNet-50's parameter count, beside the bound
    n = RTC_SIZES[-1][0]
    x, a, b = (torch.randn((n,), generator=gen, device=dev)
               for _ in range(3))
    X, A, B = nd.NDArray(x), nd.NDArray(a), nd.NDArray(b)
    Y, O = nd.zeros((n,), ctx=mt.gpu(0)), nd.zeros((n,), ctx=mt.gpu(0))
    ks = rtc.Rtc("scale", [("x", X)], [("y", Y)], RTC_SCALE)
    ka = rtc.Rtc("addmul", [("a", A), ("b", B)], [("o", O)], RTC_ADDMUL)
    grid, block = rtc_grid(n)
    for name, nbytes, cases in (
            ("scale", 8 * n, (
                ("Rtc", lambda: ks.push([X], [Y], grid, block)),
                ("TritonKernel", lambda: tk["scale"](X, n)),
                ("plain x * 2.0", lambda: x * 2.0),
                ("torch.mul", lambda: torch.mul(x, 2.0)))),
            ("addmul", 12 * n, (
                ("Rtc", lambda: ka.push([A, B], [O], grid, block)),
                ("TritonKernel", lambda: tk["addmul"](A, B, n)),
                ("plain a * b + a", lambda: a * b + a),
                ("torch.addcmul", lambda: torch.addcmul(a, a, b))))):
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        times = {what: cuda_time_ms(fn, reps) for what, fn in cases}
        log("rtc %s at %d float32: %s; bound %.6f ms (bytes) [%s]"
            % (name, n, ", ".join("%s %.6f ms" % kv for kv in times.items()),
               bound, card))

    # the wrappers' own host cost, beside direct launches, at (8, 128), in
    # turns; with it the ways a push could take the stream handle, and a
    # push whose arrays change every call
    xs = nd.NDArray(torch.randn((8, 128), generator=gen, device=dev))
    ys = nd.zeros((8, 128), ctx=mt.gpu(0))
    os_ = torch.empty((8, 128), device=dev)
    small = rtc.Rtc("scale", [("x", xs)], [("y", ys)], RTC_SCALE)
    small.push([xs], [ys], (4,), (RTC_BLOCK,))
    ctx, _mod, fn = small._function(dev.index)
    drv = rtc._lib("driver")
    ptrs = [ctypes.c_void_p(xs.data.data_ptr()),
            ctypes.c_void_p(ys.data.data_ptr())]
    params = (ctypes.c_void_p * 2)(*[ctypes.addressof(p) for p in ptrs])
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    dims = (ctypes.c_uint * 6)(4, 1, 1, RTC_BLOCK, 1, 1)
    launcher = rtc._launcher()[0]
    pool = [(nd.NDArray(torch.randn((8, 128), generator=gen, device=dev)),
             nd.zeros((8, 128), ctx=mt.gpu(0))) for _ in range(8)]
    turn = iter(range(10 ** 9))

    def fresh_push():
        x, y = pool[next(turn) % len(pool)]
        small.push([x], [y], (4,), (RTC_BLOCK,))

    raw, grid_fn = tk["raw_scale"], tk["grid"]
    fns = {
        "Rtc.push": lambda: small.push([xs], [ys], (4,), (RTC_BLOCK,)),
        "Rtc.push, new arrays every call": fresh_push,
        "cuLaunchKernel through ctypes": lambda: drv.cuLaunchKernel(
            fn, 4, 1, 1, RTC_BLOCK, 1, 1, 0, stream, params, None),
        "rtc_launch (C) through ctypes": lambda: launcher(fn, ctx, dims,
                                                          stream, params),
        "TritonKernel.__call__": lambda: tk["scale"](xs, 1024),
        "direct Triton launch": lambda: raw[grid_fn](xs.data, 1024, os_,
                                                     BLOCK=1024),
        "direct Triton launch, its output allocated": lambda: raw[grid_fn](
            xs.data, 1024, torch.empty((8, 128), device=dev), BLOCK=1024),
        "stream: torch.accelerator.current_stream(i).native_handle":
            lambda: torch.accelerator.current_stream(0).native_handle,
        "stream: torch.cuda.current_stream(i).cuda_stream":
            lambda: torch.cuda.current_stream(0).cuda_stream,
    }
    host = host_costs(fns)
    torch.cuda.synchronize()
    for x, y in pool:
        if not torch.equal(y.data, 2.0 * x.data):
            raise SystemExit("rtc: a push with new arrays every call did not "
                             "land in that call's arrays")
    ratios = {"Rtc.push": host["Rtc.push"]
              / host["cuLaunchKernel through ctypes"],
              "TritonKernel.__call__": host["TritonKernel.__call__"]
              / host["direct Triton launch"]}
    log("rtc host cost per call at (8, 128), median of 5 rounds in turns: "
        "%s; Rtc.push / cuLaunchKernel %.2f, TritonKernel / direct Triton "
        "%.2f (%.2f against the direct launch that allocates its output, as "
        "TritonKernel does); the pushes with new arrays every call landed in "
        "those arrays [%s]"
        % (", ".join("%s %.2f us" % kv for kv in host.items()),
           ratios["Rtc.push"], ratios["TritonKernel.__call__"],
           host["TritonKernel.__call__"]
           / host["direct Triton launch, its output allocated"], card))
    # the ratios of the launch path before its redesign (3.3 and 2.1 on an
    # H100 80GB HBM3 at 700 W): a wrapper may not come back above them
    if ratios["Rtc.push"] > 3.3 or ratios["TritonKernel.__call__"] > 2.1:
        raise SystemExit("rtc: wrapper host cost ratios %s past those before "
                         "the launch path's redesign (3.3, 2.1)" % ratios)
    return err, host


def host_costs(fns, rounds=5, n=2000):
    """Median host microseconds a call of each of ``fns``, timed in turns
    (the order reversed every other round)."""
    got = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            got[name].append(host_us(fns[name], n))
    return {name: float(np.median(v)) for name, v in got.items()}


# ---------------------------------------------------------------------------
# bind phase: ResNet-50 bound with simple_bind, trained by hand
# ---------------------------------------------------------------------------

def rtc_update(kernel, params, grads, moms, hps):
    """The SGD-momentum update of every parameter through one Rtc kernel,
    one push per array, in place."""
    for n, w in params.items():
        grid, block = rtc_grid(w.size)
        kernel.push([grads[n], hps[n]], [w, moms[n]], grid, block)


def triton_update(kernel, params, grads, moms):
    """The same update through one TritonKernel, one launch per array; the
    arrays are rebound to its outputs."""
    for n, w in params.items():
        new_w, new_m = kernel(w, grads[n], moms[n], w.size, SGD["lr"],
                              SGD["momentum"], SGD["wd"],
                              SGD["rescale_grad"])
        w._set_data(new_w.data)
        moms[n]._set_data(new_m.data)


def plain_update(params, grads, moms):
    """nd.sgd_mom_update over every array (the plain version)."""
    import mxnet_tpu_torch as mt
    for n, w in params.items():
        mt.nd.sgd_mom_update(w, grads[n], moms[n], out=[w, moms[n]], **SGD)


def update_excess(w, m, w0, g, m0):
    """How far a kernel's (w, m) from (w0, g, m0) exceeds the stated bound
    around nd.sgd_mom_update's result: the new momentum within 2 float32
    ulps of |momentum*m0| + lr*(rescale*|g| + wd*|w0|) (fma contraction of
    the two products skips up to two roundings), the weight within that
    plus one ulp of |w0| + |m|. Returns (excess, max |diff|) over w and m."""
    import torch
    import mxnet_tpu_torch as mt
    W, M = mt.nd.NDArray(w0.clone()), mt.nd.NDArray(m0.clone())
    mt.nd.sgd_mom_update(W, mt.nd.NDArray(g), M, out=[W, M], **SGD)
    ulp = 2.0 ** -23
    mag = (SGD["momentum"] * m0.abs() + SGD["lr"] * (
        SGD["rescale_grad"] * g.abs() + SGD["wd"] * w0.abs()))
    dm = (m - M.data).abs()
    dw = (w - W.data).abs()
    excess = max(float((dm - 2 * ulp * mag).max()),
                 float((dw - 2 * ulp * mag - ulp * (w0.abs() + m.abs()))
                       .max()))
    return excess, max(float(dm.max()), float(dw.max()))


def scaled_excess(got, want, frac):
    """max |got - want| over ``frac`` times the array's largest |want|
    (a ratio <= 1 passes)."""
    return float((got - want).abs().max()) / max(
        frac * float(want.abs().max()), 1e-30)


def bind_phase(seed, reps, card):
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import initializer, models, rtc
    from mxnet_tpu_torch.train_step import TrainStep
    nd = mt.nd
    dev = mt.gpu(0).to_device()
    bsz, img = RESNET_BATCH, RESNET_IMAGE
    dshape = (bsz, 3, img, img)
    torch.cuda.reset_peak_memory_stats()
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=RESNET_CLASSES, num_layers=50,
                            image_shape="3,%d,%d" % (img, img),
                            layout="NCHW")
    data_names = ("data", "softmax_label")
    pnames = [n for n in sym.list_arguments() if n not in data_names]
    req = {n: ("null" if n in data_names else "write")
           for n in sym.list_arguments()}
    problems = []
    # the checks with cuDNN's deterministic algorithms, the times without
    with no_tf32(), deterministic_cudnn():
        t0 = time.perf_counter()
        exe = sym.simple_bind(mt.gpu(0), grad_req=req, data=dshape,
                              softmax_label=(bsz,))
        attrs = sym.attr_dict()
        saved = mt.random.get_state()
        mt.random.seed(seed)
        init = initializer.Xavier()
        for n in pnames + exe.aux_names:
            init(initializer.InitDesc(n, attrs.get(n, {})),
                 exe.arg_dict[n] if n in exe.arg_dict else exe.aux_dict[n])
        mt.random.set_state(saved)
        params = {n: exe.arg_dict[n] for n in pnames}
        grads = {n: exe.grad_dict[n] for n in pnames}
        nparam = sum(w.size for w in params.values())
        torch.cuda.synchronize()
        log("bind: resnet-50 NCHW %dx%d b=%d float32 bound with simple_bind "
            "on %s in %.2f s: %d parameter arrays (%d values), %d aux states"
            % (img, img, bsz, exe._device, time.perf_counter() - t0,
               len(pnames), nparam, len(exe.aux_names)))
        if (len(pnames), nparam, len(exe.aux_names)) != (161, 25557032, 106):
            raise SystemExit("bind: expected 161 arrays, 25,557,032 values "
                             "and 106 aux states")
        w0 = {n: w.data.clone() for n, w in params.items()}
        aux0 = {n: a.data.clone() for n, a in exe.aux_dict.items()}
        moms = {n: nd.zeros(w.shape, ctx=mt.gpu(0)) for n, w in
                params.items()}
        hps = {n: nd.array([SGD["lr"], SGD["momentum"], SGD["wd"],
                            SGD["rescale_grad"], w.size], ctx=mt.gpu(0))
               for n, w in params.items()}
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 4)
        batches = [{"data": torch.randn(dshape, generator=gen, device=dev),
                    "softmax_label": torch.randint(
                        0, RESNET_CLASSES, (bsz,), generator=gen,
                        device=dev).float()} for _ in range(2)]
        first = pnames[0]
        k_rtc = rtc.Rtc("sgd_mom", [("g", grads[first]), ("hp", hps[first])],
                        [("w", params[first]), ("mom", moms[first])],
                        RTC_SGD)
        k_tri = triton_kernels()["sgd_mom"]

        # grad_req="add": two backward passes give twice one
        exe_add = sym.bind(
            mt.gpu(0), exe.arg_dict,
            args_grad={n: nd.zeros(params[n].shape, ctx=mt.gpu(0))
                       for n in pnames},
            grad_req={n: ("add" if n in pnames else "null")
                      for n in sym.list_arguments()},
            aux_states={n: nd.NDArray(a.clone()) for n, a in aux0.items()})
        exe_add.forward(is_train=True, **batches[0])
        exe_add.backward()
        once = {n: g.data.clone() for n, g in exe_add.grad_dict.items()}
        exe_add.backward()
        worst_add = max(scaled_excess(exe_add.grad_dict[n].data, 2 * g,
                                      GRAD_TOL) for n, g in once.items())
        del exe_add
        log("bind: grad_req='add' after two backward passes: max |g - 2 g1| "
            "is %.3g of the tolerance (%g of the array's largest gradient)"
            % (worst_add, GRAD_TOL))
        if worst_add > 1:
            problems.append("grad_req='add' over two passes is not twice "
                            "the gradient")

        # the main path: two steps, counts at 0 just before, read just after
        rtc.RTC_LAUNCHES = 0
        rtc.TRITON_LAUNCHES = 0
        exe.forward(is_train=True, **batches[0])
        exe.backward()
        g1 = {n: g.data.clone() for n, g in grads.items()}
        rtc_update(k_rtc, params, grads, moms, hps)
        w1 = {n: w.data.clone() for n, w in params.items()}
        m1 = {n: m.data.clone() for n, m in moms.items()}
        aux1 = {n: a.data.clone() for n, a in exe.aux_dict.items()}
        exe.forward(is_train=True, **batches[1])
        exe.backward()
        g2 = {n: g.data.clone() for n, g in grads.items()}
        triton_update(k_tri, params, grads, moms)
        torch.cuda.synchronize()
        launches = {"cuda": rtc.RTC_LAUNCHES, "triton": rtc.TRITON_LAUNCHES}
        log("bind: two steps launched the Rtc update %d times and the "
            "TritonKernel update %d times" % (launches["cuda"],
                                             launches["triton"]))
        if launches != {"cuda": 161, "triton": 161}:
            problems.append("expected 161 launches of each update")
        for step, g in ((1, g1), (2, g2)):
            bad = [n for n, v in g.items() if not bool(torch.isfinite(v)
                                                       .all())]
            if bad:
                problems.append("step %d: non-finite gradients %s"
                                % (step, bad[:3]))
        worst_write = max(scaled_excess(g1[n], once[n], GRAD_TOL)
                          for n in pnames)
        log("bind: step-1 gradients against the grad_req='add' executor's "
            "first pass: %.3g of the tolerance" % worst_write)
        if worst_write > 1:
            problems.append("write and add gradients differ")

        # each update against nd.sgd_mom_update on the same tensors
        err = {}
        for route, (wa, ma, wb, gb, mb) in (
                ("cuda", (w1, m1, w0, g1, None)),
                ("triton", ({n: p.data for n, p in params.items()},
                            {n: m.data for n, m in moms.items()},
                            w1, g2, m1))):
            ex, diff = 0.0, 0.0
            for n in pnames:
                e, d = update_excess(wa[n], ma[n], wb[n], gb[n],
                                     torch.zeros_like(wb[n]) if mb is None
                                     else mb[n])
                ex, diff = max(ex, e), max(diff, d)
            err[route] = diff
            log("bind: %s update of step %d against nd.sgd_mom_update: max "
                "|diff| %g, %s the stated ulp bound" % (
                    "Rtc" if route == "cuda" else "TritonKernel",
                    1 if route == "cuda" else 2, diff,
                    "within" if ex <= 0 else "PAST"))
            if ex > 0:
                problems.append("%s update differs from nd.sgd_mom_update"
                                % route)

        # the Rtc update of step 1 captured once into a CUDA graph after a
        # warm eager update, replayed from a fresh copy of step 1's start
        gw = {n: nd.NDArray(w0[n].clone()) for n in pnames}
        gm = {n: nd.zeros(w0[n].shape, ctx=mt.gpu(0)) for n in pnames}
        gg = {n: nd.NDArray(g1[n].clone()) for n in pnames}
        rtc_update(k_rtc, gw, gg, gm, hps)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            rtc_update(k_rtc, gw, gg, gm, hps)
        for n in pnames:
            gw[n].data.copy_(w0[n])
            gm[n].data.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same = all(torch.equal(gw[n].data, w1[n]) and
                   torch.equal(gm[n].data, m1[n]) for n in pnames)
        ex = max(update_excess(gw[n].data, gm[n].data, w0[n], g1[n],
                               torch.zeros_like(w0[n]))[0] for n in pnames)
        log("bind: the Rtc update captured in a CUDA graph (161 kernels) and "
            "replayed from step 1's start %s the eager Rtc update bit for "
            "bit, %s the stated ulp bound around nd.sgd_mom_update"
            % ("equals" if same else "DIFFERS from",
               "within" if ex <= 0 else "PAST"))
        if not same or ex > 0:
            problems.append("the captured Rtc update differs from the eager "
                            "one")

        # the same two steps through TrainStep from the same state
        ts = TrainStep(sym, optimizer="sgd", learning_rate=SGD["lr"],
                       momentum=SGD["momentum"], wd=SGD["wd"],
                       compute_dtype=None)
        st = ts.init({"data": dshape}, {"softmax_label": (bsz,)}, seed=seed)
        finals = ({n: p.data for n, p in params.items()},
                  {n: m.data for n, m in moms.items()},
                  {n: a.data for n, a in exe.aux_dict.items()})
        starts = ((w0, None, aux0), (w1, m1, aux1))
        for step, (wb, mb, ab) in ((1, (w1, m1, aux1)), (2, finals)):
            # each step from the state the bind step started from
            sw, sm, sa = starts[step - 1]
            for n in pnames:
                st["params"][n].copy_(sw[n])
                st["opt"][n].copy_(0 if sm is None else sm[n])
            for n in exe.aux_names:
                st["aux"][n].copy_(sa[n])
            ts.step(st, batches[step - 1])
            torch.cuda.synchronize()
            # tolerances: weights and momenta within 1e-3 of the array's
            # largest momentum (the step's size), as pooling's backward
            # may still sum in another order and the user kernels contract
            # into fmas; moving statistics within 1e-5 of the array's
            # largest value
            rw = max(float((wb[n] - st["params"][n]).abs().max())
                     / max(1e-3 * float(st["opt"][n].abs().max()), 1e-30)
                     for n in pnames)
            rm = max(scaled_excess(mb[n], st["opt"][n], 1e-3) for n in pnames)
            ra = max(scaled_excess(ab[n], st["aux"][n], 1e-5)
                     for n in exe.aux_names)
            log("bind: after step %d against TrainStep(compute_dtype=None): "
                "weights %.3g, momenta %.3g (of 1e-3 of the largest "
                "momentum), moving statistics %.3g (of 1e-5 of the largest)"
                % (step, rw, rm, ra))
            if max(rw, rm, ra) > 1:
                problems.append("step %d differs from TrainStep" % step)

    with no_tf32():
        def bind_step():
            exe.forward(is_train=True, **batches[0])
            exe.backward()
            rtc_update(k_rtc, params, grads, moms, hps)

        t_bind = time_steps(bind_step, reps)
        t_ts = time_steps(lambda: ts.step(st, batches[0]), reps)
        for what, t in (("bind step (forward, backward, Rtc update)",
                         t_bind), ("TrainStep float32 step", t_ts)):
            log("bind: %s %.3f ms, %.1f images/s (host clock, median of "
                "%d) [%s]" % (what, 1e3 * t, bsz / t, reps, card))
        ws = {n: nd.NDArray(w.data.clone()) for n, w in params.items()}
        ms_ = {n: nd.NDArray(m.data.clone()) for n, m in moms.items()}
        fns = {"Rtc": lambda: rtc_update(k_rtc, ws, grads, ms_, hps),
               "TritonKernel": lambda: triton_update(k_tri, ws, grads, ms_),
               "plain nd.sgd_mom_update": lambda: plain_update(ws, grads,
                                                               ms_)}
        if hasattr(torch, "_fused_sgd_"):
            wl = [w.data for w in ws.values()]
            gl = [grads[n].data for n in ws]
            ml = [m.data for m in ms_.values()]
            fns["torch._fused_sgd_"] = lambda: torch._fused_sgd_(
                wl, gl, ml, weight_decay=SGD["wd"],
                momentum=SGD["momentum"], lr=SGD["lr"], dampening=0.0,
                nesterov=False, maximize=False, is_first_step=False)
        log("bind: torch._fused_sgd_ is one call over the 161 arrays; its "
            "momentum buffer differs by a factor lr, so it is a yardstick "
            "of time only")
        # back to back on CUDA events, in turns, the graph replay among them
        fns_ev = dict(fns, **{"Rtc captured, graph.replay()": graph.replay})
        event = dict.fromkeys(fns_ev, 0.0)
        for name in list(fns_ev) + list(fns_ev)[::-1]:
            event[name] += cuda_time_ms(fns_ev[name], 10) / 2
        host_upd = {"Rtc": host_us(fns["Rtc"], 20),
                    "TritonKernel": host_us(fns["TritonKernel"], 20)}
        nbytes = 5 * 4 * nparam + 4 * 5 * len(pnames)
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        log("bind: update of 161 arrays, CUDA-event time (launches back to "
            "back, host gaps included): %s; bound %.6f ms (%d bytes) [%s]"
            % (", ".join("%s %.6f ms" % kv for kv in event.items()), bound,
               nbytes, card))
        kern = {k: kernel_ms(f) for k, f in fns.items()}
        log("bind: update of 161 arrays, kernel time summed by "
            "torch.profiler: %s [%s]" % (", ".join(
                "%s %s" % (k, "not recorded" if v is None else "%.6f ms" % v)
                for k, v in kern.items()), card))
        upd = kern if all(v is not None for v in kern.values()) else event
        if upd is event:
            log("bind: the profiler recorded no device time: the kernels "
                "line reports CUDA-event times")
        log("bind: host time of one update (161 launches): Rtc %.1f us, "
            "TritonKernel %.1f us [%s]" % (host_upd["Rtc"],
                                           host_upd["TritonKernel"], card))
        log("bind: peak device memory %.2f GiB"
            % (torch.cuda.max_memory_allocated() / 2 ** 30))
        profile_step(bind_step, card, "one bind step",
                     ("the Rtc update", ("sgd_mom",)))
    if problems:
        raise SystemExit("bind phase failed: " + "; ".join(problems))
    return launches, err, upd, event, bound


# ---------------------------------------------------------------------------
# imperative phase: nd, autograd and a CustomOp on the card
# ---------------------------------------------------------------------------

_RTC_OPS = {}


def register_rtc_custom_op():
    """A CustomOp (y = 2x) whose forward and backward push Rtc kernels."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import rtc

    def push_scale(src, dst):
        k = _RTC_OPS.get(src.shape)
        if k is None:
            k = _RTC_OPS[src.shape] = rtc.Rtc("scale", [("x", src)],
                                              [("y", dst)], RTC_SCALE)
        grid, block = rtc_grid(src.size)
        k.push([src], [dst], grid, block)

    class RtcScale(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            push_scale(in_data[0], out_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            push_scale(out_grad[0], in_grad[0])

    @mt.operator.register("chip_smoke_rtc_scale")
    class RtcScaleProp(mt.operator.CustomOpProp):
        def declare_backward_dependency(self, out_grad, in_data, out_data):
            return list(out_grad)

        def create_operator(self, ctx, shapes, dtypes):
            return RtcScale()


def imperative_phase(seed, card):
    import torch
    import mxnet_tpu_torch as mt
    nd = mt.nd
    rng = np.random.default_rng(seed + 5)
    gpu, cpu = mt.gpu(0), mt.cpu()
    problems = []
    with no_tf32():
        # nd on the card against the CPU, within 1e-5 of (1 + the result's
        # largest |value|): the CUDA and CPU kernels sum reductions and dot
        # products in other orders, so the error scales with the terms
        worst, worst_op = 0.0, None
        ops = {"arith": lambda x, y: (x + y) * 2 - y / 3,
               "pow": lambda x, y: x ** 2, "rsub": lambda x, y: 1 - x,
               "exp": lambda x, y: nd.exp(x) / (nd.abs(y) + 1),
               "sum": lambda x, y: nd.sum(x, axis=1),
               "max": lambda x, y: nd.max(y, axis=0),
               "mean": lambda x, y: nd.mean(x),
               "norm": lambda x, y: nd.norm(x),
               "dot": lambda x, y: nd.dot(x, y, transpose_b=True),
               "argmax": lambda x, y: nd.argmax(x, axis=1),
               "topk": lambda x, y: nd.topk(y, k=2), "sort": lambda x, y:
               nd.sort(x), "clip": lambda x, y: nd.clip(x, a_min=-0.5,
                                                        a_max=0.5)}
        for shape in ((3, 4), (17, 33), (64, 257)):
            a = rng.standard_normal(shape).astype(np.float32)
            b = rng.standard_normal(shape).astype(np.float32)
            for name, op in ops.items():
                g = op(nd.array(a, ctx=gpu), nd.array(b, ctx=gpu))
                c = op(nd.array(a, ctx=cpu), nd.array(b, ctx=cpu)).asnumpy()
                if g.context != gpu:
                    problems.append("nd.%s's result left the card" % name)
                r = float(np.abs(g.asnumpy() - c).max()) / (
                    1e-5 * (1 + float(np.abs(c).max())))
                if r > worst:
                    worst, worst_op = r, "%s at %s" % (name, shape)
        log("imperative: nd arithmetic and reductions at 3 shapes on the "
            "card against the CPU: %.3g of the tolerance (closest: %s)"
            % (worst, worst_op))
        if worst > 1:
            problems.append("nd on the card differs from the CPU")

        # autograd of a two-layer network against Executor.backward
        x = rng.standard_normal((8, 20)).astype(np.float32)
        vals = {"fc1_weight": rng.standard_normal((32, 20)) * 0.2,
                "fc1_bias": rng.standard_normal((32,)) * 0.1,
                "fc2_weight": rng.standard_normal((10, 32)) * 0.2,
                "fc2_bias": rng.standard_normal((10,)) * 0.1}
        og = rng.standard_normal((8, 10)).astype(np.float32)
        ps = [nd.array(vals[n], ctx=gpu) for n in sorted(vals)]
        gs = [nd.zeros(p.shape, ctx=gpu) for p in ps]
        mt.autograd.mark_variables(ps, gs)
        fc1_b, fc1_w, fc2_b, fc2_w = ps
        with mt.autograd.train_section():
            h = nd.Activation(nd.FullyConnected(nd.array(x, ctx=gpu), fc1_w,
                                                fc1_b, num_hidden=32),
                              act_type="relu")
            out = nd.FullyConnected(h, fc2_w, fc2_b, num_hidden=10)
        mt.autograd.compute_gradient([out], [nd.array(og, ctx=gpu)])
        with mt.symbol.NameManager():
            s = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=32,
                                      name="fc1")
            s = mt.sym.Activation(s, act_type="relu")
            s = mt.sym.FullyConnected(s, num_hidden=10, name="fc2")
        args = {n: nd.array(v, ctx=gpu) for n, v in vals.items()}
        args["data"] = nd.array(x, ctx=gpu)
        eg = {n: nd.zeros(a.shape, ctx=gpu) for n, a in args.items()
              if n != "data"}
        ex = s.bind(gpu, args, args_grad=eg)
        ex.forward(is_train=True)
        ex.backward([nd.array(og, ctx=gpu)])
        # the same cuBLAS products on the same tensors: rtol 1e-6
        worst = max(float(np.abs(g.asnumpy() - eg[n].asnumpy()).max()
                          / (1e-6 * np.abs(eg[n].asnumpy()).max()))
                    for g, n in zip(gs, sorted(vals)))
        log("imperative: autograd gradients of a two-layer network against "
            "Executor.backward on the card: %.3g of the tolerance" % worst)
        if worst > 1:
            problems.append("autograd and Executor gradients differ")

        # a CustomOp pushing Rtc kernels, against _mul_scalar
        register_rtc_custom_op()
        data = rng.standard_normal((8, 20)).astype(np.float32)
        res = []
        for use_rtc in (True, False):
            with mt.symbol.NameManager():
                s = mt.sym.FullyConnected(mt.sym.Variable("data"),
                                          num_hidden=16, name="fc1")
                s = (mt.sym.Custom(s, op_type="chip_smoke_rtc_scale")
                     if use_rtc else mt.sym._mul_scalar(s, scalar=2.0))
                s = mt.sym.FullyConnected(s, num_hidden=4, name="fc2")
            ex = s.simple_bind(gpu, data=(8, 20))
            for n, a in ex.arg_dict.items():
                a[:] = data if n == "data" else np.full(a.shape, 0.1,
                                                        np.float32)
            before = mt.rtc.RTC_LAUNCHES
            out = ex.forward(is_train=True)[0].asnumpy()
            ex.backward([nd.ones((8, 4), ctx=gpu)])
            res.append((out, {n: g.asnumpy() for n, g in ex.grad_dict.items()},
                        mt.rtc.RTC_LAUNCHES - before))
        (o1, g1, l1), (o2, g2, _) = res
        same = np.array_equal(o1, o2) and all(np.array_equal(g1[n], g2[n])
                                              for n in g2)
        log("imperative: a CustomOp pushing Rtc kernels (%d pushes) inside a "
            "bound symbol %s the same network with _mul_scalar"
            % (l1, "equals" if same else "DIFFERS from"))
        if not same or l1 != 2:
            problems.append("the Rtc CustomOp differs from _mul_scalar")
    if problems:
        raise SystemExit("imperative phase failed: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# module phase: ResNet-50 trained through Module.fit, and ResNet-50 served
# ---------------------------------------------------------------------------

#: batches and epochs of the module phase's fits, and the steps per
#: dispatch in (b)
MODULE_BATCHES = 8
MODULE_EPOCHS = 2
MODULE_K = 4
#: the SGD hyper-parameters of the module phase
MODULE_OPT = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))
#: trained parameters and moving statistics, fit against a TrainStep driven
#: by hand: |a - b| <= MODULE_RTOL |b| + MODULE_ATOL elementwise
MODULE_RTOL, MODULE_ATOL = 1e-4, 1e-5
#: the fits' cross-entropy sums (float32 on the host and on the card)
#: against the hand-driven step's, taken in float64
METRIC_CE_RTOL = 1e-5


def xavier_params(sym, dshape, seed):
    """Xavier ``arg_params`` of ``sym`` on the host, from ``seed`` (the
    port's initializer on CPU tensors; BatchNorm gamma 1, beta 0)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import initializer
    shapes, _, _ = sym.infer_shape(data=dshape, softmax_label=(dshape[0],))
    attrs = sym.attr_dict()
    saved = mt.random.get_state()
    mt.random.seed(seed)
    init = initializer.Xavier()
    params = {}
    for n, shape in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        params[n] = mt.nd.zeros(shape, ctx=mt.cpu())
        init(initializer.InitDesc(n, attrs.get(n, {})), params[n])
    mt.random.set_state(saved)
    return params


def max_excess(got, want):
    """(largest relative difference max|a - b| / max|b| over the tensors,
    largest excess over MODULE_RTOL |b| + MODULE_ATOL); both infinite when
    either side holds a NaN or an infinity."""
    import torch
    rel = excess = 0.0
    for n, b in want.items():
        a = got[n].float()
        b = b.float()
        if not bool(torch.isfinite(a).all() and torch.isfinite(b).all()):
            return float("inf"), float("inf")
        d = (a - b).abs()
        rel = max(rel, float(d.max()) / max(float(b.abs().max()), 1e-30))
        excess = max(excess, float(
            (d - MODULE_RTOL * b.abs() - MODULE_ATOL).max()))
    return rel, excess


def module_phase(seed, card):
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.callback import Speedometer
    from mxnet_tpu_torch.model import BatchEndParam
    from mxnet_tpu_torch.ops import matmul_stats as ms
    from mxnet_tpu_torch.train_step import TrainStep
    bsz, img, nb = RESNET_BATCH, RESNET_IMAGE, MODULE_BATCHES
    dshape = (bsz, img, img, 3)
    dev = mt.gpu(0).to_device()
    os.environ["MXTPU_FUSE_CONV_BN"] = "1"
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=RESNET_CLASSES, num_layers=50,
                            image_shape="3,%d,%d" % (img, img),
                            layout="NHWC")
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 6)
    images = rng.standard_normal((nb * bsz,) + dshape[1:], dtype=np.float32)
    labels = rng.integers(0, RESNET_CLASSES, nb * bsz).astype(np.float32)
    arg_params = xavier_params(sym, dshape, seed)
    log("module: resnet-50 NHWC %dx%d b=%d float32, %d host batches and "
        "Xavier arg_params from the seed in %.2f s"
        % (img, img, bsz, nb, time.perf_counter() - t0))
    problems = []
    epochs = MODULE_EPOCHS
    expected = sum(B1_STEP_SHAPES.values()) * nb * epochs
    fits = {}
    with no_tf32(), deterministic_cudnn():
        for name, k in (("a", 1), ("b", MODULE_K)):
            it = mt.io.NDArrayIter(images, labels, batch_size=bsz,
                                   shuffle=False)
            metric = mt.metric.CompositeEvalMetric(
                [mt.metric.Accuracy(), mt.metric.CrossEntropy()])
            mod = mt.mod.Module(sym, context=mt.gpu(0))
            speedo = Speedometer(bsz, frequent=MODULE_K)
            ends, accs = [], []

            def on_batch(param, speedo=speedo):
                # the speed line without resetting the metric under check
                speedo(BatchEndParam(param.epoch, param.nbatch, None,
                                     param.locals))

            def on_epoch(epoch, *_, metric=metric, ends=ends, accs=accs):
                torch.cuda.synchronize()
                ends.append(time.perf_counter())
                accs.append([(m.sum_metric, m.num_inst)
                             for m in metric.metrics])
            torch.cuda.synchronize()
            # the main path: counts at 0 just before, read just after
            ms.LAUNCHES = 0
            for r in ms.LAUNCHES_BY_ROUTE:
                ms.LAUNCHES_BY_ROUTE[r] = 0
            t0 = time.perf_counter()
            mod.fit(it, num_epoch=epochs, eval_metric=metric, optimizer="sgd",
                    optimizer_params=MODULE_OPT, arg_params=arg_params,
                    steps_per_dispatch=k, dispatch_pipeline=1,
                    batch_end_callback=on_batch, epoch_end_callback=on_epoch)
            torch.cuda.synchronize()
            routes = dict(ms.LAUNCHES_BY_ROUTE)
            first, steady = ends[0] - t0, ends[1] - ends[0]
            spec = mod._fused_metric_spec
            fits[name] = {"mod": mod, "accs": accs, "routes": routes,
                          "step_ms": 1e3 * steady / nb,
                          "device_sums": spec is not None and spec.tag}
            log("module (%s) Module.fit steps_per_dispatch=%d, %d epochs of "
                "%d batches: epoch 0 %.3f s, %.1f images/s (bind, init and "
                "the first step included); epoch 1 %.3f s, %.1f images/s, "
                "%.3f ms a step (host clock, each epoch ended by a "
                "synchronize); metric device sums: %s; matmul_stats "
                "launches by route %s [%s]"
                % (name, k, epochs, nb, first, nb * bsz / first, steady,
                   nb * bsz / steady, 1e3 * steady / nb,
                   fits[name]["device_sums"], routes, card))
            if routes != {"wgmma": 0, "wmma": 0, "tf32x3": expected,
                          "f32": 0}:
                problems.append("fit (%s): matmul_stats routes %s, expected "
                                "%d tf32x3" % (name, routes, expected))

        # check 1: a TrainStep driven by hand over the same batches
        opt = mt.optimizer.create(
            "sgd", sym=sym, rescale_grad=1.0 / bsz,
            param_idx2name=dict(enumerate(
                fits["a"]["mod"]._exec_group.param_names)),
            **dict(MODULE_OPT))
        step = TrainStep(sym, optimizer=opt, device=dev)
        state = step.init({"data": dshape}, {"softmax_label": (bsz,)},
                          seed=seed)
        for n, v in arg_params.items():
            state["params"][n].copy_(v.data)
        # the metric's sums by epoch from the hand-driven step's outputs:
        # correct top-1 and the cross-entropy sum (float64, eps 1e-8)
        lab = torch.from_numpy(labels).to(dev).long()
        hand = torch.zeros((epochs, 2), dtype=torch.float64, device=dev)
        t0 = None
        for i in range(epochs * nb):
            if i == nb:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            j = i % nb
            state, outs = step.step(state, {
                "data": images[j * bsz:(j + 1) * bsz],
                "softmax_label": labels[j * bsz:(j + 1) * bsz]})
            p, y = outs[0].double(), lab[j * bsz:(j + 1) * bsz]
            hand[i // nb, 0] += (p.argmax(1) == y).sum()
            hand[i // nb, 1] -= torch.log(p.gather(1, y[:, None])
                                          + 1e-8).sum()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / ((epochs - 1) * nb)
        log("module: the same batches through TrainStep.step alone (host "
            "batches, as fit's k=1 path gets them): %.3f ms a step, %.1f "
            "images/s after the first epoch; Module.fit's epoch 1 took "
            "%+.3f ms a step more at k=1 and %+.3f at k=%d [%s]"
            % (step_ms, 1e3 * bsz / step_ms, fits["a"]["step_ms"] - step_ms,
               fits["b"]["step_ms"] - step_ms, MODULE_K, card))
        want = dict(state["params"], **state["aux"])
        for name in ("a", "b"):
            arg, aux = fits[name]["mod"].get_params()
            got = {n: v.data for n, v in dict(arg, **aux).items()}
            rel, excess = max_excess(got, want)
            log("module check 1 (%s): parameters and moving statistics after "
                "fit against a TrainStep driven by hand over the same %d "
                "steps: largest relative difference %g (tolerance rtol %g, "
                "atol %g elementwise)" % (name, epochs * nb, rel,
                                          MODULE_RTOL, MODULE_ATOL))
            if excess > 0:
                problems.append("fit (%s) differs from the hand-driven "
                                "TrainStep beyond the tolerance, or is not "
                                "finite" % name)
        # check 2: the host metric (a) against the device sums (b), and
        # both against the sums of the hand-driven step's outputs
        ref = [(float(c), float(ce)) for c, ce in hand.tolist()]
        for name in ("a", "b"):
            got = fits[name]["accs"]
            log("module check 2 (%s): (correct, count) and (cross-entropy "
                "sum, count) by epoch %s; from the hand-driven TrainStep's "
                "outputs (correct, cross-entropy sum) %s"
                % (name, got, ref))
            for (correct, n), (ce, n_ce), (rc, rce) in zip(
                    [e[0] for e in got], [e[1] for e in got], ref):
                if (n, n_ce) != (nb * bsz, nb * bsz) or correct != rc \
                        or not abs(ce - rce) <= METRIC_CE_RTOL * abs(rce):
                    problems.append(
                        "fit (%s) metric sums %s differ from the "
                        "hand-driven step's %s (correct to the count, "
                        "cross-entropy within rtol %g)"
                        % (name, got, ref, METRIC_CE_RTOL))
                    break
        if [e[0] for e in fits["a"]["accs"]] \
                != [e[0] for e in fits["b"]["accs"]]:
            problems.append("accuracy differs across k")
        if fits["a"]["device_sums"] or fits["b"]["device_sums"] != "acc+ce":
            problems.append("the metric took the device sums in (a) or "
                            "not in (b): %s, %s"
                            % (fits["a"]["device_sums"],
                               fits["b"]["device_sums"]))

        # check 4: a checkpoint round trip on the card
        mod = fits["b"]["mod"]
        it = mt.io.NDArrayIter(images, labels, batch_size=bsz)
        with tempfile.TemporaryDirectory() as tmp:
            prefix = os.path.join(tmp, "resnet50")
            mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
            loaded = mt.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                        context=mt.gpu(0))
            loaded.bind(it.provide_data, it.provide_label)
            loaded.init_optimizer(optimizer="sgd",
                                  optimizer_params=MODULE_OPT)
        score = dict(mod.score(it, ["acc", "ce"]))
        score_loaded = dict(loaded.score(it, ["acc", "ce"]))
        mod._sync_fused_opt_states()
        moms_equal = all(
            torch.equal(loaded._updater.states[i].data.cpu(), st.data.cpu())
            for i, st in mod._updater.states.items())
        log("module check 4: save_checkpoint + Module.load on the card: "
            "score %s, trained module's %s; momentum equal: %s"
            % (score_loaded, score, moms_equal))
        if score_loaded != score or not moms_equal:
            problems.append("the loaded checkpoint scores %s, the trained "
                            "module %s (momentum equal: %s)"
                            % (score_loaded, score, moms_equal))
        del loaded, fits

        # check 3: at each shape the tf32x3 route and the SIMT f32 kernel
        # (forced) against the plain version; their times a step against
        # torch.matmul f32 and the plain version, each against its bound
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 7)
        keys = ("tf32x3", "f32", "torch.matmul f32", "plain")
        per_step = dict.fromkeys(keys, 0.0)
        bound_step = {"tf32x3": 0.0, "f32": 0.0, "bytes": 0.0}
        max_err = 0.0
        for (m, kk, n), count in B1_STEP_SHAPES.items():
            x = torch.randn((m, kk), generator=gen, device=dev)
            w = torch.randn((n, kk), generator=gen, device=dev) / kk ** 0.5
            before = dict(ms.LAUNCHES_BY_ROUTE)
            err, e1, e2 = b1_check(ms, x, w)
            simt = b1_check(ms, x, w, "f32")
            took = b1_routes_since(ms, before)
            if (took["tf32x3"], took["f32"]) != (2, 2):
                problems.append("matmul_stats f32 %s took routes %s"
                                % ((m, kk, n), took))
            max_err = max(max_err, err, simt[0])
            fns = {"tf32x3": lambda: ms.matmul_stats(x, w),
                   "f32": lambda: ms._launch(x, w, "f32"),
                   "torch.matmul f32": lambda: torch.matmul(x, w.t()),
                   "plain": lambda: ms.matmul_stats_reference(x, w)}
            # CUDA events around back-to-back calls, in turns (a b c d d c
            # b a): at 0.09-1.3 ms a launch the wrapper's host time hides
            # under the kernel. (The profiler loses kernel records after the
            # bind phase: device_ms_by_kernel)
            ev = dict.fromkeys(keys, 0.0)
            for key in keys + keys[::-1]:
                ev[key] += cuda_time_ms(fns[key], 5) / 2
            bound, by = b1_bound_ms(m, kk, n, "tf32x3")
            simt_bound = b1_bound_ms(m, kk, n, "f32")[0]
            log("matmul_stats f32 (M, K, N) = (%d, %d, %d) x%d: max |y - "
                "plain| %g (tf32x3), %g (f32), s1 %.3g, s2 %.3g (tf32x3); "
                "ms (CUDA events, back to back, in turns): tf32x3 %.6f, f32 "
                "SIMT %.6f, torch.matmul f32 (TF32 off) %.6f, plain %.6f; "
                "tf32x3 bound %.6f ms (%s), share %.3f; FP32 SIMT bound "
                "%.6f ms [%s]"
                % (m, kk, n, count, err, simt[0], e1, e2, ev["tf32x3"],
                   ev["f32"], ev["torch.matmul f32"], ev["plain"], bound,
                   by, bound / ev["tf32x3"], simt_bound, card))
            for key in keys:
                per_step[key] += count * ev[key]
            bound_step["tf32x3"] += count * bound
            bound_step["f32"] += count * simt_bound
            if by == "bytes":
                bound_step["bytes"] += count * bound
            del x, w
        log("matmul_stats float32 per ResNet-50 step (%d launches), ms (CUDA "
            "events, in turns): tf32x3 %.6f, f32 SIMT %.6f, torch.matmul "
            "f32 %.6f, plain %.6f; tf32x3 bound %.6f ms (3xTF32 at %.0f "
            "TFLOP/s, HBM %.2f TB/s), share %.3f; FP32 SIMT bound %.6f ms "
            "(%.0f TFLOP/s), f32 SIMT share %.3f [%s]"
            % (sum(B1_STEP_SHAPES.values()), per_step["tf32x3"],
               per_step["f32"], per_step["torch.matmul f32"],
               per_step["plain"], bound_step["tf32x3"],
               TF32_OPS_PER_S / 1e12, HBM_BYTES_PER_S / 1e12,
               bound_step["tf32x3"] / per_step["tf32x3"], bound_step["f32"],
               FP32_OPS_PER_S / 1e12, bound_step["f32"] / per_step["f32"],
               card))
        if not per_step["tf32x3"] < min(per_step["f32"], per_step["plain"]):
            problems.append("the tf32x3 route (%.6f ms a step) is not below "
                            "the SIMT f32 route (%.6f) and the plain version "
                            "(%.6f)" % (per_step["tf32x3"], per_step["f32"],
                                        per_step["plain"]))

        # a step's device time, fused against unfused
        os.environ["MXTPU_FUSE_CONV_BN"] = "0"
        unfused = TrainStep(sym, optimizer=opt, device=dev)
        os.environ["MXTPU_FUSE_CONV_BN"] = "1"
        batch = {"data": torch.from_numpy(images[:bsz]).to(dev),
                 "softmax_label": torch.from_numpy(labels[:bsz]).to(dev)}
        twin = clone_state(state)
        step_ms = {"fused": cuda_time_ms(lambda: step.step(state, batch), 3),
                   "unfused": cuda_time_ms(lambda: unfused.step(twin, batch),
                                           3)}
        log("module: one float32 TrainStep step, CUDA events around 3 back "
            "to back (the card sets their pace): fused (MXTPU_FUSE_CONV_BN=1) "
            "%.3f ms, unfused %.3f ms [%s]"
            % (step_ms["fused"], step_ms["unfused"], card))
    if problems:
        raise SystemExit("module phase failed: " + "; ".join(problems))
    return {"name": "matmul_stats_f32", "route": "cuda",
            "kernel_route": "tf32x3",
            "source": "mxnet_tpu_torch/csrc/matmul_stats.cu",
            "replaces": "mxnet_tpu/ops/pallas_fused.py:49",
            "launches": 2 * expected, "max_abs_err": max_err,
            "ms": per_step["tf32x3"], "ms_source": "cuda_events",
            "plain_ms": per_step["plain"],
            "bound_ms": bound_step["tf32x3"],
            "bound_by": ("bytes" if 2 * bound_step["bytes"]
                         >= bound_step["tf32x3"] else "operations"),
            "library_ms": per_step["torch.matmul f32"],
            "simt_ms": per_step["f32"], "simt_bound_ms": bound_step["f32"]}


def resnet_serve_phase(seed, reps, card):
    """ResNet-50 (NCHW, 3x224x224, 1000 classes) served through
    ServingEngine on the card, buckets (1, 8, 32): the outputs are finite
    probabilities, and the p50 latency per bucket."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.serving import ServingEngine
    shape = (3, RESNET_IMAGE, RESNET_IMAGE)
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=RESNET_CLASSES, num_layers=50,
                            image_shape="3,%d,%d" % shape[1:])
    params = xavier_params(sym, (1,) + shape, seed)
    _, _, aux_shapes = sym.infer_shape(data=(1,) + shape)
    aux = {n: (mt.nd.ones if n.endswith("_var") else mt.nd.zeros)(
        sh, ctx=mt.cpu()) for n, sh in zip(sym.list_auxiliary_states(),
                                           aux_shapes)}
    rng = np.random.default_rng(seed + 8)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "resnet50")
        mt.model.save_checkpoint(prefix, 0, sym, params, aux)
        eng = ServingEngine(prefix + "-symbol.json", prefix + "-0000.params",
                            {"data": shape}, buckets=BUCKETS)
    for n in (1, 5, 8, 32):
        out = eng.infer({"data": rng.random((n,) + shape,
                                            dtype=np.float32)})[0]
        sums = out.sum(axis=1)
        if (out.shape != (n, RESNET_CLASSES) or not np.isfinite(out).all()
                or np.abs(sums - 1).max() > 1e-4):
            raise SystemExit("resnet-50 serve n=%d: output %s, finite %s, "
                             "row sums off by %g" % (
                                 n, out.shape, np.isfinite(out).all(),
                                 np.abs(sums - 1).max()))
    for b in BUCKETS:
        x = {"data": rng.random((b,) + shape, dtype=np.float32)}
        eng.infer(x)
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            eng.infer(x)
            ts.append(time.perf_counter() - t)
        log("resnet-50 serve bucket %d: p50 %.3f ms over %d requests (host "
            "clock, input copy and output copy included) [%s]"
            % (b, 1e3 * float(np.median(ts)), reps, card))


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
    cuda_build.build(["multibox_nms", "matmul_stats", "rtc_launch"])
    log("build: %.2f s" % (time.perf_counter() - t0))
    for name, text in cuda_build.BUILD_LOG.items():
        for line in text.splitlines():
            log("  nvcc %s: %s" % (name, line))

    rng = np.random.default_rng(args.seed)
    nms = kernel_phase(rng, max(20, 10 * args.reps), card)
    b1 = b1_phase(args.seed, args.reps, card)
    nms["launches"] = serve_phase(args.seed, args.reps, card)
    b1["launches"] = train_phase(args.seed, card)
    rtc_err, rtc_host = rtc_phase(args.seed, args.reps, card)
    launches, upd_err, upd, event, bound = bind_phase(args.seed, 3, card)
    upd_source = "cuda_events" if upd is event else "profiler"
    imperative_phase(args.seed, card)
    b1_f32 = module_phase(args.seed, card)
    resnet_serve_phase(args.seed, args.reps, card)
    b3 = []
    for route, wrapper, call in (("cuda", "Rtc", "Rtc.push"),
                                 ("triton", "TritonKernel",
                                  "TritonKernel.__call__")):
        b3.append({"name": "rtc_%s" % route, "route": route,
                   "source": "mxnet_tpu_torch/rtc.py",
                   "replaces": "mxnet_tpu/rtc.py:83",
                   "launches": launches[route],
                   "max_abs_err": max(rtc_err[route], upd_err[route]),
                   "ms": upd[wrapper], "ms_source": upd_source,
                   "plain_ms": upd["plain nd.sgd_mom_update"],
                   "bound_ms": bound, "bound_by": "bytes",
                   "library_ms": upd.get("torch._fused_sgd_"),
                   "event_ms": event[wrapper], "host_us": rtc_host[call]})
    b3[0]["graph_ms"] = event["Rtc captured, graph.replay()"]

    log(card)
    log(json.dumps({"kernels": [nms, b1, b1_f32] + b3}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
