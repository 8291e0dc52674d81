#!/usr/bin/env python3
"""Drive the PyTorch port (mxnet_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--reps N]

Phases, each of which must pass (nothing is caught; any failure exits
non-zero):

1. device: requires CUDA; prints the card's name and power limit
   (nvidia-smi) and the float32 convolution precision the engine uses.
2. build: compiles every CUDA kernel of the served path from the sources
   in the checkout (one nvcc per source, all started together).
3. kernels: holds each kernel against its plain PyTorch version on the
   same CUDA tensors (the NMS masks must be exactly equal) and times both
   with CUDA events at the shapes the served path gives them.
4. serve: builds the SSD detector at its full width (models/ssd.py
   get_symbol() defaults, 3x300x300 input) with weights from --seed,
   writes symbol JSON and .params through the port, loads them in
   ServingEngine on cuda:0 with buckets (1, 8, 32) and serves requests of
   1, 5, 8, 32 and 40 images. Checks shapes, finiteness, that the kernels
   ran, and that the detections equal MultiBoxDetection with the plain NMS
   on the same heads. Then times p50 latency per bucket.

The line before the last is {"kernels": [...]} (per kernel: launches on
the served path, max error against the plain version, times and bound);
the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
#: float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

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
    from mxnet_tpu_torch.serving import engine as _engine

    card = gpu_name_and_power()
    log("device: %s | torch %s, CUDA %s" % (card, torch.__version__,
                                           torch.version.cuda))
    log("float32 convolutions: ServingEngine runs them with TF32 %s "
        "(PyTorch's default cudnn.allow_tf32 here is %s)"
        % ("on" if _engine.CONV_TF32 else "off",
           torch.backends.cudnn.allow_tf32))

    t0 = time.perf_counter()
    cuda_build.build(["multibox_nms"])
    log("build: %.2f s" % (time.perf_counter() - t0))
    for name, text in cuda_build.BUILD_LOG.items():
        for line in text.splitlines():
            log("  nvcc %s: %s" % (name, line))

    rng = np.random.default_rng(args.seed)
    nms = kernel_phase(rng, max(20, 10 * args.reps), card)
    nms["launches"] = serve_phase(args.seed, args.reps, card)

    log(card)
    log(json.dumps({"kernels": [nms]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
