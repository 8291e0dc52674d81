"""cuDNN's convolution workspace on the card, with and without a cap.

The memory analyzer prices each convolution's cuDNN workspace as the
process saw it take (``memcheck.learn_workspaces``). This measures what a
cap would do instead: cuDNN's ``CUDNN_CONV_WSCAP_DBG`` (mebibytes), alone
on torch's default cuDNN v8 path (``run_conv_plan``) and with
``TORCH_CUDNN_V8_API_DISABLED=1`` (torch's legacy v7 path). Both are read
when a process first runs a convolution, so each configuration runs in a
process of its own, the configurations in turns, the order reversed for
the second half.

Each process serves the full-width SSD (``models/ssd.get_symbol()``
defaults, 3x300x300, random weights from ``--seed``) through
``ServingEngine`` at buckets 1, 8 and 32 and, for each bucket, prints the
dry run's static peak (``memory_report``), the allocator's peak over one
real forward plus the weights, their ratio, the forward's largest
allocation and the p50 of ``--reps`` requests (host clock, copies
included). With ``--resnet`` the first turn of each configuration also
times ``chip_smoke.py``'s bf16 ResNet-50 b=128 training step (CUDA events
over 8 steps after 3).

Run from the repo root on a GPU host::

    python -m mxnet_tpu_torch.tools.conv_workspace [--reps 30]
        [--caps 16,64] [--resnet]

It prints one line a process and bucket, the card's name and power limit,
and a JSON summary as its last line; it exits non-zero if a process
fails.
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

V7 = "TORCH_CUDNN_V8_API_DISABLED"
CAP = "CUDNN_CONV_WSCAP_DBG"
BUCKETS = (1, 8, 32)
INPUT = (3, 300, 300)


def log(*a):
    print(*a, flush=True)


def _ssd(prefix, seed):
    """The full-width SSD and random weights, written as a checkpoint."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import ssd
    with mt.symbol.NameManager():
        net = ssd.get_symbol()
    shapes, _, _ = net.infer_shape(data=(1,) + INPUT)
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in zip(net.list_arguments(), shapes):
        if name == "data":
            continue
        scale = (np.sqrt(2.0 / np.prod(shape[1:]))
                 if name.endswith("_weight") else 0.1)
        params["arg:" + name] = mt.nd.array(
            (rng.standard_normal(shape) * scale).astype(np.float32),
            ctx=mt.cpu())
    net.save(prefix + "-symbol.json")
    mt.nd.save(prefix + "-0000.params", params)


def _largest_alloc(fn):
    """The largest allocation ``fn()`` made on the card, in bytes."""
    import torch
    torch.cuda.memory._record_memory_history(max_entries=100000)
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    trace = snap["device_traces"][torch.cuda.current_device()]
    return max((e["size"] for e in trace if e["action"] == "alloc"),
               default=0)


def _resnet_ms(seed):
    """Milliseconds of a bf16 ResNet-50 b=128 NHWC training step (CUDA
    events over 8 steps after 3)."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.train_step import TrainStep
    os.environ["MXTPU_FUSE_CONV_BN"] = "1"
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=1000, num_layers=50,
                            image_shape="3,224,224", layout="NHWC")
    ts = TrainStep(sym, optimizer="sgd", learning_rate=0.1, momentum=0.9,
                   wd=1e-4, compute_dtype="bfloat16")
    state = ts.init({"data": (128, 224, 224, 3)}, {"softmax_label": (128,)},
                    seed=seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    batch = {"data": torch.randn((128, 224, 224, 3), generator=gen,
                                 device="cuda"),
             "softmax_label": torch.randint(0, 1000, (128,), generator=gen,
                                            device="cuda").float()}
    for _ in range(3):
        ts.step(state, batch)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(8):
        ts.step(state, batch)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / 8


def _child(args):
    import torch
    from mxnet_tpu_torch.serving import ServingEngine
    rng = np.random.default_rng(args.seed + 1)
    out = {"config": args.config, "buckets": {}}
    eng = ServingEngine(args.prefix + "-symbol.json",
                        args.prefix + "-0000.params", {"data": INPUT},
                        buckets=BUCKETS)
    reports = eng.memory_report()
    for b in BUCKETS:
        x = rng.random((b,) + INPUT, dtype=np.float32)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        big = _largest_alloc(lambda: eng.infer({"data": x}))
        measured = (torch.cuda.max_memory_allocated() - base
                    + eng.weight_bytes())
        times = []
        for _ in range(args.reps):
            t = time.perf_counter()
            eng.infer({"data": x})
            times.append(time.perf_counter() - t)
        out["buckets"][b] = {
            "static": reports[b].peak_bytes, "measured": measured,
            "ratio": reports[b].peak_bytes / measured, "largest": big,
            "p50_ms": 1e3 * float(np.median(times))}
    if args.resnet:
        del eng
        torch.cuda.empty_cache()
        out["resnet_ms"] = _resnet_ms(args.seed)
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=30,
                    help="timed requests a bucket")
    ap.add_argument("--caps", default="16,64",
                    help="caps in MiB, each on the v7 path")
    ap.add_argument("--resnet", action="store_true",
                    help="also time the bf16 ResNet-50 step, once a config")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--config", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--prefix", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _child(args)
    import torch
    if not torch.cuda.is_available():
        print("conv_workspace: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log("device: %s | torch %s, CUDA %s, cuDNN %s"
        % (card, torch.__version__, torch.version.cuda,
           torch.backends.cudnn.version()))
    from mxnet_tpu_torch import cuda_build
    cuda_build.build(["multibox_nms"])
    configs = {"v8": {}, "v8 cap 64": {CAP: "64"}}
    for cap in args.caps.split(","):
        configs["v7 cap %s" % cap] = {V7: "1", CAP: cap}
    order = list(configs)
    order += order[::-1]
    results = {c: [] for c in configs}
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "ssd")
        _ssd(prefix, args.seed)
        for turn, config in enumerate(order):
            env = {k: v for k, v in os.environ.items()
                   if k not in (V7, CAP)}
            env.update(configs[config])
            first = turn < len(configs)
            p = subprocess.run(
                [sys.executable, "-m", "mxnet_tpu_torch.tools.conv_workspace",
                 "--child", "1", "--config", config, "--prefix", prefix,
                 "--seed", str(args.seed), "--reps", str(args.reps)]
                + (["--resnet"] if args.resnet and first else []),
                env=env, capture_output=True, text=True, timeout=900)
            got = [ln for ln in p.stdout.splitlines()
                   if ln.startswith("RESULT ")]
            if p.returncode or not got:
                log("conv_workspace: %s failed (exit %d)\n%s"
                    % (config, p.returncode, p.stderr[-3000:]))
                return 1
            r = json.loads(got[0][len("RESULT "):])
            results[config].append(r)
            for b, v in r["buckets"].items():
                log("%-10s bucket %2s: static %d, measured %d (%.4f), "
                    "largest allocation %d, p50 %.3f ms [%s]"
                    % (config, b, v["static"], v["measured"], v["ratio"],
                       v["largest"], v["p50_ms"], card))
            if "resnet_ms" in r:
                log("%-10s ResNet-50 bf16 b=128 step %.3f ms [%s]"
                    % (config, r["resnet_ms"], card))
    log(card)
    log(json.dumps({c: {
        "env": configs[c],
        "p50_ms": {b: [r["buckets"][b]["p50_ms"] for r in rs]
                   for b in rs[0]["buckets"]},
        "ratio": {b: rs[0]["buckets"][b]["ratio"] for b in rs[0]["buckets"]},
        "largest": {b: rs[0]["buckets"][b]["largest"]
                    for b in rs[0]["buckets"]},
        "resnet_ms": rs[0].get("resnet_ms")} for c, rs in results.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
