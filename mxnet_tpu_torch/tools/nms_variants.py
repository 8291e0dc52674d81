"""Variants of B2's cluster kernel (``csrc/multibox_nms.cu``, route
``smem``), built side by side and held against each other on the card.

Each variant is the committed source with one textual change, so that a
design choice of the kernel is measured against its absence on the same
inputs and card:

- ``committed``: the source as it stands;
- ``dense``: the sweep walks every word's 64-row chain, without the visit
  of the acting rows alone (``kSparseRows`` set to -1);
- ``sparse_only``: the sweep always visits the acting rows alone
  (``kSparseRows`` set to 64), however many act;
- ``no_cluster_wait``: without the split cluster barrier (the relaxed
  arrive on entry, the wait before the first store into the leader
  block's shared memory).

For each variant, every launch is held exactly against
``ops/multibox_nms.nms_alive_reference``: k in {64, 400, 1250}, B in {1, 8,
32}, the three kinds of boxes below, with and without ``force``, at every
cluster size (1, 2, 4, 8), each launch repeated ``--repeats`` times back
to back. Then the variants' device time (torch.profiler, the kernel's own
time summed over 50 calls) at B=32 and B=1, k=400, at the wrapper's
cluster size, in turns (the order reversed every other round), on
``chip_smoke.py``'s timing inputs (``rand``), on its 1/8-grid boxes
(``grid``, more overlaps) and on ``pairs`` (every odd row a copy of the
row before it, so that some 30 kept rows of each word act).

Run from the repo root on a GPU host (it builds the variants with nvcc
under ``mxnet_tpu_torch/_build/variants/``)::

    python -m mxnet_tpu_torch.tools.nms_variants [--repeats 25]

It prints one line per measurement, the card's name and power limit, and
a JSON summary as its last line; it exits non-zero if a variant builds or
launches badly, or if the committed kernel disagrees with the plain
version.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .. import cuda_build
from ..context import raw_stream
from ..ops import multibox_nms as mnms

#: variant -> (old, new) replacements of the committed source, each old
#: text found exactly once
VARIANTS = {
    "committed": [],
    "dense": [("constexpr int kSparseRows = 12;",
               "constexpr int kSparseRows = -1;")],
    "sparse_only": [("constexpr int kSparseRows = 12;",
                     "constexpr int kSparseRows = 64;")],
    "no_cluster_wait": [("  cluster_arrive_relaxed();\n", ""),
                        ("  cluster_wait();\n", "")],
}

CLUSTERS = (1, 2, 4, 8)


def log(*a):
    print(*a, flush=True)


def build():
    """Build every variant at once (one nvcc each); {name: entry point}."""
    with open(os.path.join(cuda_build._CSRC, "multibox_nms.cu")) as f:
        src = f.read()
    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit("variant %s: %r is not in the source once"
                                 % (name, old))
            text = text.replace(old, new)
        stem = os.path.join(out_dir, "%s-%s" % (
            name, hashlib.sha256(text.encode()).hexdigest()[:16]))
        with open(stem + ".cu", "w") as f:
            f.write(text)
        procs[name] = (stem + ".so", subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", stem + ".so",
             stem + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit("nvcc failed for variant %s:\n%s" % (name, out))
        for line in out.splitlines():
            if "nms_cluster_kernel" in line or "registers" in line:
                log("  nvcc %s: %s" % (name, line.strip()))
        fn = ctypes.CDLL(lib).multibox_nms_alive_smem
        fn.argtypes = [vp] * 4 + [ci, ci, cf, ci, ci, ci, ci, vp]
        fn.restype = ci
        fns[name] = fn
    return fns


def launch(fn, boxes, score, cls, thresh, force, cluster):
    b, k = score.shape
    out = torch.empty_like(score)
    index = boxes.device.index
    err = fn(boxes.data_ptr(), score.data_ptr(), cls.data_ptr(),
             out.data_ptr(), b, k, mnms._f32_thresh(thresh), int(force),
             cluster, mnms.smem_bytes(k), index, raw_stream(index))
    if err:
        raise SystemExit("launch failed: cudaError %d at B=%d k=%d cluster "
                         "%d" % (err, b, k, cluster))
    return out


def inputs(rng, kind, b, k, dev):
    # chip_smoke.py's generators (the repo root is on sys.path under -m)
    import chip_smoke
    if kind == "grid":
        arrs = chip_smoke.nms_grid_inputs(rng, b, k)
    else:
        arrs = chip_smoke.nms_inputs(rng, b, k, k // 10, k // 5)
    if kind == "pairs":
        boxes, score, cls = arrs
        n = k // 2 * 2
        boxes[:, 1:n:2] = boxes[:, 0:n:2]
        cls[:, 1:n:2] = cls[:, 0:n:2]
    return [torch.from_numpy(a).to(dev) for a in arrs]


def acting_rows(boxes, cls, thresh, force):
    """Mean rows a 64-row word that suppress a later row of the same word,
    and the share of words with at most 12 of them (an upper bound of the
    rows the sweep visits: some are dead by then)."""
    b, k = cls.shape
    sup = mnms._iou(boxes, boxes) > mnms._f32_thresh(thresh)
    if not force:
        sup &= cls[:, :, None] == cls[:, None, :]
    idx = torch.arange(k, device=cls.device)
    same = (idx[:, None] // 64 == idx[None, :] // 64) & (idx[None, :]
                                                         > idx[:, None])
    acting = (sup & same).any(-1).float()
    nwords = (k + 63) // 64
    per_word = torch.nn.functional.pad(acting, (0, nwords * 64 - k)).view(
        b, nwords, 64).sum(-1)
    return float(per_word.mean()), float((per_word <= 12).float().mean())


def device_ms(fn, reps=50):
    """Device ms a call of the cluster kernel, summed by torch.profiler;
    raises when the profiler records none."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(float(getattr(e, "self_device_time_total", 0.0))
                 for e in prof.key_averages()
                 if "nms_cluster_kernel" in e.key)
        if us > 0:
            return us / 1e3 / reps
    raise SystemExit("the profiler recorded no device time")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=25,
                    help="launches of each case at each cluster size")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("nms_variants: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log("device: %s | torch %s, CUDA %s" % (card, torch.__version__,
                                           torch.version.cuda))
    dev = torch.device("cuda", 0)
    fns = build()
    rng = np.random.default_rng(args.seed)

    # exactness: every launch of every variant at every cluster size
    bad = dict.fromkeys(fns, 0)
    total = 0
    for k in (64, 400, 1250):
        for b in (1, 8, 32):
            for kind in ("rand", "grid", "pairs"):
                for force in (False, True):
                    boxes, score, cls = inputs(rng, kind, b, k, dev)
                    want = mnms.nms_alive_reference(boxes, score, cls, 0.5,
                                                    force)
                    for name, fn in fns.items():
                        for c in CLUSTERS:
                            outs = torch.stack([
                                launch(fn, boxes, score, cls, 0.5, force, c)
                                for _ in range(args.repeats)])
                            wrong = int((outs != want).flatten(1).any(1)
                                        .sum())
                            bad[name] += wrong
                            if wrong:
                                log("variant %s: %d of %d launches wrong at "
                                    "k=%d B=%d %s force=%s cluster %d"
                                    % (name, wrong, args.repeats, k, b, kind,
                                       force, c))
                    total += len(CLUSTERS) * args.repeats
    log("exactness: %d launches of each variant (k 64/400/1250, B 1/8/32, "
        "rand, grid and pairs boxes, force off and on, clusters %s); wrong "
        "launches by variant: %s [%s]" % (total, CLUSTERS, bad, card))

    # device time in turns
    names = list(fns)
    times = {}
    for kind in ("rand", "grid", "pairs"):
        for b in (32, 1):
            boxes, score, cls = inputs(rng, kind, b, 400, dev)
            c = mnms.cluster_size(b, torch.cuda.get_device_properties(0)
                                  .multi_processor_count)
            got = {n: [] for n in names}
            for r in range(4):
                for n in (names if r % 2 == 0 else names[::-1]):
                    got[n].append(device_ms(
                        lambda: launch(fns[n], boxes, score, cls, 0.5, False,
                                       c)))
            mean_act, sparse_share = acting_rows(boxes, cls, 0.5, False)
            times["%s B=%d" % (kind, b)] = {n: float(np.mean(v))
                                            for n, v in got.items()}
            log("device ms a call, %s boxes, B=%d k=400 cluster %d (mean "
                "of 4 rounds in turns): %s; acting rows a word %.2f, words "
                "with at most 12 %.3f [%s]"
                % (kind, b, c, ", ".join(
                    "%s %.6f (%s)" % (n, np.mean(v), " ".join(
                        "%.6f" % t for t in v)) for n, v in got.items()),
                   mean_act, sparse_share, card))
    log(card)
    log(json.dumps({"wrong_launches": bad, "launches_each": total,
                    "device_ms": times}))
    return 1 if bad["committed"] else 0


if __name__ == "__main__":
    sys.exit(main())
