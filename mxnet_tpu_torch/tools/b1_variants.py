"""Variants of B1's float32 kernel (``csrc/matmul_stats.cu``, route
``tf32x3``), built side by side and held against each other on the card.

Each variant is the committed source with one textual change, so that a
design choice of the kernel is measured against its absence on the same
inputs and card:

- ``committed``: the source as it stands;
- ``prefetch``: the next stage's A is read and split into a second
  register bank while the current stage's wgmma group runs (the committed
  loop does it after the group has completed);
- ``no_fold``: at BN = 128 the running column sums are kept unfolded (64
  registers instead of 32);
- ``one_pass``: x_big w_big alone, one TF32 product: what the two extra
  products buy in accuracy and cost in time (it must miss the tolerance);
- ``bn64``: the committed source with 64-wide N-tiles at every shape (5
  stages instead of 3 where N > 64).

For each variant, each launch at the 12 ResNet-50 step shapes and at TMA
edge shapes is held against ``ops/matmul_stats.matmul_stats_reference``
(full FP32) within ``chip_smoke.py``'s tolerances (y 1e-5 P, s1 and s2
1e-5 of sum P and sum P^2 per column, P = |x| @ |w|.T) and against a
second launch, bitwise. Then the variants' time a launch at each step
shape (CUDA events around back-to-back launches, in turns, the order
reversed every other round) and a step's sum over its 33 launches.

Run from the repo root on a GPU host (it builds the variants with nvcc
under ``mxnet_tpu_torch/_build/variants/``)::

    python -m mxnet_tpu_torch.tools.b1_variants [--rounds 4]

It prints one line per measurement, the card's name and power limit, and
a JSON summary as its last line; it exits non-zero if a variant builds or
launches badly, or if the committed kernel misses the tolerance.
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
from ..ops import matmul_stats as ms

#: the committed main loop of the tf32x3 kernel, from its K-step loop to
#: the accumulators' fence
_SERIAL = """    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(full0 + 8 * s, (it / S) & 1);
      const uint32_t xs = base + s * L::kStageBytes;
      // A of the stage's 4 K-steps: columns 8kk + l % 4 (chunk 2kk) and
      // 8kk + 4 + l % 4 (chunk 2kk + 1), rows srow and srow + 8
      uint32_t ab[kTfBK / 8][4], as[kTfBK / 8][4];
#pragma unroll
      for (int kk = 0; kk < kTfBK / 8; ++kk) {
        const uint32_t p0 = xs + arow + (((2 * kk) ^ sw) << 4);
        const uint32_t p1 = xs + arow + (((2 * kk + 1) ^ sw) << 4);
        split_tf32(lds_f32(p0), ab[kk][0], as[kk][0]);
        split_tf32(lds_f32(p0 + 1024), ab[kk][1], as[kk][1]);
        split_tf32(lds_f32(p1), ab[kk][2], as[kk][2]);
        split_tf32(lds_f32(p1 + 1024), ab[kk][3], as[kk][3]);
      }
      const uint64_t db = wg_desc(xs + kTfXBytes);
      const uint64_t ds = wg_desc(xs + kTfXBytes + L::kWBytes);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kTfBK / 8; ++kk) {
        WgmmaTf32<BN>::mma(d, as[kk], db + 2 * kk, (kt | kk) != 0);
        WgmmaTf32<BN>::mma(d, ab[kk], ds + 2 * kk, 1);
        WgmmaTf32<BN>::mma(d, ab[kk], db + 2 * kk, 1);
      }
      wg_commit();
      wg_wait<0>();
      if (leader) mbar_arrive(empty0 + 8 * s);
    }
    fence_regs(d);
"""

#: the same with the next stage's A read and split into a second register
#: bank while the current stage's group runs (the loop unrolled by two, so
#: that each bank is its own registers)
_PREFETCH = """    struct Frag {
      uint32_t big[kTfBK / 8][4], small[kTfBK / 8][4];
    };
    auto load_a = [&](Frag& f, int s) {
      const uint32_t xs = base + s * L::kStageBytes;
#pragma unroll
      for (int kk = 0; kk < kTfBK / 8; ++kk) {
        const uint32_t p0 = xs + arow + (((2 * kk) ^ sw) << 4);
        const uint32_t p1 = xs + arow + (((2 * kk + 1) ^ sw) << 4);
        split_tf32(lds_f32(p0), f.big[kk][0], f.small[kk][0]);
        split_tf32(lds_f32(p0 + 1024), f.big[kk][1], f.small[kk][1]);
        split_tf32(lds_f32(p1), f.big[kk][2], f.small[kk][2]);
        split_tf32(lds_f32(p1 + 1024), f.big[kk][3], f.small[kk][3]);
      }
    };
    auto step = [&](Frag& f, Frag& next, int kt) {
      const int s = it % S;
      const uint32_t xs = base + s * L::kStageBytes;
      const uint64_t db = wg_desc(xs + kTfXBytes);
      const uint64_t ds = wg_desc(xs + kTfXBytes + L::kWBytes);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kTfBK / 8; ++kk) {
        WgmmaTf32<BN>::mma(d, f.small[kk], db + 2 * kk, (kt | kk) != 0);
        WgmmaTf32<BN>::mma(d, f.big[kk], ds + 2 * kk, 1);
        WgmmaTf32<BN>::mma(d, f.big[kk], db + 2 * kk, 1);
      }
      wg_commit();
      if (kt + 1 < ktiles) {
        mbar_wait(full0 + 8 * ((it + 1) % S), ((it + 1) / S) & 1);
        load_a(next, (it + 1) % S);
      }
      wg_wait<0>();
      if (leader) mbar_arrive(empty0 + 8 * s);
      ++it;
    };
    Frag a0, a1;
    mbar_wait(full0 + 8 * (it % S), (it / S) & 1);
    load_a(a0, it % S);
    for (int kt = 0; kt < ktiles; kt += 2) {
      step(a0, a1, kt);
      if (kt + 1 < ktiles) step(a1, a0, kt + 1);
    }
    fence_regs(d);
"""

#: variant -> (old, new) replacements of the committed source, each old
#: text found exactly once
VARIANTS = {
    "committed": [],
    "prefetch": [(_SERIAL, _PREFETCH)],
    "no_fold": [("using Sums = ColumnSums<BN, (BN > 64 ? 1 : 0)>;",
                 "using Sums = ColumnSums<BN, 0>;")],
    "one_pass": [
        ("        WgmmaTf32<BN>::mma(d, as[kk], db + 2 * kk, (kt | kk) != 0);"
         "\n        WgmmaTf32<BN>::mma(d, ab[kk], ds + 2 * kk, 1);\n"
         "        WgmmaTf32<BN>::mma(d, ab[kk], db + 2 * kk, 1);\n",
         "        WgmmaTf32<BN>::mma(d, ab[kk], db + 2 * kk, (kt | kk) != 0);"
         "\n")],
    "bn64": [],
}

#: variant -> its N-tile width by N, where not ops/matmul_stats.tf32x3_tile_n
TILE_N = {"bn64": lambda n: 64}

#: (M, K, N) of ResNet-50's fused pairs at batch 128 -> pairs a step
STEP_SHAPES = {
    (401408, 64, 64): 1, (401408, 64, 256): 4, (401408, 256, 64): 2,
    (401408, 256, 128): 1, (100352, 128, 512): 4, (100352, 512, 128): 3,
    (100352, 512, 256): 1, (25088, 256, 1024): 6, (25088, 1024, 256): 5,
    (25088, 1024, 512): 1, (6272, 512, 2048): 3, (6272, 2048, 512): 2}
EDGE_SHAPES = [(m, k, n) for m in (1, 17, 100003) for k in (4, 36)
               for n in (4, 132, 260)]
TOL = 1e-5


def log(*a):
    print(*a, flush=True)


def build():
    """Build every variant at once (one nvcc each); {name: entry point}."""
    with open(os.path.join(cuda_build._CSRC, "matmul_stats.cu")) as f:
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
        stem = os.path.join(out_dir, "b1-%s-%s" % (
            name, hashlib.sha256(text.encode()).hexdigest()[:16]))
        with open(stem + ".cu", "w") as f:
            f.write(text)
        procs[name] = (stem + ".so", subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", stem + ".so",
             stem + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit("nvcc failed for variant %s:\n%s" % (name, out))
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "mm_stats_tf32x3_kernel" in line and "Compiling" in line:
                for info in lines[i + 1:i + 4]:
                    if "registers" in info or "spill" in info:
                        log("  nvcc %s: %s" % (name, info.strip()))
        fn = ctypes.CDLL(lib).matmul_stats_tf32x3
        fn.argtypes = [vp] * 6 + [ci] * 6 + [vp]
        fn.restype = ci
        fns[name] = fn
    return fns


class Launch:
    """One shape's operands and buffers, and a launch of a variant on
    them (the wrapper's arguments: the SM count as the persistent grid)."""

    def __init__(self, m, k, n, gen):
        dev = torch.device("cuda", 0)
        self.shape = (m, k, n)
        self.x = torch.randn((m, k), generator=gen, device=dev)
        self.w = torch.randn((n, k), generator=gen, device=dev) / k ** 0.5
        self.rows = torch.cuda.get_device_properties(0).multi_processor_count
        self.wsplit = torch.empty((2, n, k), device=dev)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def __call__(self, fn, tile_n=ms.tf32x3_tile_n):
        m, k, n = self.shape
        y = torch.empty((m, n), device=self.x.device)
        part = torch.empty(((self.rows + 1) * 2 * n,), device=self.x.device)
        stats = part[self.rows * 2 * n:].view(2, n)
        err = fn(self.x.data_ptr(), self.w.data_ptr(), self.wsplit.data_ptr(),
                 y.data_ptr(), part.data_ptr(), stats.data_ptr(), m, n, k,
                 tile_n(n), self.rows, 0, self.stream)
        if err:
            raise SystemExit("launch failed: error %d at %s" % (err,
                                                               self.shape))
        return y, stats[0], stats[1]

    def excess(self, got):
        """Largest error of (y, s1, s2) as a share of its tolerance."""
        yr, r1, r2 = ms.matmul_stats_reference(self.x, self.w)
        p = self.x.abs() @ self.w.abs().t()
        y, s1, s2 = got
        return max(float(((y - yr).abs() / (TOL * p)).max()),
                   float(((s1 - r1).abs() / (TOL * p.sum(0))).max()),
                   float(((s2 - r2).abs() / (TOL * (p * p).sum(0))).max()))


def event_ms(fn, reps=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=4,
                    help="timing rounds in turns at each step shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b1_variants: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log("device: %s | torch %s, CUDA %s" % (card, torch.__version__,
                                           torch.version.cuda))
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    names = list(fns)

    # accuracy and repeatability of every variant at every shape
    worst = dict.fromkeys(names, 0.0)
    unrepeatable = dict.fromkeys(names, 0)
    step = {n: 0.0 for n in names}
    by_shape = {}
    for shape in EDGE_SHAPES + list(STEP_SHAPES):
        op = Launch(*shape, gen)
        for name, fn in fns.items():
            tile_n = TILE_N.get(name, ms.tf32x3_tile_n)
            got, again = op(fn, tile_n), op(fn, tile_n)
            torch.cuda.synchronize()
            worst[name] = max(worst[name], op.excess(got))
            unrepeatable[name] += not all(torch.equal(a, b)
                                          for a, b in zip(got, again))
        if shape in STEP_SHAPES:
            got = {n: [] for n in names}
            for r in range(args.rounds):
                for n in (names if r % 2 == 0 else names[::-1]):
                    got[n].append(event_ms(lambda: op(
                        fns[n], TILE_N.get(n, ms.tf32x3_tile_n))))
            by_shape[str(shape)] = {n: float(np.mean(v))
                                    for n, v in got.items()}
            for n, v in got.items():
                step[n] += STEP_SHAPES[shape] * float(np.mean(v))
            log("ms a launch at (M, K, N) = %s x%d (CUDA events, mean of %d "
                "rounds in turns): %s [%s]"
                % (shape, STEP_SHAPES[shape], args.rounds,
                   ", ".join("%s %.6f" % (n, np.mean(v))
                             for n, v in got.items()), card))
        del op
    log("largest error as a share of the tolerance (<= 1 passes): %s; "
        "launches not bitwise repeatable: %s [%s]"
        % ({n: round(v, 4) for n, v in worst.items()}, unrepeatable, card))
    log("ms a ResNet-50 step (33 launches): %s [%s]"
        % (", ".join("%s %.6f" % (n, v) for n, v in step.items()), card))
    log(card)
    log(json.dumps({"worst_share_of_tolerance": worst,
                    "unrepeatable": unrepeatable, "step_ms": step,
                    "ms_by_shape": by_shape}))
    return 1 if worst["committed"] > 1.0 or unrepeatable["committed"] else 0


if __name__ == "__main__":
    sys.exit(main())
