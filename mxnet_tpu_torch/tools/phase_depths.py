"""Seconds of ``chip_smoke.py``'s deepest phases at two depths, on one
host in one call.

The script must finish inside its time limit, so some of its phases run
at a cut depth, and a phase added later is paid for by cutting an earlier
one. This times the phases the latest cut touches as the script runs them
(``new``) and at their depth before that cut (``old``), each phase run in
full with its checks, in turns, beside the phase the cut pays for: phase
15 (the data tier: one timed epoch of each ResNet-50 fit, ``old`` 2, and
the device-resident fit with the decode workers busy beside it on 1/4 of
the records, ``old`` 1/2), phase 17 and phase
21 (the LM's decode legs and the sharded decode: 48 new tokens a request,
``old`` 96), and phase 28 (ImageRecordIter on the card, at its one depth).
Phase 21 takes phase 17's trained weights of the same turn.

Run from the repo root on a GPU host (it builds the kernels first)::

    python -m mxnet_tpu_torch.tools.phase_depths [--turns old,new,new,old]

It prints each phase's seconds a turn, the card's name and power limit,
and a JSON summary as its last line: each phase's seconds by depth, what
the cut saves and what phase 28 costs. A phase whose checks fail ends the
run non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

#: chip_smoke.py's constants at each depth
DEPTHS = {
    "old": {"DATA_BUSY_SHARE": 2, "DATA_EPOCHS": (1, 2), "DEC_NEW": 96},
    "new": {},
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", default="old,new,new,old",
                    help="the depths in the order they run")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("phase_depths: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs    # the repo root is on sys.path under -m
    from mxnet_tpu_torch import cuda_build
    cuda_build.build(["multibox_nms", "matmul_stats", "rtc_launch",
                      "image_augment", "jpeg_decode"])
    card = cs.gpu_name_and_power()
    committed = {k: getattr(cs, k) for k in DEPTHS["old"]}
    DEPTHS["new"] = dict(committed)
    seconds = {}
    for depth in args.turns.split(","):
        for k, v in DEPTHS[depth].items():
            setattr(cs, k, v)
        times = seconds.setdefault(depth, {})

        def timed(name, fn, *a):
            t0 = time.perf_counter()
            out = fn(*a)
            times.setdefault(name, []).append(time.perf_counter() - t0)
            cs.log("phase_depths %s: %s %.1f s %s [%s]"
                   % (depth, name, times[name][-1], DEPTHS[depth], card))
            return out
        timed("15 data", cs.data_phase, args.seed, card)
        lm = timed("17 lm", cs.lm_phase, args.seed, card, {})
        timed("21 mp", cs.mp_phase, args.seed, card, lm)
        timed("28 imagenet", cs.imagenet_phase, args.seed, args.reps, card)
    for k, v in committed.items():
        setattr(cs, k, v)
    summary = {"depths": DEPTHS, "seconds": seconds}
    if "old" in seconds and "new" in seconds:
        cut = [n for n in seconds["new"] if not n.startswith("28")]
        summary["saved"] = {
            name: min(seconds["old"][name]) - min(seconds["new"][name])
            for name in cut}
        summary["saved_total"] = sum(summary["saved"].values())
        summary["phase_28"] = min(seconds["old"]["28 imagenet"]
                                  + seconds["new"]["28 imagenet"])
    cs.log(card)
    cs.log(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
