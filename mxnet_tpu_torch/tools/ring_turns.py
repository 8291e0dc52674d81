"""The ring's sum over a localhost ``TCPStore``, timed with the
``dist_ring`` of one or more checkouts in turns.

Phase 22 (a) of ``chip_smoke.py`` sums one float32 gradient vector a step
over two ranks (ResNet-50's, 25,557,032 floats) through
``Ring.allreduce_sum`` over ``StoreClient``. This times that sum alone,
without the model: each run starts a store in this process and one
process a rank, with ``PYTHONPATH`` on one checkout's root, so that the
ranks import that checkout's ``mxnet_tpu_torch.dist_ring``. Every rank
writes its heartbeat from a thread on its own connection, sums its own
vector (drawn from ``--seed`` and its rank) once to warm up and then
``--rounds`` times, each timed on the host's clock to its return, and
checks that every sum equals the member-order sum of the ranks' vectors,
bit for bit. The checkouts take turns, the order reversed every other
turn, so that two versions of the ring are compared on one host in one
call.

Run from a checkout's root (nothing here needs a card)::

    python -m mxnet_tpu_torch.tools.ring_turns [--checkouts DIR ...]
        [--turns 4] [--rounds 6] [--floats 25557032] [--ranks 2]

Without ``--checkouts`` it times this checkout alone. It prints one line
a run and, as its last line, a JSON summary: for each checkout the median
milliseconds of a sum over all its runs and ranks, and each run's median.
It exits non-zero if a rank fails or a sum is off.
"""
from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _vector(seed, rank, floats):
    return np.random.default_rng([seed, rank]).standard_normal(
        floats, dtype=np.float32)


def _child(args):
    from mxnet_tpu_torch import dist_ring
    client = dist_ring.StoreClient.connect("127.0.0.1", args.port, 120)
    beat = dist_ring.StoreClient.connect("127.0.0.1", args.port, 120)
    stop = threading.Event()

    def heartbeat():
        while not stop.is_set():
            beat.set(dist_ring.HB_PREFIX + "%d" % args.rank,
                     repr(time.time()))
            stop.wait(1.0)
    hb = threading.Thread(target=heartbeat, daemon=True)
    hb.start()
    ring = dist_ring.Ring(client, args.rank, range(args.ranks))
    vec = _vector(args.seed, args.rank, args.floats)
    ring.allreduce_sum(vec)
    ring.barrier()
    ms, shas = [], set()
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        out = ring.allreduce_sum(vec)
        ms.append(1e3 * (time.perf_counter() - t0))
        shas.add(hashlib.sha256(out.tobytes()).hexdigest())
    ring.barrier()
    stop.set()
    hb.join()
    print(json.dumps({"rank": args.rank, "ms": ms, "sha": sorted(shas),
                      "dist_ring": os.path.abspath(dist_ring.__file__)}))
    return 0


def _run(checkout, args, want_sha):
    import torch.distributed as dist
    master = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                           timeout=datetime.timedelta(seconds=120),
                           wait_for_workers=False)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [checkout] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child",
         "--port", str(master.port), "--rank", str(r),
         "--ranks", str(args.ranks), "--floats", str(args.floats),
         "--rounds", str(args.rounds), "--seed", str(args.seed)],
        cwd=checkout, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(args.ranks)]
    res = []
    for r, p in enumerate(procs):
        out, err = p.communicate(timeout=args.timeout)
        if p.returncode != 0:
            raise SystemExit("ring_turns: rank %d of %s exited %d:\n%s"
                             % (r, checkout, p.returncode, err[-4000:]))
        res.append(json.loads(out.strip().splitlines()[-1]))
    del master
    for r in res:
        if r["sha"] != [want_sha]:
            raise SystemExit("ring_turns: rank %d of %s summed %s, not the "
                             "member-order sum" % (r["rank"], checkout,
                                                   r["sha"]))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkouts", nargs="+", default=[ROOT],
                    help="checkout roots whose dist_ring the ranks import")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--floats", type=int, default=25557032)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _child(args)
    checkouts = [os.path.abspath(c) for c in args.checkouts]
    total = None
    for r in range(args.ranks):              # the ring's member order
        v = _vector(args.seed, r, args.floats)
        total = v.copy() if total is None else total + v
    want_sha = hashlib.sha256(total.tobytes()).hexdigest()
    runs = {c: [] for c in checkouts}
    for t in range(args.turns):
        for c in (checkouts if t % 2 == 0 else checkouts[::-1]):
            res = _run(c, args, want_sha)
            ms = [m for r in res for m in r["ms"]]
            runs[c].append(ms)
            print("ring_turns: turn %d, %s (%s): %.3f ms a sum (median of "
                  "%d over %d ranks), %d floats" % (
                      t, c, res[0]["dist_ring"], float(np.median(ms)),
                      len(ms), args.ranks, args.floats), flush=True)
    print(json.dumps({c: {"median_ms": float(np.median(
        [m for ms in runs[c] for m in ms])),
        "runs_median_ms": [float(np.median(ms)) for ms in runs[c]]}
        for c in checkouts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
