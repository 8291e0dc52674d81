"""``python -m mxnet_tpu_torch.autotune`` — run one tuning sweep from the
shell (the port's copy of ``mxnet_tpu/autotune/__main__.py``, with
``--device``: ``cuda:0`` by default, ``cpu`` on a host without a card).

    python -m mxnet_tpu_torch.autotune --model mlp --objective img_per_sec \
        --budget 12 --write-db

Progress lines go to stderr; the final result is ONE JSON line on stdout
(the bench house style). Exit status: 0 on a sweep with at least one
successful trial, 2 when every candidate was pruned/crashed/timed out.
"""
from __future__ import annotations

import argparse
import json
import sys


def _values(spec, typ):
    return tuple(typ(s) for s in spec.split(",") if s.strip())


def main(argv=None):
    from . import (DECODE_OBJECTIVES, SERVE_OBJECTIVES, TRAIN_OBJECTIVES,
                   decode_space, serve_space, train_space, tune)
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.autotune",
        description="Search the performance-knob space for one model and "
                    "objective through the in-process bench harnesses; "
                    "optionally persist the winner to the tuning DB.")
    p.add_argument("--model", default="mlp",
                   help="zoo model name (training objectives) or mlp|lenet "
                        "(serving objectives); default mlp")
    p.add_argument("--objective", default="img_per_sec",
                   choices=(list(TRAIN_OBJECTIVES) + list(SERVE_OBJECTIVES)
                            + list(DECODE_OBJECTIVES)))
    p.add_argument("--budget", type=int, default=24,
                   help="max trials (default 24); spaces larger than the "
                        "budget switch from exhaustive grid to greedy "
                        "per-knob hill climb")
    p.add_argument("--batch", type=int, default=None,
                   help="global batch for training objectives (default 32)")
    p.add_argument("--db", default=None,
                   help="tuning DB path (default MXTPU_AUTOTUNE_DB or the "
                        "committed AUTOTUNE_db.json)")
    p.add_argument("--write-db", action="store_true",
                   help="persist the winner to the tuning DB (atomic "
                        "write; the baseline-update workflow)")
    p.add_argument("--trial-timeout", type=float, default=None,
                   help="per-trial wall-clock cap in seconds (default "
                        "MXTPU_AUTOTUNE_TIMEOUT / 120)")
    p.add_argument("--rounds", type=int, default=2,
                   help="measurement rounds per training trial (best-of)")
    p.add_argument("--qps", type=float, default=None,
                   help="offered load for serving objectives (default 100)")
    p.add_argument("--reqs", type=int, default=None,
                   help="requests per serving trial (default 160)")
    p.add_argument("--spd", default=None, metavar="K,K,...",
                   help="steps_per_dispatch candidates (training; default "
                        "1,2,4,8 — list the built-in default FIRST)")
    p.add_argument("--pipeline", default=None, metavar="D,D,...",
                   help="dispatch_pipeline candidates (training; default "
                        "1,0,2)")
    p.add_argument("--buckets", default=None, metavar="SPEC;SPEC;...",
                   help="bucket-set candidates, ';'-separated comma specs "
                        "(serving; default '1,8,32;1,8;1,16,64')")
    p.add_argument("--latency", default=None, metavar="MS,MS,...",
                   help="max_latency_ms candidates (serving; default "
                        "5,2,10)")
    p.add_argument("--spec-k", default=None, metavar="K,K,...",
                   help="speculative draft-depth candidates (decode; "
                        "default 0,2,4 — 0 disables speculation)")
    p.add_argument("--prefix", default=None, metavar="B,B,...",
                   help="prefix_cache candidates as 0/1 (decode; default "
                        "1,0)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-trial progress lines")
    p.add_argument("--device", default=None,
                   help="where the trials run (default cuda:0; 'cpu' on a "
                        "host without a card)")
    args = p.parse_args(argv)

    space = None
    if args.objective in TRAIN_OBJECTIVES:
        if args.spd or args.pipeline:
            space = train_space(
                spd_values=_values(args.spd, int) if args.spd else None,
                pipeline_values=(_values(args.pipeline, int)
                                 if args.pipeline else None))
    elif args.objective in DECODE_OBJECTIVES:
        if args.spec_k or args.prefix:
            space = decode_space(
                spec_k_values=(_values(args.spec_k, int)
                               if args.spec_k else None),
                prefix_values=(_values(args.prefix, int)
                               if args.prefix else None))
    else:
        if args.buckets or args.latency:
            space = serve_space(
                bucket_values=(tuple(s for s in args.buckets.split(";")
                                     if s.strip())
                               if args.buckets else None),
                latency_values=(_values(args.latency, float)
                                if args.latency else None))

    log = (None if args.quiet
           else (lambda msg: print("autotune: %s" % msg,
                                   file=sys.stderr)))
    result = tune(model=args.model, objective=args.objective,
                  budget=args.budget, batch=args.batch, db_path=args.db,
                  write_db=args.write_db, space=space,
                  trial_timeout=args.trial_timeout, qps=args.qps,
                  nreq=args.reqs, rounds=args.rounds, log=log,
                  device=args.device)
    print(json.dumps(result))
    if result["best"] is None:
        print("autotune: no successful trial (counts: %r)"
              % (result["counts"],), file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
