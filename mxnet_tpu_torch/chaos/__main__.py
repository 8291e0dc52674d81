"""CLI for the port's chaos harness.

    python -m mxnet_tpu_torch.chaos --audit-sites
    python -m mxnet_tpu_torch.chaos --emit-plan --seed 7 --scenario train
    python -m mxnet_tpu_torch.chaos --run --seed 7 --scenario serve \
        --workdir DIR [--device cpu]
    python -m mxnet_tpu_torch.chaos --replay plan.json --workdir DIR
    python -m mxnet_tpu_torch.chaos --shrink plan.json --workdir DIR

``--device`` (``gpu``, the default, or ``cpu``) is where the scenario
workers run. ``--scenario-worker`` is internal: the runner spawns it in
the watched subprocess (and, for dist, once per rank through the port's
launcher).
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _build_parser():
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.chaos",
        description="seeded deterministic chaos harness")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--audit-sites", action="store_true",
                      help="cross-check faults.SITES vs the faults.py "
                           "site table vs test coverage")
    mode.add_argument("--emit-plan", action="store_true",
                      help="print the plan JSON for --seed/--scenario")
    mode.add_argument("--run", action="store_true",
                      help="sample a plan for --seed/--scenario, run it, "
                           "check invariants")
    mode.add_argument("--replay", metavar="PLAN_JSON",
                      help="run a saved plan file and check invariants")
    mode.add_argument("--shrink", metavar="PLAN_JSON",
                      help="greedily shrink a failing plan file to a "
                           "minimal failing schedule")
    mode.add_argument("--scenario-worker", metavar="SCENARIO",
                      help=argparse.SUPPRESS)  # internal
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scenario", default="train")
    p.add_argument("--workdir", default=None,
                   help="scratch directory (default: a fresh tempdir)")
    p.add_argument("--deadline", type=float, default=None,
                   help="watchdog override, seconds")
    p.add_argument("--device", choices=("gpu", "cpu"), default=None,
                   help="where the scenario workers run (default: "
                        "MXTPU_CHAOS_DEVICE, else gpu, i.e. cuda:0)")
    p.add_argument("--plan", default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    p.add_argument("--out-dir", default=None, help=argparse.SUPPRESS)
    return p


def _workdir(args, tag):
    if args.workdir:
        os.makedirs(args.workdir, exist_ok=True)
        return args.workdir
    import tempfile
    return tempfile.mkdtemp(prefix="mxtpu-chaos-%s-" % tag)


def _run_and_judge(plan, workdir, deadline):
    from .runner import run_plan
    from .invariants import check_scenario
    outcome = run_plan(plan, workdir, deadline=deadline)
    violations = check_scenario(plan, outcome)
    return outcome, violations


def _report(plan, outcome, violations):
    print("plan [%s seed=%d]: %s" % (plan.scenario, plan.seed,
                                     plan.describe()))
    print("outcome: watchdog=%s rc=%s wall=%.1fs (log: %s)"
          % (outcome["watchdog_fired"], outcome["rc"],
             outcome["wall_s"], outcome["log"]))
    for v in violations:
        print("VIOLATION [%s] %s" % (v.invariant, v.detail))
    print("RESULT: %s" % ("RED (%d violation(s))" % len(violations)
                          if violations else "GREEN"))
    return 1 if violations else 0


def main(argv=None):
    args = _build_parser().parse_args(argv)
    if args.device:
        os.environ["MXTPU_CHAOS_DEVICE"] = args.device

    if args.audit_sites:
        from .audit import main as audit_main
        return audit_main()

    from .plan import ChaosPlan, sample_plan

    if args.emit_plan:
        sys.stdout.write(sample_plan(args.seed, args.scenario).to_json())
        return 0

    if args.scenario_worker:
        return _scenario_worker(args)

    if args.run:
        plan = sample_plan(args.seed, args.scenario)
        outcome, violations = _run_and_judge(
            plan, _workdir(args, args.scenario), args.deadline)
        return _report(plan, outcome, violations)

    if args.replay:
        plan = ChaosPlan.load(args.replay)
        outcome, violations = _run_and_judge(
            plan, _workdir(args, plan.scenario), args.deadline)
        return _report(plan, outcome, violations)

    if args.shrink:
        from .shrink import shrink_plan
        plan = ChaosPlan.load(args.shrink)
        base = _workdir(args, "shrink")
        counter = {"n": 0}

        def violates(candidate):
            counter["n"] += 1
            wd = os.path.join(base, "try%03d" % counter["n"])
            _outcome, viols = _run_and_judge(candidate, wd, args.deadline)
            return bool(viols)

        shrunk, runs = shrink_plan(plan, violates, log=print)
        out_path = os.path.join(base, "shrunk.json")
        shrunk.save(out_path)
        print("shrunk %d -> %d rule(s) in %d run(s); wrote %s"
              % (len(plan), len(shrunk), runs, out_path))
        # one final run of the minimal plan, leaving its flight dump +
        # result JSON in <base>/minimal for the post-mortem
        outcome, violations = _run_and_judge(
            shrunk, os.path.join(base, "minimal"), args.deadline)
        return _report(shrunk, outcome, violations)

    return 2


def _scenario_worker(args):
    """Internal: run ONE scenario workload under the plan file (the
    runner watches this process from outside)."""
    from .plan import ChaosPlan
    from . import runner

    plan = ChaosPlan.load(args.plan)
    scen = args.scenario_worker
    if scen == "dist-rank":
        runner.worker_dist_rank(plan, args.out_dir, args.workdir)
        return 0  # unreachable — worker_dist_rank os._exits
    workers = {"train": runner.worker_train, "data": runner.worker_data,
               "serve": runner.worker_serve}
    try:
        workers[scen](plan, args.out, args.workdir)
    except Exception:
        # the result JSON (if any) is the fact sheet; the traceback goes
        # to the captured log for humans
        import traceback
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
