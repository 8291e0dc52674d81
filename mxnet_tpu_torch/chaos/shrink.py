"""Greedy plan shrinking: reduce a failing chaos schedule to a minimal
one that still violates, then commit THAT as the regression artifact
(the port's own copy of ``mxnet_tpu/chaos/shrink.py``).

A sampled plan composes 2–4 faults; usually only one or two of them
matter to a violation. ``shrink_plan`` repeatedly tries dropping each
rule and keeps any drop that still fails, looping to a fixpoint — the
classic delta-debugging greedy pass, which is exact enough here because
plans are tiny and re-running a scenario is the expensive step.

The ``violates`` callback owns re-execution (normally
``lambda p: bool(check_scenario(p, run_plan(p, fresh_workdir())))``), so
this module stays pure and unit-testable against synthetic run
functions.
"""
from __future__ import annotations


def shrink_plan(plan, violates, log=None):
    """Shrink ``plan`` to a minimal still-violating schedule.

    ``violates(plan) -> bool`` re-runs the scenario and judges it; it is
    called once per candidate drop per pass (O(n^2) runs worst case for
    an n-rule plan — n <= 4 in practice). Returns ``(shrunk_plan,
    runs)`` where ``runs`` counts ``violates`` invocations. The input
    plan is assumed failing and is never re-checked; if every single
    drop passes, the input IS minimal and comes back unchanged.
    """
    runs = 0
    current = plan
    progress = True
    while progress and len(current) > 1:
        progress = False
        for i in range(len(current)):
            candidate = current.without(i)
            dropped = current.faults[i]
            runs += 1
            if violates(candidate):
                if log is not None:
                    log("shrink: dropped %s@%d=%s -> %d rule(s) still "
                        "violate" % (dropped["site"], dropped["nth"],
                                     dropped["kind"], len(candidate)))
                current = candidate
                progress = True
                break  # restart the pass over the smaller plan
            elif log is not None:
                log("shrink: %s@%d=%s is load-bearing (drop passes)"
                    % (dropped["site"], dropped["nth"], dropped["kind"]))
    return current, runs
