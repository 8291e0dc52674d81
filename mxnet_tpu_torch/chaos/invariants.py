"""System-level invariants the chaos gate asserts after every scenario.

The port's own copy of ``mxnet_tpu/chaos/invariants.py``.

The scenario workers (:mod:`~mxnet_tpu_torch.chaos.runner`) record FACTS —
outcome, error type, health-counter deltas, hashes, the settlement
partition — and this module holds the JUDGMENT, so the gate, the
shrinker and the tests all agree on what "violated" means.

Invariants:

``no_hang``           the scenario finished inside its watchdog deadline
                      (a hang is the WORST violation, not a timeout to
                      shrug at) and every expected worker reported back.
``typed_outcome``     the run either completed or raised a *typed*
                      :class:`~mxnet_tpu_torch.base.MXNetError` subclass —
                      never a bare exception, never a silent nonzero
                      exit.
``bitwise_resume``    after a trajectory-preserving plan (no data-poison
                      faults fired, no rollbacks), resuming from the
                      newest known-good checkpoint converges on the
                      bitwise-identical final params of the unfaulted
                      reference; non-preserving plans degrade to the
                      consistency form (resume completes from a valid
                      checkpoint). The data scenario's analogue: the
                      faulted stream is byte-identical to the reference
                      (delays never reorder batches).
``settled_once``      every submitted serving request settles exactly
                      once — completed/expired/shed/failed PARTITION the
                      submit count, no future times out unresolved.
``health_consistent`` counter deltas match the injected plan (a fired
                      ``guard.grad_nan`` shows up as skipped steps, a
                      fired ``ckpt.async_write`` raise as a writer
                      error, ...).
``flight_dump``       the flight recorder dumped at the failure site and
                      the dump parses.
"""
from __future__ import annotations

from ..base import env_str

INVARIANTS = ("no_hang", "typed_outcome", "bitwise_resume",
              "settled_once", "health_consistent", "flight_dump")


class Violation(object):
    """One broken invariant: which one, and the evidence."""

    __slots__ = ("invariant", "detail")

    def __init__(self, invariant, detail):
        self.invariant = invariant
        self.detail = detail

    def to_dict(self):
        return {"invariant": self.invariant, "detail": self.detail}

    def __repr__(self):
        return "Violation(%s: %s)" % (self.invariant, self.detail)


def _fired(result, site, kinds=None):
    """How often ``site`` actually fired in the worker, optionally only
    counting rules of the given kinds (the worker reports per-site fired
    totals; kind attribution comes from the plan)."""
    if result is None:
        return 0
    return int((result.get("fault_fired") or {}).get(site, 0))


def _plan_kinds(plan, site):
    return {r["kind"] for r in plan.faults if r["site"] == site}


def _health(result, view, key):
    try:
        return float(result["health"][view][key])
    except (KeyError, TypeError):
        return 0.0


def _check_result(plan, result, out):
    """Invariants over ONE worker's fact sheet (dist runs one per rank)."""
    scen = plan.scenario
    outcome = result.get("outcome")
    if outcome == "error" and not result.get("typed"):
        out.append(Violation(
            "typed_outcome", "%s: untyped %s: %s"
            % (scen, result.get("error_type"), result.get("error_msg"))))

    # -- resume / stream contract --------------------------------------
    res = result.get("resume")
    if res is not None:
        if not res.get("ok"):
            out.append(Violation(
                "bitwise_resume", "%s resume (%s form): %s"
                % (scen, res.get("mode"), res.get("detail"))))
    stream = result.get("stream")
    if stream is not None and stream.get("ok") is False:
        out.append(Violation(
            "bitwise_resume", "data stream diverged from the unfaulted "
            "reference: %s" % (stream.get("detail"),)))

    # -- settlement partition ------------------------------------------
    settle = result.get("settle")
    if settle is not None:
        parts = (settle.get("completed", 0) + settle.get("expired", 0)
                 + settle.get("shed", 0) + settle.get("failed", 0))
        if settle.get("unsettled", 0):
            out.append(Violation(
                "settled_once", "%d request(s) never settled (future "
                "still pending at drain)" % settle["unsettled"]))
        if parts != settle.get("submitted", 0):
            out.append(Violation(
                "settled_once",
                "completed+expired+shed+failed = %d != submitted %d (%s)"
                % (parts, settle.get("submitted", 0), settle)))

    # -- health-counter consistency ------------------------------------
    def _expect(cond, msg):
        if not cond:
            out.append(Violation("health_consistent", msg))

    if _fired(result, "guard.grad_nan"):
        _expect(_health(result, "training", "skipped") >= 1,
                "guard.grad_nan fired %d time(s) but TRAINING_HEALTH "
                "counted no skipped steps"
                % _fired(result, "guard.grad_nan"))
    for site in ("ckpt.async_write", "ckpt.async_die"):
        kinds = _plan_kinds(plan, site) - {"delay"}
        if kinds and _fired(result, site):
            ac = result.get("async_ckpt") or {}
            _expect(ac.get("errors", 0) >= 1,
                    "%s fired but the async writer counted no errors "
                    "(%s)" % (site, ac))
    if _fired(result, "data.worker_die"):
        _expect(outcome == "error",
                "data.worker_die fired but the run completed — a worker "
                "died holding a claimed batch and nobody noticed")
    if "drop" in _plan_kinds(plan, "serve.enqueue_drop") \
            and _fired(result, "serve.enqueue_drop"):
        # the drop may land on the caller's submit (-> settle.shed) or
        # inside the router's replica dispatch (-> SERVING_HEALTH shed/
        # dropped + a requeue); either way it must be COUNTED somewhere
        _expect((settle or {}).get("shed", 0) >= 1
                or _health(result, "serving", "shed") >= 1
                or _health(result, "serving", "dropped") >= 1,
                "serve.enqueue_drop fired %d time(s) but neither the "
                "settle partition nor SERVING_HEALTH counted a shed/drop"
                % _fired(result, "serve.enqueue_drop"))
    for site in ("io.record_read", "io.batch_read", "io.h2d"):
        if "transient" in _plan_kinds(plan, site) and _fired(result, site):
            _expect(_health(result, "data", "retries") >= 1
                    or outcome == "error",
                    "%s transient fired but DATA_HEALTH counted no "
                    "retries and the run completed" % site)

    # -- flight recorder -----------------------------------------------
    flight = result.get("flight")
    dump_expected = (
        result.get("error_type") in ("TrainingDivergedError",
                                     "WorkerLostError",
                                     "TrainingPreemptedError")
        or _fired(result, "fleet.replica_die")
        or _fired(result, "serve.decode_die"))
    if dump_expected:
        if flight is None or not flight.get("exists"):
            out.append(Violation(
                "flight_dump", "failure path %s should have dumped the "
                "flight recorder but no dump exists"
                % (result.get("error_type") or "replica/decode death")))
        elif not flight.get("parses"):
            out.append(Violation(
                "flight_dump", "flight dump at %s does not parse: %s"
                % (flight.get("path"), flight.get("detail"))))


def check_scenario(plan, outcome):
    """All invariants over one scenario run.

    ``outcome`` is the runner's record: ``{"watchdog_fired", "wall_s",
    "rc", "result"}`` plus ``"rank_results"``/``"expected_dead"`` for the
    dist scenario. Returns a list of :class:`Violation` (empty = green).
    """
    out = []
    if outcome.get("watchdog_fired"):
        out.append(Violation(
            "no_hang", "%s scenario hit the %.0fs watchdog deadline "
            "(plan: %s)" % (plan.scenario, outcome.get("deadline_s", 0),
                            plan.describe())))
    else:
        results = outcome.get("rank_results")
        if results is None:
            results = {None: outcome.get("result")}
        expected_dead = set(outcome.get("expected_dead") or ())
        for rank, result in sorted(results.items(),
                                   key=lambda kv: str(kv[0])):
            if result is None:
                if rank in expected_dead:
                    continue  # the plan SIGKILLed this rank mid-exchange
                out.append(Violation(
                    "typed_outcome",
                    "%s%s exited (rc=%s) without reporting — a bare "
                    "crash, not a typed failure"
                    % (plan.scenario,
                       "" if rank is None else " rank %s" % rank,
                       outcome.get("rc"))))
            else:
                _check_result(plan, result, out)
        # dist: every surviving rank must land on the SAME final params
        # (the ring reduction is bitwise-deterministic, and post-reform
        # survivors adopt one checkpoint)
        if outcome.get("rank_results"):
            hashes = {r: res.get("final_hash")
                      for r, res in results.items()
                      if res is not None and res.get("final_hash")}
            if len(set(hashes.values())) > 1:
                out.append(Violation(
                    "bitwise_resume",
                    "surviving ranks diverged — final param hashes %s"
                    % ({r: h[:12] for r, h in sorted(hashes.items())},)))

    # RED self-test hook (the commscheck discipline): the gate proves its
    # own plumbing by deliberately inverting ONE invariant's verdict and
    # demanding the run turn red. Never set outside ci/chaos.sh's
    # self-test leg.
    broken = env_str("MXTPU_CHAOS_BREAK_INVARIANT")
    if broken:
        kept = [v for v in out if v.invariant != broken]
        if len(kept) == len(out):
            kept.append(Violation(
                broken, "MXTPU_CHAOS_BREAK_INVARIANT=%s: verdict "
                "deliberately inverted to prove the gate turns red"
                % broken))
        out = kept
    return out
