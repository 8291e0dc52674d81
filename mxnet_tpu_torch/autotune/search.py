"""Search driver: closes the loop between bench and config.

The port's copy of ``mxnet_tpu/autotune/search.py``. Two strategies, both
deterministic:

* **exhaustive grid** when the space is small enough for the trial budget
  (``itertools.product`` in declared knob order — the first value of every
  knob is its built-in default, so trial #0 is always the default config
  and the winner can be compared against it);
* **greedy per-knob hill climb** for larger spaces: start from the default
  config, then sweep each knob in declared order holding the others at
  their current best, adopting improvements as they appear. Bounded by the
  same trial budget.

Every candidate passes the **static pruner** first (a
:mod:`mxnet_tpu_torch.memcheck` pass over the candidate's program set — a
shape-only dry run, never a run on the device); candidates whose peak or
resident bytes exceed the device budget are recorded as ``pruned`` with
score -inf and never execute. A candidate that crashes (out of memory, a
backend error) scores -inf and is recorded — one bad config can never
kill the sweep (the TVM search-loop discipline, arXiv:1802.04799). A
candidate that WEDGES past the per-trial timeout also scores -inf, and
stops the sweep: its abandoned thread may still be executing against the
shared harness, and hold the card, so any later measurement would be
contaminated by the zombie's contention — the results honestly cover only
the clean trials measured before it.
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import namedtuple

from ..base import MXNetError, env_float

NEG_INF = float("-inf")

#: one searchable knob: ``values[0]`` is the built-in default
Knob = namedtuple("Knob", ["name", "values"])


def trial_timeout_default():
    """Per-trial wall-clock cap (``MXTPU_AUTOTUNE_TIMEOUT`` seconds,
    default 120): a wedged candidate is abandoned (daemon thread), scored
    -inf, and STOPS the sweep — the zombie may still hold the harness, so
    later measurements could not be trusted."""
    return env_float("MXTPU_AUTOTUNE_TIMEOUT", 120.0)


class Trial(object):
    """One evaluated (or pruned) candidate."""

    __slots__ = ("knobs", "score", "status", "detail", "seconds")

    def __init__(self, knobs, score, status, detail=None, seconds=0.0):
        self.knobs = dict(knobs)
        self.score = score
        self.status = status  # ok | pruned | error | timeout
        self.detail = detail
        self.seconds = seconds

    @property
    def ok(self):
        return self.status == "ok"

    def to_dict(self):
        return {"knobs": self.knobs, "score": self.score,
                "status": self.status, "detail": self.detail,
                "seconds": round(self.seconds, 2)}

    def __repr__(self):
        return "Trial(%r, score=%r, %s)" % (self.knobs, self.score,
                                            self.status)


def _isolated_call(fn, knobs, timeout):
    """Run one trial on a daemon worker thread: a candidate that raises
    (OOM, compile failure) or never returns must cost the sweep one trial
    slot, not the process. Returns ``(score, status, detail)``."""
    box = {}

    def target():
        try:
            box["score"] = float(fn(dict(knobs)))
        except BaseException as e:  # OOM lands as RuntimeError subclasses
            box["error"] = "%s: %s" % (type(e).__name__, e)

    th = threading.Thread(target=target, daemon=True,
                          name="mxtpu-autotune-trial")
    th.start()
    th.join(timeout)
    if th.is_alive():
        # the thread is abandoned (daemon): a wedged dispatch cannot be
        # interrupted from Python, but it must not wedge the sweep
        return NEG_INF, "timeout", "trial exceeded %gs timeout" % timeout
    if "error" in box:
        return NEG_INF, "error", box["error"]
    return box["score"], "ok", None


class SearchDriver(object):
    """Deterministic bounded search over a knob space.

    ``evaluate(knobs) -> score`` (higher is better) runs the candidate
    through a bench harness in-process; ``prune(knobs) -> findings`` (may
    be None) is the static memcheck pass — any returned finding rejects the
    candidate before execution. ``program_knobs`` names the knob subset
    that actually changes the compiled program set, so prune results are
    cached per projection (a ``dispatch_pipeline`` change never re-prunes).
    """

    def __init__(self, space, evaluate, prune=None, program_knobs=None,
                 budget=24, trial_timeout=None, logger=None, log=None):
        if not space:
            raise MXNetError("SearchDriver: empty knob space")
        for knob in space:
            if not knob.values:
                raise MXNetError("SearchDriver: knob %r has no values"
                                 % (knob.name,))
        self.space = list(space)
        self.evaluate = evaluate
        self.prune = prune
        self.program_knobs = tuple(program_knobs
                                   or [k.name for k in self.space])
        self.budget = max(1, int(budget))
        self.trial_timeout = (trial_timeout if trial_timeout is not None
                              else trial_timeout_default())
        self.logger = logger or logging
        self._log = log or (lambda msg: None)
        self.trials = []
        self._seen = {}        # knob tuple -> Trial (dedup re-visits)
        self._prune_cache = {}  # program-knob projection -> findings
        #: a timed-out trial's abandoned thread may still be executing
        #: against the SHARED harness (TrainStep/engine caches, the
        #: card) — any measurement taken after it would be contaminated
        #: by the zombie's contention, so the sweep STOPS at the first
        #: timeout and reports only the clean trials measured before it
        self.timed_out = False

    # -- candidate plumbing ---------------------------------------------
    def _key(self, knobs):
        return tuple(knobs[k.name] for k in self.space)

    def default_knobs(self):
        return {k.name: k.values[0] for k in self.space}

    def grid_size(self):
        n = 1
        for k in self.space:
            n *= len(k.values)
        return n

    def _prune_findings(self, knobs):
        if self.prune is None:
            return []
        proj = tuple(knobs.get(n) for n in self.program_knobs)
        if proj not in self._prune_cache:
            try:
                self._prune_cache[proj] = list(self.prune(dict(knobs)) or [])
            except Exception as e:
                # the pruner is an optimization, not a gate: if the static
                # analysis itself fails, the candidate runs (and its own
                # crash isolation still applies)
                self.logger.warning(
                    "autotune: static pruner failed for %r (%r) — "
                    "candidate will be measured instead", knobs, e)
                self._prune_cache[proj] = []
        return self._prune_cache[proj]

    def run_trial(self, knobs):
        """Prune-then-measure one candidate (deduped on revisit)."""
        key = self._key(knobs)
        if key in self._seen:
            return self._seen[key]
        t0 = time.perf_counter()
        findings = self._prune_findings(knobs)
        if findings:
            trial = Trial(knobs, NEG_INF, "pruned",
                          detail="; ".join(
                              getattr(f, "format", lambda: str(f))()
                              for f in findings[:3]),
                          seconds=time.perf_counter() - t0)
        else:
            score, status, detail = _isolated_call(
                self.evaluate, knobs, self.trial_timeout)
            trial = Trial(knobs, score, status, detail=detail,
                          seconds=time.perf_counter() - t0)
            if status == "timeout":
                self.timed_out = True
                self.logger.warning(
                    "autotune: trial %r timed out; its abandoned thread "
                    "may still hold the harness, so the sweep stops here "
                    "— results cover only the %d trial(s) measured before "
                    "it", knobs, len(self.trials))
        self._seen[key] = trial
        self.trials.append(trial)
        self._log("trial %d/%d %r -> %s%s"
                  % (len(self.trials), self.budget, trial.knobs,
                     ("%.4g" % trial.score) if trial.ok else trial.status,
                     (" (%s)" % trial.detail) if trial.detail else ""))
        return trial

    # -- strategies ------------------------------------------------------
    def _grid(self):
        for combo in itertools.product(*[k.values for k in self.space]):
            if len(self.trials) >= self.budget or self.timed_out:
                return
            self.run_trial({k.name: v
                            for k, v in zip(self.space, combo)})

    def _hill_climb(self):
        current = self.default_knobs()
        best = self.run_trial(current)
        for knob in self.space:
            if len(self.trials) >= self.budget or self.timed_out:
                break
            for v in knob.values:
                if v == current[knob.name]:
                    continue
                if len(self.trials) >= self.budget or self.timed_out:
                    break
                cand = dict(current)
                cand[knob.name] = v
                t = self.run_trial(cand)
                if t.ok and (not best.ok or t.score > best.score):
                    best = t
                    current = dict(cand)
        return best

    def run(self):
        """Run the sweep; returns ``(best_trial_or_None, trials)``. The
        default config is always trial #0 (grid order puts every knob's
        first value first; the hill climb starts there), so callers can
        compare the winner against the built-in defaults."""
        if self.grid_size() <= self.budget:
            self._log("exhaustive grid: %d candidates (budget %d)"
                      % (self.grid_size(), self.budget))
            self._grid()
        else:
            self._log("greedy hill-climb: %d-candidate space over budget "
                      "%d" % (self.grid_size(), self.budget))
            self._hill_climb()
        best = None
        for t in self.trials:
            if t.ok and (best is None or t.score > best.score):
                best = t
        return best, self.trials

    @property
    def default_trial(self):
        """The all-defaults trial (always the sweep's first)."""
        return self.trials[0] if self.trials else None

    def counts(self):
        c = {"ok": 0, "pruned": 0, "error": 0, "timeout": 0}
        for t in self.trials:
            c[t.status] = c.get(t.status, 0) + 1
        return c
