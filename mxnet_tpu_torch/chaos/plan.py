"""Chaos plans: seeded, fully deterministic fault schedules.

The port's own copy of ``mxnet_tpu/chaos/plan.py``: the port's
:data:`~mxnet_tpu_torch.faults.SITES` equals the JAX package's name for
name, so a seed gives the same plan bytes in both packages.

A :class:`ChaosPlan` is a list of fault rules — ``(site, kind, nth-call,
times, intensity[, rank])`` — sampled from the live
:data:`mxnet_tpu_torch.faults.SITES` registry by a :class:`random.Random`
seeded from ``(seed, scenario)`` alone. No wall clock, no global RNG,
no ``PYTHONHASHSEED`` sensitivity (``random.Random(str)`` seeds through
sha512): the same seed produces byte-identical plan JSON in every
process on every host, which is what makes a failing schedule
committable as a permanent regression (the repo's pure-function shuffle
discipline, applied to fault injection).
"""
from __future__ import annotations

import json

from ..base import MXNetError
from .. import faults as _faults

PLAN_VERSION = 1

#: intensity menu for ``delay`` rules — bounded so a composed plan of
#: delays can never eat a scenario's watchdog budget by itself
_DELAYS = (0.05, 0.1, 0.2)

#: per-site sampling hints. ``nth`` bounds where in the workload the rule
#: arms (inclusive); ``times`` bounds the burst length; ``max_per_plan``
#: caps repeats of destructive rules; ``rank`` restricts which dist rank
#: a rule may target (rank 0 hosts the control plane's store
#: — killing it takes the control plane down with it, which is a
#: platform property, not a recovery path under test).
_HINTS = {
    "guard.loss_spike": {"times": (6, 10)},   # the divergence watcher
                                              # needs a SUSTAINED spike
    "guard.grad_nan": {"times": (1, 3)},
    "kv.worker_die": {"nth": (8, 20), "max_per_plan": 1,
                      "rank": "nonzero"},
    "kv.reform_delay": {"nth": (1, 2)},
    # the fused dist fit touches the classic push/pull/barrier surface
    # only around init (~4 pulls, a couple of barriers); per-step traffic
    # runs through the ring sites (kv.partition / kv.push_delay)
    "kvstore.pull": {"nth": (1, 4)},
    "kvstore.push": {"nth": (1, 4)},
    "kvstore.barrier": {"nth": (1, 3)},
    "kv.partition": {"nth": (1, 30), "times": (1, 3)},
    "kv.push_delay": {"nth": (1, 20)},
    "superbatch.producer": {"nth": (1, 6)},
    "data.worker_die": {"nth": (1, 6)},
    "fleet.replica_die": {"nth": (1, 6), "max_per_plan": 1},
    "serve.decode_die": {"nth": (1, 8), "max_per_plan": 1},
}
_DEFAULT_NTH = (1, 10)


class ChaosPlan(object):
    """One deterministic fault schedule. ``faults`` is a list of rule
    dicts — ``{"site", "kind", "nth", "times", "delay"}`` plus ``"rank"``
    for dist-scenario rules. Serializes to canonical JSON (sorted keys,
    fixed indent) so equality of plans is equality of bytes."""

    __slots__ = ("seed", "scenario", "faults")

    def __init__(self, seed, scenario, faults):
        self.seed = int(seed)
        self.scenario = scenario
        self.faults = [dict(r) for r in faults]

    # -- serialization --------------------------------------------------
    def to_dict(self):
        return {"version": PLAN_VERSION, "seed": self.seed,
                "scenario": self.scenario, "faults": self.faults}

    def to_json(self):
        return json.dumps(self.to_dict(), sort_keys=True, indent=1) + "\n"

    @classmethod
    def from_dict(cls, d):
        if d.get("version") != PLAN_VERSION:
            raise MXNetError(
                "chaos plan version %r != %d — regenerate the plan "
                "against this tree" % (d.get("version"), PLAN_VERSION))
        return cls(d["seed"], d["scenario"], d["faults"])

    @classmethod
    def from_json(cls, text):
        return cls.from_dict(json.loads(text))

    def save(self, path):
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls.from_json(f.read())

    # -- structure ------------------------------------------------------
    def __len__(self):
        return len(self.faults)

    def __eq__(self, other):
        return (isinstance(other, ChaosPlan)
                and self.to_json() == other.to_json())

    def __hash__(self):
        return hash(self.to_json())

    def sites(self):
        return sorted({r["site"] for r in self.faults})

    def rules_for_rank(self, rank):
        """The rules a dist worker with ``rank`` arms: rules without a
        ``rank`` field apply to every rank."""
        return [r for r in self.faults
                if r.get("rank") is None or int(r["rank"]) == int(rank)]

    def without(self, index):
        """A copy with fault ``index`` dropped (the shrinker's move)."""
        kept = [r for i, r in enumerate(self.faults) if i != index]
        return ChaosPlan(self.seed, self.scenario, kept)

    def describe(self):
        return ", ".join(
            "%s@%d=%s%s%s" % (
                r["site"], r["nth"], r["kind"],
                "*%d" % r["times"] if r.get("times", 1) != 1 else "",
                " rank%d" % r["rank"] if r.get("rank") is not None else "")
            for r in self.faults) or "(empty)"


def sample_plan(seed, scenario, n_faults=None, nproc=3):
    """Draw a plan for ``scenario`` from the live site registry.

    Deterministic in ``(seed, scenario, n_faults, nproc)`` alone. The
    sample composes 2–4 rules (site, kind, nth, burst length, delay
    intensity) subject to the per-site hints above; dist plans pin each
    rule to a rank so a 3-process run arms exactly what the plan says.
    """
    import random
    rng = random.Random("mxtpu-chaos:%d:%s" % (int(seed), scenario))
    pool = sorted(_faults.sites(scenario))
    if not pool:
        raise MXNetError("no fault sites registered for scenario %r "
                         "(known scenarios: train, data, dist, serve)"
                         % (scenario,))
    # the count draw ALWAYS happens, so an explicit n_faults equal to the
    # natural draw reproduces the default plan byte-for-byte (the
    # committed-regression resample check depends on this)
    n_draw = rng.randint(2, 4)
    n = int(n_faults) if n_faults else n_draw
    rules = []
    used = {}
    for _ in range(n):
        site = rng.choice(pool)
        hints = _HINTS.get(site, {})
        cap = hints.get("max_per_plan")
        if cap is not None and used.get(site, 0) >= cap:
            # deterministic re-draw from the non-capped pool
            open_pool = [s for s in pool
                         if _HINTS.get(s, {}).get("max_per_plan") is None
                         or used.get(s, 0) <
                         _HINTS[s]["max_per_plan"]]
            if not open_pool:
                break
            site = rng.choice(open_pool)
            hints = _HINTS.get(site, {})
        info = _faults.SITES[site]
        kind = rng.choice(info.kinds)
        lo, hi = hints.get("nth", _DEFAULT_NTH)
        tlo, thi = hints.get("times", (1, 1))
        rule = {"site": site, "kind": kind, "nth": rng.randint(lo, hi),
                "times": rng.randint(tlo, thi),
                "delay": rng.choice(_DELAYS)}
        if scenario == "dist":
            if hints.get("rank") == "nonzero" or kind == "die":
                rule["rank"] = rng.randint(1, max(1, nproc - 1))
            else:
                rule["rank"] = rng.randint(0, nproc - 1)
        rules.append(rule)
        used[site] = used.get(site, 0) + 1
    return ChaosPlan(seed, scenario, rules)
