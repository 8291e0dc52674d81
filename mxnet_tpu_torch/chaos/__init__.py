"""Deterministic chaos harness: the recovery paths under combinations of
faults.

The port's own copy of ``mxnet_tpu/chaos``. Every
:mod:`mxnet_tpu_torch.faults` site tests its seam one fault at a time;
production failures compose (a worker dies while an async checkpoint is
in flight while a decode request is queued). This package proves the
recovery paths under combinations:

- :mod:`~mxnet_tpu_torch.chaos.plan` — a :class:`ChaosPlan` is a seeded
  sample of (site, kind, nth-call, intensity) rules drawn from the site
  registry; JSON-serializable, replayable bit for bit, no wall clock or
  global RNG anywhere (the same seed gives the JAX package's plan bytes).
- :mod:`~mxnet_tpu_torch.chaos.runner` — drives four real workloads under
  a plan (fused K-step fit with async checkpoints and the guard; the data
  tier; a 3-process ``dist_sync`` fit through the port's launcher;
  FleetRouter and DecodeLoop under open-loop load), each in a subprocess
  with a hang watchdog, on the device ``--device`` names.
- :mod:`~mxnet_tpu_torch.chaos.invariants` — typed-error-or-complete,
  bitwise resume, exactly-once request settlement, health-counter
  consistency, flight-recorder dump-and-parse.
- :mod:`~mxnet_tpu_torch.chaos.shrink` — greedy reduction of a failing
  plan to the minimal failing schedule (the committed regression
  artifact).

CLI: ``python -m mxnet_tpu_torch.chaos --help`` (run/replay/shrink/
emit-plan/audit-sites).
"""
from .plan import ChaosPlan, sample_plan
from .invariants import check_scenario, Violation, INVARIANTS
from .shrink import shrink_plan
from .runner import SCENARIOS, run_plan

__all__ = ["ChaosPlan", "sample_plan", "check_scenario", "Violation",
           "INVARIANTS", "shrink_plan", "SCENARIOS", "run_plan"]
