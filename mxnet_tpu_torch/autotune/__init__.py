"""``mxnet_tpu_torch.autotune``: closes the loop between bench and config.

Counterpart of ``mxnet_tpu/autotune`` (the TVM measured-search
discipline, arXiv:1802.04799, applied to this system's own knobs):

* a **search driver** (:mod:`.search`): exhaustive grid for small spaces,
  greedy per-knob hill climb for larger ones, deterministic order, a
  bounded budget, a per-trial timeout and crash isolation;
* a **static pruner**: every candidate's program set passes a
  :mod:`mxnet_tpu_torch.memcheck` budget check before it runs (a
  shape-only dry run, where the JAX package compiles; nothing is
  allocated on the device for an over-budget config);
* the **committed tuning DB** (:mod:`.db`, ``AUTOTUNE_db.json``) keyed
  ``(model, device_kind, global_batch, objective)``, from which
  ``Module.fit``, ``ServingEngine`` and ``DecodeLoop`` resolve unset knobs
  with the precedence **explicit arg > env > tuning DB > built-in
  default**, as the JAX package's do from the same file. A DB hit is
  logged once and counted in the obs registry
  (``autotune.db_resolutions``); a device-kind mismatch is a note
  (``autotune.db_mismatches``).

The device kind is the one the engine or module runs on (``"cpu"`` or the
card's name, :func:`~.db.device_kind`), so on an H100 no committed entry
applies and the built-in defaults do until a sweep there writes one.

``python -m mxnet_tpu_torch.autotune --model mlp --objective img_per_sec
--write-db`` runs a sweep and persists the winner (``--device cpu`` on a
host without a card). :mod:`.harness` holds the trial harnesses and the
open-loop client (``open_loop_run``) the serving benchmarks drive the
batcher with. :func:`hotspot_report` is the roofline's ranked hot spots
of one program, from :mod:`mxnet_tpu_torch.flopcheck`: where a hand
kernel starts once the knob search stops.
"""
from __future__ import annotations

import logging

from ..base import MXNetError, env_str
from .db import (SCHEMA_VERSION, TuningDB, default_db_path, device_kind,
                 device_platform, load_cached, param_signature,
                 parse_buckets, symbol_signature)
from .search import Knob, SearchDriver, Trial, NEG_INF
from .space import decode_space, serve_space, space_for, train_space

__all__ = [
    "SCHEMA_VERSION", "TuningDB", "SearchDriver", "Trial", "Knob",
    "NEG_INF", "default_db_path", "symbol_signature", "param_signature",
    "parse_buckets", "device_kind", "device_platform", "load_cached",
    "train_space", "serve_space", "decode_space", "space_for",
    "enabled", "tune", "hotspot_report",
    "resolve_train_knobs", "resolve_serve_knobs", "resolve_fit_knobs",
    "note_db_resolution", "TRAIN_OBJECTIVES", "SERVE_OBJECTIVES",
    "DECODE_OBJECTIVES", "resolve_decode_knobs",
]

TRAIN_OBJECTIVES = ("img_per_sec", "tokens_per_sec")
SERVE_OBJECTIVES = ("serve_p99", "serve_p50")
DECODE_OBJECTIVES = ("decode_tokens_per_sec",)


def hotspot_report(fn, args=(), kwargs=None, name=None, device=None,
                   loop_trips=1, top=10, memory_only=True):
    """The hand-kernel shopping list of ONE program: the roofline's ranked
    hot spots (dicts, each with its ``step_time_frac``), from one
    shape-only dry run. Delegates to
    :func:`mxnet_tpu_torch.flopcheck.hotspot_report`."""
    from .. import flopcheck
    return flopcheck.hotspot_report(
        fn, args, kwargs=kwargs, name=name, device=device,
        loop_trips=loop_trips, top=top, memory_only=memory_only)


def enabled():
    """Whether tuning-DB knob resolution is armed (default ON;
    ``MXTPU_AUTOTUNE=0`` disarms — explicit args and env knobs always
    win regardless)."""
    return env_str("MXTPU_AUTOTUNE").lower() \
        not in ("0", "false", "off", "no")


def note_db_resolution(logger, who, entry_key, applied):
    """The once-per-run resolution log + obs-registry count: every run
    that takes knob values from the tuning DB says so exactly once, with
    the entry key."""
    from ..obs import REGISTRY
    REGISTRY.counter(
        "autotune.db_resolutions",
        "knob values resolved from the tuning DB").inc()
    (logger or logging).info(
        "autotune: %s resolved %s from tuning DB entry %s (%s)",
        who, ", ".join("%s=%r" % kv for kv in sorted(applied.items())),
        entry_key, default_db_path())


def _note_mismatch(logger, note):
    from ..obs import REGISTRY
    REGISTRY.counter(
        "autotune.db_mismatches",
        "tuning-DB entries skipped for platform/device mismatch").inc()
    (logger or logging).info("autotune: %s", note)


def _resolve(kind, objectives, signature, global_batch, device, logger,
             what):
    """The first entry of ``kind`` whose signature is ``signature()`` at
    ``global_batch`` on ``device``, trying ``objectives`` in their
    documented order. Returns
    ``(entry_key, knobs)`` or ``(None, None)`` — a miss, a device mismatch
    (noted) or a stale DB all resolve to None, never an error: resolution
    must not be able to break the run it is configuring."""
    if not enabled():
        return None, None
    try:
        sig = signature()
        tdb = load_cached(logger=logger)
        note = None
        for objective in objectives:
            key, entry, obj_note = tdb.lookup(
                kind, symbol_sig=sig, global_batch=int(global_batch),
                objective=objective, device=device)
            note = note or obj_note  # a mismatch seen for ANY objective
            if entry is not None:
                return key, dict(entry.get("knobs") or {})
        if note:
            _note_mismatch(logger, note)
    except Exception as e:
        (logger or logging).warning(
            "autotune: tuning-DB resolution failed (%r) — %s fall back to "
            "built-in defaults", e, what)
    return None, None


def resolve_train_knobs(symbol, global_batch, logger=None, device=None):
    """Tuning-DB knobs for a training run over ``symbol`` at
    ``global_batch`` on ``device`` (default ``cuda:0``): ``(entry_key,
    knobs)`` or ``(None, None)``. With entries for more than one training
    objective, img/s wins (documented order, not key sort order)."""
    return _resolve("train", TRAIN_OBJECTIVES,
                    lambda: symbol_signature(symbol), global_batch, device,
                    logger, "knobs")


def resolve_serve_knobs(symbol, logger=None, device=None):
    """Tuning-DB knobs for a ``ServingEngine`` over the (stripped)
    ``symbol`` on ``device``; p99 entries win over p50 (the tail is what
    the serving tier's deadlines gate on). Same never-raises contract as
    :func:`resolve_train_knobs`."""
    return _resolve("serve", SERVE_OBJECTIVES,
                    lambda: symbol_signature(symbol), 0, device, logger,
                    "serving knobs")


def resolve_decode_knobs(params, logger=None, device=None):
    """Tuning-DB knobs for a :class:`~mxnet_tpu_torch.serving.DecodeLoop`
    over ``params`` (a flat ``name -> array`` dict: the loop has no
    Symbol, so entries match on :func:`param_signature`) on ``device``.
    Returns the knobs dict or None, never raises, and logs a hit once (the
    loop has applied its own arg and env precedence first)."""
    key, knobs = _resolve("decode", DECODE_OBJECTIVES,
                          lambda: param_signature(params), 0, device,
                          logger, "decode knobs")
    if knobs:
        note_db_resolution(logger, "DecodeLoop", key, knobs)
    return knobs


def resolve_fit_knobs(module, train_data, steps_per_dispatch,
                      dispatch_pipeline, logger=None):
    """``Module.fit``'s knob resolution: precedence **explicit arg > env >
    tuning DB > built-in default**, applied per knob. Returns
    ``(steps_per_dispatch, dispatch_pipeline, {knob: source})`` with
    sources in ``{"arg", "env", "db", "default"}``; a DB hit is logged
    once via the obs registry. The DB is matched on the module's symbol,
    the batch of ``train_data`` and the module's device."""
    from .. import engine as _engine
    logger = logger or logging
    src = {}
    k = depth = None
    if steps_per_dispatch is not None:
        k = max(1, int(steps_per_dispatch))
        src["steps_per_dispatch"] = "arg"
    elif _engine.bulk_configured():
        k = max(1, int(_engine.bulk_size()))
        src["steps_per_dispatch"] = "env"
    if dispatch_pipeline is not None:
        depth = max(0, int(dispatch_pipeline))
        src["dispatch_pipeline"] = "arg"
    elif _engine.dispatch_pipeline_configured():
        depth = max(0, int(_engine.dispatch_pipeline()))
        src["dispatch_pipeline"] = "env"
    if k is None or depth is None:
        knobs = None
        try:
            symbol = module.symbol
            first = (train_data.provide_data or [None])[0]
            shape = (first.shape if hasattr(first, "shape") else first[1])
            global_batch = int(shape[0])
            device = module._device
        except (AttributeError, IndexError, TypeError, ValueError):
            symbol = None
        if symbol is not None:
            entry_key, knobs = resolve_train_knobs(
                symbol, global_batch, logger=logger, device=device)
        if knobs:
            applied = {}
            if k is None and "steps_per_dispatch" in knobs:
                k = max(1, int(knobs["steps_per_dispatch"]))
                src["steps_per_dispatch"] = "db"
                applied["steps_per_dispatch"] = k
            if depth is None and "dispatch_pipeline" in knobs:
                depth = max(0, int(knobs["dispatch_pipeline"]))
                src["dispatch_pipeline"] = "db"
                applied["dispatch_pipeline"] = depth
            if applied:
                note_db_resolution(logger, "Module.fit", entry_key,
                                   applied)
    if k is None:
        k = max(1, int(_engine.bulk_size()))
        src["steps_per_dispatch"] = "default"
    if depth is None:
        depth = max(0, int(_engine.dispatch_pipeline()))
        src["dispatch_pipeline"] = "default"
    return k, depth, src


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def tune(model="mlp", objective="img_per_sec", budget=24, batch=None,
         db_path=None, write_db=False, space=None, trial_timeout=None,
         qps=None, nreq=None, rounds=2, logger=None, log=None, device=None):
    """Run one autotuning sweep on ``device`` (default ``cuda:0``) and
    (optionally) persist the winner.

    Builds the harness for ``objective`` (training objectives measure
    ``run_steps`` with fit's pipelined readback discipline; serving
    objectives drive the batcher with open-loop arrivals; the decode
    objective a ``DecodeLoop``), prunes each candidate statically through
    memcheck, searches the space under ``budget`` trials, and returns a
    JSON-able result dict (``model, objective, kind, global_batch, unit,
    symbol_sig, counts, trials, default, best``, ``speedup_vs_default``
    where the default trial succeeded, ``db`` after a write). With
    ``write_db`` the best trial lands in the tuning DB (atomic write),
    keyed ``(model, device_kind, global_batch, objective)`` on the
    harness's device kind.
    """
    from .harness import DecodeHarness, ServeHarness, TrainHarness
    logger = logger or logging
    if objective in TRAIN_OBJECTIVES:
        h = TrainHarness(model=model, batch=batch, objective=objective,
                         rounds=rounds, logger=logger, device=device)
        sp = space or train_space()
        global_batch = h.batch
    elif objective in SERVE_OBJECTIVES:
        kw = {}
        if qps is not None:
            kw["qps"] = qps
        if nreq is not None:
            kw["nreq"] = nreq
        h = ServeHarness(model=model, objective=objective, logger=logger,
                         device=device, **kw)
        sp = space or serve_space()
        global_batch = 0
    elif objective in DECODE_OBJECTIVES:
        kw = {}
        if nreq is not None:
            kw["nreq"] = nreq
        h = DecodeHarness(model=model, objective=objective, logger=logger,
                          device=device, **kw)
        sp = space or decode_space()
        global_batch = 0
    else:
        raise MXNetError(
            "autotune: unknown objective %r (training: %s; serving: %s; "
            "decode: %s)"
            % (objective, "|".join(TRAIN_OBJECTIVES),
               "|".join(SERVE_OBJECTIVES), "|".join(DECODE_OBJECTIVES)))
    driver = SearchDriver(sp, h.evaluate, prune=h.prune,
                          program_knobs=h.program_knobs, budget=budget,
                          trial_timeout=trial_timeout, logger=logger,
                          log=log)
    try:
        best, trials = driver.run()
    finally:
        if hasattr(h, "close"):
            h.close()   # decode trials hold live loop threads
    default = driver.default_trial
    result = {
        "model": model,
        "objective": objective,
        "kind": h.kind,
        "global_batch": global_batch,
        "unit": h.unit,
        "symbol_sig": h.symbol_sig(),
        "counts": driver.counts(),
        "trials": [t.to_dict() for t in trials],
        "default": default.to_dict() if default is not None else None,
        "best": best.to_dict() if best is not None else None,
    }
    if best is not None and default is not None and default.ok:
        result["speedup_vs_default"] = (
            round(best.score / default.score, 4)
            if default.score > 0 else None)
    if best is not None and write_db:
        tdb = TuningDB.load(db_path, logger=logger)
        if tdb.stale:
            # a stale file must not survive a deliberate --write-db: the
            # refresh REPLACES it
            tdb = TuningDB(db_path)
        key = tdb.put(
            model, objective, global_batch, best.knobs, best.score,
            h.unit, kind=h.kind, symbol=h.symbol.name,
            symbol_sig=h.symbol_sig(),
            extra={"default_score": (default.score
                                     if default is not None and default.ok
                                     else None),
                   "trials": len(trials),
                   "pruned": driver.counts().get("pruned", 0)},
            device=h.device)
        tdb.save()
        result["db"] = {"path": tdb.path, "entry": key}
        logger.info("autotune: wrote winner %r (score %.6g %s) to %s",
                    best.knobs, best.score, h.unit, tdb.path)
    return result
