"""Committed per-device tuning DB.

The port's own copy of ``mxnet_tpu/autotune/db.py`` (the resolution half;
the port imports nothing of the JAX package). One JSON file maps ``(model,
device_kind, global_batch, objective)`` to the measured-best knob values
the autotuner found on that device. The file is the JAX package's
committed ``AUTOTUNE_db.json`` (reading it is not an import); a
platform/device mismatch at resolution time is a note (the entry simply
does not apply), never an error, and a schema drift falls back to
built-in defaults with a warning.

Resolution consumers (``Module.fit``, ``ServingEngine``) match entries by
the SYMBOL SIGNATURE — a crc32 over the symbol's JSON graph — plus the
global batch and device kind, so a DB tuned for ``models.mlp(...)`` at
batch 48 can never leak its knobs into a different model or shape.

The device kind and platform come from the device the engine or module
runs on (:func:`device_kind`, :func:`device_platform`): ``"cpu"`` for a
CPU device, as the JAX package's CPU entries record it, and
``torch.cuda.get_device_name(i)`` on platform ``"gpu"`` for a card. So
CPU engines and modules match the committed ``cpu`` entries exactly as the
JAX package does, and an H100 matches none of them (a noted mismatch).
"""
from __future__ import annotations

import json
import logging
import os
import zlib

import torch

from ..base import MXNetError, env_str
from ..context import resolve_device

#: bump when the entry layout changes incompatibly; a file with a
#: different schema is ignored (warn once) and every consumer falls back
#: to built-in defaults — a stale committed DB must never misconfigure a
#: run silently
SCHEMA_VERSION = 1


def default_db_path():
    """``MXTPU_AUTOTUNE_DB`` or the committed ``AUTOTUNE_db.json`` at the
    repo root."""
    p = env_str("MXTPU_AUTOTUNE_DB")
    if p:
        return p
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "AUTOTUNE_db.json")


def symbol_signature(symbol):
    """Run-to-run-stable STRUCTURAL fingerprint of a symbol's graph:
    crc32 over the canonicalized node list — op type, sorted attrs and
    input topology, NOT node names. Auto-generated names carry a
    process-global counter (``flatten0`` vs ``flatten3`` for the same
    graph built twice), so a name-bearing hash would never match across
    rebuilds; any structural change (layer count, hidden width,
    num_classes, an attr value) still changes the signature."""
    g = json.loads(symbol.tojson())
    canon = []
    for n in g.get("nodes", []):
        attrs = n.get("attrs") or n.get("param") or {}
        canon.append((n.get("op"),
                      tuple(sorted((str(k), str(v))
                                   for k, v in attrs.items())),
                      tuple(tuple(i) for i in n.get("inputs", []))))
    blob = repr((canon,
                 tuple(g.get("arg_nodes", [])),
                 tuple(tuple(h) for h in g.get("heads", [])))).encode()
    return "%08x" % (zlib.crc32(blob) & 0xffffffff)


def param_signature(params):
    """Structural fingerprint of a flat ``name -> array`` parameter dict
    (the decode loop is built from raw params, not a Symbol): crc32 over
    the sorted ``(name, shape, dtype)`` triples. Weight VALUES don't
    change the signature; any architecture change (layer count, width,
    vocab) does — the same no-leak contract as
    :func:`symbol_signature`. Quantized ``{"q","s"}`` leaves sign their
    int8 payload, so a loop resolved before and after quantization
    matches the same entry only if the stored layout matches."""
    items = []
    for k in sorted(params):
        v = params[k]
        a = v["q"] if isinstance(v, dict) and "q" in v else v
        # numpy's dtype names ("float32"), also for tensors, so a
        # signature matches the JAX package's
        items.append((str(k), tuple(int(d) for d in a.shape),
                      str(a.dtype).rpartition(".")[2]))
    return "%08x" % (zlib.crc32(repr(items).encode()) & 0xffffffff)


def device_kind(device):
    """The DB's ``device_kind`` of a ``torch.device`` (or Context or
    string): ``"cpu"``, or the card's name."""
    dev = resolve_device(device, "autotune")
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev.index)
    return dev.type


def device_platform(device):
    """The DB's ``platform`` of a device: ``"cpu"`` or ``"gpu"``."""
    dev = resolve_device(device, "autotune")
    return "gpu" if dev.type == "cuda" else dev.type


class TuningDB(object):
    """The tuning DB file: load, lookup, put, atomic save.

    ``self.stale`` is True when the file existed but could not be used
    (unparseable JSON or a schema mismatch) — resolution then behaves as
    an empty DB and the loader has already logged why.
    """

    def __init__(self, path=None):
        self.path = path or default_db_path()
        self.entries = {}
        self.stale = False
        self.tol_note = None

    # -- load / save ----------------------------------------------------
    @classmethod
    def load(cls, path=None, logger=None):
        db = cls(path)
        logger = logger or logging
        if not os.path.exists(db.path):
            return db
        try:
            with open(db.path, "r") as f:
                raw = json.load(f)
        except (OSError, ValueError) as e:
            db.stale = True
            logger.warning(
                "autotune: tuning DB %s is unreadable (%s) — knobs fall "
                "back to built-in defaults", db.path, e)
            return db
        if raw.get("schema") != SCHEMA_VERSION:
            db.stale = True
            logger.warning(
                "autotune: tuning DB %s has schema %r (this build speaks "
                "%d) — knobs fall back to built-in defaults; re-run "
                "the tuner with --write-db to refresh",
                db.path, raw.get("schema"), SCHEMA_VERSION)
            return db
        entries = raw.get("entries")
        if not isinstance(entries, dict):
            db.stale = True
            logger.warning(
                "autotune: tuning DB %s has no 'entries' table — knobs "
                "fall back to built-in defaults", db.path)
            return db
        db.entries = entries
        return db

    def save(self, path=None):
        from ..model import atomic_write_bytes
        path = path or self.path
        payload = {"schema": SCHEMA_VERSION, "entries": self.entries}
        atomic_write_bytes(
            path, (json.dumps(payload, indent=1, sort_keys=True) + "\n")
            .encode())
        return path

    # -- keys / entries -------------------------------------------------
    @staticmethod
    def key(model, device_kind, global_batch, objective):
        return "%s|%s|b%d|%s" % (model, device_kind, int(global_batch),
                                 objective)

    def put(self, model, objective, global_batch, knobs, score, unit,
            kind="train", symbol=None, symbol_sig=None, extra=None,
            device=None):
        """Record one winner measured on ``device`` (default ``cuda:0``).
        ``symbol_sig`` is what resolution matches on
        (:func:`symbol_signature` of the exact graph the tuner measured);
        the human ``model`` name keys the file for readers."""
        entry = {
            "model": model,
            "objective": objective,
            "kind": kind,
            "global_batch": int(global_batch),
            "device_kind": device_kind(device),
            "platform": device_platform(device),
            "symbol": symbol,
            "symbol_sig": symbol_sig,
            "knobs": dict(knobs),
            "score": score,
            "unit": unit,
        }
        if extra:
            entry.update(extra)
        k = self.key(model, entry["device_kind"], global_batch, objective)
        self.entries[k] = entry
        return k

    def lookup(self, kind, symbol_sig=None, model=None, global_batch=None,
               objective=None, device=None):
        """First (sorted-key) entry matching the query on ``device``
        (default ``cuda:0``), honoring the platform contract: an entry
        recorded on a different device kind is skipped with a note string
        (returned as the third element) — "a mismatch is a note, not an
        error".

        Returns ``(entry_key, entry, note)``; ``entry`` is None on miss.
        """
        if self.stale:
            return None, None, "tuning DB is stale (schema/parse mismatch)"
        dk = device_kind(device)
        note = None
        for k in sorted(self.entries):
            e = self.entries[k]
            if not isinstance(e, dict) or e.get("kind") != kind:
                continue
            if objective is not None and e.get("objective") != objective:
                continue
            if model is not None and e.get("model") != model:
                continue
            if symbol_sig is not None and e.get("symbol_sig") != symbol_sig:
                continue
            if (global_batch is not None
                    and e.get("global_batch") != int(global_batch)):
                continue
            if e.get("device_kind") != dk:
                # tuned on different hardware: the measured winner does
                # not transfer — note it, keep scanning for a same-device
                # entry
                note = ("entry %s was tuned on device_kind %r (this host: "
                        "%r) — not applied" % (k, e.get("device_kind"), dk))
                continue
            # an applicable entry WAS found: a foreign-device sibling
            # scanned along the way is not a mismatch worth reporting
            return k, e, None
        return None, None, note


# -- cached default-path loads (fit/serving consult the DB per run) ------
_CACHE = {}


def load_cached(path=None, logger=None):
    """Load with an mtime-keyed cache: resolution runs once per
    ``fit``/engine-load, and re-reading an unchanged committed file every
    run would be pure overhead."""
    path = path or default_db_path()
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = None
    hit = _CACHE.get(path)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    db = TuningDB.load(path, logger=logger)
    _CACHE[path] = (mtime, db)
    return db


def parse_buckets(spec):
    """'1,8,32' -> (1, 8, 32) with the ServingEngine validation rules."""
    try:
        buckets = tuple(sorted({int(s) for s in str(spec).split(",")
                                if str(s).strip()}))
    except ValueError:
        raise MXNetError("autotune: bucket spec must be a comma list of "
                         "batch sizes, got %r" % (spec,))
    if not buckets or buckets[0] < 1:
        raise MXNetError("autotune: bucket spec needs positive batch "
                         "sizes, got %r" % (spec,))
    return buckets
