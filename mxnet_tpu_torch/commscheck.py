"""commscheck: the collective-communication analyzer of the port's mesh
programs.

Counterpart of ``mxnet_tpu/commscheck.py``. The JAX package compiles a
partitioned program without running it and walks the scheduled HLO, where
GSPMD placed the collectives; the port places them itself: its collectives
are the functions of ``parallel/mesh.py`` (``all_reduce``, ``all_gather``,
``gather_axis``, ``replicate``, ``ppermute``, ``all_to_all``, ``grad_sync``
and ``host_to_global``'s gloo legs, the pipeline's stage hops), each of
which hands itself to ``base.note_collective``. So the port's **collective
inventory** comes from :mod:`mxnet_tpu_torch.memcheck`'s shape-only dry
run (every op on fake tensors, nothing allocated on the device, no kernel
launched, the same run that feeds memcheck and flopcheck): each collective
the program calls, recorded as it would run over separate cards even where
positions share one (two on ``cuda:0``, eight on the CPU), with

- its kind, in the JAX names: ``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``,
  ``collective-broadcast`` (``replicate``);
- the mesh axes its caller names (a device list cannot tell an axis when
  positions share a card) and its group size;
- its payload by the JAX package's conventions (an all-gather's gathered
  result, a reduce-scatter's scattered one, every other kind one
  position's tensor) and its wire bytes by the ring model
  (:func:`_wire_bytes`);
- its ``op_path`` (the executor node that issued it, or its caller's name
  for it: ``gradient/<param>`` for a gradient sum) and provenance (the
  caller's ``file:line``);
- ``operand_params``: the labels of the entry arguments whose storage (or
  a view of it) it reads;
- the backward's transposes: autograd carries a collective's gradient
  without calling ``parallel/mesh.py``, so a gradient hook on its outputs
  records the transpose (an all-gather's as a reduce-scatter, a
  broadcast's as an all-reduce, the others as their own kind) when the
  backward first reaches them; the hook adds no node to the graph, and
  outside a dry run nothing is hooked;
- **multipliers**: in a K-step ``run_steps`` program (``loop_trips=K``)
  the records of one kind, payload, axes, op path and provenance that
  number a multiple of K are the loop's: ``in_loop``, multiplier K
  (flopcheck's rule).

``mesh.COUNTERS`` keep counting the forward calls as before; the inventory
adds the transposes and the pipeline's final move to the caller (which
``COUNTERS`` does not count).

Four lints ride ``tracecheck``'s :class:`Finding` framework and shared
suppression registry (``tracecheck.COMM_LINTS``), with the JAX package's
thresholds and knobs:

====================  ====================================================
lint id               fires when
====================  ====================================================
``resharding-copy``   a collective other than an all-reduce or a permute
                      (which keeps each position's one shard) reads an
                      entry argument's storage directly: its declared
                      layout is re-laid-out before first use
``replicated-large``  an all-gather or broadcast materializes more than
                      ``MXTPU_COMMSCHECK_REPL_BYTES`` (default 1 MiB)
                      whole on every position of its group
``gather-in-loop``    a collective other than an all-reduce or a
                      permute (``DEFAULT_LOOP_ALLOW``) runs in the K-step
                      loop: it pays its bandwidth K times a dispatch
                      (tracecheck's ``collective-in-scan`` is a thin alias
                      over this pass)
``comms-bound``       the roofline's predicted scaling efficiency is below
                      ``MXTPU_COMMSCHECK_MIN_EFF`` (default 0.5)
====================  ====================================================

The roofline is a model, not a measurement: ring wire bytes over
``devspec``'s one-way link rate (the H100's NVLink, 450e9 B/s) against one
position's FLOPs a loop iteration, from flopcheck's kernel records of the
same dry run, over the bf16 peak (the JAX definition); zero overlap. On
one card the link time cannot be measured, so ``comm_seconds`` stays a
model there.

A report whose dry run failed carries ``hlo_unavailable`` (the JAX name):
its empty inventory is absence of evidence, never a clean audit; the drift
gate, the CLI and the ``error`` hooks fail it.

CLI::

    python -m mxnet_tpu_torch.commscheck --models mlp,lenet --json --device cpu
    python -m mxnet_tpu_torch.commscheck --sharded --device cuda:0 --json
    python -m mxnet_tpu_torch.commscheck --zoo --sharded --write-baseline F

``--baseline`` is the drift gate: every program's per-dispatch collective
count and payload bytes against a baseline within ``MXTPU_COMMSCHECK_TOL``
(10%); a program pinned at zero fails on its first collective. Without
``--device`` the programs run on ``cuda:0``. The exit status is non-zero
iff an unsuppressed finding or a baseline regression remains.
``MXTPU_COMMSCHECK=warn|error`` (``engine.commscheck_mode``) arms a
one-time audit of each mesh ``TrainStep`` dispatch key's program
(:func:`maybe_audit_dispatch`) and of a ``ServingEngine`` or
``DecodeLoop`` at load.

Not ported: ``analyze_compiled`` and ``parse_collectives`` (there is no
XLA executable or HLO text; each raises ``MXNetError``).
"""
from __future__ import annotations

import contextlib
import json
import logging
import sys

from .base import MXNetError, env_float, env_str
from .tracecheck import (Finding, COMM_LINTS, _is_suppressed, unsuppressed,
                         ZOO)
from .memcheck import _fmt_bytes, _parse_bytes, _reports_platform
from . import devspec

__all__ = [
    "CollectiveEntry", "CommsReport", "parse_collectives", "analyze",
    "analyze_compiled", "struct_args", "lint_report", "loop_findings",
    "check_program", "check_train_step", "check_zoo", "sharded_programs",
    "check_sharded", "compare_baseline", "write_baseline", "repl_bytes",
    "min_efficiency", "tolerance", "link_bandwidth", "peak_flops", "main",
    "COMM_LINTS",
]

#: the in-loop allow list: ``all-reduce`` is the expected gradient/metric
#: sum and ``collective-permute`` the ring/pipeline schedule
DEFAULT_LOOP_ALLOW = ("all-reduce", "collective-permute")


def link_bandwidth(device=None):
    """``devspec.link_bandwidth`` of ``device`` (None: ``cuda:0``)."""
    return devspec.link_bandwidth(device)


def peak_flops(device=None):
    """``devspec.peak_flops`` of ``device`` (None: ``cuda:0``)."""
    return devspec.peak_flops(device)


def repl_bytes():
    """``replicated-large`` threshold (``MXTPU_COMMSCHECK_REPL_BYTES``,
    bytes with K/M/G/T binary suffixes; default 1 MiB)."""
    env = _parse_bytes(env_str("MXTPU_COMMSCHECK_REPL_BYTES"),
                       "MXTPU_COMMSCHECK_REPL_BYTES")
    return env if env is not None else (1 << 20)


def min_efficiency():
    """``comms-bound`` floor: predicted scaling efficiency below this
    fails (``MXTPU_COMMSCHECK_MIN_EFF``, default 0.5)."""
    return env_float("MXTPU_COMMSCHECK_MIN_EFF", 0.5)


def tolerance():
    """Baseline drift-gate tolerance band (``MXTPU_COMMSCHECK_TOL``,
    default 0.1 = 10% growth allowed per program per metric)."""
    return env_float("MXTPU_COMMSCHECK_TOL", 0.1)


def parse_collectives(*args, **kwargs):
    """Walks scheduled partitioned HLO; the port has none (raises)."""
    raise MXNetError("commscheck.parse_collectives walks XLA's scheduled "
                     "partitioned HLO, which the port does not have; "
                     "commscheck.analyze records the collectives of a "
                     "shape-only dry run instead")


def analyze_compiled(*args, **kwargs):
    """Reads an XLA executable; the port has none (raises: use
    :func:`analyze`)."""
    raise MXNetError("commscheck.analyze_compiled reads an XLA executable's "
                     "HLO, which the port does not have; commscheck.analyze "
                     "records a program's collectives by a shape-only dry "
                     "run instead")


def _wire_bytes(kind, payload, group_size):
    """Predicted on-the-wire bytes per position for one execution of a
    collective (ring costs): an all-reduce moves 2(n-1)/n x its payload,
    an all-gather, all-to-all or broadcast (n-1)/n x its result, a
    reduce-scatter (n-1) x its (scattered) result, a permute its payload.
    An unknown group size charges one payload, never zero."""
    if group_size is None:
        return payload
    n = group_size
    if n <= 1:
        return 0 if kind != "collective-permute" else payload
    if kind == "all-reduce":
        return int(2 * (n - 1) * payload / n)
    if kind in ("all-gather", "all-to-all", "collective-broadcast"):
        return int((n - 1) * payload / n)
    if kind == "reduce-scatter":
        return int((n - 1) * payload)
    return payload  # collective-permute


class CollectiveEntry(object):
    """One collective of a program (the JAX package's fields; ``groups``
    is None: the port's records carry no device groups). ``transpose``
    marks a collective the backward ran (not in :meth:`as_dict`, whose keys
    are the JAX package's)."""

    __slots__ = ("instruction", "kind", "bytes", "wire_bytes", "group_size",
                 "axes", "groups", "in_loop", "multiplier", "op_path",
                 "provenance", "operand_params", "transpose")

    def __init__(self, instruction, kind, nbytes, wire_bytes, group_size,
                 axes, groups, in_loop, multiplier, op_path, provenance,
                 operand_params=(), transpose=False):
        self.instruction = instruction
        self.kind = kind
        self.bytes = int(nbytes)
        self.wire_bytes = int(wire_bytes)
        self.group_size = group_size
        #: mesh axis names the group runs along (None = not named)
        self.axes = axes
        self.groups = groups
        #: in the K-step loop: runs K times a dispatch
        self.in_loop = bool(in_loop)
        #: executions a dispatch (loop trips when in_loop, else 1)
        self.multiplier = int(multiplier)
        self.op_path = op_path
        self.provenance = provenance
        #: entry-argument labels this collective reads DIRECTLY (a
        #: non-empty list means a declared layout is re-laid-out)
        self.operand_params = list(operand_params)
        self.transpose = bool(transpose)

    def as_dict(self):
        return {
            "instruction": self.instruction, "kind": self.kind,
            "bytes": self.bytes, "wire_bytes": self.wire_bytes,
            "group_size": self.group_size,
            "axes": list(self.axes) if self.axes else None,
            "in_loop": self.in_loop, "multiplier": self.multiplier,
            "op_path": self.op_path, "provenance": self.provenance,
            "operand_params": list(self.operand_params),
        }

    def format(self):
        where = self.op_path or self.instruction
        if self.provenance:
            where += " @ " + self.provenance
        ax = "axes=%s" % ",".join(self.axes) if self.axes else "axes=?"
        return ("%10s x%-3d %-18s %-12s %s"
                % (_fmt_bytes(self.bytes), self.multiplier, self.kind,
                   ax, where))

    def __repr__(self):
        return "CollectiveEntry(%s)" % self.format()


def _entries(records, loop_trips=1):
    """The dry run's collective records as :class:`CollectiveEntry`s, in
    payload order. Records alike in kind, payload, group, axes, op path,
    provenance, direction and arguments that number a multiple of
    ``loop_trips`` K > 1 are the loop's: one entry per K of them,
    ``in_loop`` with multiplier K (flopcheck's rule); every other record
    is an entry of multiplier 1."""
    groups = {}
    for r in records:
        key = (r["kind"], r["bytes"], r["group_size"], r["axes"],
               r["op_path"], r["provenance"], r["transpose"],
               r["operand_params"])
        groups.setdefault(key, []).append(r)
    trips = max(1, int(loop_trips))
    out = []
    for rs in groups.values():
        in_loop = trips > 1 and len(rs) % trips == 0
        for r in (rs[:len(rs) // trips] if in_loop else rs):
            out.append(CollectiveEntry(
                "%s#%d%s" % (r["kind"], r["seq"],
                             "/transpose" if r["transpose"] else ""),
                r["kind"], r["bytes"],
                _wire_bytes(r["kind"], r["bytes"], r["group_size"]),
                r["group_size"], r["axes"], None, in_loop,
                trips if in_loop else 1, r["op_path"], r["provenance"],
                operand_params=r["operand_params"],
                transpose=r["transpose"]))
    out.sort(key=lambda e: e.bytes * e.multiplier, reverse=True)
    return out


# ---------------------------------------------------------------------------
# the report + roofline
# ---------------------------------------------------------------------------

class CommsReport(object):
    """Static communication profile of ONE program.

    ``collective_count`` / ``collective_bytes`` are per-dispatch totals
    (in-loop entries multiplied by the trip count), the two numbers the
    baseline pins. The roofline predicts one loop iteration:
    ``comm_seconds`` spreads the outside-loop wire bytes over the trips,
    ``compute_seconds`` is one position's FLOPs an iteration over the bf16
    peak of ``device``'s ``devspec`` row, and ``predicted_efficiency =
    compute / (compute + comm)``, the zero-overlap bound on scaling
    efficiency. ``hlo_unavailable`` (the JAX name) marks a report whose dry
    run failed: no evidence, not a clean audit."""

    __slots__ = ("program", "platform", "n_devices", "entries",
                 "loop_trips", "flops", "link_bytes_per_s",
                 "peak_flops_per_s", "hlo_unavailable", "device")

    def __init__(self, program, platform, n_devices, entries, loop_trips=1,
                 flops=None, link_bytes_per_s=None, peak_flops_per_s=None,
                 hlo_unavailable=False, device=None):
        self.program = program
        self.platform = platform
        if device is None:
            device = "cuda:0" if platform == "gpu" else "cpu"
        self.device = str(device)
        self.n_devices = int(n_devices)
        self.entries = list(entries)
        self.loop_trips = max(1, int(loop_trips))
        self.flops = None if flops is None else float(flops)
        self.link_bytes_per_s = (link_bandwidth(self.device)
                                 if link_bytes_per_s is None
                                 else float(link_bytes_per_s))
        self.peak_flops_per_s = (peak_flops(self.device)
                                 if peak_flops_per_s is None
                                 else float(peak_flops_per_s))
        #: the dry run failed: the (empty) inventory is absence of
        #: evidence, not a clean audit
        self.hlo_unavailable = bool(hlo_unavailable)

    @property
    def collective_count(self):
        return sum(e.multiplier for e in self.entries)

    @property
    def collective_bytes(self):
        return sum(e.bytes * e.multiplier for e in self.entries)

    @property
    def wire_bytes(self):
        return sum(e.wire_bytes * e.multiplier for e in self.entries)

    @property
    def comm_seconds(self):
        """Predicted collective seconds a loop iteration (outside-loop
        collectives amortized over the trips)."""
        per_iter = sum(
            e.wire_bytes * (1.0 if e.in_loop else 1.0 / self.loop_trips)
            for e in self.entries)
        return per_iter / self.link_bytes_per_s

    @property
    def compute_seconds(self):
        if self.flops is None:
            return None
        return self.flops / self.peak_flops_per_s

    @property
    def predicted_efficiency(self):
        """Zero-overlap roofline bound on scaling efficiency; 1.0 for a
        collective-free program, None when a communicating program has no
        FLOP count or when the dry run failed (an unaudited program is not
        a collective-free one)."""
        if self.hlo_unavailable:
            return None
        if not self.entries:
            return 1.0
        tc = self.compute_seconds
        if tc is None:
            return None
        comm = self.comm_seconds
        return tc / (tc + comm) if (tc + comm) > 0 else 1.0

    def counts_by_kind(self):
        out = {}
        for e in self.entries:
            out[e.kind] = out.get(e.kind, 0) + e.multiplier
        return out

    def breakdown(self, top=6):
        return [e.format() for e in self.entries[:top]]

    def as_dict(self):
        return {
            "program": self.program,
            "platform": self.platform,
            "n_devices": self.n_devices,
            "hlo_unavailable": self.hlo_unavailable,
            "collective_count": self.collective_count,
            "collective_bytes": self.collective_bytes,
            "wire_bytes": self.wire_bytes,
            "counts_by_kind": self.counts_by_kind(),
            "loop_trips": self.loop_trips,
            "flops": self.flops,
            "predicted_efficiency": self.predicted_efficiency,
            "entries": [e.as_dict() for e in self.entries],
        }

    def format(self):
        eff = self.predicted_efficiency
        return ("%s: %d collective(s)/dispatch, %s payload, predicted "
                "efficiency %s"
                % (self.program, self.collective_count,
                   _fmt_bytes(self.collective_bytes),
                   "?" if eff is None else "%.3f" % eff))

    def __repr__(self):
        return "CommsReport(%s)" % self.format()


def _infer_mesh(args, kwargs=None):
    """The mesh of the first MeshArray among the arguments (None when
    there is none: a TrainStep's state holds its replicas as lists, so its
    callers pass ``ts.mesh``)."""
    from .parallel.mesh import MeshArray

    def find(obj):
        if isinstance(obj, MeshArray):
            return obj.mesh
        vals = (obj.values() if isinstance(obj, dict) else
                obj if isinstance(obj, (list, tuple)) else ())
        for v in vals:
            m = find(v)
            if m is not None:
                return m
        return None
    return find((tuple(args), dict(kwargs or {})))


def struct_args(args):
    """``args`` with every tensor (MeshArray parts included) replaced by a
    fake one of the same shape, dtype, device and storage sharing, no data
    copied (memcheck's fake copy): the call signature of a program, safe
    to take from a state the dispatch just updated in place."""
    from .memcheck import fake_mode, fake_tree
    with fake_mode(like=args) as m:
        return fake_tree(args, m)


def _report(run, name, mesh=None, loop_trips=1, device=None):
    """The :class:`CommsReport` of a memcheck dry run (``run``, taken with
    ``kernels=True``): its collective records, and one position's FLOPs an
    iteration from its kernel records."""
    import torch
    from .memcheck import _platform
    dev = run.device if device is None else torch.device(device)
    records = run.tracker.collectives
    if mesh is not None:
        n_dev = len(mesh.replica_devices())
    else:
        n_dev = max([r["group_size"] or 1 for r in records] + [1])
    trips = max(1, int(loop_trips))
    flops = sum(r["flops"] for r in run.tracker.kernels or ())
    return CommsReport(name, _platform(torch.device(dev)), n_dev,
                       _entries(records, trips), loop_trips=trips,
                       flops=(flops / n_dev / trips) or None, device=dev)


def analyze(fn, args=(), kwargs=None, name=None, mesh=None, loop_trips=1,
            device=None):
    """Run ``fn(*args, **kwargs)`` once shape-only (memcheck's dry run:
    real tensor arguments become fake ones, nothing is allocated and no
    kernel launches) and return its :class:`CommsReport`, priced for
    ``device`` (default: the program's own). ``mesh`` defaults to the first
    MeshArray's among the arguments; ``loop_trips`` is the scan depth K.
    A dry run that fails raises."""
    from .memcheck import _dry_run
    kwargs = dict(kwargs or {})
    if name is None:
        name = getattr(fn, "__name__", None) or repr(fn)
    if mesh is None:
        mesh = _infer_mesh(args, kwargs)
    run = _dry_run(fn, args, kwargs, (), name, kernels=True)
    return _report(run, name, mesh, loop_trips, device)


def _blind(name, device, mesh=None):
    """The report of a program whose dry run failed."""
    import torch
    from .memcheck import _platform
    dev = torch.device(device)
    return CommsReport(name, _platform(dev), 1 if mesh is None else
                       len(mesh.replica_devices()), [], device=dev,
                       hlo_unavailable=True)


# ---------------------------------------------------------------------------
# lints
# ---------------------------------------------------------------------------

def loop_findings(report_or_entries, name, lint="gather-in-loop",
                  allow=DEFAULT_LOOP_ALLOW):
    """In-loop collective findings over an inventory: every in-loop
    collective whose kind is not in ``allow``. Shared by this module's
    ``gather-in-loop`` lint and tracecheck's ``collective-in-scan`` alias.
    Suppressions are NOT applied here; callers do."""
    entries = (report_or_entries.entries
               if isinstance(report_or_entries, CommsReport)
               else report_or_entries)
    findings = []
    for e in entries:
        if not e.in_loop or e.kind in (allow or ()):
            continue
        mult = (", x%d per dispatch" % e.multiplier
                if e.multiplier > 1 else "")
        findings.append(Finding(
            lint, name,
            "program runs %r inside the K-step loop (%s per execution%s) "
            "— the K-step dispatch should sync only by all-reduce "
            "(gradient and metric sums) and ppermute (the ring schedule); "
            "this collective pays its bandwidth every loop trip"
            % (e.kind, _fmt_bytes(e.bytes), mult),
            op_path=e.op_path or e.instruction, provenance=e.provenance))
    return findings


def lint_report(report, repl_threshold=None, min_eff=None,
                allow=DEFAULT_LOOP_ALLOW):
    """The four communication lints over one :class:`CommsReport`:
    ``resharding-copy``, ``replicated-large``, ``gather-in-loop``,
    ``comms-bound``. Returns findings with suppressions applied."""
    repl_threshold = (repl_bytes() if repl_threshold is None
                      else int(repl_threshold))
    min_eff = min_efficiency() if min_eff is None else float(min_eff)
    name = report.program
    findings = []

    for e in report.entries:
        # a collective reading an entry argument directly re-lays-out its
        # declared layout before first use (all-reduce excluded: summing
        # an argument is an application sum, not a layout change; and a
        # permute: the ring and the pipeline rotate shards a position on,
        # each keeping one, where the JAX package's while body permutes
        # its carry)
        if e.operand_params and e.kind not in ("all-reduce",
                                               "collective-permute"):
            findings.append(Finding(
                "resharding-copy", name,
                "entry argument %s is re-laid-out by %r (%s%s) before "
                "first use — its declared layout does not match what the "
                "program computes with; land it laid out as used (the way "
                "the superbatch lands pre-sharded) or fix the declared "
                "layout"
                % (", ".join(repr(p) for p in e.operand_params), e.kind,
                   _fmt_bytes(e.bytes),
                   ", axes " + ",".join(e.axes) if e.axes else ""),
                op_path=e.op_path or e.instruction,
                provenance=e.provenance))
        # an all-gather this big means every position of the group holds
        # the full array: a replicated intermediate where a split one was
        if (e.kind in ("all-gather", "collective-broadcast")
                and e.bytes > repl_threshold):
            findings.append(Finding(
                "replicated-large", name,
                "%r materializes %s replicated%s (> %s, "
                "MXTPU_COMMSCHECK_REPL_BYTES): every position of the group "
                "holds the full array where a split operand existed — keep "
                "it split or raise the threshold if replication is intended"
                % (e.kind, _fmt_bytes(e.bytes),
                   " across axis " + ",".join(e.axes) if e.axes else "",
                   _fmt_bytes(repl_threshold)),
                op_path=e.op_path or e.instruction,
                provenance=e.provenance))

    findings += loop_findings(report, name, lint="gather-in-loop",
                              allow=allow)

    eff = report.predicted_efficiency
    if eff is not None and report.entries and eff < min_eff:
        findings.append(Finding(
            "comms-bound", name,
            "predicted scaling efficiency %.3f is below the floor %.2f "
            "(MXTPU_COMMSCHECK_MIN_EFF): predicted compute %.3g s vs "
            "collective %.3g s per iteration at %s/s link bandwidth — "
            "the program is communication-bound before it ever runs. "
            "Inventory:\n  %s"
            % (eff, min_eff, report.compute_seconds, report.comm_seconds,
               _fmt_bytes(int(report.link_bytes_per_s)),
               "\n  ".join(report.breakdown())),
            op_path=(report.entries[0].op_path
                     or report.entries[0].instruction),
            provenance=report.entries[0].provenance))

    for f in findings:
        f.suppressed = _is_suppressed(f)
    return findings


def check_program(fn, args=(), kwargs=None, name=None, mesh=None,
                  loop_trips=1, repl_threshold=None, min_eff=None,
                  allow=DEFAULT_LOOP_ALLOW, device=None):
    """Analyze + lint ONE program; returns ``(findings, report)``."""
    report = analyze(fn, args, kwargs=kwargs, name=name, mesh=mesh,
                     loop_trips=loop_trips, device=device)
    return lint_report(report, repl_threshold=repl_threshold,
                       min_eff=min_eff, allow=allow), report


# ---------------------------------------------------------------------------
# the dispatch hook (MXTPU_COMMSCHECK / engine.commscheck_mode)
# ---------------------------------------------------------------------------

#: program names the dispatch hook audited: one dry run a program a process
_AUDITED = set()


def maybe_audit_dispatch(name, fn, call_args, loop_trips=1, mesh=None,
                         device=None):
    """One-time communication audit of a mesh program at its first
    dispatch (``TrainStep``'s hook when it has a mesh): under
    ``MXTPU_COMMSCHECK=warn`` unsuppressed findings are logged, under
    ``error`` they raise :class:`MXNetError`, as a dry run that fails
    does (no evidence is not a clean audit); ``off`` (the default) skips.
    The call arguments are faked first (:func:`struct_args`), so the state
    is never touched. Returns the report (None when skipped or failed)."""
    from . import engine
    mode = engine.commscheck_mode()
    if mode == "off" or name in _AUDITED:
        return None
    _AUDITED.add(name)
    # knobs resolve before the guard below: a malformed knob raises
    # instead of disarming the gate the operator set
    repl = repl_bytes()
    floor = min_efficiency()
    try:
        findings, report = check_program(
            fn, struct_args(tuple(call_args)), name=name, mesh=mesh,
            loop_trips=loop_trips, repl_threshold=repl, min_eff=floor,
            device=device)
    except Exception as exc:    # noqa: BLE001 -- reported as no evidence
        msg = ("commscheck: the dry run of %s failed (%r) — the "
               "MXTPU_COMMSCHECK audit could not run" % (name, exc))
        if mode == "error":
            raise MXNetError(msg) from exc
        logging.warning(msg)
        return None
    bad = unsuppressed(findings)
    if bad:
        msg = ("commscheck: %d finding(s) on sharded program %s "
               "(MXTPU_COMMSCHECK):\n%s"
               % (len(bad), name, "\n".join(f.format() for f in bad)))
        if mode == "error":
            raise MXNetError(msg)
        logging.warning(msg)
    return report


# ---------------------------------------------------------------------------
# TrainStep / zoo / sharded-set auditing
# ---------------------------------------------------------------------------

def _trips(pname, k):
    return k if "/scan[" in pname or "-scan[" in pname else 1


def check_train_step(ts, data_shapes, label_shapes, k=2, guard=True,
                     name=None, repl_threshold=None, min_eff=None):
    """Comms-audit a :class:`~mxnet_tpu_torch.train_step.TrainStep`'s
    program set (``tracecheck.train_step_programs``, the analyzers' shared
    recipe). Returns ``(findings, reports)``. A one-device set carries no
    collectives: its inventory pins ZERO in a baseline."""
    from .tracecheck import train_step_programs
    name = name or "TrainStep(%s)" % ts.symbol.name
    findings = []
    reports = {}
    for pname, fn, pargs in train_step_programs(
            ts, data_shapes, label_shapes, k=k, guard=guard, name=name):
        fs, rep = check_program(fn, pargs, name=pname, mesh=ts.mesh,
                                loop_trips=_trips(pname, k),
                                repl_threshold=repl_threshold,
                                min_eff=min_eff)
        findings += fs
        reports[pname] = rep
    return findings, reports


def check_zoo(names=None, k=2, guard=True, repl_threshold=None,
              min_eff=None, log=None, device=None):
    """Comms-audit the model zoo's step programs (``tracecheck.ZOO``) on
    ``device`` (default ``cuda:0``); returns ``(findings, reports)``."""
    from .tracecheck import zoo_train_step
    names = list(names) if names else sorted(ZOO)
    findings = []
    reports = {}
    for mname in names:
        if mname not in ZOO:
            raise MXNetError("commscheck: unknown zoo model %r (have %s)"
                             % (mname, ", ".join(sorted(ZOO))))
        if log:
            log("commscheck: analyzing %s ..." % mname)
        ts, data_shapes, label_shapes = zoo_train_step(mname, device=device)
        fs, reps = check_train_step(
            ts, data_shapes, label_shapes,
            k=k, guard=guard, name=mname, repl_threshold=repl_threshold,
            min_eff=min_eff)
        findings += fs
        reports.update(reps)
    return findings, reports


def sharded_programs(n_devices=8, k=2, device=None):
    """The JAX package's sharded gate set over ``n_devices`` positions on
    ``device`` (default ``cuda:0``; positions share it), as ``(name, fn,
    args, loop_trips, mesh, scope_mesh)`` tuples whose arguments are fake
    tensors laid out over the mesh (nothing allocated):

    * ``dp8/lenet/scan[k=2]``: the K-step scan over an 8-way 'data' mesh
      (the superbatch split along 'data', the parameters replicated);
    * ``dp4xtp2/resnet18/step``: the step over data x model with the
      classifier FC split along 'model';
    * ``dp4xsp2/transformer-ring/step``: the ring-attention transformer
      over data x seq (the K/V ring in the attention);
    * ``dp4xsp2/transformer-ring/scan[k=2]``: the same over the K-step
      scan with the rank-3 ``preserve_shape`` head and the positional
      table split along 'seq'.

    ``scope_mesh`` (when set) is entered as the ambient ``MeshScope``
    while the program runs, as in the JAX package (a ``TrainStep`` enters
    its own too)."""
    import torch
    from . import models
    from .context import resolve_device
    from .memcheck import fake_mode
    from .parallel.mesh import (P, MeshScope, data_parallel_mesh,
                                make_mesh)
    from .train_step import TrainStep
    dev = resolve_device(device, "commscheck --sharded")
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        raise MXNetError(
            "commscheck --sharded: this build of torch has no CUDA backend, "
            "which autograd needs even on fake tensors on %s; pass "
            "--device cpu" % dev)
    devs = [dev] * n_devices
    f32 = torch.float32
    progs = []

    def fake_args(ts, data_shapes, label_shapes, batch_shapes, lead):
        # the state and the batch laid out over the mesh, as fake tensors
        # of one mode
        with fake_mode():
            state = ts.init(data_shapes, label_shapes,
                            initializer=lambda desc, arr: None, seed=0)
            vals = {n: torch.empty(s, dtype=f32, device=dev)
                    for n, s in batch_shapes.items()}
            return state, (ts.shard_superbatch(vals) if lead
                           else ts.shard_batch(vals))

    # 1) dp lenet K-step scan
    mesh = data_parallel_mesh(n_devices, devices=devs)
    batch = 64
    ts = TrainStep(models.lenet(num_classes=10), optimizer="sgd",
                   learning_rate=0.1, momentum=0.9, mesh=mesh)
    args = fake_args(ts, {"data": (batch, 1, 28, 28)},
                     {"softmax_label": (batch,)},
                     {"data": (k, batch, 1, 28, 28),
                      "softmax_label": (k, batch)}, 1)
    progs.append(("dp%d/lenet/scan[k=%d]" % (n_devices, k),
                  _program(ts, scan=True), args, k, mesh, None))

    # 2) resnet18 dp x tp step: the classifier FC split along 'model'
    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    mesh2 = make_mesh({"data": dp, "model": tp}, devs)
    ts2 = TrainStep(models.resnet(num_classes=64, num_layers=18,
                                  image_shape="3,32,32"),
                    optimizer="sgd", learning_rate=0.1, momentum=0.9,
                    mesh=mesh2,
                    param_shardings={"fc1_weight": P("model", None),
                                     "fc1_bias": P("model")})
    b2 = 2 * dp
    shapes2 = {"data": (b2, 3, 32, 32)}, {"softmax_label": (b2,)}
    args2 = fake_args(ts2, *shapes2, dict(shapes2[0], **shapes2[1]), 0)
    progs.append(("dp%dxtp%d/resnet18/step" % (dp, tp), _program(ts2),
                  args2, 1, mesh2, None))

    # 3) ring-attention transformer dp x sp step
    sp = max(n_devices // dp, 1)
    mesh3 = make_mesh({"data": dp, "seq": sp}, devs)
    seq_len = 8 * sp
    b3 = 2 * dp
    sym3 = models.transformer(vocab_size=64, embed=32, num_heads=4,
                              num_layers=2, seq_len=seq_len,
                              seq_parallel="ring")
    shapes3 = {"data": (b3, seq_len)}, {"softmax_label": (b3, seq_len)}
    with MeshScope(mesh3):
        ts3 = TrainStep(sym3, optimizer="sgd", learning_rate=0.1,
                        mesh=mesh3)
        args3 = fake_args(ts3, *shapes3, dict(shapes3[0], **shapes3[1]), 0)
    progs.append(("dp%dxsp%d/transformer-ring/step" % (dp, sp),
                  _program(ts3), args3, 1, mesh3, mesh3))

    # 4) the same over the K-step scan with the rank-3 head, the
    # positional table's rows living with their 'seq' shard
    sym4 = models.transformer(vocab_size=64, embed=32, num_heads=4,
                              num_layers=2, seq_len=seq_len,
                              seq_parallel="ring", preserve_shape=True)
    with MeshScope(mesh3):
        ts4 = TrainStep(sym4, optimizer="sgd", learning_rate=0.1,
                        mesh=mesh3,
                        param_shardings={"pos_embed_weight":
                                         P("seq", None)})
        args4 = fake_args(ts4, *shapes3,
                          {"data": (k, b3, seq_len),
                           "softmax_label": (k, b3, seq_len)}, 1)
    progs.append(("dp%dxsp%d/transformer-ring/scan[k=%d]" % (dp, sp, k),
                  _program(ts4, scan=True), args4, k, mesh3, mesh3))
    return progs


def _program(ts, scan=False):
    """A ``TrainStep`` program (``tracecheck.StepProgram``, which holds its
    step by weak reference) as a function that keeps the step alive."""
    from .tracecheck import StepProgram
    prog = StepProgram(ts, scan=scan)

    def run(state, batch):
        return prog(state, batch)
    run.ts = ts
    return run


def check_sharded(n_devices=8, k=2, repl_threshold=None, min_eff=None,
                  log=None, device=None):
    """Comms-audit the sharded gate set on ``device``; returns
    ``(findings, reports)``."""
    findings = []
    reports = {}
    from .parallel.mesh import MeshScope
    for name, fn, args, trips, mesh, scope in sharded_programs(
            n_devices=n_devices, k=k, device=device):
        if log:
            log("commscheck: analyzing %s ..." % name)
        ambient = (MeshScope(scope) if scope is not None
                   else contextlib.nullcontext())
        with ambient:
            fs, rep = check_program(fn, args, name=name, mesh=mesh,
                                    loop_trips=trips,
                                    repl_threshold=repl_threshold,
                                    min_eff=min_eff)
        findings += fs
        reports[name] = rep
    return findings, reports


# ---------------------------------------------------------------------------
# the baseline drift gate
# ---------------------------------------------------------------------------

#: metrics the baseline pins per program: deterministic counts, so there
#: is NO absolute slack: a collective where the baseline pinned zero fails
#: at any tolerance
_BASELINE_METRICS = ("collective_count", "collective_bytes")


def write_baseline(reports, path, tol=None):
    """Write the baseline: per-program collective count and bytes, keyed by
    the reports' platform (a CPU baseline must not gate a card's run).
    Refuses reports without evidence (a failed dry run): a fabricated zero
    would pin the gate on nothing."""
    from .model import atomic_write_bytes
    blind = sorted(n for n, r in reports.items()
                   if getattr(r, "hlo_unavailable", False))
    if blind:
        raise MXNetError(
            "write_baseline: the dry run failed for %s — their inventories "
            "are absence of evidence, not zeros; refusing to commit a "
            "fabricated baseline" % ", ".join(blind))
    data = {
        "platform": _reports_platform(reports),
        "tolerance": tolerance() if tol is None else float(tol),
        "programs": {
            name: {m: int(getattr(rep, m)) for m in _BASELINE_METRICS}
            for name, rep in sorted(reports.items())},
    }
    atomic_write_bytes(path, (json.dumps(data, indent=2, sort_keys=True)
                              + "\n").encode())
    return data


def compare_baseline(reports, baseline, tol=None):
    """The drift gate: compare every report against the baseline. Returns
    ``(failures, notes)``: a program whose collective count or payload
    bytes grew past the tolerance band fails with its inventory (byte
    counts and provenance); a program missing from the baseline, a
    nonzero-pinned program collapsing to zero and a failed dry run fail
    too. Shrinks and stale entries are notes; a baseline of another
    platform skips the gate with one note."""
    if isinstance(baseline, str):
        with open(baseline) as f:
            baseline = json.load(f)
    if tol is None:
        # explicit arg > MXTPU_COMMSCHECK_TOL > the baseline's band > 0.1
        tol = env_float("MXTPU_COMMSCHECK_TOL",
                        float(baseline.get("tolerance", 0.1)))
    else:
        tol = float(tol)
    platform = (_reports_platform(reports) if reports
                else baseline.get("platform"))
    failures, notes = [], []
    if baseline.get("platform") != platform:
        notes.append(
            "commscheck baseline was written on platform %r but this run "
            "is %r — skipping the drift gate (re-run --write-baseline on "
            "this platform to arm it)"
            % (baseline.get("platform"), platform))
        return failures, notes
    base_progs = dict(baseline.get("programs") or {})
    for name, rep in sorted(reports.items()):
        base = base_progs.pop(name, None)
        if getattr(rep, "hlo_unavailable", False):
            failures.append(
                "%s: the dry run failed — the collective inventory could "
                "not be audited; the drift gate refuses to pass on absence "
                "of evidence" % name)
            continue
        if base is None:
            failures.append(
                "%s: not in the baseline — a new program must be added "
                "deliberately (run `python -m mxnet_tpu_torch.commscheck "
                "--zoo --sharded --write-baseline FILE` and commit the "
                "diff)" % name)
            continue
        for metric in _BASELINE_METRICS:
            b = int(base.get(metric, 0))
            cur = int(getattr(rep, metric))
            allowed = b + int(b * tol)
            if cur > allowed:
                breakdown = "\n  ".join(rep.breakdown()) or "(empty)"
                failures.append(
                    "%s: %s grew %d -> %d (tolerance %.0f%%, "
                    "MXTPU_COMMSCHECK_TOL) — a collective was added or "
                    "its payload grew. Inventory:\n  %s"
                    % (name, metric, b, cur, 100.0 * tol, breakdown))
            elif cur == 0 and b > 0:
                # a nonzero-pinned program collapsing to zero is
                # indistinguishable from an inventory gone blind: fail
                failures.append(
                    "%s: %s collapsed %d -> 0 — either the program "
                    "genuinely stopped communicating (refresh the "
                    "baseline deliberately) or the inventory went blind; "
                    "the gate refuses to treat a total collapse as a win"
                    % (name, metric, b))
            elif cur < b - int(b * tol) and b > 0:
                notes.append(
                    "%s: %s shrank %d -> %d — nice; refresh the baseline "
                    "to lock the win in" % (name, metric, b, cur))
    for name in sorted(base_progs):
        notes.append("baseline entry %r matches no audited program "
                     "(stale — refresh the baseline)" % name)
    return failures, notes


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def report_table(reports, out=None):
    out = out or sys.stdout
    w = max([len(n) for n in reports] + [8])
    out.write("%-*s  %6s %12s %12s %8s\n"
              % (w, "program", "coll", "payload", "wire", "pred-eff"))
    for name in sorted(reports):
        r = reports[name]
        eff = r.predicted_efficiency
        out.write("%-*s  %6d %12s %12s %8s\n"
                  % (w, name, r.collective_count,
                     _fmt_bytes(r.collective_bytes),
                     _fmt_bytes(r.wire_bytes),
                     "?" if eff is None else "%.3f" % eff))


def main(argv=None):
    import argparse
    from . import tracecheck as _tc
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.commscheck",
        description="Collective-communication analyzer of the port's mesh "
                    "programs, from a shape-only dry run: per-program "
                    "collective inventory (kind/axes/bytes/loop "
                    "multiplier), resharding/replication/in-loop-gather "
                    "lints, a comms roofline, and the baseline drift gate.")
    p.add_argument("--zoo", action="store_true",
                   help="analyze every shipped model's step/scan programs")
    p.add_argument("--models", default=None,
                   help="comma-separated zoo subset (implies --zoo)")
    p.add_argument("--sharded", action="store_true",
                   help="also analyze the sharded gate set (dp lenet scan, "
                        "dp x tp resnet18, dp x sp ring transformer step "
                        "and scan) over --devices positions on --device")
    p.add_argument("--devices", type=int, default=8,
                   help="positions for --sharded (default 8)")
    p.add_argument("--k", type=int, default=2,
                   help="scan depth for the K-step programs (default 2)")
    p.add_argument("--no-guard", action="store_true",
                   help="skip the guarded program variants")
    p.add_argument("--repl-bytes", default=None,
                   help="replicated-large threshold (K/M/G/T suffixes ok; "
                        "default MXTPU_COMMSCHECK_REPL_BYTES or 1 MiB)")
    p.add_argument("--min-eff", type=float, default=None,
                   help="comms-bound efficiency floor (default "
                        "MXTPU_COMMSCHECK_MIN_EFF or 0.5)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="compare against a baseline (the drift gate); exit "
                        "non-zero on collective count/byte growth past "
                        "tolerance")
    p.add_argument("--write-baseline", default=None, metavar="FILE",
                   help="write the per-program baseline JSON and exit 0")
    p.add_argument("--tol", type=float, default=None,
                   help="baseline tolerance band (default "
                        "MXTPU_COMMSCHECK_TOL, the baseline's own, or 0.1)")
    p.add_argument("--json", action="store_true", help="JSON output")
    p.add_argument("--list", action="store_true",
                   help="list zoo models and exit")
    p.add_argument("--quiet", action="store_true",
                   help="suppress progress lines")
    p.add_argument("--device", default=None,
                   help="the device the programs run on (default cuda:0; "
                        "'cpu' on a host without a card)")
    args = p.parse_args(argv)
    if args.list:
        for n in sorted(ZOO):
            print(n)
        return 0
    if not (args.zoo or args.models or args.sharded):
        p.error("nothing to check: pass --zoo, --models or --sharded")
    names = ([s.strip() for s in args.models.split(",") if s.strip()]
             if args.models else None)
    log = (lambda m: None) if (args.quiet or args.json) \
        else (lambda m: print(m, file=sys.stderr))
    repl = (None if args.repl_bytes is None
            else _parse_bytes(args.repl_bytes, "--repl-bytes"))
    findings, reports = [], {}
    if args.zoo or args.models:
        findings, reports = check_zoo(names=names, k=args.k,
                                      guard=not args.no_guard,
                                      repl_threshold=repl,
                                      min_eff=args.min_eff, log=log,
                                      device=args.device)
    if args.sharded:
        fs, reps = check_sharded(n_devices=args.devices, k=args.k,
                                 repl_threshold=repl,
                                 min_eff=args.min_eff, log=log,
                                 device=args.device)
        findings += fs
        reports.update(reps)
    if args.write_baseline:
        write_baseline(reports, args.write_baseline, tol=args.tol)
        log("commscheck: baseline written to %s (%d programs)"
            % (args.write_baseline, len(reports)))
        return 0
    failures, notes = [], []
    if args.baseline:
        failures, notes = compare_baseline(reports, args.baseline,
                                           tol=args.tol)
    else:
        # no gate running: an inventory that is no evidence still fails
        for n in sorted(reports):
            if reports[n].hlo_unavailable:
                failures.append(
                    "%s: the dry run failed — nothing was audited; refusing "
                    "to pass on absence of evidence" % n)
    bad = unsuppressed(findings)
    if args.json:
        print(json.dumps({
            "platform": _reports_platform(reports),
            "programs": {n: r.as_dict() for n, r in sorted(reports.items())},
            "comm_seconds": {n: r.comm_seconds
                             for n, r in sorted(reports.items())},
            "findings": [f.as_dict() for f in findings],
            "suppressed": len(findings) - len(bad),
            "baseline_failures": failures,
            "baseline_notes": notes,
        }, indent=2))
    else:
        report_table(reports)
        _tc.report(findings)
        for n in notes:
            print("note: %s" % n)
        for f in failures:
            print("BASELINE REGRESSION: %s" % f)
        print("commscheck: %d finding(s) (%d suppressed), %d baseline "
              "regression(s) over %d program(s)"
              % (len(findings), len(findings) - len(bad), len(failures),
                 len(reports)))
    return 1 if (bad or failures) else 0


if __name__ == "__main__":
    sys.exit(main())
