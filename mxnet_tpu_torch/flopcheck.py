"""flopcheck: the per-kernel compute/memory roofline of the port's step and
serving programs.

Counterpart of ``mxnet_tpu/flopcheck.py``. The JAX package compiles a
program without running it and walks XLA's scheduled HLO fusion by fusion;
an eager PyTorch program has no HLO, so the port's kernels are the aten
ops that :mod:`mxnet_tpu_torch.memcheck`'s shape-only dry run dispatches
(every op on fake tensors, nothing allocated on the device, no kernel
launched). One dry run yields both the program's ``MemoryReport`` and its
**kernel inventory** (:class:`KernelEntry`):

- **what is a kernel**: an op that makes a new storage or writes one.
  Views (``t``, ``expand``, ``as_strided``, ``detach``, ...: their outputs
  alias an input and they write nothing), allocation and metadata ops are
  not, as the JAX package's views are not;
- **FLOPs**: the matmul, convolution and attention families by
  ``torch.utils.flop_counter.flop_registry``; the composites that reach
  the dry run undecomposed under ``inference_mode`` (``conv2d``,
  ``linear``, ``matmul``: not in that registry) by their decomposition's
  formula; reductions one operation per element of the larger of their
  input and output; every other op one per output element. There is no
  ``cost_analysis`` to apportion the counts against, so a report's
  ``flops`` is None and its scale stays 1;
- **bytes**: each tensor argument's viewed bytes read and each output
  written (a new storage as memcheck counts it: the allocator's 512-byte
  granule on a card); an op that writes in place counts the written tensor
  once, as the JAX package's ``output_to_operand_aliasing`` rule does;
- ``is_layout``: pure data motion: ``clone``/``contiguous``, a ``copy_``
  between layouts, a ``_to_copy`` that keeps the dtype (a cast computes);
- **multipliers**: the records of one opcode, ``op_path`` (the executor
  node), provenance (``file:line``) and input shapes and dtypes are one
  entry, ``multiplier`` their count; in a K-step ``run_steps`` program
  (``loop_trips=K``) an entry recorded a multiple of K times is the loop's
  (``in_loop``);
- **the hand-written kernels** are one entry a launch, priced by their own
  modules' cost formulas (``ops/matmul_stats.launch_cost`` for B1,
  ``ops/multibox_nms.launch_cost`` for B2, ``rtc.launch_cost`` for B3: the
  formulas ``chip_smoke.py`` bounds them by), handed to the dry run by
  their shape-only routes (``base.note_kernel``). B1's wrapper runs its
  plain version for CPU tensors, so its entry shows on a card or a
  ``device="meta"`` program.

Each kernel is priced at ``max(flops x passes / peak, bytes / bandwidth)``
against ``devspec``'s row of the program's device: the peak of its compute
type (:data:`devspec.PEAK_BY_DTYPE`: bf16 and f16 at the tensor-core
rate, a float32 matmul or convolution at TF32's while torch's switch of
its family is on, else FP32). From the inventory: the predicted step time
(zero overlap, the sum), the predicted MFU (the JAX definition: dispatch
FLOPs over predicted time x the bf16 peak) and the ranked hot spots
(:func:`hotspot_report`, ``autotune.hotspot_report``). A report built with
an explicit ``peak_flops_per_s`` prices every kernel at it.

The four roofline lints ride ``tracecheck``'s :class:`Finding` framework
and shared suppression registry (``tracecheck.ROOFLINE_LINTS``), with the
JAX package's thresholds and knobs:

====================  ====================================================
lint id               fires when
====================  ====================================================
``memory-bound-hot``  one kernel holds >= ``MXTPU_FLOPCHECK_HOT_FRAC``
                      (0.6) of the predicted step time below the ridge
                      and moves >= ``MXTPU_FLOPCHECK_HOT_BYTES`` (4 MiB):
                      the step waits on HBM, and a hand kernel that keeps
                      the working set in shared memory wins
``layout-copy``       a pure-data-motion kernel moves more than
                      ``MXTPU_FLOPCHECK_LAYOUT_BYTES`` (4 MiB) and at
                      least ``MXTPU_FLOPCHECK_LAYOUT_FRAC`` (0.25) of the
                      program's bytes per dispatch
``tiny-dispatch``     more than ``MXTPU_FLOPCHECK_TINY_COUNT`` (4096)
                      kernel executions per dispatch each predicted under
                      ``MXTPU_FLOPCHECK_TINY_US`` (1.0): launch overhead
                      dominates compute
``predicted-mfu``     the predicted MFU is below ``MXTPU_FLOPCHECK_MIN_MFU``
                      (default 0: disabled)
====================  ====================================================

The roofline is a model, not a measurement: spec-sheet rates, zero
overlap, no launch cost. CLI::

    python -m mxnet_tpu_torch.flopcheck --models mlp --json --device cpu
    python -m mxnet_tpu_torch.flopcheck --zoo --hotspots 5 --device cuda:0
    python -m mxnet_tpu_torch.flopcheck --zoo --write-baseline FILE

``--baseline`` is the drift gate: per program, kernel count, predicted
step ms, predicted MFU and top-hotspot identity against a baseline within
``MXTPU_FLOPCHECK_TOL`` (10%). ``--memcheck-baseline`` and
``--commscheck-baseline`` run memcheck's and commscheck's gates from the
same dry runs (one per program feeds the three analyzers). ``--sharded``
adds ``commscheck``'s sharded gate set (:func:`compiled_sharded_programs`,
:func:`check_sharded`: eight positions on ``--device``), whose reports
carry the collectives' wire time: ``RooflineReport.comm_seconds`` is the
``CommsReport`` of the same dry run (``comms``), and zero for a program
without collectives. ``MXTPU_FLOPCHECK=warn|error``
(``engine.flopcheck_mode``) arms a one-time audit of each ``TrainStep``
dispatch key's program (:func:`maybe_audit_dispatch`).

Not ported: ``analyze_compiled`` and ``parse_kernels`` (there is no XLA
executable or HLO; each raises ``MXNetError``).
"""
from __future__ import annotations

import json
import logging
import sys

from .base import MXNetError, env_float, env_int, env_str
from .tracecheck import (Finding, ROOFLINE_LINTS, _is_suppressed,
                         unsuppressed, ZOO)
from .memcheck import _fmt_bytes, _parse_bytes, _reports_platform
from . import devspec

__all__ = [
    "KernelEntry", "RooflineReport", "parse_kernels", "analyze",
    "analyze_compiled", "lint_report", "check_program", "check_train_step",
    "check_zoo", "check_sharded", "zoo_programs",
    "compiled_sharded_programs", "hotspot_report", "write_baseline",
    "compare_baseline", "report_table", "hotspot_table", "hot_frac",
    "hot_bytes", "layout_bytes", "layout_frac", "tiny_us", "tiny_count",
    "min_mfu", "tolerance", "maybe_audit_dispatch", "main",
    "ROOFLINE_LINTS",
]

# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

def hot_frac():
    """``memory-bound-hot`` step-time share threshold
    (``MXTPU_FLOPCHECK_HOT_FRAC``, default 0.6)."""
    return env_float("MXTPU_FLOPCHECK_HOT_FRAC", 0.6)


def hot_bytes():
    """``memory-bound-hot`` traffic floor a dispatch
    (``MXTPU_FLOPCHECK_HOT_BYTES``, K/M/G/T binary suffixes; default 4 MiB:
    the zoo's tiny programs all have some dominant kernel)."""
    env = _parse_bytes(env_str("MXTPU_FLOPCHECK_HOT_BYTES"),
                       "MXTPU_FLOPCHECK_HOT_BYTES")
    return env if env is not None else (4 << 20)


def layout_bytes():
    """``layout-copy`` traffic floor a dispatch
    (``MXTPU_FLOPCHECK_LAYOUT_BYTES``, default 4 MiB)."""
    env = _parse_bytes(env_str("MXTPU_FLOPCHECK_LAYOUT_BYTES"),
                       "MXTPU_FLOPCHECK_LAYOUT_BYTES")
    return env if env is not None else (4 << 20)


def layout_frac():
    """``layout-copy`` share of the program's bytes a dispatch
    (``MXTPU_FLOPCHECK_LAYOUT_FRAC``, default 0.25): a copy beside far
    larger real traffic is not the problem."""
    return env_float("MXTPU_FLOPCHECK_LAYOUT_FRAC", 0.25)


def tiny_us():
    """``tiny-dispatch`` per-kernel predicted-time floor in microseconds
    (``MXTPU_FLOPCHECK_TINY_US``, default 1.0)."""
    return env_float("MXTPU_FLOPCHECK_TINY_US", 1.0)


def tiny_count():
    """``tiny-dispatch`` kernel-execution count threshold a dispatch
    (``MXTPU_FLOPCHECK_TINY_COUNT``, default 4096)."""
    return env_int("MXTPU_FLOPCHECK_TINY_COUNT", 4096)


def min_mfu():
    """``predicted-mfu`` floor (``MXTPU_FLOPCHECK_MIN_MFU``, default 0.0 =
    disabled)."""
    return env_float("MXTPU_FLOPCHECK_MIN_MFU", 0.0)


def tolerance():
    """Baseline drift band (``MXTPU_FLOPCHECK_TOL``, default 0.1)."""
    return env_float("MXTPU_FLOPCHECK_TOL", 0.1)


def analyze_compiled(*args, **kwargs):
    """Walks an XLA executable's HLO; the port has none (raises: use
    :func:`analyze`)."""
    raise MXNetError("flopcheck.analyze_compiled walks an XLA executable's "
                     "HLO, which the port does not have; flopcheck.analyze "
                     "prices a program's kernels by a shape-only dry run "
                     "instead")


def parse_kernels(*args, **kwargs):
    """Parses scheduled HLO text; the port has none (raises)."""
    raise MXNetError("flopcheck.parse_kernels parses XLA's scheduled HLO, "
                     "which the port does not have; flopcheck.analyze "
                     "records the kernels of its dry run instead")


# ---------------------------------------------------------------------------
# the inventory and the roofline
# ---------------------------------------------------------------------------

class KernelEntry(object):
    """One kernel of a program: an aten op or a hand-written kernel's
    launch, with its FLOPs, bytes, roofline classification and provenance.
    ``multiplier`` is its executions a dispatch; ``seconds`` the roofline
    time of ONE execution, ``max(flops x passes / peak, bytes / bw)``.
    ``compute`` is the ``devspec.PEAK_BY_DTYPE`` key of its peak (None:
    the report's peak), ``passes`` how many times its arithmetic issues
    its FLOPs (B1's ``tf32x3`` route: 3) and ``inputs`` its tensor
    arguments' ``(shape, dtype)``."""

    __slots__ = ("instruction", "opcode", "flops", "bytes", "in_loop",
                 "multiplier", "is_layout", "op_path", "provenance",
                 "seconds", "intensity", "bound", "norm_flops", "compute",
                 "passes", "inputs")

    def __init__(self, instruction, opcode, flops, bytes_, in_loop=False,
                 multiplier=1, is_layout=False, op_path=None,
                 provenance=None, norm_flops=None, compute=None, passes=1,
                 inputs=()):
        self.instruction = instruction
        self.opcode = opcode
        self.flops = float(flops)
        self.bytes = int(bytes_)
        #: the kernel's weight in a normalization against a whole-program
        #: FLOP count (the JAX package's cost-analysis basis)
        self.norm_flops = (self.flops if norm_flops is None
                           else float(norm_flops))
        self.in_loop = bool(in_loop)
        self.multiplier = max(1, int(multiplier))
        self.is_layout = bool(is_layout)
        self.op_path = op_path
        self.provenance = provenance
        self.compute = compute
        self.passes = max(1, int(passes))
        self.inputs = tuple(inputs)
        # roofline fields, priced by the report against its device spec
        self.seconds = 0.0
        self.intensity = 0.0
        self.bound = "memory"

    def price(self, peak_flops_per_s, hbm_bytes_per_s):
        """Price one execution at ``peak_flops_per_s`` (the peak of this
        kernel's compute type) and ``hbm_bytes_per_s``."""
        rate = peak_flops_per_s / self.passes
        self.intensity = (self.flops / self.bytes) if self.bytes else 0.0
        self.bound = ("compute" if self.intensity >= rate / hbm_bytes_per_s
                      else "memory")
        self.seconds = max(self.flops / rate, self.bytes / hbm_bytes_per_s)

    @property
    def total_seconds(self):
        return self.seconds * self.multiplier

    def as_dict(self):
        return {
            "instruction": self.instruction,
            "opcode": self.opcode,
            "flops": self.flops,
            "bytes": self.bytes,
            "intensity": self.intensity,
            "bound": self.bound,
            "in_loop": self.in_loop,
            "multiplier": self.multiplier,
            "is_layout": self.is_layout,
            "compute": self.compute,
            "passes": self.passes,
            "inputs": [[list(shape), dtype] for shape, dtype in self.inputs],
            "predicted_us": self.seconds * 1e6,
            "op_path": self.op_path,
            "provenance": self.provenance,
        }

    def format(self):
        where = self.op_path or self.instruction
        if self.provenance:
            where += " @ " + self.provenance
        mult = " x%d" % self.multiplier if self.multiplier > 1 else ""
        return ("%-7s %8.2fus %10s %8.1f FLOP/B %-14s%s %s"
                % (self.bound, self.seconds * 1e6, _fmt_bytes(self.bytes),
                   self.intensity, self.opcode, mult, where))

    def __repr__(self):
        return "KernelEntry(%s)" % self.format()


def _inventory(records, loop_trips=1):
    """The dry run's kernel records grouped into :class:`KernelEntry`s: one
    per opcode, op path, provenance and input shapes and dtypes, its count
    the multiplier; with ``loop_trips`` K > 1 an entry counted a multiple
    of K times is the loop's."""
    groups = {}
    for r in records:
        key = (r["opcode"], r["op_path"], r["provenance"], r["inputs"])
        got = groups.get(key)
        if got is None:
            groups[key] = [r, 1]
        else:
            got[1] += 1
    trips = max(1, int(loop_trips))
    return [KernelEntry(r["instruction"], r["opcode"], r["flops"],
                        r["bytes"], in_loop=trips > 1 and n % trips == 0,
                        multiplier=n, is_layout=r["is_layout"],
                        op_path=r["op_path"], provenance=r["provenance"],
                        compute=r["compute"], passes=r["passes"],
                        inputs=r["inputs"])
            for r, n in groups.values()]


class RooflineReport(object):
    """Static compute/memory profile of ONE program.

    ``kernel_count`` is the kernel executions a dispatch (multipliers
    summed); ``predicted_step_seconds`` the zero-overlap roofline time of
    one dispatch (every kernel's time, plus the collectives' wire time of
    the embedded ``CommsReport`` of the same dry run, ``comms``). The peaks
    are ``devspec``'s row of ``device`` (the program's device; None:
    ``cuda:0``) unless given; each kernel is priced at the peak of its
    compute type, or at ``peak_flops_per_s`` for every kernel when it is
    given. ``hlo_unavailable`` (the JAX package's name) marks a report
    whose inventory is no evidence: the drift gate fails it and the
    roofline claims nothing; the port's dry run either sees every op or
    raises, so only a report built by hand carries it."""

    __slots__ = ("program", "platform", "kernels", "loop_trips", "flops",
                 "comms", "peak_flops_per_s", "hbm_bytes_per_s",
                 "peak_source", "hlo_unavailable", "device")

    def __init__(self, program, platform, kernels, loop_trips=1,
                 flops=None, comms=None, peak_flops_per_s=None,
                 hbm_bytes_per_s=None, peak_source=None,
                 hlo_unavailable=False, device=None):
        self.program = program
        self.platform = platform
        self.kernels = list(kernels)
        self.loop_trips = max(1, int(loop_trips))
        self.flops = None if flops is None else float(flops)
        self.comms = comms
        self.device = None if device is None else str(device)
        kind = None
        if peak_flops_per_s is None or hbm_bytes_per_s is None:
            kind = devspec.device_kind(device)
            spec, source = devspec.kind_spec(kind)
            hbm_bytes_per_s = (spec.hbm_bytes_per_s if hbm_bytes_per_s
                               is None else hbm_bytes_per_s)
            peak_source = source if peak_source is None else peak_source
        if peak_flops_per_s is None:
            peak_flops_per_s = devspec.kind_spec(kind)[0].peak_flops_per_s
        else:
            kind = None     # every kernel at the given peak
        self.peak_flops_per_s = float(peak_flops_per_s)
        self.hbm_bytes_per_s = float(hbm_bytes_per_s)
        self.peak_source = peak_source or "spec"
        self.hlo_unavailable = bool(hlo_unavailable)
        # scale the counts to a whole-program FLOP count where one is given
        # (the JAX package's cost-analysis apportioning; the dry run gives
        # none)
        raw = sum(k.norm_flops for k in self.kernels)
        if self.flops and raw > 0:
            scale = self.flops / raw
            for k in self.kernels:
                k.flops *= scale
        for k in self.kernels:
            peak = (self.peak_flops_per_s if kind is None or k.compute is None
                    else devspec.compute_peak(kind, k.compute))
            k.price(peak, self.hbm_bytes_per_s)
        self.kernels.sort(key=lambda k: k.total_seconds, reverse=True)

    @property
    def ridge_intensity(self):
        return self.peak_flops_per_s / self.hbm_bytes_per_s

    @property
    def kernel_count(self):
        return sum(k.multiplier for k in self.kernels)

    @property
    def flops_per_dispatch(self):
        return sum(k.flops * k.multiplier for k in self.kernels)

    @property
    def bytes_per_dispatch(self):
        return sum(k.bytes * k.multiplier for k in self.kernels)

    @property
    def kernel_seconds(self):
        return sum(k.total_seconds for k in self.kernels)

    @property
    def comm_seconds(self):
        """A dispatch's collective wire time (a ``CommsReport``'s model x
        the trip count); 0 without one."""
        if self.comms is None:
            return 0.0
        return self.comms.comm_seconds * self.loop_trips

    @property
    def predicted_step_seconds(self):
        return self.kernel_seconds + self.comm_seconds

    @property
    def predicted_step_ms(self):
        return self.predicted_step_seconds * 1e3

    @property
    def predicted_mfu(self):
        """Dispatch FLOPs over predicted time x the bf16 peak: what the
        roofline says utilization can be; None without evidence."""
        if self.hlo_unavailable or not self.kernels:
            return None
        t = self.predicted_step_seconds
        if t <= 0:
            return None
        return self.flops_per_dispatch / (t * self.peak_flops_per_s)

    @property
    def top_hotspot(self):
        """The op path (or instruction) of the kernel holding the most
        predicted step time: the identity the baseline pins."""
        if not self.kernels:
            return None
        k = self.kernels[0]
        return k.op_path or k.instruction

    def hotspots(self, top=10, memory_only=False):
        """Kernels ranked by held step time (``memory_only``: the
        below-ridge ones, the hand-kernel candidates)."""
        ks = [k for k in self.kernels
              if not memory_only or k.bound == "memory"]
        return ks[:top]

    def breakdown(self, top=6):
        return [k.format() for k in self.kernels[:top]]

    def as_dict(self):
        mfu = self.predicted_mfu
        return {
            "program": self.program,
            "platform": self.platform,
            "device": self.device,
            "hlo_unavailable": self.hlo_unavailable,
            "kernel_count": self.kernel_count,
            "flops_per_dispatch": self.flops_per_dispatch,
            "bytes_per_dispatch": self.bytes_per_dispatch,
            "ridge_intensity": self.ridge_intensity,
            "peak_source": self.peak_source,
            "loop_trips": self.loop_trips,
            "kernel_seconds": self.kernel_seconds,
            "comm_seconds": self.comm_seconds,
            "predicted_step_ms": self.predicted_step_ms,
            "predicted_mfu": None if mfu is None else round(mfu, 6),
            "top_hotspot": self.top_hotspot,
            "kernels": [k.as_dict() for k in self.kernels],
        }

    def format(self):
        mfu = self.predicted_mfu
        return ("%s: %d kernel(s)/dispatch, predicted %.3f ms, MFU %s"
                % (self.program, self.kernel_count, self.predicted_step_ms,
                   "?" if mfu is None else "%.4f" % mfu))

    def __repr__(self):
        return "RooflineReport(%s)" % self.format()


def _analyze(fn, args=(), kwargs=None, name=None, device=None,
             loop_trips=1, donate_argnums=(), mesh=None):
    """One dry run of ``fn``: ``(RooflineReport, MemoryReport)``, the
    roofline report carrying the run's ``CommsReport`` (``comms``; its
    positions are ``mesh``'s, else the first MeshArray argument's)."""
    import torch
    from .commscheck import _infer_mesh, _report
    from .memcheck import _dry_run, _platform
    if name is None:
        name = getattr(fn, "__name__", None) or repr(fn)
    run = _dry_run(fn, args, kwargs, donate_argnums, name, kernels=True)
    dev = run.device if device is None else device
    if mesh is None:
        mesh = _infer_mesh(args, kwargs)
    report = RooflineReport(
        name, _platform(torch.device(dev)),
        _inventory(run.tracker.kernels, loop_trips), loop_trips=loop_trips,
        comms=_report(run, name, mesh, loop_trips, dev), device=dev)
    return report, run.report


def analyze(fn, args=(), kwargs=None, name=None, device=None, loop_trips=1,
            mesh=None):
    """Run ``fn(*args, **kwargs)`` once shape-only (memcheck's dry run:
    real tensor arguments become fake ones, nothing is allocated and no
    kernel launches) and return its :class:`RooflineReport`, priced for
    ``device`` (default: the program's own device), with the collectives
    of the same run (``comms``) over ``mesh``'s positions."""
    return _analyze(fn, args, kwargs, name, device, loop_trips,
                    mesh=mesh)[0]


# ---------------------------------------------------------------------------
# lints
# ---------------------------------------------------------------------------

def lint_report(report, hot_threshold=None, hot_floor=None,
                layout_threshold=None, layout_share=None,
                tiny_floor_us=None, tiny_threshold=None, mfu_floor=None):
    """The four roofline lints over one :class:`RooflineReport`:
    ``memory-bound-hot``, ``layout-copy``, ``tiny-dispatch``,
    ``predicted-mfu``. Returns findings with suppressions applied."""
    hot_threshold = hot_frac() if hot_threshold is None \
        else float(hot_threshold)
    hot_floor = hot_bytes() if hot_floor is None else int(hot_floor)
    layout_threshold = layout_bytes() if layout_threshold is None \
        else int(layout_threshold)
    layout_share = layout_frac() if layout_share is None \
        else float(layout_share)
    tiny_floor_us = tiny_us() if tiny_floor_us is None \
        else float(tiny_floor_us)
    tiny_threshold = tiny_count() if tiny_threshold is None \
        else int(tiny_threshold)
    mfu_floor = min_mfu() if mfu_floor is None else float(mfu_floor)
    name = report.program
    findings = []
    step = report.predicted_step_seconds
    total_bytes = report.bytes_per_dispatch

    for k in report.kernels:
        frac = (k.total_seconds / step) if step > 0 else 0.0
        if (k.bound == "memory" and not k.is_layout
                and frac >= hot_threshold
                and k.bytes * k.multiplier >= hot_floor):
            findings.append(Finding(
                "memory-bound-hot", name,
                "kernel %r holds %.0f%% of the predicted step time "
                "(%.2fus of %.2fus) at intensity %.1f FLOP/B — below "
                "the ridge %.1f, so it is waiting on HBM (%s moved per "
                "dispatch); this is the hand-kernel candidate's signature: "
                "a kernel that keeps the working set in shared memory wins "
                "(threshold MXTPU_FLOPCHECK_HOT_FRAC=%.2f)"
                % (k.instruction, 100.0 * frac, k.total_seconds * 1e6,
                   step * 1e6, k.intensity, report.ridge_intensity,
                   _fmt_bytes(k.bytes * k.multiplier), hot_threshold),
                op_path=k.op_path or k.instruction,
                provenance=k.provenance))
        kb = k.bytes * k.multiplier
        byte_share = (kb / float(total_bytes)) if total_bytes > 0 else 0.0
        if (k.is_layout and kb > layout_threshold
                and byte_share >= layout_share):
            findings.append(Finding(
                "layout-copy", name,
                "kernel %r is pure data motion (%s) moving %s per "
                "dispatch — %.0f%% of the program's HBM traffic "
                "(> %.0f%%, MXTPU_FLOPCHECK_LAYOUT_FRAC) spent "
                "re-laying-out memory, zero FLOPs; fix the layout that "
                "forced the %s"
                % (k.instruction, k.opcode, _fmt_bytes(kb),
                   100.0 * byte_share, 100.0 * layout_share, k.opcode),
                op_path=k.op_path or k.instruction,
                provenance=k.provenance))

    tiny = [k for k in report.kernels
            if k.seconds * 1e6 < tiny_floor_us]
    tiny_execs = sum(k.multiplier for k in tiny)
    if tiny_execs > tiny_threshold:
        worst = tiny[0] if tiny else report.kernels[0]
        findings.append(Finding(
            "tiny-dispatch", name,
            "%d kernel execution(s) per dispatch each predicted under "
            "%.1fus (> %d, MXTPU_FLOPCHECK_TINY_COUNT) — launch overhead "
            "dominates compute: the step is shattered into tiny kernels "
            "(or the program genuinely needs fusing)"
            % (tiny_execs, tiny_floor_us, tiny_threshold),
            op_path=worst.op_path or worst.instruction,
            provenance=worst.provenance))

    mfu = report.predicted_mfu
    if mfu_floor > 0 and mfu is not None and mfu < mfu_floor:
        k = report.kernels[0]
        findings.append(Finding(
            "predicted-mfu", name,
            "predicted MFU %.4f is below the floor %.2f "
            "(MXTPU_FLOPCHECK_MIN_MFU): the roofline says the program "
            "CANNOT reach the target utilization — %.3f ms predicted "
            "step time at %s peak (%s). Inventory:\n  %s"
            % (mfu, mfu_floor, report.predicted_step_ms,
               "%.1f TFLOP/s" % (report.peak_flops_per_s / 1e12),
               report.peak_source, "\n  ".join(report.breakdown())),
            op_path=k.op_path or k.instruction, provenance=k.provenance))

    for f in findings:
        f.suppressed = _is_suppressed(f)
    return findings


def check_program(fn, args=(), kwargs=None, name=None, device=None,
                  loop_trips=1, mesh=None, **lint_kw):
    """Analyze + lint ONE program; returns ``(findings, report)``."""
    report = analyze(fn, args, kwargs=kwargs, name=name, device=device,
                     loop_trips=loop_trips, mesh=mesh)
    return lint_report(report, **lint_kw), report


def hotspot_report(fn, args=(), kwargs=None, name=None, device=None,
                   loop_trips=1, top=10, memory_only=True):
    """The hand-kernel shopping list of ONE program: its ranked hot spots
    as dicts, each with its ``step_time_frac`` (also
    ``autotune.hotspot_report``)."""
    report = analyze(fn, args, kwargs=kwargs, name=name, device=device,
                     loop_trips=loop_trips)
    step = report.predicted_step_seconds
    out = []
    for k in report.hotspots(top=top, memory_only=memory_only):
        d = k.as_dict()
        d["step_time_frac"] = ((k.total_seconds / step)
                               if step > 0 else 0.0)
        out.append(d)
    return out


# ---------------------------------------------------------------------------
# the dispatch hook (MXTPU_FLOPCHECK / engine.flopcheck_mode)
# ---------------------------------------------------------------------------

#: program names the dispatch hook audited: one dry run a program a process
_AUDITED = set()


def maybe_audit_dispatch(name, fn, call_args, loop_trips=1, device=None):
    """One-time roofline audit of a dispatch key's program at its first
    dispatch (``TrainStep``'s hook): under ``MXTPU_FLOPCHECK=warn``
    unsuppressed findings are logged, under ``error`` they raise
    :class:`MXNetError`; ``off`` (the default) skips it. The call
    arguments are faked first, so the state is never touched; a dry run
    that fails logs and skips. Returns the report (None when skipped)."""
    from . import engine
    from .memcheck import fake_mode, fake_tree
    mode = engine.flopcheck_mode()
    if mode == "off" or name in _AUDITED:
        return None
    _AUDITED.add(name)
    # knobs resolve before the guard below: a malformed knob raises
    # instead of disarming the gate the operator set
    kw = dict(hot_threshold=hot_frac(), hot_floor=hot_bytes(),
              layout_threshold=layout_bytes(), layout_share=layout_frac(),
              tiny_floor_us=tiny_us(), tiny_threshold=tiny_count(),
              mfu_floor=min_mfu())
    try:
        with fake_mode(like=tuple(call_args)) as m:
            fargs = fake_tree(tuple(call_args), m)
        findings, report = check_program(fn, fargs, name=name,
                                         device=device,
                                         loop_trips=loop_trips, **kw)
    except Exception as exc:    # noqa: BLE001 -- the audit never breaks a
        # dispatch that ran
        logging.warning("flopcheck: dispatch audit of %s failed (%r) — "
                        "skipping", name, exc)
        return None
    bad = unsuppressed(findings)
    if bad:
        msg = ("flopcheck: %d finding(s) on program %s "
               "(MXTPU_FLOPCHECK):\n%s"
               % (len(bad), name, "\n".join(f.format() for f in bad)))
        if mode == "error":
            raise MXNetError(msg)
        logging.warning(msg)
    return report


# ---------------------------------------------------------------------------
# program sets: a TrainStep's, the zoo's (one dry run feeds both analyzers)
# ---------------------------------------------------------------------------

def _trips(pname, k):
    return k if "/scan[" in pname or "-scan[" in pname else 1


def check_train_step(ts, data_shapes, label_shapes, k=2, guard=True,
                     name=None, **lint_kw):
    """Roofline-audit a :class:`~mxnet_tpu_torch.train_step.TrainStep`'s
    program set (``tracecheck.train_step_programs``). Returns
    ``(findings, reports)``."""
    from .tracecheck import train_step_programs
    name = name or "TrainStep(%s)" % ts.symbol.name
    findings, reports = [], {}
    for pname, fn, pargs in train_step_programs(
            ts, data_shapes, label_shapes, k=k, guard=guard, name=name):
        fs, rep = check_program(fn, pargs, name=pname, mesh=ts.mesh,
                                loop_trips=_trips(pname, k), **lint_kw)
        findings += fs
        reports[pname] = rep
    return findings, reports


def zoo_programs(names=None, k=2, guard=True, log=None, device=None,
                 memory=False):
    """Dry-run every zoo step program once on ``device`` (default
    ``cuda:0``) and yield ``(model, name, RooflineReport, MemoryReport or
    None)``: with ``memory`` the same run prices memcheck's report too
    (the combined gate). Names and shapes come from
    ``tracecheck.train_step_programs``, the analyzers' shared recipe."""
    from .tracecheck import train_step_programs, zoo_train_step
    names = list(names) if names else sorted(ZOO)
    for mname in names:
        if mname not in ZOO:
            raise MXNetError("flopcheck: unknown zoo model %r (have %s)"
                             % (mname, ", ".join(sorted(ZOO))))
        if log:
            log("flopcheck: analyzing %s ..." % mname)
        ts, data_shapes, label_shapes = zoo_train_step(mname, device=device)
        for pname, fn, pargs in train_step_programs(
                ts, data_shapes, label_shapes, k=k, guard=guard,
                name=mname):
            rep, mem = _analyze(fn, pargs, name=pname,
                                loop_trips=_trips(pname, k),
                                donate_argnums=(0,), mesh=ts.mesh)
            yield mname, pname, rep, (mem if memory else None)


def check_zoo(names=None, k=2, guard=True, log=None, programs=None,
              device=None, **lint_kw):
    """Roofline-audit the model zoo's step programs (``tracecheck.ZOO``)
    on ``device``; returns ``(findings, reports)``. A model's ``suppress``
    (lint -> reason) marks its findings of that lint suppressed.
    ``programs``: an iterable from :func:`zoo_programs` to audit instead of
    running it."""
    findings, reports = [], {}
    progs = programs if programs is not None else zoo_programs(
        names=names, k=k, guard=guard, log=log, device=device)
    for model, pname, rep, _mem in progs:
        expected = ZOO.get(model, {}).get("suppress", {})
        for f in lint_report(rep, **lint_kw):
            f.suppressed = f.suppressed or f.lint in expected
            findings.append(f)
        reports[pname] = rep
    return findings, reports


def compiled_sharded_programs(n_devices=8, k=2, log=None, device=None):
    """The sharded gate set (``commscheck.sharded_programs``: ``n_devices``
    positions on ``device``, default ``cuda:0``), dry-run once each: yields
    ``(name, RooflineReport, MemoryReport)``, the roofline report carrying
    the run's ``CommsReport``. (The JAX package's name: there it compiles
    each program once for the three analyzers.)"""
    from .commscheck import sharded_programs
    for name, fn, args, trips, mesh, _scope in sharded_programs(
            n_devices=n_devices, k=k, device=device):
        if log:
            log("flopcheck: analyzing %s ..." % name)
        rep, mem = _analyze(fn, args, name=name, loop_trips=trips,
                            donate_argnums=(0,), mesh=mesh)
        yield name, rep, mem


def check_sharded(n_devices=8, k=2, log=None, programs=None, device=None,
                  **lint_kw):
    """Roofline-audit the sharded gate set; returns ``(findings,
    reports)``. ``programs``: an iterable from
    :func:`compiled_sharded_programs` to audit instead of running it."""
    findings, reports = [], {}
    progs = programs if programs is not None else compiled_sharded_programs(
        n_devices=n_devices, k=k, log=log, device=device)
    for pname, rep, _mem in progs:
        findings += lint_report(rep, **lint_kw)
        reports[pname] = rep
    return findings, reports


# ---------------------------------------------------------------------------
# the baseline drift gate
# ---------------------------------------------------------------------------

def write_baseline(reports, path, tol=None):
    """Write the baseline, keyed by the reports' platform (a CPU baseline
    must not gate a card's run). Refuses reports whose inventory is no
    evidence (``hlo_unavailable``)."""
    from .model import atomic_write_bytes
    blind = sorted(n for n, r in reports.items()
                   if getattr(r, "hlo_unavailable", False))
    if blind:
        raise MXNetError(
            "write_baseline: the kernel inventory was unavailable for %s — "
            "absence of evidence, not zeros; refusing to commit a "
            "fabricated baseline" % ", ".join(blind))
    data = {
        "platform": _reports_platform(reports),
        "tolerance": tolerance() if tol is None else float(tol),
        "programs": {
            name: {
                "kernel_count": int(rep.kernel_count),
                "predicted_step_ms": round(rep.predicted_step_ms, 6),
                "predicted_mfu": (None if rep.predicted_mfu is None
                                  else round(rep.predicted_mfu, 6)),
                "top_hotspot": rep.top_hotspot,
            }
            for name, rep in sorted(reports.items())},
    }
    atomic_write_bytes(path, (json.dumps(data, indent=2, sort_keys=True)
                              + "\n").encode())
    return data


def compare_baseline(reports, baseline, tol=None):
    """The drift gate: kernel count or predicted step time growing past the
    tolerance band fails with the kernel breakdown (op paths and
    provenance); predicted MFU dropping past it fails too. A program
    missing from the baseline fails, and a nonzero-pinned kernel count
    collapsing to zero fails. Shrinks, MFU gains, hotspot moves and stale
    entries are notes; a baseline of another platform skips the gate with
    one note. Returns ``(failures, notes)``."""
    if isinstance(baseline, str):
        with open(baseline) as f:
            baseline = json.load(f)
    if tol is None:
        # explicit arg > MXTPU_FLOPCHECK_TOL > the baseline's band > 0.1
        tol = env_float("MXTPU_FLOPCHECK_TOL",
                        float(baseline.get("tolerance", 0.1)))
    else:
        tol = float(tol)
    platform = (_reports_platform(reports) if reports
                else baseline.get("platform"))
    failures, notes = [], []
    if baseline.get("platform") != platform:
        notes.append(
            "flopcheck baseline was written on platform %r but this run "
            "is %r — skipping the drift gate (re-run --write-baseline on "
            "this platform to arm it)"
            % (baseline.get("platform"), platform))
        return failures, notes
    base_progs = dict(baseline.get("programs") or {})
    for name, rep in sorted(reports.items()):
        base = base_progs.pop(name, None)
        if getattr(rep, "hlo_unavailable", False):
            failures.append(
                "%s: the kernel inventory is unavailable — the drift gate "
                "refuses to pass on absence of evidence" % name)
            continue
        if base is None:
            failures.append(
                "%s: not in the baseline — a new program must be added "
                "deliberately (run `python -m mxnet_tpu_torch.flopcheck "
                "--zoo --write-baseline FILE` and commit the diff)" % name)
            continue
        breakdown = "\n  ".join(rep.breakdown()) or "(empty)"
        b_count = int(base.get("kernel_count", 0))
        count = int(rep.kernel_count)
        if count > b_count + int(b_count * tol):
            failures.append(
                "%s: kernel_count grew %d -> %d (tolerance %.0f%%, "
                "MXTPU_FLOPCHECK_TOL) — the step shattered or new kernels "
                "appeared. Inventory:\n  %s"
                % (name, b_count, count, 100.0 * tol, breakdown))
        elif count == 0 and b_count > 0:
            failures.append(
                "%s: kernel_count collapsed %d -> 0 — either the program "
                "genuinely vanished (refresh the baseline deliberately) or "
                "the inventory went blind; the gate refuses to treat a "
                "total collapse as a win" % (name, b_count))
        elif count < b_count - int(b_count * tol) and b_count > 0:
            notes.append("%s: kernel_count shrank %d -> %d — nice; "
                         "refresh the baseline to lock the win in"
                         % (name, b_count, count))
        b_ms = float(base.get("predicted_step_ms", 0.0))
        ms = rep.predicted_step_ms
        if b_ms > 0 and ms > b_ms * (1.0 + tol):
            failures.append(
                "%s: predicted_step_ms grew %.4f -> %.4f (tolerance "
                "%.0f%%, MXTPU_FLOPCHECK_TOL) — the roofline says this "
                "dispatch got slower. Inventory:\n  %s"
                % (name, b_ms, ms, 100.0 * tol, breakdown))
        elif b_ms > 0 and ms < b_ms * (1.0 - tol):
            notes.append("%s: predicted_step_ms shrank %.4f -> %.4f — "
                         "nice; refresh the baseline to lock the win in"
                         % (name, b_ms, ms))
        b_mfu = base.get("predicted_mfu")
        mfu = rep.predicted_mfu
        if b_mfu and mfu is not None:
            if mfu < float(b_mfu) * (1.0 - tol):
                failures.append(
                    "%s: predicted_mfu dropped %.4f -> %.4f (tolerance "
                    "%.0f%%, MXTPU_FLOPCHECK_TOL). Inventory:\n  %s"
                    % (name, float(b_mfu), mfu, 100.0 * tol, breakdown))
            elif mfu > float(b_mfu) * (1.0 + tol):
                notes.append("%s: predicted_mfu rose %.4f -> %.4f — "
                             "refresh the baseline to lock the win in"
                             % (name, float(b_mfu), mfu))
        b_hot = base.get("top_hotspot")
        if b_hot and rep.top_hotspot and b_hot != rep.top_hotspot:
            notes.append(
                "%s: top hotspot moved %r -> %r — the hand-kernel "
                "shopping list reordered; refresh the baseline if intended"
                % (name, b_hot, rep.top_hotspot))
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
    out.write("%-*s  %7s %10s %10s %8s %8s\n"
              % (w, "program", "kernels", "flops", "bytes", "pred-ms",
                 "mfu"))
    for name in sorted(reports):
        r = reports[name]
        mfu = r.predicted_mfu
        out.write("%-*s  %7d %10.3g %10s %8.4f %8s\n"
                  % (w, name, r.kernel_count, r.flops_per_dispatch,
                     _fmt_bytes(r.bytes_per_dispatch),
                     r.predicted_step_ms,
                     "?" if mfu is None else "%.4f" % mfu))


def hotspot_table(reports, top=10, memory_only=False, out=None):
    """Print the ranked hotspot table: the hand-kernel shopping list."""
    out = out or sys.stdout
    for name in sorted(reports):
        r = reports[name]
        ks = r.hotspots(top=top, memory_only=memory_only)
        if not ks:
            continue
        step = r.predicted_step_seconds
        out.write("%s (predicted %.4f ms, ridge %.1f FLOP/B, %s):\n"
                  % (name, r.predicted_step_ms, r.ridge_intensity,
                     r.peak_source))
        for k in ks:
            frac = (k.total_seconds / step) if step > 0 else 0.0
            out.write("  %5.1f%%  %s\n" % (100.0 * frac, k.format()))


def _combined_memcheck(mem_by_model, baseline, tol):
    """The memcheck leg of the combined gate, from the same dry runs: the
    memory lints, each model's resident set, and memcheck's baseline."""
    from . import memcheck
    findings, reports = [], {}
    for model, reps in sorted(mem_by_model.items()):
        for rep in reps.values():
            findings += memcheck.lint_report(rep)
        findings += memcheck.lint_resident_set(
            reps.values(), "%s/resident-set" % model)
        reports.update(reps)
    failures, notes = memcheck.compare_baseline(reports, baseline, tol=tol)
    return findings, failures, notes


def _combined_commscheck(reports, baseline, tol):
    """The commscheck leg of the combined gate, from the same dry runs:
    the communication lints and commscheck's baseline over every report's
    ``CommsReport``."""
    from . import commscheck
    findings, comms = [], {}
    for pname, rep in sorted(reports.items()):
        findings += commscheck.lint_report(rep.comms)
        comms[pname] = rep.comms
    failures, notes = commscheck.compare_baseline(comms, baseline, tol=tol)
    return findings, failures, notes


def main(argv=None):
    import argparse
    import time
    from . import tracecheck as _tc
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.flopcheck",
        description="Per-kernel compute/memory roofline of the port's step "
                    "programs, from a shape-only dry run: kernel inventory "
                    "(FLOPs/bytes/intensity/bound), predicted step time "
                    "and MFU, hotspot ranking, roofline lints and the "
                    "baseline drift gate.")
    p.add_argument("--zoo", action="store_true",
                   help="analyze every shipped model's step/scan programs")
    p.add_argument("--models", default=None,
                   help="comma-separated zoo subset (implies --zoo)")
    p.add_argument("--sharded", action="store_true",
                   help="also analyze the sharded gate set (commscheck's: "
                        "--devices positions on --device)")
    p.add_argument("--devices", type=int, default=8,
                   help="positions for --sharded (default 8)")
    p.add_argument("--k", type=int, default=2,
                   help="scan depth for the K-step programs (default 2)")
    p.add_argument("--no-guard", action="store_true",
                   help="skip the guarded program variants")
    p.add_argument("--hotspots", type=int, default=None, metavar="N",
                   help="print the top-N hotspot kernels per program")
    p.add_argument("--memory-bound", action="store_true",
                   help="restrict --hotspots to memory-bound kernels")
    p.add_argument("--hot-frac", type=float, default=None,
                   help="memory-bound-hot step-share threshold (default "
                        "MXTPU_FLOPCHECK_HOT_FRAC or 0.6)")
    p.add_argument("--min-mfu", type=float, default=None,
                   help="predicted-mfu floor (default "
                        "MXTPU_FLOPCHECK_MIN_MFU or 0 = disabled)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="compare against a baseline (the drift gate); exit "
                        "non-zero on drift past tolerance")
    p.add_argument("--write-baseline", default=None, metavar="FILE",
                   help="write the per-program baseline JSON and exit 0")
    p.add_argument("--tol", type=float, default=None,
                   help="baseline tolerance band (default "
                        "MXTPU_FLOPCHECK_TOL, the baseline's own, or 0.1)")
    p.add_argument("--memcheck-baseline", default=None, metavar="FILE",
                   help="also run memcheck's gate from the same dry runs")
    p.add_argument("--commscheck-baseline", default=None, metavar="FILE",
                   help="also run commscheck's gate from the same dry runs")
    p.add_argument("--json", action="store_true", help="JSON output")
    p.add_argument("--list", action="store_true",
                   help="list zoo models and exit")
    p.add_argument("--quiet", action="store_true",
                   help="suppress progress lines")
    p.add_argument("--device", default=None,
                   help="the device the programs are priced for (default "
                        "cuda:0; 'cpu' on a host without a card)")
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
    n_analyzers = (1 + bool(args.memcheck_baseline)
                   + bool(args.commscheck_baseline))

    t0 = time.time()
    progs, sharded = [], []
    if args.zoo or args.models:
        progs = list(zoo_programs(names=names, k=args.k,
                                  guard=not args.no_guard, log=log,
                                  device=args.device,
                                  memory=bool(args.memcheck_baseline)))
    if args.sharded:
        sharded = list(compiled_sharded_programs(
            n_devices=args.devices, k=args.k, log=log, device=args.device))
    dry_s = time.time() - t0
    log("flopcheck: %d dry run(s) in %.1fs — %d analyzer(s) share them"
        % (len(progs) + len(sharded), dry_s, n_analyzers))

    lint_kw = {}
    if args.hot_frac is not None:
        lint_kw["hot_threshold"] = args.hot_frac
    if args.min_mfu is not None:
        lint_kw["mfu_floor"] = args.min_mfu
    findings, reports = check_zoo(programs=progs, **lint_kw)
    fs, reps = check_sharded(programs=sharded, **lint_kw)
    findings += fs
    reports.update(reps)

    if args.write_baseline:
        write_baseline(reports, args.write_baseline, tol=args.tol)
        log("flopcheck: baseline written to %s (%d programs)"
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
                    "%s: the kernel inventory is unavailable — nothing was "
                    "audited; refusing to pass on absence of evidence" % n)
    if args.memcheck_baseline:
        by_model = {}
        for model, pname, _rep, mem in progs:
            by_model.setdefault(model, {})[pname] = mem
        mfs, mfail, mnotes = _combined_memcheck(
            by_model, args.memcheck_baseline, args.tol)
        findings += mfs
        failures += ["[memcheck] " + f for f in mfail]
        notes += ["[memcheck] " + n for n in mnotes]
    if args.commscheck_baseline:
        cfs, cfail, cnotes = _combined_commscheck(
            reports, args.commscheck_baseline, args.tol)
        findings += cfs
        failures += ["[commscheck] " + f for f in cfail]
        notes += ["[commscheck] " + n for n in cnotes]

    bad = unsuppressed(findings)
    if args.json:
        print(json.dumps({
            "platform": _reports_platform(reports),
            "dry_run_seconds": round(dry_s, 2),
            "analyzers_sharing_dry_run": n_analyzers,
            "programs": {n: r.as_dict() for n, r in sorted(reports.items())},
            "findings": [f.as_dict() for f in findings],
            "suppressed": len(findings) - len(bad),
            "baseline_failures": failures,
            "baseline_notes": notes,
        }, indent=2))
    else:
        report_table(reports)
        if args.hotspots:
            hotspot_table(reports, top=args.hotspots,
                          memory_only=args.memory_bound)
        _tc.report(findings)
        for n in notes:
            print("note: %s" % n)
        for f in failures:
            print("BASELINE REGRESSION: %s" % f)
        print("flopcheck: %d finding(s) (%d suppressed), %d baseline "
              "regression(s) over %d program(s)%s"
              % (len(findings), len(findings) - len(bad), len(failures),
                 len(reports),
                 " [combined gate: %d analyzers, one dry run each]"
                 % n_analyzers if n_analyzers > 1 else ""))
    return 1 if (bad or failures) else 0


if __name__ == "__main__":
    sys.exit(main())
