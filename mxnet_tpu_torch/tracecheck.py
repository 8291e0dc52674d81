"""The findings framework the analyzers share, the error type of the retrace
checker, process-unique program names, and the TrainStep program set.

Counterpart of ``mxnet_tpu/tracecheck.py``, of which the port holds:

- :class:`Finding` and :func:`unsuppressed`, the structured lint hit that
  :mod:`mxnet_tpu_torch.memcheck` reports, and :func:`report`;
- the four lint catalogs (:data:`LINTS`, :data:`MEM_LINTS`,
  :data:`COMM_LINTS`, :data:`ROOFLINE_LINTS`), so that one suppression
  registry (:func:`add_suppression`, :func:`remove_suppression`,
  :func:`clear_suppressions`) takes every analyzer's names, as in the JAX
  package; and the inline marker ``# tracecheck: ignore[lint-id]`` (or a
  bare ``# tracecheck: ignore``) on, or on the line above, the source line
  a finding's provenance points at;
- :data:`ZOO` and :func:`zoo_train_step`, the model-zoo configurations
  the analyzers' CLIs audit, and :func:`train_step_programs`, the program
  set of one ``TrainStep``: ``step``, ``step(guard=True)``, ``run_steps``
  at K and ``run_steps(guard=True)`` at K, named as the JAX package names
  them (``<model>/step``, ``/guarded-step``, ``/scan[k=K]``,
  ``/guarded-scan[k=K]``);
- :class:`RetraceError`, the name ``Module`` catches around a dispatch,
  and :func:`unique_name`, which names serving engines.

The jaxpr walk, its lints, the retrace watch and the program registry
walk XLA programs and wait for ROADMAP.md A.12d; nothing in the port
raises :class:`RetraceError` yet.
"""
from __future__ import annotations

import linecache
import re
import threading

from .base import MXNetError

LINTS = ("host-sync", "retrace", "donation", "const-capture", "dtype-f64",
         "dtype-weak", "collective-in-scan")

#: memory lints (implemented in :mod:`mxnet_tpu_torch.memcheck`); declared
#: here so one suppression registry covers every analyzer
MEM_LINTS = ("hbm-budget", "donation-waste", "temp-blowup", "resident-set")

#: communication lints (the JAX package's ``commscheck``; A.12d)
COMM_LINTS = ("resharding-copy", "replicated-large", "gather-in-loop",
              "comms-bound")

#: roofline lints (the JAX package's ``flopcheck``; A.12d)
ROOFLINE_LINTS = ("memory-bound-hot", "layout-copy", "tiny-dispatch",
                  "predicted-mfu")

_NAME_SEQ = {}
_NAME_LOCK = threading.Lock()


def unique_name(base):
    """Process-unique name: the first caller gets ``base`` verbatim, later
    callers get ``base#2``, ``base#3``, ... (engines built on several
    threads at once, as a fleet's joins are, take a lock)."""
    with _NAME_LOCK:
        n = _NAME_SEQ.get(base, 0) + 1
        _NAME_SEQ[base] = n
    return base if n == 1 else "%s#%d" % (base, n)


class RetraceError(MXNetError):
    """A dispatch recompiled where it should not have. ``result`` holds
    the dispatch's own result, which the caller adopts before it re-raises
    (the state was already updated)."""

    def __init__(self, msg, result=None):
        super().__init__(msg)
        self.result = result


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------

class Finding(object):
    """One structured lint hit: ``lint`` id, the ``program`` it was found
    in, a human message, the ``op_path`` (the executor node, or the
    argument's label) and source ``provenance`` (``file:line``)."""

    __slots__ = ("lint", "program", "message", "op_path", "provenance",
                 "suppressed")

    def __init__(self, lint, program, message, op_path=None, provenance=None,
                 suppressed=False):
        self.lint = lint
        self.program = program
        self.message = message
        self.op_path = op_path
        self.provenance = provenance
        self.suppressed = suppressed

    def format(self):
        where = []
        if self.op_path:
            where.append("at %s" % self.op_path)
        if self.provenance:
            where.append(self.provenance)
        s = "[%s] %s: %s" % (self.lint, self.program, self.message)
        if where:
            s += " (%s)" % "; ".join(where)
        if self.suppressed:
            s += " [suppressed]"
        return s

    def as_dict(self):
        return {"lint": self.lint, "program": self.program,
                "message": self.message, "op_path": self.op_path,
                "provenance": self.provenance, "suppressed": self.suppressed}

    def __repr__(self):
        return "Finding(%s)" % self.format()


def unsuppressed(findings):
    return [f for f in findings if not f.suppressed]


def report(findings, out=None):
    """Write one formatted line per finding (the CLIs' human-readable
    mode)."""
    import sys
    out = out or sys.stdout
    for f in findings:
        out.write(f.format() + "\n")


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

# inline marker, checked on the finding's provenance line and the line
# above it: `# tracecheck: ignore[hbm-budget]`, `# tracecheck: ignore`
_SUPPRESS_RE = re.compile(
    r"tracecheck:\s*(?:ignore|ok)(?:\[(?P<lints>[a-z0-9_,\-\s]+)\])?")
_PROV_RE = re.compile(r"^(?P<file>.+?):(?P<line>\d+)")

#: programmatic suppressions: set of (lint, program_substring_or_None)
_SUPPRESSIONS = set()


def add_suppression(lint, program=None):
    """Suppress ``lint`` findings globally, or only for programs whose name
    contains ``program``. Returns a token usable with
    :func:`remove_suppression`."""
    if (lint not in LINTS + MEM_LINTS + COMM_LINTS + ROOFLINE_LINTS
            and lint != "*"):
        raise MXNetError("tracecheck: unknown lint %r (have %s)"
                         % (lint, ", ".join(LINTS + MEM_LINTS
                                            + COMM_LINTS
                                            + ROOFLINE_LINTS)))
    tok = (lint, program)
    _SUPPRESSIONS.add(tok)
    return tok


def remove_suppression(token):
    _SUPPRESSIONS.discard(token)


def clear_suppressions():
    _SUPPRESSIONS.clear()


def _inline_suppressed(finding):
    if not finding.provenance:
        return False
    m = _PROV_RE.match(finding.provenance)
    if not m:
        return False
    fname, line = m.group("file"), int(m.group("line"))
    for ln in (line, line - 1):
        if ln < 1:
            continue
        sm = _SUPPRESS_RE.search(linecache.getline(fname, ln))
        if sm:
            lints = sm.group("lints")
            if lints is None:
                return True
            if finding.lint in [s.strip() for s in lints.split(",")]:
                return True
    return False


def _is_suppressed(finding):
    for lint, prog in _SUPPRESSIONS:
        if lint in ("*", finding.lint) and (
                prog is None or prog in (finding.program or "")):
            return True
    return _inline_suppressed(finding)


# ---------------------------------------------------------------------------
# the TrainStep program set and the model zoo
# ---------------------------------------------------------------------------

def train_step_programs(ts, data_shapes, label_shapes, k=2, guard=True,
                        name=None):
    """The ``(name, fn, example_args)`` program set of one
    :class:`~mxnet_tpu_torch.train_step.TrainStep`: ``step``, ``run_steps``
    over a ``(k, ...)`` superbatch, and (with ``guard``) their guarded
    variants, over the given ``{name: shape}`` dicts. Each ``fn`` takes
    ``(state, batch)`` and returns ``(state, outputs...)``; the state,
    argument 0, is updated in place, the port's donation. This is the
    recipe the analyzers share.

    The arguments are fake tensors (``FakeTensorMode``) on the step's
    device: the state comes from ``ts.init`` with a no-op initializer under
    that mode and the batches are empty, so nothing is allocated on the
    device. Running a program advances nothing on ``ts``: each restores
    the optimizer's update count (the learning-rate clock) after it."""
    import torch
    from .memcheck import fake_mode
    name = name or "TrainStep(%s)" % ts.symbol.name
    if ts.device.type == "cuda" and not torch.backends.cuda.is_built():
        # autograd on fake CUDA tensors ends the process in a CPU build
        raise MXNetError(
            "train_step_programs: %s runs on %s, and this build of torch "
            "has no CUDA backend, which autograd needs even on fake "
            "tensors; price it on a GPU host, or build the TrainStep with "
            "device='cpu'" % (name, ts.device))
    devs = ts.replica_devices
    with fake_mode():
        state = ts.init(data_shapes, label_shapes,
                        initializer=lambda desc, arr: None, seed=0)
        shapes = dict(data_shapes)
        shapes.update(label_shapes or {})
        batch = {n: torch.empty(tuple(s), dtype=torch.float32,
                                device=devs[0]) for n, s in shapes.items()}
        sb = {n: torch.empty((k,) + tuple(s), dtype=torch.float32,
                             device=devs[0]) for n, s in shapes.items()}

    def keep_clock(fn):
        def run(state, batch):
            n = ts._opt.num_update
            try:
                return fn(state, batch)
            finally:
                ts._opt.num_update = n
        return run

    def scan(g):
        def run(state, superbatch):
            state, metrics = ts.run_steps(state, superbatch, guard=g)
            return state, metrics.device
        return run

    programs = [
        ("%s/step" % name, keep_clock(lambda s, b: ts.step(s, b)),
         (state, batch)),
        ("%s/scan[k=%d]" % (name, k), keep_clock(scan(False)), (state, sb)),
    ]
    if guard:
        programs += [
            ("%s/guarded-step" % name,
             keep_clock(lambda s, b: ts.step(s, b, guard=True)),
             (state, batch)),
            ("%s/guarded-scan[k=%d]" % (name, k), keep_clock(scan(True)),
             (state, sb)),
        ]
    return programs


#: model-zoo audit configs (the JAX package's): tiny shapes, and no step
#: program executes, so even 224px nets stay cheap
ZOO = {
    "mlp": dict(kwargs=dict(num_classes=4, hidden=(32,)),
                data=(8, 64), label=(8,)),
    "lenet": dict(kwargs=dict(num_classes=10),
                  data=(4, 1, 28, 28), label=(4,)),
    "resnet": dict(kwargs=dict(num_classes=4, num_layers=18,
                               image_shape="3,16,16"),
                   data=(2, 3, 16, 16), label=(2,)),
    "alexnet": dict(kwargs=dict(num_classes=10),
                    data=(2, 3, 224, 224), label=(2,)),
    "vgg": dict(kwargs=dict(num_classes=10, num_layers=11),
                data=(2, 3, 224, 224), label=(2,)),
    "inception-bn": dict(kwargs=dict(num_classes=10),
                         data=(2, 3, 224, 224), label=(2,)),
    "transformer": dict(kwargs=dict(vocab_size=32, embed=16, num_heads=2,
                                    num_layers=1, seq_len=16),
                        data=(2, 16), label=(2, 16)),
    # multi-head detection: its label rides the net's own outputs, name
    # "label"
    "ssd": dict(kwargs=dict(num_classes=3, width=8),
                data=(2, 3, 32, 32), label=(2, 2, 5),
                label_name="label"),
}


def zoo_train_step(mname, optimizer="sgd", learning_rate=0.1, device=None):
    """Build one zoo model's ``(TrainStep, data_shapes, label_shapes)`` on
    ``device`` (default ``cuda:0``; ``"cpu"`` on a host without a card):
    one recipe for the analyzers' zoo gates and the tuner (per-model data
    and label names live in the ZOO config; the SSD's label variable is
    ``label``)."""
    from . import models
    from .train_step import TrainStep
    if mname not in ZOO:
        raise MXNetError("unknown zoo model %r (have %s)"
                         % (mname, ", ".join(sorted(ZOO))))
    cfg = ZOO[mname]
    sym = models.get_symbol(mname, **cfg["kwargs"])
    dname = cfg.get("data_name", "data")
    lname = cfg.get("label_name", "softmax_label")
    ts = TrainStep(sym, data_names=(dname,), label_names=(lname,),
                   optimizer=optimizer, learning_rate=learning_rate,
                   device=device)
    return ts, {dname: cfg["data"]}, {lname: cfg["label"]}
