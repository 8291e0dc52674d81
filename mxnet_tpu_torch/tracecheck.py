"""tracecheck: the static analyzer of the port's step and serving programs,
and the retrace watch of their dispatches.

Counterpart of ``mxnet_tpu/tracecheck.py``. The JAX package lowers a
jitted program without running it and walks its jaxpr and StableHLO; an
eager PyTorch program has neither, so the port's static pass
(:func:`check_program`) runs the program once **shape-only**, on
:mod:`mxnet_tpu_torch.memcheck`'s dry run (every aten op on fake tensors,
each with the executor node that issued it and its source line), and
lints what the ops did. Nothing is allocated on the device and no kernel
launches.

Lint catalog, in the port's terms:

========================  ==================================================
lint id                   fires when
========================  ==================================================
``host-sync``             the program reads a value back to the host
                          (``.item()``, ``int()``/``float()``/``bool()`` of
                          a tensor, ``.tolist()``), copies from the card to
                          the host (``.cpu()``), takes a tensor's data
                          (``.numpy()``) or runs an op whose output shape
                          depends on the data (``nonzero``, a boolean
                          mask): each waits for the device inside every
                          dispatch. Provenance is the reading line; the
                          last two end the dry run there
``retrace``               the watch (:class:`TraceWatcher`) saw a dispatch
                          key run with a new argument signature; the differ
                          names the argument and the property that changed
``donation``              a leaf of a donated argument (the state,
                          argument 0) is rebound to a new storage instead of
                          updated in place, so the working set carries both
``const-capture``         the program reads a real tensor it was not given,
                          larger than ``MXTPU_TRACECHECK_CONST_BYTES``
                          (default 1 MiB): pass it as an argument
``dtype-f64``             an argument, or an aten op's output, is float64
                          or complex128
``collective-in-scan``    a gather-type collective (anything but an
                          all-reduce or a permute) runs in a K-step
                          ``run_steps`` program's loop: it pays its
                          bandwidth K times a dispatch. The collectives are
                          ``parallel/mesh.py``'s, recorded by the same dry
                          run (``commscheck``'s inventory); the lint is a
                          thin alias over ``commscheck.loop_findings``, and
                          :func:`check_collectives` runs it alone
========================  ==================================================

One JAX lint is never emitted here. ``dtype-weak`` flags a weak-typed
program input, a bare Python scalar that reached a trace: torch has no
weak types (a Python scalar keeps the tensor's dtype, and a dispatch
builds no trace to re-key), so no input of the port can be one.

**Retraces.** The port is eager: there is no jit cache to watch grow. A
*retrace* is a dispatch under an already-seen key whose argument
signature is new for that key and differs substantively from the last
one (:func:`explain_diff` is not empty), which is when the JAX package's
jit cache grows. The keys are the JAX package's: ``step[bs=N]``,
``guard-step[bs=N]``, ``scan[bs=N,k=K]``, ``guard-scan[bs=N,k=K]``, with a
metric spec ``scan[bs=N,k=K,m=<tag>.<crc>]``. ``TrainStep`` routes every
``step`` and ``run_steps`` dispatch through its watcher (``make_watcher(
"TrainStep(<symbol>)")``) and registers each key's program at its first
dispatch; per ``MXTPU_TRACECHECK`` (``engine.tracecheck_mode``) a retrace
is logged (``warn``, the default) or raised as :class:`RetraceError`
(``error``), and with ``off`` nothing is captured.

**The registry.** :func:`register_program` keeps a program by weak
reference with its arguments as fake tensors (never live ones);
:func:`check_registered` audits every live one, and
``memcheck.check_registered`` prices them. ``TrainStep`` registers its
programs, ``ServingEngine`` each bucket (``<engine>/bucket[b=N]``) and
``DecodeLoop`` each program of its loop.

Also here: the findings framework the analyzers share (:class:`Finding`,
the four lint catalogs, one suppression registry, the inline marker
``# tracecheck: ignore[lint-id]`` or a bare ``# tracecheck: ignore`` on,
or on the line above, a finding's provenance line), :func:`unique_name`,
:data:`ZOO` and :func:`train_step_programs`, the program set of one
``TrainStep``.

CLI::

    python -m mxnet_tpu_torch.tracecheck --zoo --device cpu
    python -m mxnet_tpu_torch.tracecheck --models mlp,lenet --json

Without ``--device`` the programs are audited on ``cuda:0``. The exit
status is non-zero iff an unsuppressed finding remains.
"""
from __future__ import annotations

import inspect
import linecache
import logging
import operator
import re
import threading
import weakref
import zlib
from collections import namedtuple

import torch

from .base import MXNetError

LINTS = ("host-sync", "retrace", "donation", "const-capture", "dtype-f64",
         "dtype-weak", "collective-in-scan")

#: memory lints (implemented in :mod:`mxnet_tpu_torch.memcheck`); declared
#: here so one suppression registry covers every analyzer
MEM_LINTS = ("hbm-budget", "donation-waste", "temp-blowup", "resident-set")

#: communication lints (implemented in :mod:`mxnet_tpu_torch.commscheck`)
COMM_LINTS = ("resharding-copy", "replicated-large", "gather-in-loop",
              "comms-bound")

#: roofline lints (implemented in :mod:`mxnet_tpu_torch.flopcheck`)
ROOFLINE_LINTS = ("memory-bound-hot", "layout-copy", "tiny-dispatch",
                  "predicted-mfu")

_NAME_SEQ = {}
_NAME_LOCK = threading.Lock()


def _const_bytes_default():
    from .base import env_float
    return int(env_float("MXTPU_TRACECHECK_CONST_BYTES", float(1 << 20)))


def unique_name(base):
    """Process-unique name: the first caller gets ``base`` verbatim, later
    callers get ``base#2``, ``base#3``, ... (engines built on several
    threads at once, as a fleet's joins are, take a lock)."""
    with _NAME_LOCK:
        n = _NAME_SEQ.get(base, 0) + 1
        _NAME_SEQ[base] = n
    return base if n == 1 else "%s#%d" % (base, n)


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
# above it: `# tracecheck: ignore[host-sync]`, `# tracecheck: ignore`
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
# mode (engine owns the env knob)
# ---------------------------------------------------------------------------

def mode():
    """Current retrace-policy mode: ``"warn"`` (default: log the diff),
    ``"error"`` (raise :class:`RetraceError`) or ``"off"`` (skip signature
    capture). Env: ``MXTPU_TRACECHECK``."""
    from . import engine
    return engine.tracecheck_mode()


def enabled():
    return mode() != "off"


# ---------------------------------------------------------------------------
# argument signatures + the retrace differ
# ---------------------------------------------------------------------------

_DTYPE_NAMES = {}


def _dtype_name(dt):
    """A dtype as the JAX package prints it: ``float32``, ``bfloat16``."""
    name = _DTYPE_NAMES.get(dt)
    if name is None:
        name = _DTYPE_NAMES[dt] = str(dt).replace("torch.", "")
    return name


#: a tensor's compact metadata, ``(shape, dtype)``, read in C
_META = operator.attrgetter("shape", "dtype")


def _flatten(x, metas):
    """Append the metadata of ``x``'s leaves to ``metas`` and return
    ``x``'s structure: ``"*"`` for a leaf, ``None`` for None (no leaf),
    else ``(kind, keys, children)``. Runs on every watched dispatch, so a
    dict is walked in its own order (:func:`_jax_order` gives the JAX
    package's, sorted keys, when a diff is reported), a container of plain
    tensors (a state's parameters) is read in C, and a tensor's metadata
    is kept compact (read out by :func:`_jax_meta`)."""
    if isinstance(x, torch.Tensor):
        metas.append(_META(x))
        return "*"
    if isinstance(x, dict):
        kind, fields, vals = "d", tuple(x), list(x.values())
    elif isinstance(x, (tuple, list)):
        fields = getattr(x, "_fields", None)
        kind = ("n", type(x).__name__) if fields is not None else (
            "l" if isinstance(x, list) else "t")
        vals = x
    elif x is None:
        return None
    else:
        metas.append(_leaf_meta(x))
        return "*"
    if vals and type(vals[0]) is torch.Tensor:
        n = len(metas)
        try:
            metas.extend(map(_META, vals))
            return (kind, fields, ("*",) * len(vals))
        except AttributeError:      # a child that is not an array
            del metas[n:]
    return (kind, fields, tuple([_flatten(v, metas) for v in vals]))


def _paths(spec, prefix, out, jax_order=False):
    """The path of each leaf of ``spec`` appended to ``out``: in leaf
    order, or with ``jax_order`` in the JAX package's (each dict's keys
    sorted)."""
    if spec == "*":
        out.append(prefix)
    elif spec is not None:
        kind, keys, children = spec
        order = range(len(children))
        if kind == "d" and jax_order:
            try:
                order = sorted(order, key=keys.__getitem__)
            except TypeError:
                pass
        for i in order:
            if kind == "d":
                p = "[%r]" % (keys[i],)
            elif keys is not None:
                p = ".%s" % keys[i]
            else:
                p = "[%d]" % i
            _paths(children[i], prefix + p, out, jax_order)
    return out


def _jax_order(spec):
    """Each leaf path's rank in the JAX package's leaf order."""
    return {p: r for r, p in enumerate(_paths(spec, "", [], True))}


class Signature(namedtuple("Signature", ["treedef", "metas"])):
    """A call signature in flat form: the argument structure plus one
    metadata tuple per leaf. The per-dispatch capture compares these
    tuples; argument *path names* (the JAX package's ``keystr``:
    ``[0][1]['data']``) are derived only when a diff must be reported."""

    __slots__ = ()

    def paths(self):
        """Per-leaf argument path strings, in leaf order."""
        return _paths(self.treedef, "", [])

    def as_dict(self):
        return dict(zip(self.paths(), map(_jax_meta, self.metas)))


def _jax_meta(m):
    """A leaf's metadata in :func:`_leaf_meta`'s form (an array's is kept
    compact, ``(shape, dtype)``, on the per-dispatch path)."""
    if len(m) == 2 and not isinstance(m[0], str):
        return ("array", tuple(m[0]), _dtype_name(m[1]), False, False)
    return m


def _leaf_meta(leaf):
    """``("array", shape, dtype, weak_type, committed)`` of an array leaf
    (a tensor, a MeshArray, a numpy array; torch has no weak types, and
    no committedness: both are False), ``("pyscalar", type)`` of a Python
    scalar, ``("static", type, repr)`` of anything else."""
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        return ("array", tuple(leaf.shape), _dtype_name(leaf.dtype), False,
                False)
    if isinstance(leaf, (bool, int, float, complex)):
        return ("pyscalar", type(leaf).__name__)
    return ("static", type(leaf).__name__, repr(leaf))


def signature(args, kwargs=None):
    """Capture the dispatch-relevant signature of a call: every argument
    leaf's shape and dtype (array leaves) or its type and value (static
    leaves; a Python scalar by its type, as a jitted JAX function traces
    it). Pure metadata: the state can be signed after an in-place
    update."""
    metas = []
    spec = ("t", None, (_flatten(tuple(args), metas),
                        _flatten(dict(kwargs), metas) if kwargs
                        else _NO_KWARGS))
    return Signature(spec, tuple(metas))


_NO_KWARGS = ("d", (), ())


#: substantive array properties, the JAX package's
_PROPS = ("shape", "dtype", "weak_type")


def _leaf_diff_line(path, a, b):
    if a[0] != b[0]:
        return ("argument %s: kind changed %s -> %s (%r -> %r)"
                % (path, a[0], b[0], a[1:], b[1:]))
    if a[0] == "array":
        for i, prop in enumerate(_PROPS, start=1):
            if a[i] != b[i]:
                return ("argument %s: %s %s -> %s" % (path, prop, a[i], b[i]))
        return None  # only committedness differs: benign
    if a[0] == "pyscalar":
        return ("argument %s: Python scalar type %s -> %s"
                % (path, a[1], b[1]))
    return "argument %s: static value %s -> %s" % (path, a[2], b[2])


def explain_diff(old, new):
    """The signature differ: given two call signatures of the same
    program, name exactly which argument's shape, dtype or static value
    changed. Returns a list of human-readable lines, empty when nothing
    substantive changed."""
    if isinstance(old, Signature) and isinstance(new, Signature):
        if old.treedef == new.treedef:
            # per-dispatch fast path: elementwise meta compare, path names
            # derived only for the leaves that changed
            idxs = [i for i, (a, b) in enumerate(zip(old.metas, new.metas))
                    if a != b]
            if not idxs:
                return []
            paths = new.paths()
            rank = _jax_order(new.treedef)
            idxs.sort(key=lambda i: rank[paths[i]])
            lines = [_leaf_diff_line(paths[i], _jax_meta(old.metas[i]),
                                     _jax_meta(new.metas[i]))
                     for i in idxs]
            return [ln for ln in lines if ln is not None]
        old, new = old.as_dict(), new.as_dict()
    elif isinstance(old, Signature):
        old = old.as_dict()
    elif isinstance(new, Signature):
        new = new.as_dict()
    lines = []
    for path in sorted(set(old) | set(new)):
        a, b = old.get(path), new.get(path)
        if a == b:
            continue
        if a is None:
            lines.append("argument %s: newly present %r" % (path, (b,)))
        elif b is None:
            lines.append("argument %s: no longer present (was %r)"
                         % (path, (a,)))
        else:
            ln = _leaf_diff_line(path, a, b)
            if ln is not None:
                lines.append(ln)
    return lines


def benign_diff(old, new):
    """The JAX package's differences that re-key only jit's dispatch fast
    path, not the trace: array committedness. A torch tensor has no
    committedness, and an eager dispatch no fast-path key that another
    property could re-key (a change of strides or ``requires_grad`` runs
    the same code), so this is always empty; kept for the JAX package's
    interface."""
    return []


class RetraceError(MXNetError):
    """Raised by :class:`TraceWatcher` under ``MXTPU_TRACECHECK=error``.

    The watcher runs after the dispatch, which has already updated the
    state in place, so when this is raised from ``TrainStep.step`` or
    ``run_steps``, ``result`` carries the call's return value (the state
    and the outputs or metrics) for the caller to adopt (``Module``
    does)."""

    def __init__(self, msg, result=None):
        super().__init__(msg)
        self.result = result


RetraceEvent = namedtuple("RetraceEvent", ["site", "diff"])

#: process-global log of every detected retrace (test_utils.assert_no_retrace
#: snapshots its length; Speedometer counts them)
RETRACE_EVENTS = []


def retrace_count():
    return len(RETRACE_EVENTS)


def make_watcher(base):
    """A :class:`TraceWatcher` under a process-unique name (see
    :func:`unique_name`)."""
    return TraceWatcher(unique_name(base))


class TraceWatcher(object):
    """Per-call-site retrace detector: records the argument signature of
    every watched dispatch by key; a dispatch under an already-seen key
    whose signature is new for the key and differs substantively from the
    last one is a retrace: the differ names the offending argument and
    property, the event is counted (process-global ``RETRACE_EVENTS``,
    ``guard.TRAINING_HEALTH.retraces`` or the per-run health when one is
    attached), and per ``MXTPU_TRACECHECK`` the diff is logged (``warn``)
    or raised (``error``)."""

    __slots__ = ("name", "events", "_seen")

    def __init__(self, name):
        self.name = name
        self.events = []
        self._seen = {}     # key -> (last signature, signatures seen)

    def after_call(self, key, fn, sig, health=None):
        """Feed one dispatch of ``fn`` (the program, kept for the JAX
        package's interface) under ``key`` with signature ``sig``; returns
        the :class:`RetraceEvent`, or None."""
        seen = self._seen.get(key)
        if seen is None:
            self._seen[key] = (sig, {sig})
            return None
        last, sigs = seen
        if sig == last:
            return None
        self._seen[key] = (sig, sigs)
        if sig in sigs:
            return None     # a signature this key ran before
        sigs.add(sig)
        diff = explain_diff(last, sig)
        if not diff:
            return None
        return self._emit(key, diff, health)

    def _cache_size(self):
        """The distinct (key, signature) pairs seen: what the JAX
        package's jit caches would hold (``assert_no_retrace`` pins it)."""
        return sum(len(sigs) for _, sigs in self._seen.values())

    def _emit(self, key, diff, health):
        site = "%s/%s" % (self.name, key)
        ev = RetraceEvent(site=site, diff=tuple(diff))
        self.events.append(ev)
        RETRACE_EVENTS.append(ev)
        from . import guard as _guard
        if health is not None:
            health.record_retrace(site)
        else:
            _guard.TRAINING_HEALTH.record_retrace(site)
        msg = ("tracecheck: unexpected retrace at %s — an already-"
               "dispatched program key ran with a new argument signature. "
               "Changed: %s" % (site, "; ".join(diff)))
        if mode() == "error":
            raise RetraceError(msg)
        logging.warning(msg)
        return ev


def _stable_sig(sig):
    """A metric spec's signature projected onto run-to-run-stable atoms
    for program naming: a function object (a ``CustomMetric``'s
    ``step_sums``) is named by its qualified name, not its address."""
    if isinstance(sig, tuple):
        return tuple(_stable_sig(s) for s in sig)
    if isinstance(sig, (str, int, float, bool)) or sig is None:
        return sig
    return getattr(sig, "__qualname__", type(sig).__name__)


def dispatch_key(kind, cache_key, spec=None):
    """The JAX package's name of a ``TrainStep`` dispatch key: ``kind``
    (``step``, ``guard-step``, ``scan``, ``guard-scan``) at ``cache_key``
    (the batch size, or ``(batch, k)`` or ``(batch, k, spec signature)``
    for a scan), with a metric spec's tag and the crc32 of its stabilised
    signature."""
    if not isinstance(cache_key, tuple):
        return "%s[bs=%d]" % (kind, cache_key)
    if len(cache_key) == 2:
        return "%s[bs=%d,k=%d]" % (kind, cache_key[0], cache_key[1])
    tag = spec.tag if spec is not None else "spec"
    return "%s[bs=%d,k=%d,m=%s.%04x]" % (
        kind, cache_key[0], cache_key[1], tag,
        zlib.crc32(repr(_stable_sig(cache_key[2])).encode()) & 0xffff)


# ---------------------------------------------------------------------------
# the program registry
# ---------------------------------------------------------------------------

ProgramRecord = namedtuple("ProgramRecord",
                           ["name", "fn_ref", "arg_structs", "donate_argnums"])

#: name -> ProgramRecord; fn_ref is a weak reference, so the registry
#: never keeps a dead TrainStep's or engine's programs alive
PROGRAMS = {}


def register_program(name, fn, args, donate_argnums=()):
    """Register a program (a callable; a bound method is held by a
    ``WeakMethod``) with example arguments, for :func:`check_registered`.
    Tensor arguments are stored as fake tensors (``memcheck.fake_mode``:
    the mode of the fake ones among them, else a fresh one): no device
    memory and no live tensor is kept."""
    from .memcheck import fake_mode, fake_tree
    ref = (weakref.WeakMethod(fn) if inspect.ismethod(fn)
           else weakref.ref(fn))
    with fake_mode(like=tuple(args)) as m:
        structs = fake_tree(tuple(args), m)
    PROGRAMS[name] = ProgramRecord(name, ref, structs, tuple(donate_argnums))
    return PROGRAMS[name]


def registered_programs():
    """Live registered programs (dead references are dropped lazily)."""
    live = []
    for n, r in list(PROGRAMS.items()):
        if r.fn_ref() is None:
            PROGRAMS.pop(n, None)
        else:
            live.append(r)
    return live


def check_registered(const_bytes=None, match=None):
    """Audit every live registered program (a TrainStep's guarded and
    unguarded step and scan programs as a unit, an engine's buckets)
    whose name contains ``match``, and return all findings."""
    findings = []
    for rec in registered_programs():
        if match is not None and match not in rec.name:
            continue
        fn = rec.fn_ref()
        if fn is None:
            continue
        findings += check_program(fn, rec.arg_structs,
                                  donate_argnums=rec.donate_argnums,
                                  name=rec.name, const_bytes=const_bytes)
    return findings


# ---------------------------------------------------------------------------
# the static pass
# ---------------------------------------------------------------------------

def _const_sources(fn):
    """Python-level ``{name: value}`` candidates for a program's captured
    constants: the (unwrapped) function's closure cells plus the globals
    its code references."""
    try:
        f = inspect.unwrap(getattr(fn, "__wrapped__", fn))
    except ValueError:
        f = fn
    code = getattr(f, "__code__", None)
    if code is None:
        return {}
    out = {}
    for nm, cell in zip(code.co_freevars, getattr(f, "__closure__", ())
                        or ()):
        try:
            out[nm] = cell.cell_contents
        except ValueError:
            pass
    g = getattr(f, "__globals__", None) or {}
    for nm in code.co_names:
        if nm in g:
            out.setdefault(nm, g[nm])
    return out


def _const_var_name(c, sources):
    """The closure or global variable a captured tensor came from: by
    identity, else by a unique shape+dtype match (an ambiguous match
    names nothing rather than the wrong variable)."""
    ids = [nm for nm, v in sources.items() if v is c]
    if len(ids) == 1:
        return ids[0]
    matches = [nm for nm, v in sources.items()
               if hasattr(v, "shape") and hasattr(v, "dtype")
               and tuple(v.shape) == tuple(c.shape) and v.dtype == c.dtype]
    return matches[0] if len(matches) == 1 else None


def check_program(fn, args=(), kwargs=None, donate_argnums=(), name=None,
                  const_bytes=None):
    """Run every static lint over ONE program: ``fn(*args, **kwargs)`` run
    once shape-only (``memcheck``'s dry run; real tensor arguments become
    fake ones, so nothing is allocated and nothing launches). Returns a
    list of :class:`Finding` with inline and programmatic suppressions
    already applied (``.suppressed``)."""
    import torch
    from .memcheck import _dry_run, _fmt_bytes, _tb_line
    if name is None:
        name = getattr(fn, "__name__", None) or repr(fn)
    threshold = (_const_bytes_default() if const_bytes is None
                 else int(const_bytes))
    run = _dry_run(fn, args, kwargs, donate_argnums, name, lint=True)
    findings = []
    for lab, t in run.arg_leaves:
        if t.dtype in (torch.float64, torch.complex128):
            findings.append(Finding(
                "dtype-f64", name, "program input %s is %s — pin a 32-bit "
                "dtype" % (lab, _dtype_name(t.dtype)), op_path=lab))
    seen = set()
    sources = None
    for kind, what, node, prov in run.tracker.events:
        if kind == "host-sync":
            if (what, prov) in seen:
                continue    # .tolist() reads once per element
            seen.add((what, prov))
            findings.append(Finding(
                "host-sync", name, "%s inside the program — every dispatch "
                "waits here for the device" % what, op_path=node,
                provenance=prov))
        elif kind == "dtype-f64":
            opcode, t = what
            findings.append(Finding(
                "dtype-f64", name, "op %r produces %s%s — a 64-bit value "
                "inside the step program"
                % (opcode, _dtype_name(t.dtype), list(t.shape)),
                op_path=node, provenance=prov))
        elif kind == "const":
            nbytes = what.untyped_storage().nbytes()
            if nbytes <= threshold:
                continue
            if sources is None:
                sources = _const_sources(fn)
            var = _const_var_name(what, sources)
            findings.append(Finding(
                "const-capture", name,
                "captured tensor %s (%s%s) is %s (> %s, "
                "MXTPU_TRACECHECK_CONST_BYTES) read by the program but not "
                "passed to it — pass it as an argument instead"
                % ("variable %r" % var if var else "on %s" % what.device,
                   _dtype_name(what.dtype), list(what.shape),
                   _fmt_bytes(nbytes), _fmt_bytes(threshold)),
                op_path=node, provenance=prov))
    trips = _loop_trips(fn, args)
    if trips > 1:
        from .commscheck import _entries, loop_findings
        findings += loop_findings(_entries(run.tracker.collectives, trips),
                                  name, lint="collective-in-scan")
    if run.stopped is not None:
        from torch._subclasses.fake_tensor import DynamicOutputShapeException
        what = ("an op whose output shape depends on the data (%s)"
                % (run.stopped.args or ("?",))[0]
                if isinstance(run.stopped, DynamicOutputShapeException)
                else "a read of a tensor's data (.numpy())")
        findings.append(Finding(
            "host-sync", name, "%s inside the program — every dispatch "
            "waits here for the device; the dry run ended at it" % what,
            provenance=_tb_line(run.stopped)))
    for lab, nbytes in run.report.unaliased_donated:
        node, prov = run.replaced_by.get(lab, (None, None))
        findings.append(Finding(
            "donation", name, "donated argument %s (%s) is rebound to a new "
            "storage, not updated in place — the working set carries both"
            % (lab, _fmt_bytes(nbytes)), op_path=node or lab,
            provenance=prov))
    for f in findings:
        f.suppressed = _is_suppressed(f)
    return findings


def _loop_trips(fn, args):
    """The trip count K of a K-step program: a scan :class:`StepProgram`'s
    superbatch depth (its second argument's leading dimension); 1 for any
    other program."""
    fn = getattr(fn, "__self__", fn)
    if not (isinstance(fn, StepProgram) and fn.scan and len(args) > 1
            and isinstance(args[1], dict) and args[1]):
        return 1
    return int(next(iter(args[1].values())).shape[0])


def check_collectives(fn, args=(), kwargs=None, name=None,
                      allow=("all-reduce", "collective-permute"),
                      loop_trips=None):
    """``collective-in-scan`` alone: run the program once shape-only and
    flag every collective of ``parallel/mesh.py`` in its K-step loop whose
    kind is not in ``allow`` (default: the all-reduce, the expected
    gradient and metric sum, and the permute, the ring and pipeline
    schedule). ``loop_trips`` is K (None: a scan :class:`StepProgram`'s
    depth, else 1). A thin alias over ``commscheck``'s inventory (one
    collective record for both analyzers); the findings keep this lint's
    id. Returns findings with suppressions applied, like
    :func:`check_program`."""
    from . import commscheck as _cc
    trips = _loop_trips(fn, args) if loop_trips is None else loop_trips
    report = _cc.analyze(fn, args, kwargs=kwargs, name=name,
                         loop_trips=trips)
    findings = _cc.loop_findings(report, report.program,
                                 lint="collective-in-scan", allow=allow)
    for f in findings:
        f.suppressed = _is_suppressed(f)
    return findings


# ---------------------------------------------------------------------------
# TrainStep auditing + the model zoo
# ---------------------------------------------------------------------------

class StepProgram(object):
    """One ``TrainStep`` program as a callable ``(state, batch) -> (state,
    outputs...)``: ``step``, or with ``scan`` ``run_steps`` over a stacked
    superbatch (returning the metric sums' device tensor), guarded or not,
    with a metric spec. It holds its ``TrainStep`` by weak reference, and
    restores the optimizer's update count (the learning-rate clock) after
    each call, so an audit advances nothing."""

    __slots__ = ("_ts", "scan", "guard", "spec", "__weakref__")

    def __init__(self, ts, scan=False, guard=False, spec=None):
        self._ts = weakref.ref(ts)
        self.scan = scan
        self.guard = guard
        self.spec = spec

    def __call__(self, state, batch):
        ts = self._ts()
        if ts is None:
            raise MXNetError("tracecheck: the TrainStep of this program is "
                             "gone")
        n = ts._opt.num_update
        try:
            if self.scan:
                state, metrics = ts.run_steps(state, batch, guard=self.guard,
                                              metric_spec=self.spec)
                return state, metrics.device
            return ts.step(state, batch, guard=self.guard)
        finally:
            ts._opt.num_update = n


def train_step_programs(ts, data_shapes, label_shapes, k=2, guard=True,
                        name=None):
    """The ``(name, fn, example_args)`` program set of one
    :class:`~mxnet_tpu_torch.train_step.TrainStep`: ``step``, ``run_steps``
    over a ``(k, ...)`` superbatch, and (with ``guard``) their guarded
    variants, over the given ``{name: shape}`` dicts, each a
    :class:`StepProgram`. The state, argument 0, is updated in place, the
    port's donation. This is the recipe the analyzers share.

    The arguments are fake tensors (``FakeTensorMode``) on the step's
    device: the state comes from ``ts.init`` with a no-op initializer under
    that mode and the batches are empty, so nothing is allocated on the
    device."""
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

    programs = [
        ("%s/step" % name, StepProgram(ts), (state, batch)),
        ("%s/scan[k=%d]" % (name, k), StepProgram(ts, scan=True),
         (state, sb)),
    ]
    if guard:
        programs += [
            ("%s/guarded-step" % name, StepProgram(ts, guard=True),
             (state, batch)),
            ("%s/guarded-scan[k=%d]" % (name, k),
             StepProgram(ts, scan=True, guard=True), (state, sb)),
        ]
    return programs


def check_train_step(ts, data_shapes, label_shapes, k=2, guard=True,
                     const_bytes=None, name=None):
    """Audit a :class:`~mxnet_tpu_torch.train_step.TrainStep`'s full
    program set (see :func:`train_step_programs`)."""
    findings = []
    for pname, fn, pargs in train_step_programs(
            ts, data_shapes, label_shapes, k=k, guard=guard, name=name):
        findings += check_program(fn, pargs, donate_argnums=(0,),
                                  name=pname, const_bytes=const_bytes)
    return findings


#: the eager port's launch count: one launch an op of the forward, the
#: backward and each parameter's update, most of them under a microsecond
#: at the zoo's tiny batches; fusing the step waits for a benchmark
#: (ROADMAP.md B, the port's first bottleneck)
_EAGER_LAUNCHES = ("the eager port launches every op on its own: %s, past "
                   "MXTPU_FLOPCHECK_TINY_COUNT (4096) of launches under a "
                   "microsecond; fusing the step waits for a benchmark "
                   "(ROADMAP.md B)")

#: model-zoo audit configs (the JAX package's): tiny shapes, and no step
#: program executes, so even 224px nets stay cheap. ``suppress`` maps a
#: lint to the reason its findings on the model's programs are expected
#: (``flopcheck.check_zoo`` marks them suppressed)
ZOO = {
    "mlp": dict(kwargs=dict(num_classes=4, hidden=(32,)),
                data=(8, 64), label=(8,)),
    "lenet": dict(kwargs=dict(num_classes=10),
                  data=(4, 1, 28, 28), label=(4,)),
    "resnet": dict(kwargs=dict(num_classes=4, num_layers=18,
                               image_shape="3,16,16"),
                   data=(2, 3, 16, 16), label=(2,),
                   suppress={"tiny-dispatch": _EAGER_LAUNCHES % (
                       "some 4300 launches in the guarded K=2 scan on a "
                       "card")}),
    "alexnet": dict(kwargs=dict(num_classes=10),
                    data=(2, 3, 224, 224), label=(2,)),
    "vgg": dict(kwargs=dict(num_classes=10, num_layers=11),
                data=(2, 3, 224, 224), label=(2,)),
    "inception-bn": dict(kwargs=dict(num_classes=10),
                         data=(2, 3, 224, 224), label=(2,),
                         suppress={"tiny-dispatch": _EAGER_LAUNCHES % (
                             "some 4300 launches a step (its BatchNorms "
                             "and branches, and each parameter's update)")}),
    "transformer": dict(kwargs=dict(vocab_size=32, embed=16, num_heads=2,
                                    num_layers=1, seq_len=16),
                        data=(2, 16), label=(2, 16)),
    # multi-head detection: its label rides the net's own outputs, name
    # "label"
    "ssd": dict(kwargs=dict(num_classes=3, width=8),
                data=(2, 3, 32, 32), label=(2, 2, 5),
                label_name="label",
                suppress={"tiny-dispatch": _EAGER_LAUNCHES % (
                    "some 2200 launches a step (MultiBoxTarget's small ops; "
                    "on the CPU the plain NMS sweep, k steps), past 4096 "
                    "in the K=2 scans")}),
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


def check_zoo(names=None, k=2, guard=True, const_bytes=None, log=None,
              device=None):
    """Audit the model zoo's step programs on ``device`` (default
    ``cuda:0``); returns ``(findings, n_programs)``. ``names=None`` audits
    every shipped model."""
    names = list(names) if names else sorted(ZOO)
    findings = []
    nprog = 0
    for mname in names:
        if mname not in ZOO:
            raise MXNetError("tracecheck: unknown zoo model %r (have %s)"
                             % (mname, ", ".join(sorted(ZOO))))
        if log:
            log("auditing %s ..." % mname)
        ts, data_shapes, label_shapes = zoo_train_step(mname, device=device)
        findings += check_train_step(
            ts, data_shapes, label_shapes,
            k=k, guard=guard, const_bytes=const_bytes, name=mname)
        nprog += 4 if guard else 2
    return findings, nprog


def main(argv=None):
    import argparse
    import sys
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.tracecheck",
        description="Static analyzer for the port's step programs: "
                    "host-sync, donation, const-capture and dtype lints over"
                    " a shape-only dry run of the model zoo's train steps.")
    p.add_argument("--zoo", action="store_true",
                   help="audit every shipped model's step/scan programs")
    p.add_argument("--models", default=None,
                   help="comma-separated zoo subset (implies --zoo)")
    p.add_argument("--k", type=int, default=2,
                   help="scan depth for the K-step programs (default 2)")
    p.add_argument("--no-guard", action="store_true",
                   help="skip the guarded program variants")
    p.add_argument("--const-bytes", type=int, default=None,
                   help="const-capture threshold (default "
                        "MXTPU_TRACECHECK_CONST_BYTES or 1 MiB)")
    p.add_argument("--json", action="store_true", help="JSON findings")
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
    if not (args.zoo or args.models):
        p.error("nothing to check: pass --zoo or --models")
    names = ([s.strip() for s in args.models.split(",") if s.strip()]
             if args.models else None)
    log = (lambda m: None) if (args.quiet or args.json) \
        else (lambda m: print(m, file=sys.stderr))
    findings, nprog = check_zoo(names=names, k=args.k,
                                guard=not args.no_guard,
                                const_bytes=args.const_bytes, log=log,
                                device=args.device)
    bad = unsuppressed(findings)
    if args.json:
        import json as _json
        print(_json.dumps({
            "findings": [f.as_dict() for f in findings],
            "total": len(findings),
            "suppressed": len(findings) - len(bad),
            "programs": nprog,
        }, indent=2))
    else:
        report(findings)
        print("tracecheck: %d finding(s) (%d suppressed) over %d program(s)"
              % (len(findings), len(findings) - len(bad), nprog))
    return 1 if bad else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
