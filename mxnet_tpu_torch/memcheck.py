"""memcheck: a static memory analyzer for the port's step and serving
programs.

Counterpart of ``mxnet_tpu/memcheck.py``. The JAX package compiles a
program without running it and reads XLA's buffer assignment
(``compiled.memory_analysis()`` and the scheduled HLO). An eager PyTorch
step has no compiled program to ask, so the port prices a program by
running it **shape-only**: :func:`analyze` calls it once under
``torch._subclasses.fake_tensor.FakeTensorMode``, where every tensor
carries its shape, dtype, device and storage size but no data. Nothing is
allocated on the device and no kernel launches (the hand-written kernels'
wrappers take a shape-only route for fake tensors). A dispatch mode above
the fake one sees every aten op: it records each new output storage once
(views share their base's storage), releases it when its last tensor dies
(the storage object outlives its Python wrappers while autograd or a view
still holds it), and keeps the peak of the live bytes. The figures:

- ``argument_bytes``: the distinct storages of the arguments;
- ``output_bytes``: the distinct new storages the call returns, plus the
  donated leaves it kept (the donated state is the program's output, as
  in the JAX package);
- ``alias_bytes``: the donated leaves the call kept, the port's donation:
  updated in place (``TrainStep`` and the decode loop update their state
  in place), returned as they are, or left alone. A donated leaf is
  *replaced* (``unaliased_donated``) when the call returns a new storage
  at its place in the output (the same key path, or the same path under
  the output's first-level position) and did not write the old one;
- ``temp_bytes``: the peak of the live bytes less ``argument_bytes +
  output_bytes - alias_bytes``, so that ``peak_bytes = args + out + temp
  - alias`` is that peak, as in the JAX package.

On a CUDA device each storage is counted rounded up to the caching
allocator's 512-byte granule, the size ``torch.cuda.max_memory_allocated``
counts. A convolution on a card adds cuDNN's workspace while it runs:
cuDNN picks the algorithm, and so the workspace, only when the
convolution first runs for real (on torch's cuDNN v8 path no environment
cap bounds it, ``PERF.md``), so the dry run prices the workspace the
process saw that convolution take under :func:`learn_workspaces` (each
``ServingEngine`` warms its buckets up under it) and counts the others in
``MemoryReport.unpriced_workspaces``. What the dry run cannot see:
cuBLAS's workspace, the kernels' own scratch (B1's per-block partial
sums, B2's ``l2`` mask), and the allocator's free cached blocks. Temp and
peak are not comparable with the JAX package's: XLA plans and fuses
buffers, an eager step frees each one when its last reference dies;
argument bytes and the state's leaves are.

A program that reads a value back to the host (``.item()``, ``int()`` of
a tensor, ``.cpu().numpy()``) cannot be priced: :func:`analyze` raises
``MXNetError`` naming the line. Autograd on fake CUDA tensors needs a
CUDA build of torch (a CPU build ends the process), so a CUDA training
step is priced on a GPU host.

Memory lint catalog (the JAX package's definitions and knobs):

==================  =====================================================
lint id             fires when
==================  =====================================================
``hbm-budget``      a program's peak exceeds ``MXTPU_MEMCHECK_BUDGET``
                    (default :func:`device_budget`)
``donation-waste``  a donated leaf was replaced: the call returned a new
                    buffer in its place, so the working set carries both
``temp-blowup``     temp bytes exceed ``MXTPU_MEMCHECK_TEMP_MULT`` (4.0)
                    times the argument+output bytes
``resident-set``    the co-resident footprint of a program set (a serving
                    engine's buckets, a train step's four programs),
                    max(args+out-alias) + sum(temps), exceeds the budget
==================  =====================================================

CLI::

    python -m mxnet_tpu_torch.memcheck --models mlp,lenet --json --device cpu
    python -m mxnet_tpu_torch.memcheck --zoo --write-baseline FILE
    python -m mxnet_tpu_torch.memcheck --zoo --baseline FILE

``--baseline`` is the regression gate: every program's peak and temp
bytes against the committed baseline within ``MXTPU_MEMCHECK_TOL``
(default 10%) plus 64 KiB. The exit status is non-zero iff an unsuppressed
finding or a baseline regression remains.

:func:`check_registered` prices the programs of ``tracecheck``'s registry
(a TrainStep's dispatched keys, an engine's buckets, a decode loop's
programs). Not ported: ``analyze_compiled`` and ``parse_hlo_buffers``
(there is no XLA executable or HLO); each raises ``MXNetError``.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import sys
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from .base import MXNetError, env_float, env_str, shape_only
from .tracecheck import (Finding, MEM_LINTS, _is_suppressed, unsuppressed,
                         ZOO)

__all__ = [
    "MemoryReport", "analyze", "analyze_compiled", "lint_report",
    "lint_resident_set", "resident_bytes", "check_program",
    "check_registered", "check_train_step", "check_zoo",
    "compare_baseline", "write_baseline", "parse_hlo_buffers",
    "fake_mode", "new_fake_mode", "fake_tree", "device_budget",
    "budget_bytes", "learn_workspaces", "CONV_WORKSPACES",
    "temp_multiple", "tolerance", "main", "MEM_LINTS",
]

#: budget of a device that reports no memory size (the CPU): the JAX
#: package's figure
_DEFAULT_BUDGET = 16 << 30

#: ignore donation waste below this (a stray scalar is not worth a red
#: gate)
_WASTE_FLOOR = 1024

#: the CUDA caching allocator's granule: every block it hands out is a
#: multiple of it
_CUDA_GRANULE = 512

_PKG_DIR = os.path.dirname(os.path.realpath(__file__))


def _parse_bytes(v, name):
    """Parse a byte count: plain number (int/float/scientific) or a
    K/M/G/T binary suffix (``MXTPU_MEMCHECK_BUDGET=12G``)."""
    v = str(v).strip()
    if not v:
        return None
    m = re.match(r"^([0-9.eE+\-]+)\s*([kKmMgGtT]?)i?[bB]?$", v)
    try:
        num = float(m.group(1)) if m else None
    except ValueError:
        num = None
    if num is None or num < 0:
        raise MXNetError("%s must be a byte count (optionally suffixed "
                         "K/M/G/T), got %r" % (name, v))
    scale = {"": 1, "k": 1 << 10, "m": 1 << 20,
             "g": 1 << 30, "t": 1 << 40}[m.group(2).lower()]
    return int(num * scale)


def _env_bytes(name):
    return _parse_bytes(env_str(name), name)


def _device(device):
    """A ``torch.device`` of a device, Context or string; None is
    ``cuda:0`` (``context.resolve_device``: without CUDA it raises, and
    the CPU is priced only where a caller asks for it)."""
    from .context import Context, resolve_device
    if isinstance(device, Context):
        device = device.to_device()
    if device is None:
        return resolve_device(None, "memcheck")
    return torch.device(device)


def device_budget(device=None):
    """A device's memory budget: ``total_memory`` of a CUDA device (the
    whole card; the CUDA context's few hundred MiB are not subtracted),
    16 GiB for the CPU, as the JAX package's fallback."""
    dev = _device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(
            dev.index or 0).total_memory)
    return _DEFAULT_BUDGET


def budget_bytes(device=None):
    """Effective peak budget: ``MXTPU_MEMCHECK_BUDGET`` (bytes, K/M/G/T
    suffixes accepted) or :func:`device_budget`."""
    env = _env_bytes("MXTPU_MEMCHECK_BUDGET")
    return env if env is not None else device_budget(device)


def temp_multiple():
    """``temp-blowup`` threshold: temps may be at most this multiple of the
    argument+output bytes (``MXTPU_MEMCHECK_TEMP_MULT``, default 4.0)."""
    return env_float("MXTPU_MEMCHECK_TEMP_MULT", 4.0)


def tolerance():
    """Baseline-gate tolerance band (``MXTPU_MEMCHECK_TOL``, default 0.1 =
    10% growth allowed per program per metric)."""
    return env_float("MXTPU_MEMCHECK_TOL", 0.1)


def _platform(dev):
    """The platform string of ``autotune.db.device_platform``: ``"gpu"``
    for a CUDA device, else the device type."""
    return "gpu" if dev.type == "cuda" else dev.type


def analyze_compiled(*args, **kwargs):
    """Reads an XLA executable's buffer assignment; the port has no
    compiled program (raises: use :func:`analyze`)."""
    raise MXNetError("memcheck.analyze_compiled reads an XLA executable, "
                     "which the port does not have; memcheck.analyze prices "
                     "a program by a shape-only dry run instead")


def parse_hlo_buffers(*args, **kwargs):
    """Walks scheduled HLO text; the port has none (raises)."""
    raise MXNetError("memcheck.parse_hlo_buffers walks XLA's scheduled "
                     "HLO, which the port does not have; memcheck.analyze "
                     "records the buffers of its dry run instead")


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def _fmt_bytes(n):
    if n is None:
        return "?"
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if n >= div:
            return "%.2f %s" % (n / div, unit)
    return "%d B" % n


class MemoryReport(object):
    """Static memory profile of ONE program.

    ``peak_bytes`` is its high-water estimate: ``argument + output + temp
    - alias`` (a donated buffer is counted once). ``device`` is the device
    the program was priced on (a string; its budget is the lints'
    default). ``top_buffers``
    attributes the largest buffers: dicts of ``bytes``, ``opcode`` (the
    aten op, ``"parameter"`` for an argument), ``op_path`` (the executor
    node that issued it, or the argument's label), ``instruction`` (the
    op and its sequence number in the run) and ``provenance`` (the
    ``file:line`` of the port's code that issued it)."""

    __slots__ = ("program", "platform", "argument_bytes", "output_bytes",
                 "temp_bytes", "alias_bytes", "generated_code_bytes",
                 "top_buffers", "donated", "unaliased_donated",
                 "unpriced_workspaces", "device")

    def __init__(self, program, platform, argument_bytes, output_bytes,
                 temp_bytes, alias_bytes, generated_code_bytes=0,
                 top_buffers=(), donated=(), unaliased_donated=(),
                 unpriced_workspaces=0, device=None):
        self.program = program
        self.platform = platform
        if device is None:
            device = "cuda:0" if platform == "gpu" else "cpu"
        self.device = str(device)
        self.argument_bytes = int(argument_bytes)
        self.output_bytes = int(output_bytes)
        self.temp_bytes = int(temp_bytes)
        self.alias_bytes = int(alias_bytes)
        self.generated_code_bytes = int(generated_code_bytes)
        self.top_buffers = list(top_buffers)
        #: [(label, bytes)] of donated argument leaves
        self.donated = list(donated)
        #: [(label, bytes)] donated leaves the call replaced
        self.unaliased_donated = list(unaliased_donated)
        #: convolutions on a card whose cuDNN workspace is not priced: the
        #: process has not run them under ``learn_workspaces``
        self.unpriced_workspaces = int(unpriced_workspaces)

    @property
    def peak_bytes(self):
        return (self.argument_bytes + self.output_bytes + self.temp_bytes
                - self.alias_bytes)

    @property
    def donated_bytes(self):
        return sum(b for _, b in self.donated)

    @property
    def wasted_donation_bytes(self):
        return sum(b for _, b in self.unaliased_donated)

    def as_dict(self):
        return {
            "program": self.program,
            "platform": self.platform,
            "device": self.device,
            "peak_bytes": self.peak_bytes,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "alias_bytes": self.alias_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "donated_bytes": self.donated_bytes,
            "wasted_donation_bytes": self.wasted_donation_bytes,
            "top_buffers": self.top_buffers,
            "unpriced_workspaces": self.unpriced_workspaces,
        }

    def breakdown(self, top=5):
        """Human-readable largest-buffer attribution, one line each."""
        lines = []
        for b in self.top_buffers[:top]:
            where = b["op_path"] or b["instruction"]
            if b["provenance"]:
                where += " @ " + b["provenance"]
            lines.append("%10s  %-16s %s"
                         % (_fmt_bytes(b["bytes"]), b["opcode"], where))
        return lines

    def format(self):
        s = ("%s: peak %s (args %s + out %s + temp %s - alias %s)"
             % (self.program, _fmt_bytes(self.peak_bytes),
                _fmt_bytes(self.argument_bytes),
                _fmt_bytes(self.output_bytes),
                _fmt_bytes(self.temp_bytes),
                _fmt_bytes(self.alias_bytes)))
        if self.unpriced_workspaces:
            s += "; %d convolution workspace(s) not priced" % (
                self.unpriced_workspaces)
        return s

    def __repr__(self):
        return "MemoryReport(%s)" % self.format()


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _walk(obj, label, fn):
    """``obj`` with ``fn(label, tensor)`` applied to each tensor leaf of
    its dicts, lists, tuples and MeshArrays; other leaves as they are.
    Labels are the JAX package's key strings (``['params']['w']``), a
    MeshArray's position as ``.parts[r]``."""
    from .parallel.mesh import MeshArray
    if isinstance(obj, torch.Tensor):
        return fn(label, obj)
    if isinstance(obj, dict):
        return {k: _walk(v, "%s[%r]" % (label, k), fn)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        vals = [_walk(v, "%s[%d]" % (label, i), fn)
                for i, v in enumerate(obj)]
        if isinstance(obj, list):
            return vals
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    if isinstance(obj, MeshArray):
        return MeshArray(obj.mesh, [fn("%s.parts[%d]" % (label, r), p)
                                    for r, p in enumerate(obj.parts)],
                         spec=obj.spec)
    return obj


def _leaves(obj, label=""):
    out = []
    _walk(obj, label, lambda lab, t: out.append((lab, t)) or t)
    return out


def _storage(t):
    """``(key, bytes)`` of a tensor's storage: bytes on a CUDA device
    rounded up to the allocator's granule."""
    st = t.untyped_storage()
    nb = int(st.nbytes())
    if t.device.type == "cuda" and nb:
        nb = -(-nb // _CUDA_GRANULE) * _CUDA_GRANULE
    return st, st._cdata, nb


def new_fake_mode(**kwargs):
    """A ``FakeTensorMode`` (``kwargs`` passed on) that never touches a
    device: on a host with CUDA too, it keeps ``torch.tensor(...,
    device=...)`` from making its data on the card and does not fold a
    constant's copy to the card by running it (what ``FakeTensorMode``
    does by itself only on a host without CUDA)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    class _DeviceFreeMode(FakeTensorMode):
        @property
        def avoid_device_init(self):
            return True

    return _DeviceFreeMode(**kwargs)


@contextlib.contextmanager
def fake_mode(mode=None, like=None):
    """Enter ``mode`` (a ``FakeTensorMode``; else the mode of the fake
    tensors in the tree ``like``; else :func:`new_fake_mode`) for a dry
    run, with tensor constructors kept on the host before they fake their
    data. Yields the mode."""
    if mode is None and like is not None:
        mode = _fake_mode_of(_leaves(like))
    mode = new_fake_mode() if mode is None else mode
    prev = torch._C._only_lift_cpu_tensors()
    torch._C._set_only_lift_cpu_tensors(True)
    try:
        with mode:
            yield mode
    finally:
        torch._C._set_only_lift_cpu_tensors(prev)


def fake_tree(tree, mode):
    """``tree`` with each real tensor leaf replaced by a fake one of
    ``mode`` (same shape, dtype, device and storage sharing; no data
    copied); fake leaves pass as they are."""
    from torch._subclasses.fake_tensor import is_fake
    return _walk(tree, "", lambda lab, t: t if is_fake(t)
                 else mode.from_tensor(t, static_shapes=True))


def _fake_mode_of(leaves):
    """The FakeTensorMode the fake leaves belong to (None if none is
    fake); leaves of two modes raise."""
    from torch._subclasses.fake_tensor import is_fake
    modes = {id(t.fake_mode): t.fake_mode for _, t in leaves if is_fake(t)}
    if len(modes) > 1:
        raise MXNetError("memcheck.analyze: the arguments are fake tensors "
                         "of %d different FakeTensorModes" % len(modes))
    return next(iter(modes.values()), None)


#: per code-object file name: ``(normalized name, in the port's package
#: outside the analyzers, the executor)``; a module may have been imported
#: through a path that is not normalized (``.../tests/../mxnet_tpu_torch``)
_FILES = {}

#: torch's own package: frames there are never a program's provenance
_TORCH_DIR = os.path.dirname(os.path.realpath(torch.__file__))

#: the analyzers (and ``autotune.hotspot_report``'s delegation to one),
#: whose frames are never a program's provenance
_ANALYZERS = ("memcheck.py", "tracecheck.py", "flopcheck.py",
              "commscheck.py", os.path.join("autotune", "__init__.py"))


def _file_kind(fname):
    kind = _FILES.get(fname)
    if kind is None:
        real = os.path.realpath(fname)
        inside = real.startswith(_PKG_DIR + os.sep)
        kind = (real, inside and not real.endswith(_ANALYZERS),
                inside and real == os.path.join(_PKG_DIR, "executor.py"))
        _FILES[fname] = kind
    return kind


def _foreign(real):
    """Whether ``real`` (a normalized file name) is code outside both the
    port's package and torch's: a caller's own program."""
    return not (real.startswith(_PKG_DIR + os.sep)
                or real.startswith(_TORCH_DIR + os.sep))


def _frame_line(frames):
    """The provenance ``file:line`` of an op from its stack, innermost
    frame first (``(code, line)`` pairs): the innermost line of the port's
    code outside the analyzers, else the innermost line outside the port
    and torch (a caller's own program), else None."""
    other = None
    for code, line in frames:
        real, port, _ = _file_kind(code.co_filename)
        if port:
            return "%s:%d" % (real, line)
        if other is None and _foreign(real):
            other = "%s:%d" % (real, line)
    return other


def _stack(f):
    while f is not None:
        yield f.f_code, f.f_lineno
        f = f.f_back


def _where(depth=2):
    """``(op_path, provenance)`` of the op being dispatched: the executor
    node whose walk issued it, and :func:`_frame_line` of the stack from
    ``depth`` frames up (the frame that called the caller)."""
    node = None
    f = sys._getframe(depth)
    g = f
    while g is not None:
        executor = _file_kind(g.f_code.co_filename)[2]
        if executor and g.f_code.co_name in ("apply", "apply_mesh"):
            node = getattr(g.f_locals.get("node"), "name", None)
            break
        g = g.f_back
    return node, _frame_line(_stack(f))


#: the collectives' own plumbing, whose frames are never a collective's
#: provenance (its caller's line is)
_PLUMBING = (os.path.join(_PKG_DIR, "base.py"),
             os.path.join(_PKG_DIR, "parallel", "mesh.py"))


def _collective_where(op_path=None):
    """``(op_path, provenance)`` of a collective being recorded
    (``base.note_collective``): the executor node whose walk issued it
    (``op_path`` where its caller names one), and :func:`_frame_line` of
    the stack from its caller outside ``parallel/mesh.py``."""
    f = sys._getframe(1)
    while f is not None and _file_kind(f.f_code.co_filename)[0] \
            in _PLUMBING:
        f = f.f_back
    node = None
    g = f
    while g is not None:
        if _file_kind(g.f_code.co_filename)[2] \
                and g.f_code.co_name in ("apply", "apply_mesh"):
            node = getattr(g.f_locals.get("node"), "name", None)
            break
        g = g.f_back
    return op_path or node, _frame_line(_stack(f))


def record_collective(mode, kind, nbytes, group_size, axes, operands, where,
                      transpose=False):
    """A recording mode's ``collective`` method (``base.note_collective``'s
    hook): append the collective to ``mode.collectives``, with the labels
    of the argument storages among its ``operands`` (``mode.arg_keys``:
    storage key -> label; one label per argument, whichever position's
    copy or shard it reads) and ``where`` its ``(op_path, provenance)``."""
    params = []
    for t in operands:
        if not isinstance(t, torch.Tensor):
            continue
        try:
            lab = mode.arg_keys.get(t.untyped_storage()._cdata)
        except (RuntimeError, NotImplementedError):
            continue
        if lab is not None:
            lab = re.sub(r"\['replicas'\]\[\d+\]|\.parts\[\d+\]", "", lab)
            if lab not in params:
                params.append(lab)
    with mode.lock:
        mode.seq += 1
        mode.collectives.append({
            "kind": kind, "bytes": int(nbytes), "group_size": group_size,
            "axes": axes, "op_path": where[0], "provenance": where[1],
            "transpose": bool(transpose), "operand_params": tuple(params),
            "seq": mode.seq})


def _tb_line(e):
    """:func:`_frame_line` of an exception's traceback."""
    frames, tb = [], e.__traceback__
    while tb is not None:
        frames.append((tb.tb_frame.f_code, tb.tb_lineno))
        tb = tb.tb_next
    return _frame_line(reversed(frames))


_F64 = (torch.float64, torch.complex128)
#: the aten ops a convolution reaches a dispatch mode as: the
#: ``torch.nn.functional`` ones under ``inference_mode``, ``convolution``
#: and its backward under autograd, the cuDNN ones called by name
_CONV_OPS = frozenset((
    "conv1d", "conv2d", "conv3d", "conv_transpose1d", "conv_transpose2d",
    "conv_transpose3d", "convolution", "_convolution",
    "convolution_backward", "cudnn_convolution",
    "cudnn_convolution_transpose"))

#: cuDNN's workspace of each convolution this process ran on a card under
#: :func:`learn_workspaces`: :func:`_conv_key` -> bytes
CONV_WORKSPACES = {}


def _conv_key(func, args, kwargs):
    """What cuDNN picks a convolution's plan by: the op, each tensor
    argument's shape, dtype, device and memory format, the other
    arguments, and cuDNN's switches (TF32, deterministic, benchmark).
    The same for a real call and its shape-only twin."""
    def part(a):
        if isinstance(a, torch.Tensor):
            return (tuple(a.shape), str(a.dtype), str(a.device),
                    a.is_contiguous(),
                    a.dim() == 4
                    and a.is_contiguous(memory_format=torch.channels_last))
        return tuple(a) if isinstance(a, list) else a
    flags = torch.backends.cudnn
    return ((str(func),) + tuple(map(part, tree_leaves((args, kwargs))))
            + (flags.allow_tf32, flags.deterministic, flags.benchmark))


def _cuda_conv(func, args):
    """The device of a convolution op's first tensor argument when the op
    is a convolution on a card, else None."""
    if func.overloadpacket.__name__ not in _CONV_OPS:
        return None
    dev = next((t.device for t in tree_leaves(args)
                if isinstance(t, torch.Tensor)), None)
    return dev if dev is not None and dev.type == "cuda" else None


class _WorkspaceProbe(TorchDispatchMode):
    """Records what each real convolution on a card allocates beyond its
    outputs (cuDNN's workspace, and any copy the op makes of an argument),
    from the caching allocator's count of bytes allocated: a host counter,
    read with no wait for the device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dev = _cuda_conv(func, args)
        if dev is None or any(shape_only(t) for t in tree_leaves(args)
                              if isinstance(t, torch.Tensor)):
            return func(*args, **kwargs)
        stat = "allocated_bytes.all.allocated"
        before = torch.cuda.memory_stats(dev)[stat]
        out = func(*args, **kwargs)
        made = torch.cuda.memory_stats(dev)[stat] - before
        made -= sum(_storage(t)[2] for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))
        key = _conv_key(func, args, kwargs)
        ws = max(0, made)
        # another thread's allocation can only add to a reading
        CONV_WORKSPACES[key] = min(ws, CONV_WORKSPACES.get(key, ws))
        return out


@contextlib.contextmanager
def learn_workspaces():
    """Run the block's real convolutions on a card under a probe that
    records each one's cuDNN workspace in :data:`CONV_WORKSPACES`, which
    the dry run then prices for the same convolution. ``ServingEngine``
    warms its buckets up under it. cuDNN picks a convolution's algorithm,
    and so its workspace, when the convolution first runs; neither a
    shape-only run nor an environment cap can bound it on torch's cuDNN
    v8 path (``PERF.md``), so the price is what the card took."""
    with _WorkspaceProbe():
        yield


# ---------------------------------------------------------------------------
# kernel records (flopcheck's inventory, from the same dry run)
# ---------------------------------------------------------------------------

#: ops that launch nothing on the device: allocation and metadata (their
#: in-place forms included)
_META_OPS = frozenset((
    "empty", "empty_like", "empty_strided", "empty_permuted", "new_empty",
    "new_empty_strided", "resize_", "resize_as_", "set_", "detach_", "t_",
    "transpose_", "squeeze_", "unsqueeze_", "as_strided_", "swapdims_",
    "swapaxes_"))

#: reductions: one operation per element of the larger of their first
#: input and their output, as the JAX package's ``_estimate_flops`` counts
#: a reduce
_REDUCTIONS = frozenset((
    "sum", "mean", "prod", "amax", "amin", "max", "min", "aminmax",
    "argmax", "argmin", "var", "std", "var_mean", "std_mean", "norm",
    "linalg_vector_norm", "logsumexp", "any", "all", "count_nonzero",
    "nansum", "topk", "median", "mode"))

#: pure data motion (``is_layout``) when the dtype is kept: a copy between
#: layouts or devices; a cast computes
_LAYOUT_OPS = frozenset(("clone", "contiguous", "copy", "copy_", "_to_copy",
                         "to", "lift_fresh_copy"))

#: composite ops that reach a dispatch mode undecomposed under
#: ``inference_mode``, which ``torch.utils.flop_counter.flop_registry``
#: does not hold: priced by their decomposition's formula. A convolution's
#: value is whether it is transposed
_CONV_COMPOSITES = {"conv1d": False, "conv2d": False, "conv3d": False,
                    "conv_transpose1d": True, "conv_transpose2d": True,
                    "conv_transpose3d": True}
_MM_COMPOSITES = frozenset(("linear", "matmul"))

_CONV_FAMILY = frozenset(_CONV_COMPOSITES) | frozenset((
    "convolution", "_convolution", "cudnn_convolution",
    "convolution_overrideable", "_slow_conv2d_forward",
    "convolution_backward"))


def _op_flops(func, name, args, kwargs, out, outs):
    """``(FLOPs, matmul-like)`` of one aten op: the matmul, convolution and
    attention families by ``flop_registry`` (the composites above by their
    decomposition's formula), reductions by :data:`_REDUCTIONS`' rule,
    everything else one operation per output element."""
    from torch.utils.flop_counter import conv_flop_count, flop_registry
    fn = flop_registry.get(func.overloadpacket)
    if fn is not None:
        return float(fn(*args, **kwargs, out_val=out)), True
    if name in _CONV_COMPOSITES:
        return float(conv_flop_count(list(args[0].shape),
                                     list(args[1].shape),
                                     list(outs[0].shape),
                                     _CONV_COMPOSITES[name])), True
    if name in _MM_COMPOSITES:
        k = args[0].shape[-1] if args[0].dim() else 1
        return 2.0 * outs[0].numel() * k, True
    n_out = sum(t.numel() for t in outs)
    if name in _REDUCTIONS:
        first = next((a for a in tree_leaves(args)
                      if isinstance(a, torch.Tensor)), None)
        return float(max(n_out, 0 if first is None else first.numel())), \
            False
    return float(n_out), False


def _compute_type(name, dtype, mm):
    """The compute type whose peak bounds an op (a ``devspec.PEAK_BY_DTYPE``
    key): bf16 and f16 at the tensor-core rate; a float32 matmul or
    convolution at the TF32 rate while torch's TF32 switch of its family
    is on; everything else at FP32."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    if dtype == torch.float16:
        return "float16"
    if mm and dtype == torch.float32:
        tf32 = (torch.backends.cudnn.allow_tf32 if name in _CONV_FAMILY
                else torch.backends.cuda.matmul.allow_tf32)
        if tf32:
            return "tf32"
    return "float32"


def _viewed_bytes(t):
    return t.numel() * t.element_size()


def _kernel_record(func, args, kwargs, out, new):
    """One aten op as a kernel record (None for an op that launches
    nothing: allocation and metadata, and a view, whose outputs all alias
    an input and which writes nothing). ``new``: the keys of the output
    storages the op made. Bytes: each tensor argument's viewed bytes read
    and each output written (a new storage at its size as memcheck counts
    it, the allocator's granule on a card); an op that writes in place
    counts its written tensor once, as the JAX package's
    ``output_to_operand_aliasing`` rule does."""
    name = func.overloadpacket.__name__
    if name in _META_OPS:
        return None
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    mutable = func._schema.is_mutable
    if not outs or (not new and not mutable):
        return None
    ins = [t for t in tree_leaves((args, kwargs))
           if isinstance(t, torch.Tensor)]
    in_bytes = sum(_viewed_bytes(t) for t in ins)
    out_bytes = 0
    for t in outs:
        st, key, nb = _storage(t)
        out_bytes += nb if key in new else _viewed_bytes(t)
    nbytes = max(in_bytes, out_bytes) if mutable else in_bytes + out_bytes
    flops, mm = _op_flops(func, name, args, kwargs, out, outs)
    dtype = outs[0].dtype
    layout = (name in _LAYOUT_OPS and bool(ins)
              and ins[-1 if name.startswith("copy") else 0].dtype == dtype)
    return {"opcode": str(func.overloadpacket), "flops": flops,
            "bytes": int(nbytes), "is_layout": layout,
            "compute": _compute_type(name, dtype, mm), "passes": 1,
            "inputs": tuple((tuple(t.shape), str(t.dtype)) for t in ins)}


class _Tracker(TorchDispatchMode):
    """Counts the live bytes of every storage the ops of a dry run make,
    and the storages they write in place. Each convolution on a card adds
    its cuDNN workspace (:data:`CONV_WORKSPACES`) to the live bytes while
    it runs, or counts in ``unpriced`` when the process has not run it
    under :func:`learn_workspaces`.

    With ``lint`` (the static pass of :mod:`.tracecheck`) it also records
    ``events``: a value read back to the host (answered with a zero, so
    the run goes on), a copy from the card to the host, an op's float64
    or complex128 output, and every real tensor the program reads that is
    not an argument (faked for the op, so the run goes on).

    With ``kernels`` (:mod:`.flopcheck`'s inventory) it also records
    ``kernels``: each op that launches a kernel (:func:`_kernel_record`),
    and each launch a hand-written kernel's shape-only route stands for
    (:meth:`hand_kernel`), with its ``op_path`` and ``provenance``.

    It always records ``collectives`` (:mod:`.commscheck`'s inventory):
    each collective of ``parallel/mesh.py`` the run calls, and each
    transpose its backward runs (:func:`record_collective`), with the
    labels of the arguments it reads (``arg_keys``, set by the dry run)."""

    def __init__(self, mode=None, lint=False, kernels=False):
        super().__init__()
        self.lock = threading.Lock()
        self.live = {}
        self.cur = self.peak = 0
        self.written = set()
        self.records = []
        self.seq = 0
        self.mode = mode
        self.lint = lint
        self.events = []
        self.made_by = {}       # storage key -> (op_path, provenance)
        self.unpriced = 0
        self._consts = set()
        self.kernels = [] if kernels else None
        self.collectives = []
        self.arg_keys = {}

    collective = record_collective

    def hand_kernel(self, name, flops, nbytes, compute, passes, inputs):
        """``base.note_kernel``'s hook: record the launch a hand-written
        kernel's shape-only route stands for, priced by its own formula."""
        if self.kernels is None:
            return
        # from the kernel module's frame, past base.note_kernel
        node, prov = _where(3)
        self.seq += 1
        self.kernels.append({
            "opcode": name.split("[")[0], "flops": float(flops),
            "bytes": int(nbytes), "is_layout": False, "compute": compute,
            "passes": int(passes),
            "inputs": tuple((tuple(t.shape), str(t.dtype)) for t in inputs),
            "instruction": "%s#%d" % (name, self.seq), "op_path": node,
            "provenance": prov})

    def add(self, t, record=None):
        """Count ``t``'s storage live (once); returns its key when it is
        new, else None."""
        if not isinstance(t, torch.Tensor):
            return None
        try:
            st, key, nb = _storage(t)
        except (RuntimeError, NotImplementedError):
            return None     # a tensor without a storage (sparse)
        with self.lock:
            if key in self.live:
                return None
            self.live[key] = nb
            self.cur += nb
            self.peak = max(self.peak, self.cur)
        weakref.finalize(st, self._release, key)
        if record is not None and nb:
            record["bytes"] = nb
            self.records.append(record)
            self.made_by[key] = (record["op_path"], record["provenance"])
        return key

    def _release(self, key):
        with self.lock:
            self.cur -= self.live.pop(key, 0)

    def _read_back(self, func, args, kwargs, node, prov):
        """A copy from the card to the host, as a lint event."""
        if func is torch.ops.aten._to_copy.default:
            src, dst = args[0], kwargs.get("device")
        elif func is torch.ops.aten.copy_.default:
            src, dst = args[1], args[0].device
        else:
            return
        if (isinstance(src, torch.Tensor) and src.device.type == "cuda"
                and dst is not None and torch.device(dst).type == "cpu"):
            self.events.append(("host-sync", "a copy from the card to the "
                                "host (.cpu(), .to('cpu'))", node, prov))

    def _lift_consts(self, args, kwargs, node, prov):
        """``(args, kwargs)`` with each real tensor among them (a tensor
        the program reads but was not given) recorded once and faked."""
        from torch._subclasses.fake_tensor import is_fake
        leaves, spec = tree_flatten((args, kwargs))
        if not any(isinstance(t, torch.Tensor) and not t.is_meta
                   and not is_fake(t) for t in leaves):
            return args, kwargs
        out = []
        for t in leaves:
            if isinstance(t, torch.Tensor) and not t.is_meta \
                    and not is_fake(t):
                st = t.untyped_storage()
                if st._cdata not in self._consts:
                    self._consts.add(st._cdata)
                    self.events.append(("const", t, node, prov))
                t = self.mode.from_tensor(t, static_shapes=True)
            out.append(t)
        return tree_unflatten(out, spec)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        node, prov = _where()
        if self.lint:
            if func is torch.ops.aten._local_scalar_dense.default:
                self.events.append((
                    "host-sync", "a value read back to the host (.item(), "
                    "int(), float(), bool(), .tolist())", node, prov))
                dt = args[0].dtype
                return (False if dt == torch.bool else
                        0.0 if dt.is_floating_point else 0)
            args, kwargs = self._lift_consts(args, kwargs, node, prov)
            self._read_back(func, args, kwargs, node, prov)
        out = func(*args, **kwargs)
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                for t in tree_leaves(v):
                    if isinstance(t, torch.Tensor):
                        self.written.add(t.untyped_storage()._cdata)
        opcode = str(func.overloadpacket)
        f64 = None
        new = set()
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.seq += 1
                key = self.add(t, {"opcode": opcode, "op_path": node,
                                   "instruction": "%s#%d" % (opcode,
                                                             self.seq),
                                   "provenance": prov})
                if key is not None:
                    new.add(key)
                if self.lint and f64 is None and t.dtype in _F64:
                    f64 = t
        if self.kernels is not None:
            rec = _kernel_record(func, args, kwargs, out, new)
            if rec is not None:
                rec.update(instruction="%s#%d" % (opcode, self.seq),
                           op_path=node, provenance=prov)
                self.kernels.append(rec)
        if f64 is not None:
            self.events.append(("dtype-f64", (opcode, f64), node, prov))
        if _cuda_conv(func, args) is not None:
            ws = CONV_WORKSPACES.get(_conv_key(func, args, kwargs))
            if ws is None:
                self.unpriced += 1
            elif ws:
                with self.lock:
                    self.peak = max(self.peak, self.cur + ws)
                self.records.append({
                    "bytes": ws, "opcode": "workspace", "op_path": node,
                    "instruction": "%s#%d workspace" % (opcode, self.seq),
                    "provenance": prov})
        return out


def _host_read_error(name, e):
    """The error of a priced program that read a value back to the host:
    names the line (:func:`_tb_line`) that read it."""
    prov = _tb_line(e)
    return MXNetError(
        "memcheck: %s reads a value back to the host%s (%s), which a "
        "shape-only run cannot price" % (name, " at " + prov if prov else "",
                                         type(e).__name__))


class _DryRun(object):
    """What :func:`_dry_run` saw: the ``report``, the ``tracker`` (its
    lint events), the argument leaves ``(label, tensor)``, where each
    replaced donated leaf's new storage was made (``{label: (op_path,
    provenance)}``), and the error that ended a lint run early (None when
    the program ran to its end)."""

    __slots__ = ("report", "tracker", "arg_leaves", "replaced_by", "stopped",
                 "device")

    def __init__(self, report, tracker, arg_leaves, replaced_by, stopped,
                 device):
        self.report = report
        self.tracker = tracker
        self.arg_leaves = arg_leaves
        self.replaced_by = replaced_by
        self.stopped = stopped
        #: the program's device (its arguments', else its outputs')
        self.device = device


def analyze(fn, args=(), kwargs=None, donate_argnums=(), name=None, top=8):
    """Run ``fn(*args, **kwargs)`` once shape-only and return its
    :class:`MemoryReport` (see the module's note). Real tensors among the
    arguments are converted to fake ones and fake ones pass as they are,
    so nothing is allocated and no kernel launches. The leaves of the
    positional arguments in ``donate_argnums`` are the donated state."""
    return _dry_run(fn, args, kwargs, donate_argnums, name, top).report


def _dry_run(fn, args=(), kwargs=None, donate_argnums=(), name=None, top=8,
             lint=False, kernels=False):
    """:func:`analyze`'s run, returning a :class:`_DryRun`. With ``lint``
    the tracker records the static pass's events, and a program whose op
    has an output shape that depends on the data (``nonzero``, a boolean
    mask) or that reads a tensor's data (``.numpy()``) ends the run there
    (``stopped``) instead of raising. With ``kernels`` it records the
    kernel records ``flopcheck`` prices (``tracker.kernels``)."""
    from torch._subclasses.fake_tensor import (
        DataDependentOutputException, DynamicOutputShapeException)
    kwargs = dict(kwargs or {})
    if name is None:
        name = getattr(fn, "__name__", None) or repr(fn)
    args = tuple(args)
    real = _leaves(args) + _leaves(kwargs)
    mode = _fake_mode_of(real) or new_fake_mode()

    with fake_mode(mode):
        fargs = tuple(fake_tree(a, mode) for a in args)
        fkwargs = fake_tree(kwargs, mode)
    tracker = _Tracker(mode, lint=lint, kernels=kernels)
    arg_leaves = []
    for i, a in enumerate(fargs):
        arg_leaves += [(lab, t, i) for lab, t in _leaves(a, "args[%d]" % i)]
    arg_leaves += [(lab, t, None) for lab, t in _leaves(fkwargs, "kwargs")]
    arg_bytes, donated = {}, []
    for lab, t, i in arg_leaves:
        _, key, nb = _storage(t)
        tracker.arg_keys.setdefault(key, lab)
        if key not in arg_bytes:
            arg_bytes[key] = nb
            tracker.add(t, {"opcode": "parameter", "op_path": lab,
                            "instruction": lab, "provenance": None})
        if i in (donate_argnums or ()):
            donated.append((lab, nb, key, lab[len("args[%d]" % i):]))
    stopped = out = None
    try:
        with fake_mode(mode), tracker:
            out = fn(*fargs, **fkwargs)
    except (DataDependentOutputException,
            DynamicOutputShapeException) as e:
        if not lint:
            raise _host_read_error(name, e) from e
        stopped = e
    except RuntimeError as e:
        # FakeTensor refuses a data pointer (``.numpy()``) this way
        if not (lint and "tensor subclasses" in str(e)):
            raise
        stopped = e
    out_leaves = _leaves(out)
    out_bytes, out_at = {}, {}
    for lab, t in out_leaves:
        _, key, nb = _storage(t)
        out_bytes[key] = nb
        out_at.setdefault(lab, key)
        out_at.setdefault(re.sub(r"^\[\d+\]", "", lab), key)
    replaced = {key for _, _, key, path in donated
                if key not in tracker.written
                and out_at.get(path, key) != key}
    new_out = sum(nb for key, nb in out_bytes.items() if key not in arg_bytes)
    alias = sum(arg_bytes[key] for key in
                {key for _, _, key, _ in donated} - replaced)
    argument = sum(arg_bytes.values())
    temp = max(0, tracker.peak - (argument + new_out))
    records = sorted(tracker.records, key=lambda r: r["bytes"],
                     reverse=True)[:top]
    dev = next((t.device for _, t, _ in arg_leaves), None) or next(
        (t.device for _, t in out_leaves), torch.device("cpu"))
    report = MemoryReport(
        name, _platform(dev), argument_bytes=argument,
        output_bytes=new_out + alias, temp_bytes=temp, alias_bytes=alias,
        top_buffers=[{k: r[k] for k in ("bytes", "opcode", "op_path",
                                        "instruction", "provenance")}
                     for r in records],
        donated=[(lab, nb) for lab, nb, _, _ in donated],
        unaliased_donated=[(lab, nb) for lab, nb, key, _ in donated
                           if key in replaced],
        unpriced_workspaces=tracker.unpriced, device=dev)
    replaced_by = {lab: tracker.made_by.get(out_at.get(path), (None, None))
                   for lab, _, key, path in donated if key in replaced}
    return _DryRun(report, tracker, [(lab, t) for lab, t, _ in arg_leaves],
                   replaced_by, stopped, dev)


# ---------------------------------------------------------------------------
# lints
# ---------------------------------------------------------------------------

def _top_attr(report, skip_params=False):
    """(op_path, provenance) of the report's largest attributable buffer —
    the thing a budget/temp finding should point at."""
    for b in report.top_buffers:
        if skip_params and b["opcode"] == "parameter":
            continue
        return b["op_path"] or b["instruction"], b["provenance"]
    return None, None


def lint_report(report, budget=None, temp_mult=None, waste_floor=None):
    """Per-program memory lints over one :class:`MemoryReport`:
    ``hbm-budget``, ``donation-waste``, ``temp-blowup``. The default budget
    is that of the device the report priced (``report.device``). Returns
    findings with suppressions applied."""
    findings = []
    budget = budget_bytes(report.device) if budget is None else int(budget)
    temp_mult = temp_multiple() if temp_mult is None else float(temp_mult)
    waste_floor = _WASTE_FLOOR if waste_floor is None else int(waste_floor)
    name = report.program

    if report.peak_bytes > budget:
        op_path, prov = _top_attr(report)
        findings.append(Finding(
            "hbm-budget", name,
            "peak HBM %s exceeds the budget %s (args %s + out %s + temp %s"
            " - alias %s; MXTPU_MEMCHECK_BUDGET). Largest buffers:\n  %s"
            % (_fmt_bytes(report.peak_bytes), _fmt_bytes(budget),
               _fmt_bytes(report.argument_bytes),
               _fmt_bytes(report.output_bytes),
               _fmt_bytes(report.temp_bytes),
               _fmt_bytes(report.alias_bytes),
               "\n  ".join(report.breakdown())),
            op_path=op_path, provenance=prov))

    for label, nbytes in report.unaliased_donated:
        if nbytes < waste_floor:
            continue
        findings.append(Finding(
            "donation-waste", name,
            "donated argument %s (%s) was replaced, not updated in place "
            "— the call returned a new buffer in its place, so the working "
            "set carries both the old and the new one (alias savings "
            "realized: %s of %s donated)"
            % (label, _fmt_bytes(nbytes), _fmt_bytes(report.alias_bytes),
               _fmt_bytes(report.donated_bytes)),
            op_path=label))

    estimate = report.argument_bytes + report.output_bytes
    if estimate > 0 and report.temp_bytes > temp_mult * estimate:
        op_path, prov = _top_attr(report, skip_params=True)
        findings.append(Finding(
            "temp-blowup", name,
            "temp buffers %s are %.1fx the param+activation estimate %s "
            "(threshold %.1fx, MXTPU_MEMCHECK_TEMP_MULT) — a "
            "rematerialization/fusion regression. Largest buffers:\n  %s"
            % (_fmt_bytes(report.temp_bytes),
               report.temp_bytes / estimate, _fmt_bytes(estimate),
               temp_mult, "\n  ".join(report.breakdown())),
            op_path=op_path, provenance=prov))

    for f in findings:
        f.suppressed = _is_suppressed(f)
    return findings


def resident_bytes(reports):
    """Co-resident footprint of a program set: arguments and outputs are
    shared state (the same params and state feed every variant: the max),
    and every program's temps add up (the JAX package's accounting)."""
    reports = list(reports)
    if not reports:
        return 0
    return (max(r.argument_bytes + r.output_bytes - r.alias_bytes
                for r in reports)
            + sum(r.temp_bytes for r in reports))


def lint_resident_set(reports, set_name, budget=None):
    """``resident-set``: the summed footprint of co-resident programs (all
    serving buckets of one engine; a train step's four programs) against
    the budget (default: that of the device the first report priced)."""
    reports = list(reports)
    if budget is None:
        budget = budget_bytes(reports[0].device) if reports else 0
    budget = int(budget)
    total = resident_bytes(reports)
    findings = []
    if reports and total > budget:
        biggest = max(reports, key=lambda r: r.temp_bytes)
        members = ", ".join(
            "%s (temp %s)" % (r.program, _fmt_bytes(r.temp_bytes))
            for r in reports)
        findings.append(Finding(
            "resident-set", set_name,
            "co-resident program set needs %s (> budget %s): "
            "max(args+out-alias) + sum(temps) over [%s]. Largest temp "
            "holder: %s\n  %s"
            % (_fmt_bytes(total), _fmt_bytes(budget), members,
               biggest.program, "\n  ".join(biggest.breakdown())),
            op_path=biggest.program))
    for f in findings:
        f.suppressed = _is_suppressed(f)
    return findings


def check_program(fn, args=(), kwargs=None, donate_argnums=(), name=None,
                  budget=None, temp_mult=None):
    """Analyze + lint ONE program; returns ``(findings, report)``."""
    report = analyze(fn, args, kwargs, donate_argnums=donate_argnums,
                     name=name)
    return lint_report(report, budget=budget, temp_mult=temp_mult), report


def check_registered(match=None, budget=None, temp_mult=None,
                     resident_name=None):
    """Memory-audit the live programs of tracecheck's registry whose name
    contains ``match`` (a string, or a tuple: contains any): per-program
    lints plus one ``resident-set`` lint over the whole matched set (a
    ``BucketingModule``'s bucket steps, an engine's buckets: they are all
    kept, so their co-resident footprint is what the budget must cover).
    An explicitly empty tuple audits nothing. Returns ``(findings,
    reports)``."""
    from .tracecheck import registered_programs
    if match is None:
        matches = None
    else:
        matches = (match,) if isinstance(match, str) else tuple(match)
        if not matches:
            # a BucketingModule that never dispatched must not sweep (and
            # attribute a resident set over) unrelated programs
            return [], {}
    findings = []
    reports = {}
    for rec in registered_programs():
        if matches is not None and not any(m in rec.name for m in matches):
            continue
        fn = rec.fn_ref()
        if fn is None:
            continue
        fs, rep = check_program(fn, rec.arg_structs,
                                donate_argnums=rec.donate_argnums,
                                name=rec.name, budget=budget,
                                temp_mult=temp_mult)
        findings += fs
        reports[rec.name] = rep
    findings += lint_resident_set(
        reports.values(), "%s/resident-set" % (resident_name or "registered"),
        budget=budget)
    return findings, reports


# ---------------------------------------------------------------------------
# TrainStep / zoo auditing
# ---------------------------------------------------------------------------

def check_train_step(ts, data_shapes, label_shapes, k=2, guard=True,
                     name=None, budget=None, temp_mult=None):
    """Memory-audit a :class:`~mxnet_tpu_torch.train_step.TrainStep`'s
    program set (``tracecheck.train_step_programs``: ``step``, ``run_steps``
    at ``k``, and their guarded variants) plus the ``resident-set`` lint
    over the set. No step runs on the device. Returns ``(findings,
    reports)``, ``reports`` mapping program name ->
    :class:`MemoryReport`."""
    from .tracecheck import train_step_programs
    name = name or "TrainStep(%s)" % ts.symbol.name
    findings = []
    reports = {}
    if budget is None:
        budget = budget_bytes(ts.device)
    for pname, fn, pargs in train_step_programs(
            ts, data_shapes, label_shapes, k=k, guard=guard, name=name):
        fs, rep = check_program(fn, pargs, donate_argnums=(0,),
                                name=pname, budget=budget,
                                temp_mult=temp_mult)
        findings += fs
        reports[pname] = rep
    findings += lint_resident_set(reports.values(),
                                  "%s/resident-set" % name, budget=budget)
    return findings, reports


def check_zoo(names=None, k=2, guard=True, budget=None, temp_mult=None,
              log=None, device=None):
    """Memory-audit the model zoo's step programs (``tracecheck.ZOO``) on
    ``device`` (default ``cuda:0``); returns ``(findings, reports)``."""
    from .tracecheck import zoo_train_step
    names = list(names) if names else sorted(ZOO)
    findings = []
    reports = {}
    for mname in names:
        if mname not in ZOO:
            raise MXNetError("memcheck: unknown zoo model %r (have %s)"
                             % (mname, ", ".join(sorted(ZOO))))
        if log:
            log("memcheck: analyzing %s ..." % mname)
        ts, data_shapes, label_shapes = zoo_train_step(mname, device=device)
        fs, reps = check_train_step(
            ts, data_shapes, label_shapes,
            k=k, guard=guard, name=mname, budget=budget,
            temp_mult=temp_mult)
        findings += fs
        reports.update(reps)
    return findings, reports


# ---------------------------------------------------------------------------
# the baseline regression gate
# ---------------------------------------------------------------------------

#: metrics the baseline pins per program
_BASELINE_METRICS = ("peak_bytes", "temp_bytes")

#: absolute slack added to the tolerance band — the zoo programs are tiny
#: on purpose, and a 10% band around a 40 KiB program is measurement noise
_BASELINE_SLACK = 64 << 10


def _reports_platform(reports):
    plats = sorted({r.platform for r in reports.values()})
    return plats[0] if len(plats) == 1 else ",".join(plats)


def write_baseline(reports, path, tol=None):
    """Write the baseline: per-program peak/temp bytes, keyed by the
    reports' platform (a CPU baseline must not gate a card's run)."""
    from .model import atomic_write_bytes
    data = {
        "platform": _reports_platform(reports),
        "tolerance": tolerance() if tol is None else float(tol),
        "programs": {
            name: {m: getattr(rep, m) for m in _BASELINE_METRICS}
            for name, rep in sorted(reports.items())},
    }
    atomic_write_bytes(path, (json.dumps(data, indent=2, sort_keys=True)
                              + "\n").encode())
    return data


def compare_baseline(reports, baseline, tol=None):
    """The regression gate: compare every report against the baseline.
    Returns ``(failures, notes)``: ``failures`` are gate-red strings (a
    program grew past the tolerance band, or is missing from the
    baseline), ``notes`` informational (a program shrank well below its
    baseline; stale entries). A baseline of another platform gives one
    note and no failures."""
    if isinstance(baseline, str):
        with open(baseline) as f:
            baseline = json.load(f)
    if tol is None:
        # explicit arg > MXTPU_MEMCHECK_TOL > the baseline's band > 0.1
        tol = env_float("MXTPU_MEMCHECK_TOL",
                        float(baseline.get("tolerance", 0.1)))
    else:
        tol = float(tol)
    platform = _reports_platform(reports)
    failures, notes = [], []
    if baseline.get("platform") != platform:
        notes.append(
            "memcheck baseline was written on platform %r but this run is "
            "%r — skipping the regression gate (re-run --write-baseline on "
            "this platform to arm it)"
            % (baseline.get("platform"), platform))
        return failures, notes
    base_progs = dict(baseline.get("programs") or {})
    for name, rep in sorted(reports.items()):
        base = base_progs.pop(name, None)
        if base is None:
            failures.append(
                "%s: not in the baseline — a new program must be added "
                "deliberately (run `python -m mxnet_tpu_torch.memcheck "
                "--zoo --write-baseline FILE` and commit the diff)" % name)
            continue
        for metric in _BASELINE_METRICS:
            b = int(base.get(metric, 0))
            cur = int(getattr(rep, metric))
            allowed = b + max(int(b * tol), _BASELINE_SLACK)
            if cur > allowed:
                failures.append(
                    "%s: %s grew %s -> %s (+%.1f%%, tolerance %.0f%% + "
                    "%s slack, MXTPU_MEMCHECK_TOL). Largest buffers:\n  %s"
                    % (name, metric, _fmt_bytes(b), _fmt_bytes(cur),
                       100.0 * (cur - b) / max(1, b), 100.0 * tol,
                       _fmt_bytes(_BASELINE_SLACK),
                       "\n  ".join(rep.breakdown())))
            elif b > _BASELINE_SLACK and cur < b - max(int(b * tol),
                                                       _BASELINE_SLACK):
                notes.append(
                    "%s: %s shrank %s -> %s — refresh the baseline to lock "
                    "the win in"
                    % (name, metric, _fmt_bytes(b), _fmt_bytes(cur)))
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
    out.write("%-*s  %10s %10s %10s %10s %10s\n"
              % (w, "program", "peak", "args", "out", "temp", "alias"))
    for name in sorted(reports):
        r = reports[name]
        out.write("%-*s  %10s %10s %10s %10s %10s\n"
                  % (w, name, _fmt_bytes(r.peak_bytes),
                     _fmt_bytes(r.argument_bytes),
                     _fmt_bytes(r.output_bytes), _fmt_bytes(r.temp_bytes),
                     _fmt_bytes(r.alias_bytes)))


def main(argv=None):
    import argparse
    from . import tracecheck as _tc
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.memcheck",
        description="Static memory analyzer for the port's step programs, "
                    "priced by a shape-only dry run: peak/argument/temp/"
                    "alias accounting, donation-waste and budget lints, "
                    "and the baseline regression gate.")
    p.add_argument("--zoo", action="store_true",
                   help="analyze every shipped model's step/scan programs")
    p.add_argument("--models", default=None,
                   help="comma-separated zoo subset (implies --zoo)")
    p.add_argument("--k", type=int, default=2,
                   help="scan depth for the K-step programs (default 2)")
    p.add_argument("--no-guard", action="store_true",
                   help="skip the guarded program variants")
    p.add_argument("--budget", default=None,
                   help="peak budget in bytes (K/M/G/T suffixes ok; "
                        "default MXTPU_MEMCHECK_BUDGET or the device)")
    p.add_argument("--temp-mult", type=float, default=None,
                   help="temp-blowup multiple (default "
                        "MXTPU_MEMCHECK_TEMP_MULT or 4.0)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="compare against a baseline (the regression gate); "
                        "exit non-zero on growth past tolerance")
    p.add_argument("--write-baseline", default=None, metavar="FILE",
                   help="write the per-program baseline JSON and exit 0")
    p.add_argument("--tol", type=float, default=None,
                   help="baseline tolerance band (default "
                        "MXTPU_MEMCHECK_TOL, the baseline's own, or 0.1)")
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
    if not (args.zoo or args.models):
        p.error("nothing to check: pass --zoo or --models")
    names = ([s.strip() for s in args.models.split(",") if s.strip()]
             if args.models else None)
    log = (lambda m: None) if (args.quiet or args.json) \
        else (lambda m: print(m, file=sys.stderr))
    budget = (None if args.budget is None
              else _parse_bytes(args.budget, "--budget"))
    findings, reports = check_zoo(names=names, k=args.k,
                                  guard=not args.no_guard, budget=budget,
                                  temp_mult=args.temp_mult, log=log,
                                  device=args.device)
    if args.write_baseline:
        write_baseline(reports, args.write_baseline, tol=args.tol)
        log("memcheck: baseline written to %s (%d programs)"
            % (args.write_baseline, len(reports)))
        return 0
    failures, notes = [], []
    if args.baseline:
        failures, notes = compare_baseline(reports, args.baseline,
                                           tol=args.tol)
    bad = unsuppressed(findings)
    if args.json:
        print(json.dumps({
            "platform": _reports_platform(reports),
            "budget_bytes": (budget if budget is not None
                             else budget_bytes(args.device)),
            "programs": {n: r.as_dict() for n, r in sorted(reports.items())},
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
        print("memcheck: %d finding(s) (%d suppressed), %d baseline "
              "regression(s) over %d program(s)"
              % (len(findings), len(findings) - len(bad), len(failures),
                 len(reports)))
    return 1 if (bad or failures) else 0


if __name__ == "__main__":
    sys.exit(main())
