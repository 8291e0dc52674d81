"""Shape-bucketed serving engine over a saved checkpoint.

Counterpart of ``mxnet_tpu/serving/engine.py:ServingEngine``. The engine
loads a symbol and its parameters once, moves the parameters to its device
once, and serves any request size: ``infer`` pads a batch up to the
smallest covering bucket, chunks requests above the largest bucket, and
slices the pad rows off again. Inference is per-example independent, so
padding never leaks into real rows.

The JAX package compiles one program per bucket ahead of time; here the
forward runs eagerly, under ``torch.inference_mode()``, on the engine's
device, and the counterpart of that compile is a warm-up: at load every
bucket runs once on zeros, so the kernels' build, cuDNN's choice of plan
and the allocator's pools are settled before the first request. The
warm-up counts nothing in ``health``. Entry points run on the card:
``device=None`` means ``cuda:0``, and without CUDA the engine raises
instead of falling back to the CPU (pass ``device="cpu"`` to serve on the
CPU, as the tests do).

Float32 convolutions run in full FP32 (``ops.nn.CONV_TF32`` is False).

``quantize=`` (or ``MXTPU_SERVE_QUANT``) stores the weights int8 or bf16
on the device (:mod:`.quantize`); each dispatch widens them to f32
temporaries, and aux states stay f32. ``update_params`` hot-reloads a
checkpoint under the live engine: the new arrays land on the device, then
one assignment swaps the ``(params, aux)`` pair that ``infer`` reads once,
so a concurrent request serves the old set or the new one, never a mix.
Bucket sets resolve as ``buckets=``, then ``MXTPU_SERVE_BUCKETS``, then the
tuning DB (:mod:`mxnet_tpu_torch.autotune`, matched on the engine's device
kind), then (1, 8, 32).

Serialized executables: PyTorch cannot serialize a forward that walks the
graph eagerly, nor the CUDA state (cuDNN plans, built kernels) that the
warm-up settles. So :meth:`ServingEngine.export_compiled` raises
``MXNetError`` (the JAX method's contract for a backend that cannot
serialize), and ``executables=path`` does what the JAX engine does with a
file it cannot import: it logs a warning naming the file and the reason,
and warms up afresh.

``contexts=`` makes a model-parallel engine: one replica over a 'model'
mesh of positions. ``contexts=N`` (an int above 1) puts N positions on the
engine's ``device``; a list puts one position on each entry's torch device
(``[mt.cpu(i) for i in range(4)]`` gives four on the host CPU,
``[mt.gpu(0)] * 2`` two on ``cuda:0``); 0, 1 or a one-entry list builds no
mesh. Positions may share a device, where the JAX package asks for a chip
each: one card or the host CPU then holds every shard, and its times are
that device's own cost, not a scaling figure. Each parameter is laid out
by the placement rule (``parallel.placement.model_spec``: the first
dimension the positions divide, the output dimension of an ``(out, in)``
weight), an int8 leaf's scale along its payload's split of axis 0; aux
states and inputs are replicated, one copy a device. The forward is the
executor's mesh walk with a hook that re-lays every node's outputs
replicated: each ``FullyConnected`` and ``Convolution`` computes its
output slice per position over the whole contraction and the slices are
gathered (Megatron's column-parallel layer plus a gather), so no
reduction spans positions; an op of replicated inputs runs once a device
(MultiBoxDetection, and its NMS kernel, once a dispatch on one card).
:data:`~mxnet_tpu_torch.parallel.mesh.COUNTERS` counts the gathers.

:meth:`ServingEngine.memory_report` prices every bucket's forward by
:mod:`mxnet_tpu_torch.memcheck`'s shape-only dry run over fake copies of
the parameters, aux states and a bucket of inputs (the live ones are never
touched, nothing is allocated on the device), under the JAX package's
program names (``<engine>/bucket[b=N]``). With ``MXTPU_MEMCHECK=warn`` or
``error`` (``engine.memcheck_mode``) the engine audits its bucket set at
load, before the warm-up runs any bucket, so an over-budget deploy raises
before it touches the card's memory beyond its parameters.
:meth:`ServingEngine.priced` prices the engine a set of arguments would
build without building it (the autotuner's pruner).

Each bucket's forward is registered with ``tracecheck`` as
``<engine>/bucket[b=N]`` after the warm-up, and :meth:`ServingEngine.check`
audits the engine: ``tracecheck``'s static lints over every bucket and,
with ``memory=True``, the memory lints over :meth:`memory_report` plus a
``resident-set`` lint over the bucket set, and with ``comms=True`` the
communication lints over :meth:`ServingEngine.comms_report`: each bucket's
collective inventory from :mod:`mxnet_tpu_torch.commscheck`'s view of the
same kind of dry run (a sharded engine's gathers along 'model', as they
would run over separate cards; none on one device). With
``MXTPU_COMMSCHECK=warn`` or ``error`` the engine audits those at load
too, after the memory audit (the ``comms-bound`` floor is not applied:
model-parallel serving trades efficiency for fitting the model).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..base import MXNetError, env_str, shape_only
from ..context import resolve_device
from ..executor import _build_graph_runner
from ..ops.nn import conv_precision
from ..parallel import mesh as _mesh
from ..predictor import (_strip_loss_heads, load_symbol, load_param_dict,
                         pick_partial_outputs, check_missing_params)
from ..tracecheck import unique_name
from . import quantize as _quant
from .health import ServingHealth, SERVING_HEALTH

#: default batch-size buckets (env: MXTPU_SERVE_BUCKETS="1,8,32")
_DEFAULT_BUCKETS = (1, 8, 32)


def default_buckets():
    spec = env_str("MXTPU_SERVE_BUCKETS", "")
    if not spec:
        return _DEFAULT_BUCKETS
    try:
        buckets = tuple(sorted({int(s) for s in spec.split(",") if s.strip()}))
    except ValueError:
        raise MXNetError("MXTPU_SERVE_BUCKETS must be a comma-separated "
                         "list of batch sizes, got %r" % spec)
    if not buckets or buckets[0] < 1:
        raise MXNetError("MXTPU_SERVE_BUCKETS needs positive batch sizes, "
                         "got %r" % spec)
    return buckets


def _host_array(v):
    """NDArray, tensor or array-like -> tensor (no device move yet)."""
    data = getattr(v, "data", v)
    if isinstance(data, torch.Tensor):
        return data
    if hasattr(v, "asnumpy"):            # an NDArray of another package
        data = v.asnumpy()
    return torch.from_numpy(np.array(data))


def _model_mesh(contexts, device, who):
    """``(mesh, device)`` of ``contexts=``: a one-axis 'model' mesh of
    positions (None below two) and the device that takes the inputs and
    gives the outputs (the first position's). An int N puts N positions on
    ``device`` (default ``cuda:0``); a list puts one on each entry's torch
    device, and ``device``, where given, must be the first's."""
    if isinstance(contexts, int) or not contexts:
        dev = resolve_device(device, who)
        if not contexts or contexts <= 1:
            return None, dev
        return _mesh.model_parallel_mesh(contexts, [dev] * contexts), dev
    devs = [resolve_device(c, who) for c in contexts]
    if device is not None and resolve_device(device, who) != devs[0]:
        raise MXNetError("%s: device=%s is not the first of contexts %s"
                         % (who, device, list(contexts)))
    if len(devs) == 1:
        return None, devs[0]
    return _mesh.make_mesh({_mesh.AXIS_MODEL: len(devs)}, devs), devs[0]


def _sync(mesh, device):
    """Wait for every card a (possibly sharded) engine or loop uses."""
    for d in ({device} if mesh is None else set(mesh.replica_devices())):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _replicated(node, outs):
    """The sharded engine's ``node_constraint``: every output re-laid
    whole on every position (gathered where an op left it split)."""
    return [_mesh.reshard(o, ()) for o in outs]


def _comms_reports(obj, programs):
    """``comms_report`` of :class:`ServingEngine` and ``DecodeLoop``:
    ``{name: CommsReport}`` of each ``(name, fn, args)`` program, by one
    shape-only dry run each. A program whose dry run fails is reported
    without evidence (``hlo_unavailable``), never as collective-free."""
    from .. import commscheck as _cc
    reports = {}
    for name, fn, args in programs:
        try:
            reports[name] = _cc.analyze(fn, args, name=name, mesh=obj._mesh,
                                        device=obj.device)
        except Exception as e:  # noqa: BLE001 -- reported as no evidence
            logging.warning("%s: the dry run of %s failed (%r) — its "
                            "collective inventory is no evidence",
                            type(obj).__name__, name, e)
            reports[name] = _cc._blind(name, obj.device, obj._mesh)
    return reports


def _check(obj, const_bytes, memory, budget, comms, min_eff=0.0):
    """``check`` of :class:`ServingEngine` and ``DecodeLoop``: the static
    lints over the programs ``obj`` registered (``<name>/...``); with
    ``memory``, the memory lints over ``obj.memory_report()`` and one
    ``resident-set`` lint over them all (they are all kept, so their
    footprints co-reside); with ``comms``, the communication lints over
    ``obj.comms_report()`` at the ``min_eff`` floor (a program whose dry
    run failed raises: no evidence is not a clean audit)."""
    from .. import tracecheck as _tc
    findings = _tc.check_registered(const_bytes=const_bytes,
                                    match=obj.name + "/")
    if memory:
        from .. import memcheck as _mc
        reports = obj.memory_report()
        for rep in reports.values():
            findings += _mc.lint_report(rep, budget=budget)
        findings += _mc.lint_resident_set(
            reports.values(), "%s/resident-set" % obj.name, budget=budget)
    if comms:
        from .. import commscheck as _cc
        for rep in obj.comms_report().values():
            if rep.hlo_unavailable:
                raise MXNetError(
                    "%s.check(comms=True): the dry run of %s failed — its "
                    "collectives could not be audited"
                    % (type(obj).__name__, rep.program))
            findings += _cc.lint_report(rep, min_eff=min_eff)
    return findings


def _audit_load_comms(obj, who):
    """The ``MXTPU_COMMSCHECK`` load-time hook of :class:`ServingEngine`
    and ``DecodeLoop``: the communication lints over ``obj.comms_report()``
    (a sharded program set's collectives; none on one device), logged
    under ``warn``, raised under ``error``, a failed dry run included (no
    evidence is not a clean audit). The ``comms-bound`` floor is not
    applied (``min_eff=0``): it gates training scale-out, while a
    model-parallel serving program trades efficiency for fitting the model
    at all. The knob resolves before the audit: a malformed one raises."""
    from ..engine import commscheck_mode
    mode = commscheck_mode()
    if mode == "off":
        return
    from .. import commscheck as _cc
    repl = _cc.repl_bytes()
    bad = []
    for rep in obj.comms_report().values():
        if rep.hlo_unavailable:
            bad.append("%s: the dry run failed — nothing was audited"
                       % rep.program)
            continue
        bad += [f.format() for f in _cc.lint_report(rep, repl_threshold=repl,
                                                    min_eff=0.0)
                if not f.suppressed]
    if not bad:
        return
    msg = ("%s(%s): comms audit found %d problem(s) at load "
           "(MXTPU_COMMSCHECK=%s):\n%s"
           % (who, obj.name, len(bad), mode, "\n".join(bad)))
    if mode == "error":
        raise MXNetError(msg)
    logging.warning(msg)


def _dry_run():
    """Whether a ``FakeTensorMode`` is active (the constructor runs inside
    :meth:`ServingEngine.priced` or ``DecodeLoop.priced``): an engine or
    loop built there holds fake tensors, and skips its warm-up, its load
    audit and its thread."""
    return shape_only(torch.empty(0))


def _audit_load_memory(obj, who):
    """The ``MXTPU_MEMCHECK`` load-time hook of :class:`ServingEngine` and
    ``DecodeLoop``: run the memory lints over the program set
    (``obj.memory_report()``, a shape-only dry run) and warn, or raise
    under ``error``, on any unsuppressed finding. The budget and the temp
    multiple are read before the analyzer's guard: a malformed knob is an
    operator error that propagates; an analyzer failure is logged and the
    audit skipped, never the deploy."""
    from ..engine import memcheck_mode
    mode = memcheck_mode()
    if mode == "off":
        return
    from .. import memcheck as _mc
    budget = _mc.budget_bytes(obj.device)
    temp_mult = _mc.temp_multiple()
    try:
        reports = obj.memory_report()
        findings = []
        for rep in reports.values():
            findings += _mc.lint_report(rep, budget=budget,
                                        temp_mult=temp_mult)
        findings += _mc.lint_resident_set(
            reports.values(), "%s/resident-set" % obj.name, budget=budget)
        bad = _mc.unsuppressed(findings)
    except Exception as e:
        logging.warning("%s(%s): memory audit could not run (%r) — "
                        "skipped", who, obj.name, e)
        return
    if not bad:
        return
    msg = ("%s(%s): memory audit found %d problem(s) at load "
           "(MXTPU_MEMCHECK=%s):\n%s"
           % (who, obj.name, len(bad), mode,
              "\n".join(f.format() for f in bad)))
    if mode == "error":
        raise MXNetError(msg)
    logging.warning(msg)


class ServingEngine(object):
    """Shape-bucketed forward over a saved checkpoint.

    ``input_shapes`` maps input name -> PER-EXAMPLE shape (no batch dim),
    e.g. ``{"data": (3, 300, 300)}``; ``buckets`` is the set of batch sizes
    served (explicit ``buckets=``, else ``MXTPU_SERVE_BUCKETS``, else the
    tuning DB, else (1, 8, 32)); each runs once at load. ``infer`` accepts
    any request size: n <= max(buckets) dispatches one padded bucket,
    larger requests are chunked over the largest bucket. ``device``: where
    the engine runs (default ``cuda:0``). ``quantize``: ``"none"``,
    ``"bf16"`` or ``"int8"`` weight storage (default
    ``MXTPU_SERVE_QUANT``, else ``"none"``). ``executables``: accepted for
    the JAX package's signature; the file cannot be imported here, so the
    engine warns and warms up afresh. ``contexts``: a model-parallel
    engine (see the module's note).
    """

    def __init__(self, symbol_json_or_file, param_file_or_dict, input_shapes,
                 buckets=None, output_names=None, allow_missing=False,
                 input_dtypes=None, executables=None, health=None,
                 name=None, contexts=None, quantize=None, device=None):
        self.quant_mode = _quant.resolve_mode(
            quantize if quantize is not None
            else env_str("MXTPU_SERVE_QUANT", "none"))
        #: the 'model' mesh one replica spans (None: one device)
        self._mesh, self.device = _model_mesh(contexts, device,
                                              "ServingEngine")
        self._symbol = _strip_loss_heads(load_symbol(symbol_json_or_file))
        if output_names:
            self._symbol = pick_partial_outputs(self._symbol, output_names)
        arg_params, aux_params = load_param_dict(param_file_or_dict)
        if not allow_missing:
            check_missing_params(self._symbol, set(input_shapes),
                                 arg_params, aux_params, who="ServingEngine")
        self._input_names = list(input_shapes)
        self._input_shapes = {n: tuple(int(d) for d in s)
                              for n, s in input_shapes.items()}
        self._input_dtypes = {
            n: np.dtype((input_dtypes or {}).get(n, np.float32))
            for n in self._input_names}
        # explicit buckets= > MXTPU_SERVE_BUCKETS > tuning DB > default; a
        # DB hit also keeps the entry's other knobs (``_autotuned``) for
        # the Batcher, and is logged once
        self._autotuned = None
        if buckets is None and not env_str("MXTPU_SERVE_BUCKETS"):
            buckets = self._db_buckets()
        self.buckets = tuple(sorted(set(
            int(b) for b in (buckets or default_buckets()))))
        if not self.buckets or self.buckets[0] < 1:
            raise MXNetError("ServingEngine: buckets must be positive "
                             "batch sizes, got %r" % (self.buckets,))
        self.health = health or ServingHealth(parent=SERVING_HEALTH)
        self.name = unique_name(name or "serving(%s)" % (self._symbol.name,))

        # parameter shapes are batch-independent: infer at the smallest
        # bucket, then move every parameter to the device once
        arg_shapes, out_shapes, aux_shapes = \
            self._symbol.infer_shape(**self._full_shapes(self.buckets[0]))
        shape_of = dict(zip(self._symbol.list_arguments(), arg_shapes))
        aux_shape_of = dict(zip(self._symbol.list_auxiliary_states(),
                                aux_shapes))

        def host(v, shape):
            t = _host_array(v)
            if tuple(t.shape) != tuple(shape):
                raise MXNetError(
                    "ServingEngine: parameter shape %s does not match the "
                    "graph's %s" % (tuple(t.shape), tuple(shape)))
            return t

        def zeros(shape):         # allow_missing=True: deliberate zero-fill
            return torch.zeros(shape, dtype=torch.float32)

        params = {
            n: self._store(host(arg_params[n], shape_of[n])
                           if n in arg_params else zeros(shape_of[n]))
            for n in self._symbol.list_arguments()
            if n not in self._input_names}
        aux = {
            n: self._whole(host(aux_params[n], aux_shape_of[n])
                           if n in aux_params else zeros(aux_shape_of[n]))
            for n in self._symbol.list_auxiliary_states()}
        #: the served (params, aux) pair: ``infer`` reads it once, and
        #: ``update_params`` replaces it with one assignment
        self._state = (params, aux)
        if self._mesh is None:
            self._run, _ = _build_graph_runner(self._symbol)
        else:
            self._run, _ = _build_graph_runner(
                self._symbol, mesh=self._mesh, node_constraint=_replicated)
        # per-output row factor: outputs whose leading dim is a multiple of
        # the batch (e.g. an LM's (batch*seq, vocab) head) slice by it
        self._out_row_factor = []
        for s in out_shapes:
            lead = int(s[0]) if s else 0
            self._out_row_factor.append(
                lead // self.buckets[0]
                if lead and lead % self.buckets[0] == 0 else None)
        if _dry_run():
            return
        # MXTPU_MEMCHECK: price the bucket set before the warm-up runs it;
        # MXTPU_COMMSCHECK: audit its collectives (a sharded engine's)
        _audit_load_memory(self, "ServingEngine")
        _audit_load_comms(self, "ServingEngine")
        if executables is not None:
            logging.warning(
                "ServingEngine: could not import executables from %s (a "
                "PyTorch engine runs its forward eagerly, and cannot "
                "serialize it or its CUDA state) — warming up afresh",
                executables)
        from .. import memcheck as _mc
        # the warm-up shows memcheck what cuDNN's workspace of each
        # convolution is, which memory_report then prices
        with _mc.learn_workspaces():
            for b in self.buckets:
                self._forward({n: np.zeros((b,) + self._input_shapes[n],
                                           self._input_dtypes[n])
                               for n in self._input_names})
        _sync(self._mesh, self.device)
        # every bucket goes to the static analyzer's registry, audited as
        # the train step's programs are (``check``)
        from .. import tracecheck as _tc
        for b in self.buckets:
            _tc.register_program("%s/bucket[b=%d]" % (self.name, b),
                                 self._device_forward, self._bucket_args(b))

    @classmethod
    def priced(cls, *args, top=8, **kwargs):
        """:meth:`memory_report` of the engine ``ServingEngine(*args,
        **kwargs)`` would build, without building it: the constructor runs
        inside a ``FakeTensorMode``, so the parameters land as fake tensors
        (nothing allocated on the device), and an engine built there skips
        its load audit and its warm-up. No bucket runs."""
        from ..memcheck import fake_mode, new_fake_mode
        with fake_mode(new_fake_mode(allow_non_fake_inputs=True)):
            eng = cls(*args, **kwargs)
        return eng.memory_report(top=top)

    # ------------------------------------------------------------------
    def _db_buckets(self):
        """The tuning DB's bucket spec for this symbol on this device, or
        None. The DB must never be able to break the deploy it configures:
        a corrupt spec falls back to the defaults with a warning."""
        from .. import autotune as _autotune
        entry_key, knobs = _autotune.resolve_serve_knobs(
            self._symbol, device=self.device)
        if not (knobs and knobs.get("buckets")):
            return None
        try:
            buckets = _autotune.parse_buckets(knobs["buckets"])
        except MXNetError as e:
            logging.warning(
                "autotune: tuning-DB entry %s carries an unusable bucket "
                "spec (%s) — built-in defaults apply", entry_key, e)
            return None
        self._autotuned = knobs
        _autotune.note_db_resolution(logging, "ServingEngine", entry_key,
                                     {"buckets": knobs["buckets"]})
        return buckets

    def _store(self, host_tensor):
        """Quantize one host parameter per ``quant_mode`` and move it to
        the device: a tensor, or an int8 ``{"q", "s"}`` pair; over a mesh
        laid out by the placement rule (``quantize.place_leaf``)."""
        return self._place(_quant.quantize_array(host_tensor,
                                                 self.quant_mode))

    def _place(self, stored):
        """A stored parameter leaf on the device, or over the mesh."""
        if self._mesh is not None:
            return _quant.place_leaf(stored, self._mesh)
        if _quant.is_quantized_leaf(stored):
            return {k: v.to(self.device) for k, v in stored.items()}
        return stored.to(self.device)

    def _whole(self, t):
        """A tensor (aux state, input) on the device, or replicated over
        the mesh with one copy a device."""
        if self._mesh is None:
            return t.to(self.device)
        return _mesh.split_spec(t, self._mesh, ())

    def _full_shapes(self, b):
        return {n: (b,) + self._input_shapes[n] for n in self._input_names}

    @property
    def max_batch(self):
        return self.buckets[-1]

    @property
    def model_devices(self):
        """Number of mesh positions one replica of this engine spans (1
        without ``contexts=``; positions may share a device)."""
        return 1 if self._mesh is None else len(
            self._mesh.replica_devices())

    def bucket_for(self, n):
        """Smallest bucket covering ``n`` examples."""
        for b in self.buckets:
            if b >= n:
                return b
        raise MXNetError("ServingEngine: no bucket covers %d examples "
                         "(buckets %s); chunk the request or add a bucket"
                         % (n, list(self.buckets)))

    # ------------------------------------------------------------------
    def update_params(self, arg_params, aux_params=None):
        """Hot-reload parameters under the live engine: a checkpoint swaps
        in without re-bucketing or dropping a request.

        ``arg_params`` is a ``{name: array/NDArray}`` dict, a param-file
        path (``load_param_dict`` formats: ``Module.save_checkpoint``
        output loads directly), or an ``(arg_params, aux_params)`` pair.
        Every non-input argument of the serving graph must be present with
        the graph's exact shape; extra keys (stripped loss heads, optimizer
        state) are ignored. A float checkpoint narrows or widens to the
        resident dtype (an f32 checkpoint into a bf16 engine), and a
        quantized engine re-quantizes it on the host. A sharded engine
        lays the new set out by the same rule. The copies land on the
        device before one assignment swaps the ``(params, aux)`` pair
        (every position's shards in it), so a concurrent ``infer`` serves
        the old set or the new one, never a mix."""
        if isinstance(arg_params, (str, bytes)) or hasattr(arg_params,
                                                           "read"):
            arg_params, file_aux = load_param_dict(arg_params)
            if aux_params is None:
                aux_params = file_aux
        elif isinstance(arg_params, tuple) and len(arg_params) == 2:
            arg_params, aux_params = arg_params
        cur_params, cur_aux = self._state

        def validated(new, cur, kind):
            missing = sorted(set(cur) - set(new))
            if missing:
                raise MXNetError(
                    "update_params: checkpoint is missing %s %s — a "
                    "partial swap would serve a chimera; pass every "
                    "parameter of the serving graph"
                    % (kind, ", ".join(missing)))
            out = {}
            for n, resident in cur.items():
                t = _host_array(new[n])
                lead = resident["q"] if _quant.is_quantized_leaf(resident) \
                    else resident
                if tuple(t.shape) != tuple(lead.shape):
                    raise MXNetError(
                        "update_params: %s %r shape %s does not match the "
                        "served graph's %s — rebuild the engine for a "
                        "different architecture"
                        % (kind, n, tuple(t.shape), tuple(lead.shape)))
                if _quant.is_quantized_leaf(resident):
                    # re-quantize the incoming checkpoint on the host
                    out[n] = self._place(_quant.quantize_array(
                        t.to(torch.float32), self.quant_mode))
                    continue
                if t.dtype != resident.dtype:
                    if not t.is_floating_point():
                        raise MXNetError(
                            "update_params: %s %r dtype %s does not match "
                            "the resident %s" % (kind, n, t.dtype,
                                                 resident.dtype))
                    t = t.to(resident.dtype)
                out[n] = (self._place(t) if kind == "parameter"
                          else self._whole(t))
            return out

        if cur_aux and aux_params is None:
            raise MXNetError(
                "update_params: the graph has aux states %s but no "
                "aux_params were passed" % sorted(cur_aux))
        new_params = validated(arg_params, cur_params, "parameter")
        new_aux = (validated(aux_params, cur_aux, "aux state")
                   if cur_aux else {})
        # land the copies before the swap: a request dispatched the
        # instant after it must never read a half-copied weight
        _sync(self._mesh, self.device)
        self._state = (new_params, new_aux)
        from ..obs import REGISTRY
        REGISTRY.counter(
            "serving.param_reloads",
            "parameter hot-reloads into live serving engines").inc()
        logging.info("%s: hot-reloaded %d parameters", self.name,
                     len(new_params))

    # ------------------------------------------------------------------
    def infer(self, inputs):
        """Run the forward over ``{name: (n, ...) array}``; returns a list
        of numpy arrays with pad rows already sliced off. Requests larger
        than the biggest bucket are chunked."""
        n = None
        host = {}
        for name in self._input_names:
            if name not in inputs:
                raise MXNetError("infer: missing input %r (need %s)"
                                 % (name, self._input_names))
            v = np.asarray(inputs[name], self._input_dtypes[name])
            if tuple(v.shape[1:]) != self._input_shapes[name]:
                raise MXNetError(
                    "infer: input %r per-example shape %s != %s"
                    % (name, tuple(v.shape[1:]), self._input_shapes[name]))
            if n is None:
                n = v.shape[0]
            elif v.shape[0] != n:
                raise MXNetError("infer: inputs disagree on batch size "
                                 "(%d vs %d)" % (n, v.shape[0]))
            host[name] = v
        if n == 0:
            raise MXNetError("infer: empty request")
        if n > self.max_batch:
            chunks = [self.infer({k: v[i:i + self.max_batch]
                                  for k, v in host.items()})
                      for i in range(0, n, self.max_batch)]
            return [np.concatenate([c[i] for c in chunks])
                    for i in range(len(chunks[0]))]
        b = self.bucket_for(n)
        if b > n:
            host = {k: np.concatenate(
                [v, np.zeros((b - n,) + v.shape[1:], v.dtype)])
                for k, v in host.items()}
        res = self._forward(host, n)
        self.health.record_batch(n, b - n)
        return res

    def _forward(self, batch, n=None):
        """One bucket's forward over the host ``batch`` (already padded);
        returns the outputs' first ``n`` rows as numpy. Records nothing."""
        params, aux = self._state
        with torch.inference_mode():
            inputs = {k: self._whole(torch.from_numpy(
                np.ascontiguousarray(v))) for k, v in batch.items()}
            outs = self._device_forward(params, aux, inputs)
            return [(o[:n * f] if f and n is not None else o).cpu().numpy()
                    for o, f in zip(outs, self._out_row_factor)]

    def _device_forward(self, params, aux, inputs):
        """The bucket program: the forward over device ``inputs`` (tensors,
        or replicated MeshArrays over a mesh), returning the outputs on the
        device (position 0's over a mesh). What :meth:`memory_report`
        prices."""
        with torch.inference_mode(), conv_precision(self.device):
            args = (dict(params) if self.quant_mode == "none"
                    else _quant.dequant_tree(params))
            args.update(inputs)
            outs, _ = self._run(args, aux)
            if self._mesh is not None:
                outs = [o.parts[0] for o in outs]
            return outs

    # ------------------------------------------------------------------
    def export_compiled(self, path):
        """Serialize every bucket's compiled executable (the JAX engine's
        cold-start-free deploy). Raises :class:`MXNetError`: the port's
        forward runs eagerly, and neither it nor its CUDA state can be
        serialized."""
        raise MXNetError(
            "export_compiled: this backend cannot serialize compiled "
            "executables (PyTorch runs the forward eagerly; cuDNN plans and "
            "built kernels live in the process) — not written to %s" % path)

    def weight_bytes(self, position=None):
        """Resident device bytes of the engine's (possibly quantized)
        parameters and aux states, from dtypes and shapes: global across a
        sharded engine's positions, or with ``position=r`` what position
        ``r`` holds."""
        params, aux = self._state
        return (_quant.tree_bytes(params, position)
                + _quant.tree_bytes(aux, position))

    def quality_report(self, reference, probe_inputs):
        """Quantization quality gate, step 1: run the SAME probe batch
        through this (quantized) engine and an unquantized ``reference``
        engine of the same graph, and compare first-output argmax
        agreement and the largest difference. Feed the result to
        :func:`mxnet_tpu_torch.serving.quantize.check_quality`, which
        raises below the ``MXTPU_SERVE_QUANT_MIN_AGREE`` floor."""
        ref = reference.infer(probe_inputs)[0]
        got = self.infer(probe_inputs)[0]
        return _quant.quality_report(ref, got)

    def memory_report(self, top=8):
        """Static memory profile of every bucket: ``{bucket:
        MemoryReport}``, each named ``<engine>/bucket[b=N]`` (the JAX
        package's keys and names), priced by ``memcheck.analyze``'s
        shape-only dry run of the bucket's forward over fake copies of the
        served parameters and aux states and a bucket of fake inputs. The
        live arrays are never touched and nothing runs on the device. A
        sharded engine's report counts the bytes of every position, on
        every device it touches."""
        from .. import memcheck as _mc
        return {b: _mc.analyze(self._device_forward, self._bucket_args(b),
                               name="%s/bucket[b=%d]" % (self.name, b),
                               top=top)
                for b in self.buckets}

    def _bucket_args(self, b):
        """The bucket program's arguments: the served parameters and aux
        states and a bucket of fake inputs (nothing allocated)."""
        from .. import memcheck as _mc
        from ..base import torch_dtype
        params, aux = self._state
        with _mc.fake_mode(like=self._state):
            inputs = {n: self._whole(torch.empty(
                (b,) + self._input_shapes[n],
                dtype=torch_dtype(self._input_dtypes[n])))
                for n in self._input_names}
        return params, aux, inputs

    def comms_report(self):
        """Static collective inventory of every bucket: ``{program_name:
        CommsReport}`` (``<engine>/bucket[b=N]``, the JAX package's keys),
        each from ``commscheck.analyze``'s shape-only dry run of the
        bucket's forward over the arguments :meth:`memory_report` prices.
        A one-device engine reports zero collectives; a model-parallel
        engine's inventory is the bill a request pays along 'model' over
        separate cards. Nothing runs on the device."""
        return _comms_reports(self, [
            ("%s/bucket[b=%d]" % (self.name, b), self._device_forward,
             self._bucket_args(b)) for b in self.buckets])

    def check(self, const_bytes=None, memory=False, budget=None,
              comms=False, min_eff=0.0):
        """Static-analyze this engine's bucket programs; returns the
        findings: ``tracecheck``'s lints over every registered bucket;
        with ``memory=True`` the memory lints over every bucket
        (``hbm-budget``, ``temp-blowup``) plus the ``resident-set`` lint
        over the bucket set; with ``comms=True`` the communication lints
        over :meth:`comms_report`. ``min_eff`` is the ``comms-bound``
        floor, 0 by default (unlike the training gate: model-parallel
        serving trades scale-out efficiency for fitting the model; pass a
        floor to opt in)."""
        return _check(self, const_bytes, memory, budget, comms, min_eff)
