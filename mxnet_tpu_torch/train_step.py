"""Fused training step: forward, backward and optimizer update per batch.

Counterpart of ``mxnet_tpu/train_step.py:TrainStep``, the engine under
``Module.fit(steps_per_dispatch=...)`` and ``bench.py``. The JAX package
compiles the step into one donated XLA program; here it runs eagerly on
the card:

- the forward runs the symbol through ``executor._build_graph_runner`` with
  f32 master parameters cast to ``compute_dtype`` inside it, so autograd
  delivers f32 gradients; ``jax.vjp`` with all-ones cotangents becomes
  ``torch.autograd.grad`` with all-ones output gradients over the outputs
  that carry a gradient (a ``MakeLoss`` head of ``grad_scale`` 0, or of a
  label, has none: its cotangent is zero in the JAX package);
- an optimizer's ``clip_global_norm`` scales every rescaled gradient by
  ``min(1, clip / global norm)`` before the per-parameter update, and an
  optimizer that draws noise (``SGLD``) gets one generator per parameter
  from the step's key, offset by :data:`_OPT_KEY_OFFSET` as the JAX
  package folds its key;
- buffer donation becomes an in-place update: ``step`` and ``run_steps``
  update the state's tensors and return the same dict, whose keys are the
  JAX package's (``params``, ``aux``, ``opt``, ``step``);
- ``run_steps`` runs K steps in a Python loop, keeps the metric sums on the
  device and reads them back once per dispatch through
  :class:`StepMetrics`: the legacy ``[loss, top-1, samples]`` layout, or a
  metric's declared slots with ``metric_spec=`` (a
  :class:`~mxnet_tpu_torch.metric.DeviceSumSpec`).

- ``guard=True`` (``step``/``run_steps``) computes the training guard's
  sentinels in the step: the global gradient norm (which
  ``clip_global_norm`` reuses) and an all-finite flag over the outputs and
  the gradients. A non-finite step keeps every piece of state unchanged,
  the step counter included: each in-place update is followed by a
  ``torch.where`` back to a copy of the old value, so nothing is read back
  to the host inside the step. The fault site ``guard.grad_nan`` poisons a
  step's gradients. The unguarded step is unchanged;
- ``remat`` recomputes activations in the backward
  (``executor._build_graph_runner``): ``True`` the whole forward,
  ``"conv"`` keeps only the values that cross the segments ending at each
  Convolution and FullyConnected node;
- ``MXTPU_BF16_STATS`` stores the aux states (BatchNorm's moving
  statistics) in bfloat16 (any truthy value), and with ``opt``, ``all`` or
  ``full`` the optimizer states too: storage casts only, the update
  computes in the promoted dtype and stores back, and checkpoints still
  write float32.

One divergence from the JAX package: it casts every floating batch input
to ``compute_dtype``, labels and token ids included, so bf16 rounds class
257 to 256 and 998 and 999 to 1000 (a class that does not exist), and an
``Embedding`` looks token 257 up in row 256. The port casts only the inputs
that are neither in ``label_names`` nor an ``Embedding``'s indices.

- ``mesh=`` (a :class:`~mxnet_tpu_torch.parallel.mesh.Mesh`) trains
  every position in one process. Each parameter is held as one shard per
  position, by its spec (:meth:`TrainStep.param_spec`): an explicit
  ``param_shardings`` entry (a :class:`~mxnet_tpu_torch.parallel.mesh.P`),
  else its ``group2ctx`` group's (``parallel.placement``: the first
  dimension the axis divides), else whole on every position, as every
  parameter is over a 'data' mesh. The optimizer states are sharded like
  their parameter; the aux states are whole on every position. The inputs
  split along 'data' at their batch axis and, over a 'seq' axis, along
  'seq' at dim 1 (``shard_batch``). The graph runner walks the positions
  in lock step by spec (``executor.spec_plan``; BatchNorm's statistics,
  Dropout's mask and the losses' normalisation over the whole batch).
  Each position's gradient of a parameter is summed over every position
  that holds the same shard (the axes the parameter is whole along:
  'data', and 'seq' or 'model' where it is replicated there), and each
  position applies the update to its own shard, so copies stay bitwise
  identical. The state keeps position 0's tensors at the usual keys and
  the others' under ``"replicas"``; :meth:`~TrainStep.whole_state`
  assembles whole arrays (for ``get_params`` and checkpoints), and
  :meth:`~TrainStep.replicate_state` splits whole ones. The metric sums
  are taken once for each shard of the batch along 'data' and summed
  across the shards once a dispatch, and the guard takes one decision
  from the summed gradients. The step runs under the mesh as the ambient
  ``MeshScope``, so sequence-parallel attention and the pipelined layer
  stack see it. A mesh step equals the one-device step at the same
  global batch.
"""
from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from .base import MXNetError, env_str, torch_dtype
from . import faults as _faults
from .context import resolve_device
from .executor import _build_graph_runner, node_generator, shard_grad_sums
from .initializer import Xavier, InitDesc
from .ops.nn import conv_precision
from . import optimizer as _opt
from .optimizer import Optimizer
from . import random as _random

#: offset of the optimizer's noise streams (SGLD) among a step's node
#: streams, so they never meet a graph node's (the JAX package's)
_OPT_KEY_OFFSET = 1 << 20


class StepMetrics(object):
    """Device-resident metric sums of one ``run_steps`` dispatch. The first
    property access (or :meth:`fetch`) is the dispatch's one host readback.

    Without a ``spec`` the layout is the legacy ``[loss_sum, top1_correct,
    num_samples]``; with a :class:`~mxnet_tpu_torch.metric.DeviceSumSpec`
    it is the spec's slots, read by name through :meth:`values`, and
    ``loss_sum``/``num_samples`` read the spec's ``loss_slots`` pair (NaN
    and 0 when it declares none). A guarded dispatch appends ``[skipped,
    last_grad_norm]``; its skipped steps are already left out of every
    sum."""

    __slots__ = ("device", "guarded", "spec", "_host")

    def __init__(self, device_tensor, spec=None, guarded=False):
        self.device = device_tensor
        self.guarded = guarded
        self.spec = spec
        self._host = None

    def _vals(self):
        if self._host is None:
            self._host = self.device.cpu().numpy()
        return self._host

    def fetch(self):
        """Do the host readback now (idempotent); returns self."""
        self._vals()
        return self

    @property
    def fetched(self):
        return self._host is not None

    @property
    def _n_slots(self):
        return 3 if self.spec is None else len(self.spec.slots)

    def values(self):
        """Slot name -> float of the dispatch's sums."""
        v = self._vals()
        if self.spec is None:
            return {"loss_sum": float(v[0]), "top1_correct": float(v[1]),
                    "num_samples": float(v[2])}
        return {s: float(v[i]) for i, s in enumerate(self.spec.slots)}

    def _loss_pair(self):
        v = self._vals()
        if self.spec is None:
            return float(v[0]), float(v[2])
        if self.spec.loss_slots is None:
            return float("nan"), 0.0
        idx = {s: i for i, s in enumerate(self.spec.slots)}
        ls, ns = self.spec.loss_slots
        return float(v[idx[ls]]), float(v[idx[ns]])

    @property
    def loss_sum(self):
        return self._loss_pair()[0]

    @property
    def top1_correct(self):
        """Top-1 correct count (legacy layout only; NaN under a spec)."""
        if self.spec is not None:
            return float("nan")
        return float(self._vals()[1])

    @property
    def num_samples(self):
        return int(round(self._loss_pair()[1]))

    @property
    def accuracy(self):
        n = self.num_samples
        return self.top1_correct / n if n else float("nan")

    @property
    def loss_avg(self):
        n = self.num_samples
        return self.loss_sum / n if n else float("nan")

    @property
    def skipped(self):
        """Non-finite steps the guard skipped (0 unguarded)."""
        return int(self._vals()[self._n_slots]) if self.guarded else 0

    @property
    def last_grad_norm(self):
        """The last step's global gradient norm (guarded only, else
        None)."""
        if not self.guarded:
            return None
        return float(self._vals()[self._n_slots + 1])

    def __repr__(self):
        if self.spec is not None:
            s = "StepMetrics(%s: %r" % (self.spec.tag, self.values())
        else:
            s = ("StepMetrics(loss_sum=%.6g, top1_correct=%g, num_samples=%d"
                 % (self.loss_sum, self.top1_correct, self.num_samples))
        if self.guarded:
            s += ", skipped=%d, last_grad_norm=%g" % (self.skipped,
                                                      self.last_grad_norm)
        return s + ")"


def _metric_step_sums(outs, labels, zero):
    """One step's metric sums (cross-entropy with eps 1e-8, top-1 correct)
    over every (rank-2 output, rank-1 label) pair, positionally; ``None``
    labels skip (ref: the JAX package's ``_metric_step_sums``)."""
    loss = zero
    correct = zero
    for o, lbl in zip(outs, labels):
        if (lbl is not None and o.dim() == 2 and lbl.dim() == 1
                and o.shape[0] == lbl.shape[0]):
            li = lbl.to(torch.int32)
            p = torch.gather(o, 1, li.long()[:, None])[:, 0].float()
            loss = loss + torch.sum(-torch.log(p + 1e-8))
            correct = correct + torch.sum(
                (torch.argmax(o, dim=1).to(torch.int32) == li).float())
    return loss, correct


def _default_slot_sums(outs, labels, batch_size):
    """The legacy packed layout ``(ce_loss, top1_correct, num_samples)``."""
    zero = torch.zeros((), dtype=torch.float32, device=outs[0].device)
    loss, correct = _metric_step_sums(outs, labels, zero)
    return loss, correct, zero + float(batch_size)


def _with_guard_loss(spec, batch_size):
    """A spec that declares no watchable loss pair, with two hidden slots
    appended: the cross-entropy and sample count the training guard's
    divergence watch reads. The metric's own fold never sees them."""
    from .metric import DeviceSumSpec
    if spec is None or spec.loss_slots is not None:
        return spec
    base_slots, base_step, base_fold = spec.slots, spec.step_sums, spec.fold

    def step_sums(outs, labels):
        vals = tuple(base_step(outs, labels))
        zero = torch.zeros((), dtype=torch.float32, device=outs[0].device)
        loss, _ = _metric_step_sums(outs, labels, zero)
        return vals + (loss, zero + float(batch_size))

    def fold(metric, values):
        base_fold(metric, {s: values[s] for s in base_slots})

    sig = spec.signature if isinstance(spec.signature, tuple) \
        else (spec.signature,)
    return DeviceSumSpec(base_slots + ("__guard_loss", "__guard_n"),
                         step_sums, fold, ("guardloss",) + sig,
                         loss_slots=("__guard_loss", "__guard_n"),
                         tag=spec.tag)


def _parts(v):
    """A value's tensor on each replica: a MeshArray's parts, or the one
    tensor."""
    return v.parts if hasattr(v, "parts") else [v]


def _like(v, parts):
    """``parts`` held as ``v`` holds its own: a MeshArray over ``v``'s mesh
    and spec, or the one tensor."""
    return (type(v)(v.mesh, parts, spec=v.spec) if hasattr(v, "parts")
            else parts[0])


def _data_shard(v, r):
    """Position ``r``'s part of ``v`` (a tensor, or a MeshArray), whole
    along every axis but 'data': a read of the step's outputs, as
    ``MeshArray.gather`` is, not a collective of the step."""
    if isinstance(v, torch.Tensor):
        return v
    from .parallel import mesh as _mesh
    data = tuple(a if a == _mesh.AXIS_DATA else None for a in v.spec)
    if data == v.spec:
        return v.parts[r]
    return _mesh._narrow(v.gather(v.parts[r].device), v.mesh, data, r)


def _index(v, i):
    """Step ``i`` of a stacked ``(k, batch, ...)`` superbatch value."""
    if not hasattr(v, "parts"):
        return v[i]
    return type(v)(v.mesh, [p[i] for p in v.parts], spec=v.spec[1:])


def _map_state(fn, s):
    """``fn`` over an optimizer state's tensors (None, a tensor or a
    tuple)."""
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_map_state(fn, x) for x in s)
    return fn(s)


def _copy_state(dst, src):
    """Copy an optimizer state's tensors into ``dst``'s, in place."""
    if isinstance(dst, tuple):
        for d, x in zip(dst, src):
            _copy_state(d, x)
    elif dst is not None:
        dst.copy_(src)


def _select_state(ok, new, old):
    """``new`` where ``ok`` else ``old``, into ``new``'s tensors."""
    if isinstance(new, tuple):
        for n, o in zip(new, old):
            _select_state(ok, n, o)
    elif new is not None:
        new.copy_(torch.where(ok, new, old))


def bf16_stats_mode():
    """``MXTPU_BF16_STATS`` as ``(aux in bf16, optimizer states in
    bf16)``: any truthy value stores the aux states in bfloat16; ``opt``,
    ``all`` or ``full`` the optimizer states too."""
    v = env_str("MXTPU_BF16_STATS").lower()
    stats = v not in ("", "0", "false", "off", "no")
    return stats, v in ("opt", "all", "full")


class TrainStep(object):
    """Training step over a symbol, on one device.

    state = ``{params, aux, opt, step}``; ``step(state, batch)`` updates it
    in place and returns ``(state, outputs)``. ``optimizer`` is a registry
    name (created with ``learning_rate``/``momentum``/``wd``) or an
    :class:`~mxnet_tpu_torch.optimizer.Optimizer` with a fused update.
    ``device``: where it runs, ``cuda:0`` by default; without CUDA that
    raises (pass ``device="cpu"`` to train on the CPU). ``remat``: one of
    ``False``, ``True`` and ``"conv"`` (see the module's note).
    ``batch_axes`` (over a mesh): input name -> its batch axis, the 'N' of
    its layout (``parallel.mesh.layout_axes``; a ``"TN"`` input splits
    along dim 1); an input without one splits along dim 0, or along the
    axis of the batch's size (``parallel.mesh.batch_axis``).
    """

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), optimizer="sgd",
                 learning_rate=0.01, momentum=0.9, wd=0.0, rescale_grad=None,
                 mesh=None, param_shardings=None, dtype=np.float32,
                 compute_dtype=None, remat=False, frozen_param_names=None,
                 group2ctx=None, device=None, batch_axes=None):
        from .parallel import mesh as _mesh
        from .parallel import placement as _placement
        if mesh is not None and not isinstance(mesh, _mesh.Mesh):
            raise MXNetError("TrainStep: mesh=%r is not a parallel.mesh.Mesh"
                             % (mesh,))
        self._placement = _placement.resolve(group2ctx, mesh)
        if self._placement is not None and mesh is None:
            mesh = self._placement.mesh
        self.param_shardings = dict(param_shardings or {})
        if self.param_shardings and mesh is None:
            raise MXNetError("TrainStep: param_shardings needs a mesh "
                             "(mesh= or group2ctx=)")
        for n, spec in self.param_shardings.items():
            for a in spec or ():
                if a is not None and a not in mesh.axis_names:
                    raise MXNetError(
                        "TrainStep: param_shardings[%r] = %r names axis %r, "
                        "not in mesh axes %r" % (n, spec, a,
                                                 tuple(mesh.axis_names)))
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device, "TrainStep")
            self.replica_devices = [self.device]
        else:
            self.replica_devices = [resolve_device(d, "TrainStep")
                                    for d in mesh.replica_devices()]
            self.device = self.replica_devices[0]
            if (device is not None
                    and resolve_device(device, "TrainStep") != self.device):
                raise MXNetError("TrainStep: device=%s but the mesh's first "
                                 "replica is on %s" % (device, self.device))
        self.symbol = symbol
        self.batch_axes = dict(batch_axes or {})
        self.data_names = list(data_names)
        self.label_names = list(label_names)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.param_names = [n for n in self.arg_names
                            if n not in self.data_names + self.label_names]
        self.frozen_param_names = set(frozen_param_names or ())
        if isinstance(optimizer, Optimizer):
            self._opt = optimizer
            # an instance's rescale_grad is authoritative, as the JAX
            # package's (ref: module.py:460-463 warns on 1.0)
            if rescale_grad is None:
                rescale_grad = optimizer.rescale_grad
                if rescale_grad == 1.0:
                    logging.warning(
                        "TrainStep: optimizer instance has rescale_grad=1.0 "
                        "(gradients are batch sums); pass "
                        "rescale_grad=1/batch_size to the optimizer or to "
                        "TrainStep if per-example scaling is intended")
        else:
            kwargs = {"learning_rate": learning_rate, "wd": wd,
                      "sym": symbol}
            if optimizer.lower() in ("sgd", "nag", "ccsgd", "dcasgd"):
                kwargs["momentum"] = momentum
            self._opt = _opt.create(optimizer, **kwargs)
        if not self._opt.fused_supported:
            raise MXNetError("fused step: optimizer %r has no fused update"
                             % type(self._opt).__name__)
        self.optimizer = optimizer
        self.rescale_grad = rescale_grad
        self.dtype = torch_dtype(dtype)
        self.bf16_stats, self.bf16_opt = bf16_stats_mode()
        if compute_dtype is not None:
            self.compute_dtype = torch_dtype(compute_dtype)
        elif self.dtype != torch.float32:
            # parameters stored in another dtype: inputs are cast to match
            self.compute_dtype = self.dtype
        else:
            self.compute_dtype = None
        self.remat = remat
        self._run, self._nodes = _build_graph_runner(
            symbol, placement=self._placement, remat=remat, mesh=mesh)
        self._groups = ({} if self._placement is None else
                        _placement.param_groups(self._nodes))
        self._shapes = {}     # whole parameter shapes, from init
        # the inputs that feed an Embedding's indices keep their dtype under
        # compute_dtype, as the labels do
        self._keep_dtype = set(self.label_names) | {
            src.name for node in self._nodes
            if not node.is_variable and node.op.name == "Embedding"
            for src, _ in node.inputs[:1] if src.is_variable}
        self._needs_rng = any((not n.is_variable) and n.op.needs_rng
                              for n in self._nodes) or getattr(
                                  self._opt, "fused_needs_key", False)
        self._base_key = None

    # ------------------------------------------------------------------
    def init(self, data_shapes, label_shapes=None, initializer=None, seed=0):
        """Allocate and initialize the state on the device from the
        inferred shapes. Seeding is scoped: the random module's state is
        restored afterwards."""
        shapes = dict(data_shapes)
        shapes.update(label_shapes or {})
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**shapes)
        shape_of = dict(zip(self.arg_names, arg_shapes))
        aux_shape_of = dict(zip(self.aux_names, aux_shapes))
        initializer = initializer or Xavier()
        attrs = self.symbol.attr_dict()
        saved = _random.get_state()
        _random.seed(seed)
        try:
            def make(name, shape):
                t = torch.zeros(shape, dtype=self.dtype, device=self.device)
                initializer(InitDesc(name, attrs.get(name, {})), t)
                return t
            params = {n: make(n, shape_of[n]) for n in self.param_names}
            self._shapes = {n: tuple(shape_of[n]) for n in self.param_names}
            aux = {n: make(n, aux_shape_of[n]) for n in self.aux_names}
        finally:
            _random.set_state(saved)
        opt = self.cast_opt_state(
            {n: self._opt.create_fused_state(v) for n, v in params.items()
             if n not in self.frozen_param_names})
        return self.replicate_state(
            {"params": params, "aux": self.cast_stats(aux), "opt": opt,
             "step": torch.zeros((), dtype=torch.int32, device=self.device)})

    # -- replicas of the state over a mesh -----------------------------
    def param_spec(self, name, ndim=None):
        """The partition spec of parameter ``name`` over the mesh: its
        ``param_shardings`` entry, else its group's, else whole (a tuple
        of one entry per dimension: ``ndim``, else the parameter's
        from ``init``)."""
        spec = self.param_shardings.get(name)
        if spec is None and name not in self.param_shardings:
            g = self._groups.get(name)
            if g is not None:
                spec = self._placement.param_spec(g, self._shapes[name])
        spec = tuple(spec or ())
        if ndim is None:
            ndim = len(self._shapes[name])
        return spec + (None,) * (ndim - len(spec))

    def replicate_state(self, state):
        """Over a mesh, lay ``state`` (whole tensors at the usual keys) out
        over the positions: each parameter (and its optimizer states) cut
        to every position's shard of it by :meth:`param_spec`, a copy on
        its device for every other position under ``"replicas"``, and
        position 0's at the usual keys (the tensors themselves where
        nothing is split); the same dict. Call it after replacing tensors
        at the usual keys. A no-op without a mesh."""
        if self.mesh is None:
            return state
        from .parallel import mesh as _mesh
        mesh = self.mesh
        for n, v in state["params"].items():
            self._shapes.setdefault(n, tuple(v.shape))

        def cut(t, n, spec, r, dev):
            # a parameter's shard (an optimizer state of its shape too)
            if any(spec) and tuple(t.shape) == self._shapes[n]:
                return _mesh._narrow(t, mesh, spec, r).detach().to(
                    dev, copy=True)
            return t if r == 0 else t.detach().to(dev, copy=True)

        def position(r, dev):
            def p(n, v):
                spec = self.param_spec(n)
                return _map_state(lambda t: cut(t, n, spec, r, dev), v)

            def whole(v):
                return _map_state(lambda t: cut(t, None, (), r, dev), v)
            return {"params": {n: p(n, v) for n, v in state["params"].items()},
                    "aux": {n: whole(v) for n, v in state["aux"].items()},
                    "opt": {n: p(n, v) for n, v in state["opt"].items()},
                    "step": whole(state["step"])}
        reps = [position(r, d) for r, d in enumerate(self.replica_devices)]
        state.update(reps[0])
        state["replicas"] = reps[1:]
        return state

    def whole_state(self, state):
        """``state`` with whole arrays at the usual keys (parameters and
        optimizer states assembled from every position's shards, on
        position 0's device; the aux states and step counter position
        0's), without ``"replicas"``: what ``get_params`` and the
        checkpoint helpers read. The state itself where nothing is
        split."""
        if self.mesh is None or not any(
                any(self.param_spec(n, v.dim()))
                for n, v in state["params"].items()):
            return state
        from .parallel import mesh as _mesh
        reps = self.replica_states(state)

        def whole(n, pick):
            spec = self.param_spec(n)
            leaves = [pick(rep) for rep in reps]

            def join(*parts):
                if parts[0] is None:
                    return None
                if isinstance(parts[0], tuple):
                    return tuple(join(*xs) for xs in zip(*parts))
                arr = _mesh.MeshArray(self.mesh, parts, spec=spec)
                if arr.shape != self._shapes[n]:
                    return parts[0]
                return arr.gather(self.device)
            return join(*leaves)
        return {"params": {n: whole(n, lambda rep, n=n: rep["params"][n])
                           for n in state["params"]},
                "aux": dict(state["aux"]),
                "opt": {n: whole(n, lambda rep, n=n: rep["opt"][n])
                        for n in state["opt"]},
                "step": state["step"]}

    @staticmethod
    def replica_states(state):
        """Every replica's state, replica 0 (``state`` itself) first."""
        return [state] + list(state.get("replicas", ()))

    def set_step(self, state, value):
        """Set every replica's step counter to ``value``."""
        for rep in self.replica_states(state):
            rep["step"] = torch.full((), int(value), dtype=torch.int32,
                                     device=rep["step"].device)

    def cast_stats(self, aux):
        """``MXTPU_BF16_STATS``: the aux states' storage cast (identity when
        the knob is off)."""
        if not self.bf16_stats:
            return aux
        return {n: (v.to(torch.bfloat16) if v.is_floating_point() else v)
                for n, v in aux.items()}

    def cast_opt_state(self, opt):
        """``MXTPU_BF16_STATS=opt|all|full``: the optimizer states' storage
        cast (identity when the knob is off)."""
        if not self.bf16_opt:
            return opt
        return {n: _map_state(lambda v: (v.to(torch.bfloat16)
                                         if v.is_floating_point() else v), s)
                for n, s in opt.items()}

    # ------------------------------------------------------------------
    def _to_device(self, batch):
        out = {}
        for k, v in batch.items():
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
            out[k] = t.to(self.device)
        return out

    def _placed(self, batch, lead):
        """``batch`` laid out over the mesh (``lead`` 1 for a stacked
        superbatch, whose step axis comes first): each input split along
        'data' at its batch axis (``batch_axes``) and, over a 'seq' axis,
        along 'seq' at dim 1 where it has one (the token dimension of a
        (batch, seq) input); an input with neither whole on every
        position. MeshArrays pass through."""
        from .parallel import mesh as _mesh
        m = self.mesh
        who = "shard_superbatch" if lead else "shard_batch"
        hint = "" if lead else (" — pad the %s or pick a divisible %s")
        for k, v in batch.items():
            if isinstance(v, _mesh.MeshArray):
                if v.mesh.replica_devices() != m.replica_devices():
                    raise MXNetError("TrainStep: %r lies on another mesh" % k)
            elif len(v.shape) <= lead:
                raise MXNetError("TrainStep: %r of shape %s has no batch "
                                 "axis to split over the 'data' mesh"
                                 % (k, tuple(v.shape)))
        order = ([k for k in self.data_names if k in batch]
                 + [k for k in batch if k not in self.data_names])
        _, axes = _mesh.batch_axes(
            {k: tuple(batch[k].shape)[lead:] for k in order},
            self.batch_axes)
        nd, ns = m.size(_mesh.AXIS_DATA), m.size(_mesh.AXIS_SEQ)
        out = {}
        for k, v in batch.items():
            if isinstance(v, _mesh.MeshArray):
                out[k] = v
                continue
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
            spec = [None] * t.dim()
            ax = axes[k]
            if ax is not None and _mesh.AXIS_DATA in m.axis_names:
                if t.shape[lead + ax] % nd:
                    raise MXNetError(
                        "%s: %r batch dim %d does not divide the %d-way "
                        "'data' mesh axis%s" % (
                            who, k, t.shape[lead + ax], nd,
                            hint and hint % ("batch", "batch size")))
                spec[lead + ax] = _mesh.AXIS_DATA
            if ns > 1 and t.dim() - lead >= 2 and ax != 1:
                if t.shape[lead + 1] % ns:
                    raise MXNetError(
                        "%s: %r sequence dim %d does not divide the %d-way "
                        "'seq' mesh axis%s" % (
                            who, k, t.shape[lead + 1], ns,
                            hint and hint % ("sequence", "seq_len")))
                spec[lead + 1] = _mesh.AXIS_SEQ
            out[k] = (_mesh.split_spec(t, m, spec) if any(spec) else
                      _mesh.replicate(t.to(self.device), m))
        return out

    def shard_batch(self, batch):
        """``batch`` (name -> array) split along its batch axis over the
        mesh's 'data' axis (and along 'seq' at dim 1 over a 'seq' axis),
        one MeshArray each (ref: the JAX package's
        ``shard_batch``; the axis of ``batch_axes``, else dim 0, or where
        an input's dim 0 is not the batch, as an RNN's begin state
        ``(layers, batch, hidden)``, the axis of the batch's size). A batch
        that does not divide the axis raises. Without a mesh: the batch on
        the device."""
        if self.mesh is None:
            return self._to_device(batch)
        return self._placed(batch, 0)

    def shard_superbatch(self, superbatch):
        """Stacked ``(k, batch, ...)`` arrays split along dim 1 over the
        'data' mesh. MeshArrays (``SuperBatchIter(sharding=)`` lands them
        split on its producer thread) pass through as they are."""
        if self.mesh is None:
            return self._to_device(superbatch)
        return self._placed(superbatch, 1)

    def _next_lr(self):
        # the scheduler clock advances on the host, once per step
        self._opt.num_update += 1
        if self._opt.lr_scheduler is not None:
            return self._opt.lr_scheduler(self._opt.num_update)
        return self._opt.lr

    def _step_key(self, state):
        """The run's rng key: a base drawn once from the random module,
        offset by the state's own step counter (read from the device only
        for graphs with a random op, or an optimizer that draws noise)."""
        if not self._needs_rng:
            return None
        if self._base_key is None:
            self._base_key = _random.randint63()
        return self._base_key + int(state["step"])

    def _step(self, state, batch, lr, batch_size, guard=False):
        """One forward, backward and in-place update, on the device or on
        every replica of the mesh at once (``batch`` then of MeshArrays):
        each parameter's gradient is summed across the replicas and every
        replica applies the one update to its copy (the clip factor and the
        guard's decision are replica 0's, from the summed gradients and
        every replica's outputs). Returns ``(outputs, sentinels)``: the
        outputs detached (MeshArrays over a mesh), and with ``guard`` ``(ok,
        grad_norm)``, the step's all-finite flag and global gradient norm
        as device scalars (else None)."""
        from .parallel import mesh as _mesh
        from .executor import head_pairs
        reps = self.replica_states(state)
        devs = self.replica_devices
        n_rep = len(reps)
        updated = [n for n in self.param_names
                   if n not in self.frozen_param_names]
        cdt = self.compute_dtype
        key = self._step_key(state)
        leaves = {n: [rep["params"][n].detach().requires_grad_(
            n not in self.frozen_param_names) for rep in reps]
            for n in self.param_names}
        specs = ({} if self.mesh is None else
                 {n: self.param_spec(n, ls[0].dim())
                  for n, ls in leaves.items()})

        def over(parts, name=None):
            # the positions' parts of one value as the runner takes them
            if self.mesh is None:
                return parts[0]
            return _mesh.MeshArray(self.mesh, parts, spec=specs.get(name))
        with torch.enable_grad(), conv_precision(self.device), \
                self._ambient():
            arg_vals = {k: (_like(v, [p.to(cdt) for p in _parts(v)])
                            if cdt is not None and v.dtype.is_floating_point
                            and k not in self._keep_dtype else v)
                        for k, v in batch.items()}
            arg_vals.update({n: over([t.to(cdt) if cdt is not None else t
                                      for t in ls], n)
                             for n, ls in leaves.items()})
            aux_vals = {k: over([rep["aux"][k] for rep in reps])
                        for k in self.aux_names}
            outs, aux_up = self._run(arg_vals, aux_vals, key, True)
            # only outputs with a gradient take a cotangent (the others'
            # is zero); autograd.grad raises on one without
            pairs = head_pairs(outs)
            flat = [t for n in updated for t in leaves[n]]
            grads = [None] * len(flat)
            if pairs and flat:
                grads = torch.autograd.grad(
                    [t for t, _ in pairs], flat,
                    grad_outputs=[c for _, c in pairs], allow_unused=True)
        with torch.no_grad():
            summed = []
            for i, n in enumerate(updated):
                parts = grads[i * n_rep:(i + 1) * n_rep]
                if self.mesh is not None:
                    # the sum over every position holding the same shard
                    parts = shard_grad_sums(
                        [torch.zeros_like(t) if g is None else g
                         for t, g in zip(leaves[n], parts)], self.mesh,
                        specs[n])
                summed.append(parts)
            poison = guard and _faults.fire_flag("guard.grad_nan")
            every_out = [p for o in outs for p in _parts(o)]
            ok = gnorm = scale = None
            scaled = [self._scaled_grads(rep["params"], updated,
                                         [g[r] for g in summed], batch_size,
                                         poison)
                      for r, rep in enumerate(reps)]
            if scaled[0] and (guard or self._opt.clip_global_norm
                              is not None):
                gnorm, others = self._global_norm(updated, scaled, specs)
                every_out = every_out + others
            for r, rep in enumerate(reps):
                gs = scaled[r]
                if r == 0:
                    gs, ok, gnorm, scale = self._sentinels(
                        gs, every_out, guard, gnorm=gnorm)
                else:
                    gs = self._sentinels(gs, None, False, scale=scale)[0]
                self._apply(rep, updated, gs,
                            {k: _parts(u)[r] for k, u in aux_up.items()},
                            lr, key, guard,
                            None if ok is None else ok.to(devs[r]))
        return ([_like(o, [p.detach() for p in _parts(o)]) for o in outs],
                (ok, gnorm) if guard else None)

    def _scaled_grads(self, params, updated, grads, batch_size, poison):
        """The gradients in the parameters' dtype times ``rescale_grad``
        (1/batch by default), NaN everywhere when ``poison``."""
        rescale = (self.rescale_grad if self.rescale_grad is not None
                   else 1.0 / batch_size)
        gs = [(torch.zeros_like(params[n]) if g is None
               else g.to(params[n].dtype)) * rescale
              for n, g in zip(updated, grads)]
        if poison:
            gs = [g + float("nan") for g in gs]
        return gs

    def _global_norm(self, updated, scaled, specs):
        """The global norm of the scaled gradients (``scaled[r]``: position
        ``r``'s; ``specs``: the parameters' specs): each parameter's sum of
        squares over its distinct shards, on position 0's device. Also the
        gradients the guard's finiteness check reads beyond position 0's:
        the other distinct shards'."""
        from .parallel import mesh as _mesh
        total, others = None, []
        for i, n in enumerate(updated):
            pos = ([0] if self.mesh is None else
                   _mesh.distinct_positions(self.mesh, specs[n]))
            others += [scaled[r][i] for r in pos[1:]]
            sq = None
            for r in pos:
                t = torch.sum(torch.square(scaled[r][i].float())).to(
                    self.device)
                sq = t if sq is None else sq + t
            total = sq if total is None else total + sq
        return torch.sqrt(total), others

    def _ambient(self):
        """The mesh as the ambient ``MeshScope`` for the step: the ops that
        read it (sequence-parallel attention, the pipelined layer stack)
        see this step's mesh."""
        import contextlib
        if self.mesh is None:
            return contextlib.nullcontext()
        from .parallel.mesh import MeshScope
        return MeshScope(self.mesh)

    def _sentinels(self, gs, outs, guard, scale=None, gnorm=None):
        """``clip_global_norm`` and the guard's sentinels: ``(gs clipped,
        ok, grad norm, clip factor)``, from ``gnorm`` (the global norm,
        :meth:`_global_norm`). ``scale`` (position 0's clip factor) is
        applied as it is instead of being computed."""
        clip_norm = self._opt.clip_global_norm
        ok = None
        if clip_norm is not None and gs:
            if scale is None:
                scale = torch.clamp(
                    clip_norm / torch.clamp_min(gnorm, 1e-12), max=1.0)
            gs = [g * scale.to(device=g.device, dtype=g.dtype) for g in gs]
        if guard and outs is not None:
            if gnorm is None:
                gnorm = torch.zeros((), device=self.device)
            # all-finite over the gradients and the outputs
            ok = torch.stack([torch.isfinite(x).all()
                              for x in list(gs) + list(outs)]).all()
        return gs, ok, gnorm, scale

    def _apply(self, state, updated, gs, aux_up, lr, key, guard, ok):
        """The optimizer update of one replica's ``state`` in place, and its
        aux states and step counter; under ``guard`` a step whose ``ok`` is
        False leaves all of it as it was."""
        params, aux, opt = state["params"], state["aux"], state["opt"]
        device = state["step"].device
        t = state["step"].float() + 1.0
        wd = self._opt.wd
        needs_key = getattr(self._opt, "fused_needs_key", False)
        for i, (n, g) in enumerate(zip(updated, gs)):
            gen = (node_generator(key, _OPT_KEY_OFFSET + i, device)
                   if needs_key else None)
            w, s = params[n], opt[n]
            if guard:
                old_w, old_s = w.clone(), _map_state(torch.clone, s)
            # bf16 optimizer states: the update computes on a float32
            # copy, and storage goes back to bfloat16
            s_up = (_map_state(lambda v: v.to(w.dtype), s)
                    if self.bf16_opt else s)
            self._opt.fused_update(
                n, w, g, s_up, lr * self._opt.lr_mult.get(n, 1.0),
                wd * self._opt.wd_mult.get(n, 1.0), t, key=gen)
            if self.bf16_opt:
                _copy_state(s, s_up)
            if guard:
                w.copy_(torch.where(ok, w, old_w))
                _select_state(ok, s, old_s)
        for k, v in aux_up.items():
            nv = v.to(aux[k].dtype)
            aux[k].copy_(torch.where(ok, nv, aux[k]) if guard else nv)
        # a skipped step is a full no-op: the step counter (and the
        # noise streams keyed by it) does not advance either
        state["step"].add_(ok.to(torch.int32) if guard else 1)

    def step(self, state, batch, guard=False):
        """One training step. ``batch``: dict name -> array or tensor.
        Returns ``(state, outputs)``; the state's tensors are updated in
        place. ``guard=True`` runs the guarded step and returns ``(state,
        outputs, packed)``, ``packed`` the device tensor ``[loss, correct,
        nsamp, skipped, grad_norm]`` (zeros but ``skipped`` for a skipped
        step)."""
        batch = self.shard_batch(batch)
        bs = next(iter(batch.values())).shape[0]
        outs, sentinels = self._step(state, batch, self._next_lr(), bs,
                                     guard=guard)
        labels = [batch.get(n) for n in self.label_names]
        if self.mesh is not None:
            # the outputs merged in batch order on replica 0's device
            outs = [o.gather(self.device).detach() for o in outs]
            labels = [None if v is None else v.gather(self.device)
                      for v in labels]
        if not guard:
            return state, outs
        ok, gnorm = sentinels
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        loss, correct = _metric_step_sums(outs, labels, zero)
        okf = ok.float()
        packed = torch.stack([torch.where(ok, loss, zero),
                              torch.where(ok, correct, zero),
                              okf * float(bs), 1.0 - okf, gnorm.float()])
        return state, outs, packed

    def run_steps(self, state, superbatch, k=None, guard=False,
                  metric_spec=None):
        """K training steps over a stacked ``(k, batch, ...)`` superbatch.
        Returns ``(state, metrics)``: the state updated in place and a
        :class:`StepMetrics` of the K steps' sums, held on the device until
        read: the loss, top-1 and sample sums, or with ``metric_spec`` (a
        :class:`~mxnet_tpu_torch.metric.DeviceSumSpec`) the spec's slots,
        each step's ``step_sums(outputs, labels)`` added up. ``guard=True``
        runs guarded steps: skipped steps stay out of every sum, and the
        metrics carry ``skipped`` and ``last_grad_norm`` (a spec without a
        loss pair gains the cross-entropy the guard watches)."""
        superbatch = self.shard_superbatch(superbatch)
        vals = list(superbatch.values())
        if not vals:
            raise MXNetError("run_steps: empty superbatch")
        lead = vals[0].shape[0]
        if k is not None and k != lead:
            raise MXNetError("run_steps: k=%d but superbatch is stacked %d "
                             "deep" % (k, lead))
        k = lead
        if any(v.shape[0] != k or len(v.shape) < 2 for v in vals):
            raise MXNetError("run_steps: superbatch arrays must share a "
                             "(k, batch, ...) leading shape, got %r"
                             % {n: tuple(v.shape)
                                for n, v in superbatch.items()})
        bs = vals[0].shape[1]
        # over a mesh the first position of each shard of the batch along
        # 'data' sums its outputs and labels (whole along the other axes;
        # positions holding copies would count twice), once across the
        # shards at the end of the dispatch; the sample counts the sums
        # carry add up to the batch
        pos = [0]
        if self.mesh is not None:
            from .parallel import mesh as _mesh
            pos = _mesh.distinct_positions(self.mesh, tuple(
                a for a in (_mesh.AXIS_DATA,) if a in self.mesh.axis_names))
        devs = [self.replica_devices[r] for r in pos]
        counts = [bs // len(devs) + (r < bs % len(devs))
                  for r in range(len(devs))]
        if guard:
            specs = [_with_guard_loss(metric_spec, c) for c in counts]
        else:
            specs = [metric_spec] * len(devs)
        if metric_spec is None:
            nslots = 3
            sums = [functools.partial(_default_slot_sums, batch_size=c)
                    for c in counts]
        else:
            nslots = len(specs[0].slots)
            sums = [sp.step_sums for sp in specs]
        lrs = [self._next_lr() for _ in range(k)]
        accs = [torch.zeros(nslots, dtype=torch.float32, device=d)
                for d in devs]
        skipped = gnorm = None
        for i in range(k):
            batch = {n: _index(v, i) for n, v in superbatch.items()}
            outs, sentinels = self._step(state, batch, lrs[i], bs,
                                         guard=guard)
            with torch.no_grad():
                # the sums are tensors on the device (a spec fills its
                # constants there): nothing here waits for the card
                for r, acc in enumerate(accs):
                    labels = [_data_shard(batch[n], pos[r]) if n in batch
                              else None for n in self.label_names]
                    step_outs = [_data_shard(o, pos[r]) for o in outs]
                    step_vals = torch.stack(
                        [v.float().reshape(()) for v in
                         sums[r](step_outs, labels)])
                    if guard:
                        acc += torch.where(sentinels[0].to(devs[r]),
                                           step_vals,
                                           torch.zeros_like(step_vals))
                    else:
                        acc += step_vals
                if guard:
                    ok, gnorm = sentinels
                    skip = 1.0 - ok.float()
                    skipped = skip if skipped is None else skipped + skip
        if len(devs) > 1:
            acc = _mesh.all_reduce(accs, [self.device])[0]
        else:
            acc = accs[0]
        if guard:
            acc = torch.cat([acc, torch.stack([skipped, gnorm.float()])])
        return state, StepMetrics(acc, specs[0], guarded=guard)


def data_parallel_spec(mesh_shape, n_devices=None, devices=None):
    """A mesh from a ``{'data': n}`` dict (ref: the JAX package's helper;
    ``n_devices`` is accepted and unused, as there)."""
    from .parallel.mesh import make_mesh
    return make_mesh(mesh_shape, devices)
