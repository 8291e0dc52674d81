"""BucketingModule (ref: python/mxnet/module/bucketing_module.py).

Counterpart of ``mxnet_tpu/module/bucketing_module.py``. ``sym_gen(bucket_key)
-> (symbol, data_names, label_names)``; a :class:`Module` is bound per
bucket on demand, sharing its parameter arrays with the default bucket's
(the port's ``simple_bind`` hands a shared executor's arrays of the same
name, shape and dtype to the new one), and every bucket module borrows the
default bucket's optimizer.

The fused path that ``fit`` takes: one
:class:`~mxnet_tpu_torch.train_step.TrainStep` per bucket shape, built from
its symbol without binding an executor, all sharing the module's one
optimizer and one state (parameters, aux and optimizer states, step
counter) seeded from the default bucket's executor arrays and updater
states. A superbatch (``SuperBatchIter`` cuts one where the bucket key
changes) runs through its bucket's ``run_steps``; the tail of a bucket run
through its bucket's single ``step`` (:meth:`_try_fused_fit_step`).
``get_params``, ``forward`` and ``save_optimizer_states`` write the shared
state back to the default bucket's arrays (which every bucket's executor
shares) first. An installed monitor, ``inputs_need_grad``, ``state_names``,
a ``grad_req`` other than ``write``/``null`` or an optimizer without a
fused update keep the executor path. Over several contexts every bucket's
module and TrainStep share the default bucket's 'data' mesh of replicas,
and superbatches land split per replica. ``check`` audits every bucket
step's registered programs with the static analyzers as a unit.
"""
from __future__ import annotations

import logging

import torch

from .. import metric as _metric
from ..ndarray import NDArray
from ..tracecheck import RetraceError
from .base_module import BaseModule
from .module import Module, _seed_opt_state


def _tensor(v):
    return v.data if isinstance(v, NDArray) else v


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        # the fused path: one TrainStep per bucket over one shared state
        self._bucket_fused = {}      # bucket_key -> TrainStep
        self._bucket_specs = {}      # bucket_key -> DeviceSumSpec | None
        self._bucket_warned = set()  # bucket keys whose fallback was logged
        self._fused_state = None
        self._fused_outputs = None
        self._fused_dirty = False
        self._fused_params_stale = False
        self._fused_metric = None    # the metric fit resolved specs for
        self._fused_host_step = 0
        self._resume_step = 0

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._bucket_fused = {}
        self._bucket_specs = {}
        self._bucket_warned = set()
        self._fused_state = None
        self._fused_outputs = None
        self._fused_dirty = False
        self._fused_params_stale = False

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._call_sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    @property
    def _device(self):
        return self._base_module._device

    def _call_sym_gen(self, bucket_key):
        res = self._sym_gen(bucket_key)
        if isinstance(res, tuple):
            return res
        return (res, ("data",), ("softmax_label",))

    def _new_module(self, bucket_key):
        symbol, data_names, label_names = self._call_sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context,
                      work_load_list=self._work_load_list,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names)

    # -- params ---------------------------------------------------------
    def get_params(self):
        assert self.params_initialized
        self._sync_fused_to_executor()
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init)
        self._params_dirty = False
        self.params_initialized = True
        # the executor's arrays are authoritative now: the shared fused
        # state is re-seeded from them, never written back over them
        self._fused_params_stale = True
        self._fused_dirty = False

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    # -- bind -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        module = self._new_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False, shared_module=None,
                    grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Switch to a bucket, binding a module that shares the default
        bucket's parameter arrays if the key is new."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            module = self._new_module(bucket_key)
            module.bind(data_shapes, label_shapes, self.for_training,
                        self.inputs_need_grad, force_rebind=False,
                        shared_module=self._buckets[self._default_bucket_key],
                        grad_req="write")
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, "
                                "ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    # -- the fused path -------------------------------------------------
    @property
    def _base_module(self):
        return self._buckets[self._default_bucket_key]

    def _can_bulk_dispatch(self, eval_metric=None):
        """fit's precheck of the fused path: ``(True, None)`` or ``(False,
        why)``. With ``eval_metric`` its device-sum spec must resolve for
        the default bucket's shapes (each bucket's resolves at its first
        dispatch), and the metric is kept for those."""
        base = self._base_module
        opt = base._optimizer
        if not getattr(opt, "fused_supported", False):
            return (False, "optimizer %r has no fused update"
                    % type(opt).__name__)
        if base._monitor_installed:
            return (False, "a monitor needs per-step executor access")
        if self.inputs_need_grad or self._state_names:
            return (False, "inputs_need_grad/state_names need the "
                    "per-step executor path")
        eg = base._exec_group
        for n in eg.param_names:
            if eg.grad_req.get(n, "null") not in ("write", "null"):
                return (False, "grad_req %r needs the per-step executor "
                        "path" % eg.grad_req.get(n))
        if eval_metric is not None:
            _, lshapes, out_shapes = base._bound_shapes()
            if _metric.device_sum_spec(eval_metric, out_shapes,
                                       lshapes) is None:
                return (False, "metric %r declares no device-sum layout "
                        "for the default bucket's shapes — it updates "
                        "per-step on host"
                        % getattr(eval_metric, "name", eval_metric))
            self._fused_metric = eval_metric
            self._bucket_specs = {}
        return True, None

    def _can_guard(self):
        """The guard's sentinels ride the bucket steps, so the guard needs
        what the fused path needs."""
        return self._can_bulk_dispatch()

    def _get_bucket_step(self, bucket_key):
        """The bucket's TrainStep, built from its symbol on first use (no
        executor is bound for it). Every bucket's TrainStep shares the
        module's one optimizer, so the lr schedule's clock advances once a
        step whatever the bucket."""
        ts = self._bucket_fused.get(bucket_key)
        if ts is not None:
            return ts
        from ..train_step import TrainStep
        base = self._base_module
        symbol, data_names, label_names = self._call_sym_gen(bucket_key)
        eg = base._exec_group
        frozen = [n for n in eg.param_names
                  if eg.grad_req.get(n, "null") == "null"]
        ts = TrainStep(symbol, data_names=list(data_names),
                       label_names=list(label_names),
                       optimizer=base._optimizer,
                       frozen_param_names=frozen, device=base._device,
                       mesh=eg._mesh, batch_axes=eg.batch_axes)
        self._bucket_fused[bucket_key] = ts
        return ts

    def _get_bucket_spec(self, bucket_key, ts, super_batch):
        """The kept metric's device-sum spec for this bucket's shapes (kept
        per bucket: the slots are the metric's, the shapes the bucket's)."""
        if bucket_key in self._bucket_specs:
            return self._bucket_specs[bucket_key]
        spec = None
        if self._fused_metric is not None:
            from ..parallel.mesh import batch_axes, shard_shape
            # over a mesh each replica sums its own shard: one replica's
            # shapes
            shapes = {name: tuple(v.shape[1:]) for name, v in zip(
                ts.data_names, super_batch.data)}
            shapes.update((name, tuple(v.shape[1:])) for name, v in zip(
                ts.label_names, super_batch.label or []))
            if ts.mesh is not None:
                _, axes = batch_axes(shapes, ts.batch_axes)
                shapes = {n: shard_shape(s, ts.mesh, axes[n])
                          for n, s in shapes.items()}
            lshapes = [shapes[n] for n in ts.label_names if n in shapes]
            _, out_shapes, _ = ts.symbol.infer_shape(**shapes)
            spec = _metric.device_sum_spec(self._fused_metric, out_shapes,
                                           lshapes)
        self._bucket_specs[bucket_key] = spec
        return spec

    def _warn_bucket_fallback(self, bucket_key, why):
        if bucket_key in self._bucket_warned:
            return
        self._bucket_warned.add(bucket_key)
        self.logger.warning(
            "bucketed dispatch: bucket %r falls back to per-step "
            "training (%s)", bucket_key, why)

    def _superbatch_sharding(self):
        """The default bucket's module's superbatch sharding (every bucket
        shares its contexts)."""
        return self._base_module._superbatch_sharding()

    def _global_batch_scale(self):
        return 1

    def _seed_fused_state(self, ts, prev=None):
        """The one shared state from the default bucket's executor arrays
        (copies). ``prev`` keeps its optimizer states and step counter
        across a parameter re-seed (``set_params``, fit's epoch end);
        without it they come from the updater and the host-side mirror."""
        base = self._base_module
        ex = base._exec_group.executor
        params = {n: ex.arg_dict[n].data.detach().clone()
                  for n in ts.param_names}
        aux = ts.cast_stats({n: ex.aux_dict[n].data.detach().clone()
                             for n in ts.aux_names})
        if prev is not None:
            # whole optimizer states: replicate_state cuts them again
            whole = ts.whole_state(prev)
            return ts.replicate_state(
                {"params": params, "aux": aux, "opt": whole["opt"],
                 "step": whole["step"]})
        opt_state = _seed_opt_state(ts, params, base._optimizer,
                                    base._resolve_updater(),
                                    base._exec_group.param_names)
        # over a mesh: a copy for every other replica
        return ts.replicate_state(
            {"params": params, "aux": aux, "opt": opt_state,
             "step": torch.full((), self._fused_host_step,
                                dtype=torch.int32, device=base._device)})

    def _ensure_fused_state(self, ts):
        """Whether ``ts`` can train the shared state (its parameter set is
        the default bucket's); seeds the state through the default bucket's
        TrainStep when there is none, and re-seeds its parameters when the
        executor's arrays are newer."""
        base_ts = self._get_bucket_step(self._default_bucket_key)
        if set(ts.param_names) != set(base_ts.param_names):
            return False
        if self._fused_state is None:
            self._fused_state = self._seed_fused_state(base_ts)
        elif self._fused_params_stale:
            self._fused_state = self._seed_fused_state(
                base_ts, prev=self._fused_state)
        self._fused_params_stale = False
        return True

    def _fused_bucket(self, key):
        """The bucket's TrainStep over a live shared state, or None when
        the fused path is not open."""
        if not (self.binded and self.params_initialized
                and self.optimizer_initialized):
            return None
        ok, _why = self._can_bulk_dispatch()
        if not ok:
            return None
        from .. import profiler as _profiler
        _profiler.maybe_autostart()
        if key is None:
            key = self._default_bucket_key
        ts = self._get_bucket_step(key)
        if not self._ensure_fused_state(ts):
            self._warn_bucket_fallback(
                key, "its symbol's parameter set differs from the shared "
                "state")
            return None
        return ts

    def _dispatch_fused_steps(self, super_batch, guard=None):
        """fit's K-step path: one ``run_steps`` of the superbatch's bucket
        over the shared state. None when this superbatch trains step by
        step."""
        key = super_batch.bucket_key
        ts = self._fused_bucket(key)
        if ts is None:
            return None
        if key is None:
            key = self._default_bucket_key
        spec = self._get_bucket_spec(key, ts, super_batch)
        if self._fused_metric is not None and spec is None:
            self._warn_bucket_fallback(
                key, "metric %r declares no device-sum layout for this "
                "bucket's shapes"
                % getattr(self._fused_metric, "name", self._fused_metric))
            return None
        feed = {n: _tensor(v) for n, v in zip(ts.data_names,
                                               super_batch.data)}
        feed.update((n, _tensor(v)) for n, v in zip(
            ts.label_names, super_batch.label or []))
        ts.health = guard.health if guard is not None else None
        try:
            self._fused_state, sums = ts.run_steps(
                self._fused_state, feed, guard=guard is not None,
                metric_spec=spec)
        except RetraceError:
            self._adopt_retrace()
            raise
        self._fused_outputs = None
        self._fused_dirty = True
        self._params_dirty = True
        if guard is None:
            # a guarded dispatch advances the mirror when it is retired
            self._fused_host_step += super_batch.num_steps
        return sums

    def _try_fused_fit_step(self, data_batch, guard=None):
        """fit's per-step path (k=1, and the tails of bucket runs): the
        bucket's single fused step over the shared state, so a superbatch
        cut short by a bucket switch never detours through the executor."""
        ts = self._fused_bucket(getattr(data_batch, "bucket_key", None))
        if ts is None:
            return False
        batch = {n: _tensor(v) for n, v in zip(ts.data_names,
                                                data_batch.data)}
        batch.update((n, _tensor(v)) for n, v in zip(
            ts.label_names, data_batch.label or []))
        ts.health = guard.health if guard is not None else None
        try:
            if guard is not None:
                guard.last_step_skipped = False
                self._fused_state, outs, packed = ts.step(
                    self._fused_state, batch, guard=True)
            else:
                self._fused_state, outs = ts.step(self._fused_state, batch)
                self._fused_host_step += 1
        except RetraceError:
            self._adopt_retrace()
            raise
        self._fused_outputs = [NDArray(o) for o in outs]
        self._fused_dirty = True
        self._params_dirty = True
        if guard is not None:
            self._feed_guard_sentinels(guard, packed.cpu().numpy())
        return True

    def _adopt_retrace(self):
        """A RetraceError is raised after the dispatch updated the shared
        state in place: mark it ahead of the executors before
        re-raising."""
        self._fused_outputs = None
        self._fused_dirty = True
        self._params_dirty = True

    # -- rollback and resume hooks --------------------------------------
    def _drop_fused_state(self):
        """Rollback hook: discard the shared state unwritten; the next
        dispatch re-seeds from the restored arrays. The bucket TrainSteps
        stay."""
        self._fused_state = None
        self._fused_outputs = None
        self._fused_dirty = False
        self._fused_params_stale = False

    def _scale_lr(self, factor):
        """Rollback hook: one optimizer serves every bucket."""
        self._base_module._scale_lr(factor)

    def _restore_trainer_clock(self, num_update, fused_step=None):
        """Resume hook: the optimizer clock through the default bucket's
        module, and the shared state's step counter and its mirror."""
        base = self._base_module
        base._restore_trainer_clock(num_update, fused_step)
        self._fused_host_step = base._resume_step
        if self._fused_state is not None:
            self._get_bucket_step(self._default_bucket_key).set_step(
                self._fused_state, self._fused_host_step)

    def load_optimizer_states(self, fname):
        """Restore the updater states through the current module; the
        shared state re-seeds from them at the next dispatch."""
        self._curr_module.load_optimizer_states(fname)
        self._fused_state = None

    def _fused_step_count(self):
        """Checkpoint-manifest hook: the host mirror of the shared step
        counter (never read from the device)."""
        if self._fused_state is None:
            return None
        return int(self._fused_host_step)

    def _sync_fused_to_executor(self):
        """Write the shared parameters and aux states into the default
        bucket's executor arrays, which every bucket's executor shares."""
        if not self._fused_dirty or self._fused_state is None:
            return
        ex = self._base_module._exec_group.executor
        for n, v in self._fused_state["params"].items():
            ex.arg_dict[n]._set_data(v.clone())
        for n, v in self._fused_state["aux"].items():
            ex.aux_dict[n]._set_data(v.clone())
        self._fused_dirty = False

    def _sync_fused_opt_states(self):
        """Mirror the shared optimizer states into the updater's
        index-keyed states, so ``save_optimizer_states`` and an
        imperative ``update()`` after fused training see them."""
        if self._fused_state is None:
            return
        base = self._base_module
        updater = base._resolve_updater()
        if updater is None:
            return

        def to_nd(x):
            if x is None:
                return None
            if isinstance(x, tuple):
                return tuple(to_nd(i) for i in x)
            return NDArray(x.detach().float() if x.dtype == torch.bfloat16
                           else x.detach().clone())

        idx_of = {n: i for i, n in enumerate(base._exec_group.param_names)}
        for n, st in self._fused_state["opt"].items():
            if n in idx_of:
                updater.states[idx_of[n]] = to_nd(st)

    def save_optimizer_states(self, fname):
        self._sync_fused_opt_states()
        return self._curr_module.save_optimizer_states(fname)

    def check(self, memory=False, budget=None, temp_mult=None):
        """Static audit of the bucket steps' programs as a unit:
        ``tracecheck``'s lints over every program each bucket's TrainStep
        registered (its watcher's prefix), plus with ``memory=True`` the
        memory lints per program and one ``resident-set`` finding over
        every bucket's programs (the bucket steps are all kept, so their
        footprints co-reside). A module that never dispatched audits
        nothing."""
        from .. import tracecheck as _tc
        prefixes = [ts._watcher.name + "/"
                    for ts in self._bucket_fused.values()
                    if ts._watcher is not None]
        findings = []
        for p in prefixes:
            findings += _tc.check_registered(match=p)
        if memory:
            from .. import memcheck as _mc
            fs, _reports = _mc.check_registered(
                match=tuple(prefixes), budget=budget, temp_mult=temp_mult,
                resident_name="BucketingModule(%s)"
                % self._default_bucket_key)
            findings += fs
        return findings

    # -- computation ----------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        # an executor forward sees the fused-trained parameters (one write
        # covers every bucket's executor)
        self._sync_fused_to_executor()
        self._fused_outputs = None
        self.switch_bucket(data_batch.bucket_key,
                           data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        if self._fused_state is not None:
            # the executor's arrays and the updater's states take this
            # update: hand them the fused optimizer states first; the next
            # fused step seeds a new shared state from them
            self._sync_fused_opt_states()
            self._fused_state = None
            self._fused_params_stale = False
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        if self._fused_outputs is not None:
            return list(self._fused_outputs)
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        if self._fused_outputs is not None:
            eval_metric.update(labels, self._fused_outputs)
            return
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """Install the monitor on every bucket's executor bound so far."""
        assert self.binded
        for mod in self._buckets.values():
            mod.install_monitor(mon)
