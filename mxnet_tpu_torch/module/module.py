"""Module: the standard computation module over one symbol
(ref: python/mxnet/module/module.py).

Counterpart of ``mxnet_tpu/module/module.py`` on one device (``cuda:0``
unless ``context=mt.cpu()``): ``bind``, ``init_params``,
``init_optimizer`` with the reference's kvstore rules, ``forward``/
``backward``/``update`` through the executor and the per-index
``Updater``, checkpoints in the JAX package's file layout, and the fused
path that ``fit`` takes where the optimizer has a fused update: the port's
:class:`~mxnet_tpu_torch.train_step.TrainStep` holds its own copy of the
parameters, optimizer states and step count, which ``get_params``,
``save_checkpoint``, ``forward`` and ``score`` write back to the executor
first. The fused path also carries ``fit``'s training guard (the guarded
step, its sentinels fed to the guard), its checkpoints (a host-side mirror
of the fused step counter, decoupled optimizer-state snapshots for the
async writer) and resume (the optimizer clock and the fused step counter
restored). ``compute_dtype`` (the port's own argument) sets the fused
step's compute dtype over float32 masters. ``install_monitor`` takes the
module off the fused path (the monitor reads the executor's op outputs),
and the fused step starts a deferred ``MXNET_PROFILER_AUTOSTART``.
Several contexts (``context=[mt.cpu(i) for i in range(n)]``, or
``MXTPU_DP_DEVICES=n`` without a context) train over a 'data' mesh of
replicas: the executor group splits each batch across them, and the fused
step is a :class:`~mxnet_tpu_torch.train_step.TrainStep` over the group's
mesh, fed superbatches that ``SuperBatchIter`` lands split per replica.
``work_load_list`` is kept and passed on, and the batch splits evenly, as
in the JAX package. ``mesh_axes`` (``"data=2,seq=2"`` or a dict; also
read from ``MXTPU_LM_MESH``, the argument winning) makes the fused step
run over a multi-axis mesh instead of the contexts' 'data' mesh, built
over the module's contexts where it has several (``[mt.gpu(0)] * 4``
puts four positions on one card) and else over every visible device;
``param_shardings`` maps parameter names to partition specs for it
(e.g. the stacked layer weights onto ``P('pipe')``). A dist kvstore
refuses it, as in the JAX package.

Under a dist kvstore (``fit(kvstore="dist_sync")`` in processes started
by ``mxnet_tpu_torch.tools.launch``) each process trains its shard of the
global batch: ``rescale_grad`` is ``1/(batch * num_workers)``, the
kvstore's init broadcasts rank 0's parameters, and the fused step sums
the gradients across the processes through the kvstore's ring once a
step (``TrainStep.dist_reduce``). The legacy ``MXTPU_DIST_TRANSPORT=mesh``
trains through the executor, its kvstore summing over gloo.
"""
from __future__ import annotations

import logging
import math

import torch

from ..base import MXNetError, env_str
from ..context import Context, current_context, resolve_device
from ..initializer import Uniform, InitDesc
from .. import engine as _engine
from .. import metric as _metric
from .. import optimizer as opt
from ..ndarray import NDArray
from ..optimizer import Optimizer
from ..model import (_create_kvstore, _initialize_kvstore,
                     _update_params, _update_params_on_kvstore,
                     apply_optimizer_states, atomic_write_bytes,
                     load_checkpoint)
from ..tracecheck import RetraceError
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup, _name_shape


def _seed_opt_state(ts, params, optimizer, updater, exec_param_names):
    """The optimizer states of a fused state over ``params`` for the
    :class:`~mxnet_tpu_torch.train_step.TrainStep` ``ts``: the updater's
    states where it has them (a load_optimizer_states round trip, or steps
    through the executor), else fresh ones. One recipe for
    ``Module`` and ``BucketingModule``."""
    states = dict(getattr(updater, "states", None) or {})
    idx_of = {n: i for i, n in enumerate(exec_param_names)}

    def leaf(x, like):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(leaf(i, like) for i in x)
        t = x.data if isinstance(x, NDArray) else x
        return t.detach().to(device=like.device, dtype=like.dtype, copy=True)

    out = {}
    for n, v in params.items():
        if n in ts.frozen_param_names:
            continue
        idx = idx_of.get(n)
        if idx is not None and idx in states:
            out[n] = leaf(states[idx], v)
        else:
            out[n] = optimizer.create_fused_state(v)
    return ts.cast_opt_state(out)


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, mesh_axes=None, param_shardings=None,
                 compute_dtype=None):
        super().__init__(logger=logger)
        # the fused step's compute dtype (float32 masters, e.g. bfloat16
        # compute as bench.py main() trains); the JAX package's Module has
        # no such argument and computes in the parameters' dtype, as the
        # executor path here does
        self._compute_dtype = compute_dtype
        # multi-axis mesh training: the spec from the argument, else from
        # MXTPU_LM_MESH; the mesh itself is built at the first fused step
        if mesh_axes is None:
            mesh_axes = env_str("MXTPU_LM_MESH") or None
        if mesh_axes is not None:
            from ..parallel.mesh import parse_mesh_axes
            mesh_axes = parse_mesh_axes(mesh_axes)
        self._mesh_axes = mesh_axes
        self._param_shardings = dict(param_shardings or {})
        self._override_mesh_cache = None
        if context is None:
            context = current_context()
            n_dp = _engine.dp_devices()
            if n_dp > 1:
                # MXTPU_DP_DEVICES=N: a replica on each of the first N
                # devices of the current context's type; an over-ask raises
                # rather than folding replicas onto fewer devices
                from ..context import num_devices
                avail = num_devices(context.device_type)
                if n_dp > avail:
                    raise MXNetError(
                        "MXTPU_DP_DEVICES=%d but only %d %s device(s) are "
                        "visible" % (n_dp, avail, context.device_type))
                context = [Context(context.device_type, i)
                           for i in range(n_dp)]
        if not isinstance(context, (list, tuple)):
            context = [context]
        self._context = [c if isinstance(c, Context) else Context(c)
                         for c in context]
        self._device = resolve_device(self._context[0], "Module")
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        self._work_load_list = work_load_list

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        state_names = list(state_names) if state_names is not None else []
        fixed_param_names = (list(fixed_param_names)
                             if fixed_param_names is not None else [])
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names + state_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = fixed_param_names
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = state_names
        self._output_names = symbol.list_outputs()

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False

        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

        # the fused path: TrainStep and its state, which is ahead of the
        # executor's arrays while _fused_dirty
        self._fused = None
        self._fused_state = None
        self._fused_outputs = None
        self._fused_ok = True
        self._monitor_installed = False
        self._fused_dirty = False
        self._fused_params_stale = False
        self._fused_metrics_ok = False
        # the eval metric's device-sum spec, resolved by _can_bulk_dispatch
        self._fused_metric_spec = None
        # the step count a resumed run's fused state starts from
        self._resume_step = 0
        # host-side mirror of the fused state's step counter, advanced per
        # dispatch (guarded ones when their sentinels are read), so
        # checkpoint manifests never read the device
        self._fused_host_step = 0

    # -- checkpointing --------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over ``prefix``'s symbol with the epoch's parameters
        (and, with ``load_optimizer_states``, its ``.states`` applied at
        ``init_optimizer``)."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        atomic_write_bytes("%s-symbol.json" % prefix,
                           self._symbol.tojson().encode())
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        logging.info("Saved checkpoint to \"%s\"", param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info("Saved optimizer state to \"%s\"", state_name)

    def save_optimizer_states(self, fname):
        """Write the optimizer states; returns the bytes written."""
        assert self.optimizer_initialized
        self._sync_fused_opt_states()
        if self._update_on_kvstore:
            return self._kvstore.save_optimizer_states(fname)
        data = self._updater.get_states()
        atomic_write_bytes(fname, data)
        return data

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            apply_optimizer_states(self._updater.set_states, fname)
        # the fused state's optimizer states are re-seeded from these
        self._fused_state = None

    # -- properties -----------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        """The outputs' shapes, inferred from the bound shapes (the JAX
        package reads them off the outputs, so before a forward it raises
        and SequentialModule cannot bind)."""
        assert self.binded
        return list(zip(self._output_names, self._bound_shapes()[2]))

    # -- params ---------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def _sync_params_from_devices(self):
        self._sync_fused_to_executor()
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None and not (arg_params or aux_params):
            initializer = Uniform(0.01)
        # the values go into the executor's arrays, and the module's dicts
        # name those arrays again: a get_params that synced the fused state
        # left copies in the dicts, and writing into the copies (as the JAX
        # package does) would leave the executor, and the fused state seeded
        # from it, on the old values
        ex = self._exec_group.executor
        self._arg_params = {n: ex.arg_dict[n] for n in self._param_names}
        self._aux_params = {n: ex.aux_dict[n] for n in self._aux_names}
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                cache_arr = cache[name]
                if cache_arr is not arr:
                    cache_arr.copyto(arr)
            else:
                if not allow_missing and initializer is None:
                    raise MXNetError("%s is not presented" % name)
                if initializer is not None:
                    initializer(InitDesc(name, attrs.get(name, {})), arr)

        for name in self._param_names:
            _impl(name, self._arg_params[name], arg_params)
        for name in self._aux_names:
            _impl(name, self._aux_params[name], aux_params)
        self.params_initialized = True
        self._params_dirty = False
        # the executor's arrays are authoritative now: the fused copy is
        # re-seeded from them, never written back over them
        self._fused_params_stale = True
        self._fused_dirty = False

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init)
            return
        if self.params_initialized and not force_init:
            return
        self._exec_group.set_params(arg_params, aux_params)
        self._params_dirty = True
        self.params_initialized = True
        self._fused_params_stale = True
        self._fused_dirty = False

    # -- bind -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        if not for_training:
            assert not inputs_need_grad
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        shared_group = None
        if shared_module is not None:
            assert shared_module.binded and shared_module.params_initialized
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list, data_shapes,
            label_shapes, self._param_names, for_training, inputs_need_grad,
            shared_group, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            state_names=self._state_names)
        if shared_module is not None:
            # the parameter arrays are shared through simple_bind's pool
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)
        if shared_module is not None and shared_module.optimizer_initialized:
            self.borrow_optimizer(shared_module)

    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        self._fused = None
        self._fused_state = None
        self._fused_outputs = None

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        # write the fused state back and drop it: it is shaped for the
        # old batch
        self._sync_fused_to_executor()
        self._fused = None
        self._fused_state = None
        self._fused_outputs = None
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        shapes = dict(_name_shape(d) for d in data_shapes)
        shapes.update(_name_shape(d) for d in (label_shapes or []))
        self._exec_group.executor = self._exec_group.executor.reshape(
            allow_up_sizing=True, **shapes)

    # -- optimizer ------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, "
                                "ignoring init_optimizer")
            return
        # a dirty fused state holds the latest trained weights
        self._sync_fused_to_executor()
        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        batch_size = self._exec_group.batch_size
        if kvstore and "dist" in kvstore.type:
            # each worker's batch is its shard of the global batch
            batch_size *= kvstore.num_workers
        rescale_grad = 1.0 / batch_size
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._exec_group.param_names))
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            assert isinstance(optimizer, Optimizer)
            if optimizer.rescale_grad != rescale_grad:
                self.logger.warning(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size/"
                    "num_workers (%s vs. %s).", optimizer.rescale_grad,
                    rescale_grad)
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=[self._arg_params[n] for n in
                                              self._exec_group.param_names],
                                arg_params=self._arg_params,
                                param_names=self._exec_group.param_names,
                                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        self._fused = None
        self._fused_state = None
        self._fused_ok = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _resolve_updater(self):
        """The updater that applies updates: the kvstore's under
        update_on_kvstore, else the local one."""
        if self._update_on_kvstore and self._kvstore is not None:
            return getattr(self._kvstore, "_updater", None)
        return self._updater

    def _drop_fused_state(self):
        """Rollback hook: discard the fused state without writing it back
        (it holds the diverged parameters and optimizer states); the next
        fused step reseeds from the executor's arrays and the updater's
        states the rollback restored."""
        self._fused_state = None
        self._fused_outputs = None
        self._fused_dirty = False
        self._fused_params_stale = False

    def _refresh_dist_scale(self):
        """Re-form hook: the live worker count changed, and with it the
        global batch behind ``rescale_grad``. Re-derives the scale into
        every optimizer copy (the kvstore's pickled one included) and drops
        the fused TrainStep, built with the old one. Runs before the
        checkpoint's optimizer states are re-applied: ``set_optimizer``
        makes a fresh kvstore updater."""
        kv = self._kvstore
        if kv is None or "dist" not in kv.type:
            return
        rescale = 1.0 / (self._exec_group.batch_size
                         * max(1, kv.num_workers))
        if self._optimizer is not None:
            self._optimizer.rescale_grad = rescale
        upd_opt = getattr(self._resolve_updater(), "optimizer", None)
        if upd_opt is not None and upd_opt is not self._optimizer:
            upd_opt.rescale_grad = rescale
        if self._update_on_kvstore and self._optimizer is not None:
            kv.set_optimizer(self._optimizer)
        self._fused = None
        self._drop_fused_state()

    def _scale_lr(self, factor):
        """Rollback hook: scale the learning rate everywhere the next step
        reads it (the optimizer, its scheduler's base_lr, and the kvstore
        updater's copy of the optimizer)."""
        def scale(opt_):
            opt_.lr *= factor
            if opt_.lr_scheduler is not None:
                opt_.lr_scheduler.base_lr *= factor

        if self._optimizer is not None:
            scale(self._optimizer)
        upd_opt = getattr(self._resolve_updater(), "optimizer", None)
        if upd_opt is not None and upd_opt is not self._optimizer:
            scale(upd_opt)

    def _fused_step_count(self):
        """The fused step counter for checkpoint manifests, from the host
        mirror (never the device); it trails ``num_update`` by the guard's
        skipped steps. None when no fused state is live."""
        if self._fused_state is None:
            return None
        return int(self._fused_host_step)

    def _restore_trainer_clock(self, num_update, fused_step=None):
        """Resume hook: continue the optimizer's update clock (the lr
        schedule) from ``num_update`` and the fused step counter (the noise
        streams, Adam's t) from ``fused_step``; checkpoints without it
        carry only ``num_update``."""
        n = int(num_update or 0)
        self._resume_step = n if fused_step is None else int(fused_step)

        def wind(opt_):
            opt_.num_update = n
            opt_.begin_num_update = n
            opt_._index_update_count = {}

        if self._optimizer is not None:
            wind(self._optimizer)
        updater = self._resolve_updater()
        if updater is not None and getattr(updater, "optimizer",
                                           None) is not None:
            wind(updater.optimizer)
        if self._fused_state is not None:
            self._fused.set_step(self._fused_state, self._resume_step)
            self._fused_host_step = self._resume_step

    def borrow_optimizer(self, shared_module):
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True
        # modules sharing parameter storage keep the executor path
        self._fused_ok = False
        shared_module._fused_ok = False
        shared_module._sync_fused_to_executor()

    # -- fused fast path ------------------------------------------------
    def _fused_eligible(self):
        if not self._fused_ok or self._monitor_installed:
            return False
        if self.inputs_need_grad or self._state_names:
            return False
        if not getattr(self._optimizer, "fused_supported", False):
            return False
        if (self._is_dist_kvstore()
                and getattr(self._kvstore, "_ring", None) is None):
            # the legacy mesh transport sums through the kvstore's push
            # (gloo): the executor path, step by step
            return False
        eg = self._exec_group
        return all(eg.grad_req.get(n, "null") in ("write", "null")
                   for n in eg.param_names)

    def _is_dist_kvstore(self):
        return (self._kvstore is not None
                and "dist" in getattr(self._kvstore, "type", "")
                and getattr(self._kvstore, "num_workers", 1) > 1)

    def _override_mesh(self):
        """The multi-axis mesh ``mesh_axes``/``MXTPU_LM_MESH`` asks for,
        built once over the module's contexts (where it has several), every
        visible card (one card context), or, for one CPU context, every
        position on the CPU; None without a spec."""
        if self._mesh_axes is None:
            return None
        if self._override_mesh_cache is None:
            from ..parallel.mesh import mesh_from_spec
            devs = None
            if len(self._context) > 1:
                devs = [resolve_device(c, "Module") for c in self._context]
            elif self._device.type != "cuda":
                devs = [self._device] * math.prod(
                    self._mesh_axes.values())
            self._override_mesh_cache = mesh_from_spec(self._mesh_axes,
                                                       devs)
        return self._override_mesh_cache

    def _fused_mesh(self):
        """The mesh the fused step runs over: the ``mesh_axes`` override,
        else the executor group's 'data' mesh."""
        om = self._override_mesh()
        if om is not None:
            return om
        return (self._exec_group._mesh
                if self._exec_group is not None else None)

    def _build_fused(self):
        from ..train_step import TrainStep
        eg = self._exec_group
        frozen = [n for n in eg.param_names
                  if eg.grad_req.get(n, "null") == "null"]
        mesh = eg._mesh
        om = self._override_mesh()
        if om is not None:
            if self._is_dist_kvstore():
                raise MXNetError(
                    "mesh_axes/MXTPU_LM_MESH cannot combine with a dist "
                    "kvstore — the multi-axis mesh is single-controller; "
                    "use the global 'data' mesh for dist workers")
            mesh = om
        self._fused = TrainStep(
            self._symbol, data_names=eg.data_names,
            label_names=eg.label_names, optimizer=self._optimizer,
            frozen_param_names=frozen, device=mesh.replica_devices()[0]
            if mesh is not None else self._device,
            compute_dtype=self._compute_dtype, mesh=mesh,
            batch_axes=eg.batch_axes,
            param_shardings=(self._param_shardings or None)
            if mesh is not None else None)
        if self._is_dist_kvstore():
            # each process runs its own step; the cross-process gradient
            # sum is the ring's, once a step (a ring error leaves the
            # pre-dispatch state for the re-form)
            self._fused.dist_reduce = self._kvstore.grad_reduce
        self._fused_state = self._seed_fused_state()
        self._fused_params_stale = False
        self._fused_metrics_ok = self._infer_fused_metrics_ok()

    def _bound_shapes(self, mesh=None):
        """(input-shape dict, label shapes, output shapes) of the bound
        descriptors: what the metric's device-sum spec is resolved
        against; with ``mesh``, one replica's share of them."""
        from ..parallel.mesh import batch_axes, shard_shape
        descs = (list(self._data_shapes or [])
                 + list(self._label_shapes or []))
        shapes = dict(_name_shape(d) for d in descs)
        if mesh is not None:
            _, axes = batch_axes(shapes, self._exec_group.batch_axes)
            shapes = {n: shard_shape(s, mesh, axes[n])
                      for n, s in shapes.items()}
        lshapes = [shapes[_name_shape(d)[0]]
                   for d in (self._label_shapes or [])]
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return shapes, lshapes, out_shapes

    def _superbatch_sharding(self):
        """The sharding ``fit`` hands to ``SuperBatchIter`` so stacked
        superbatches land split per replica (the step axis whole, the batch
        axis over 'data'); None without a mesh."""
        from ..parallel.mesh import AXIS_SEQ, superbatch_sharding
        mesh = self._fused_mesh()
        if mesh is not None and mesh.size(AXIS_SEQ) > 1:
            # every slot a stacked (k, batch, seq) array: the token
            # dimension splits along 'seq' too
            if all(len(_name_shape(d)[1]) >= 2 for d in
                   list(self._data_shapes or [])
                   + list(self._label_shapes or [])):
                return superbatch_sharding(mesh, seq=True)
            return None
        return superbatch_sharding(mesh)

    def _global_batch_scale(self):
        """Factor from this process's samples a second to the global rate:
        the live worker count under a dist kvstore, whose workers each
        iterate their shard of the global batch; else 1 (the port's meshes
        live in one process, whose iterator yields the whole batch)."""
        if self._is_dist_kvstore():
            return int(self._kvstore.num_workers)
        return 1

    def _speed_tokens_per_sample(self):
        """Tokens per sample for throughput reporting: the product of the
        bound label's non-batch dims (an LM label is (batch, seq)
        next-token ids, so seq tokens land per sample); 1 for rank-1
        labels, so ``Speedometer`` appends a tokens/sec figure only to a
        sequence model's lines."""
        lshapes = [_name_shape(d)[1] for d in (self._label_shapes or [])]
        if len(lshapes) == 1 and len(lshapes[0]) > 1:
            return int(math.prod(lshapes[0][1:]))
        return 1

    def _infer_fused_metrics_ok(self):
        """Whether the default device-sum layout (cross-entropy and top-1
        of a single rank-2 output and rank-1 label) fits this module."""
        _, lshapes, out_shapes = self._bound_shapes()
        return (len(out_shapes) == 1 and len(lshapes) == 1
                and len(out_shapes[0]) == 2 and len(lshapes[0]) == 1
                and out_shapes[0][0] == lshapes[0][0])

    def _can_bulk_dispatch(self, eval_metric=None):
        """fit's precheck of the K-step path: ``(True, None)`` or ``(False,
        why)``. With ``eval_metric`` its device-sum spec is resolved
        against the bound shapes and kept for :meth:`_dispatch_fused_steps`."""
        if not self._fused_eligible():
            return (False, "module configuration needs the per-step "
                    "executor path (monitor/grad_req/unfused optimizer/"
                    "shared module)")
        mesh = self._fused_mesh()
        if mesh is not None and self._override_mesh() is not None:
            # the user asked for this mesh: a batch or sequence that does
            # not divide it fails naming the axis, rather than falling
            # back to another program
            from ..parallel.mesh import AXIS_SEQ, data_axis_size
            n = data_axis_size(mesh)
            if self._exec_group.batch_size % n:
                raise MXNetError(
                    "Module(mesh_axes=...): global batch %d does not "
                    "divide the %d-way 'data' mesh axis — the sharded scan "
                    "needs equal per-chip shards"
                    % (self._exec_group.batch_size, n))
            sp = data_axis_size(mesh, AXIS_SEQ)
            if sp > 1:
                for name, shape in self._bound_shapes()[0].items():
                    if len(shape) >= 2 and shape[1] % sp:
                        raise MXNetError(
                            "Module(mesh_axes=...): bound input %r "
                            "sequence dim %d does not divide the %d-way "
                            "'seq' mesh axis — pad the sequence or pick a "
                            "divisible seq_len" % (name, shape[1], sp))
        elif mesh is not None:
            from ..parallel.mesh import (AXIS_DATA, batch_axes,
                                         check_axis_divides)
            shapes = self._bound_shapes()[0]
            _, axes = batch_axes(shapes, self._exec_group.batch_axes)
            try:
                for name, shape in shapes.items():
                    if axes[name] is not None:
                        check_axis_divides(mesh, AXIS_DATA,
                                           shape[axes[name]],
                                           "bound input %r batch dim" % name)
            except MXNetError as e:
                return False, str(e)
        if eval_metric is None:
            if not self._infer_fused_metrics_ok():
                return (False, "the default device metric sums need a "
                        "single (rank-2 output, rank-1 label) head")
            return True, None
        # over a 'data' mesh each replica sums its own shard: one replica's
        # shapes (over other meshes the step sums the whole outputs)
        _, lshapes, out_shapes = self._bound_shapes(
            mesh if mesh is not None and mesh.is_data_only() else None)
        spec = _metric.device_sum_spec(eval_metric, out_shapes, lshapes)
        if spec is None:
            return (False, "metric %r declares no device-sum layout for "
                    "outputs %s / labels %s — it updates per-step on host"
                    % (getattr(eval_metric, "name", eval_metric),
                       [tuple(s) for s in out_shapes],
                       [tuple(s) for s in lshapes]))
        self._fused_metric_spec = spec
        return True, None

    def _can_guard(self):
        """fit's precheck of ``guard=``: the sentinels and the guard's loss
        watch need the fused step and a single classification head, as the
        K-step path does."""
        return self._can_bulk_dispatch()

    def _seed_fused_state(self, prev=None):
        """The fused state from the executor's current arrays (copies; the
        aux states in bfloat16 under ``MXTPU_BF16_STATS``). ``prev`` keeps
        the optimizer states and step count across a parameter re-seed;
        without it the step count starts where a resumed run stopped."""
        ex = self._exec_group.executor
        params = {n: ex.arg_dict[n].data.detach().clone()
                  for n in self._fused.param_names}
        aux = self._fused.cast_stats(
            {n: ex.aux_dict[n].data.detach().clone()
             for n in self._fused.aux_names})
        if prev is not None:
            whole = self._fused.whole_state(prev)
            opt_state, step = whole["opt"], whole["step"]
        else:
            opt_state = self._fused_opt_state(params)
            step = torch.full((), self._resume_step, dtype=torch.int32,
                              device=self._device)
            self._fused_host_step = self._resume_step
        # over a mesh: a copy for every other replica
        return self._fused.replicate_state(
            {"params": params, "aux": aux, "opt": opt_state, "step": step})

    def _fused_opt_state(self, params):
        """The fused optimizer states, seeded from the updater's states
        where it has them (a load_optimizer_states round trip)."""
        return _seed_opt_state(self._fused, params, self._optimizer,
                               self._resolve_updater(),
                               self._exec_group.param_names)

    def _refresh_fused_state(self):
        if self._fused_state is None:
            self._fused_state = self._seed_fused_state()
            self._fused_params_stale = False
        elif self._fused_params_stale:
            self._fused_state = self._seed_fused_state(prev=self._fused_state)
            self._fused_params_stale = False

    def _fused_ready(self):
        """Build the fused TrainStep where the module allows it; False
        when the configuration needs the executor path."""
        if not (self.binded and self.params_initialized
                and self.optimizer_initialized):
            return False
        # a deferred MXNET_PROFILER_AUTOSTART starts at the first dispatch
        from .. import profiler as _profiler
        _profiler.maybe_autostart()
        if self._fused is None:
            if not self._fused_eligible():
                return False
            self._build_fused()
        self._refresh_fused_state()
        return True

    def _batch_dict(self, data_batch):
        eg = self._exec_group
        batch = {n: v.data if isinstance(v, NDArray) else v
                 for n, v in zip(eg.data_names, data_batch.data)}
        if eg.label_names and data_batch.label:
            batch.update((n, v.data if isinstance(v, NDArray) else v)
                         for n, v in zip(eg.label_names, data_batch.label))
        return batch

    def _adopt_retrace_result(self, e):
        """A RetraceError raised after the dispatch ran carries its result:
        adopt the new state before re-raising."""
        if e.result is not None:
            self._fused_state = e.result[0]
            self._fused_outputs = None
            self._fused_dirty = True
            self._params_dirty = True

    def _try_fused_fit_step(self, data_batch, guard=None):
        """fit's per-step fast path: one fused forward, backward and update
        (``TrainStep.step``). False when the configuration needs the
        executor path. With a :class:`~mxnet_tpu_torch.guard.TrainingGuard`
        the guarded step runs, its sentinels go to the guard (the per-step
        path reads the outputs anyway, so this costs no extra wait) and
        ``guard.last_step_skipped`` keeps a skipped batch out of the
        metric."""
        if not self._fused_ready():
            return False
        batch = self._batch_dict(data_batch)
        # retrace events count in this run's health when guarded (the
        # process-wide TRAINING_HEALTH mirrors it)
        self._fused.health = guard.health if guard is not None else None
        try:
            if guard is None:
                self._fused_state, outs = self._fused.step(
                    self._fused_state, batch)
                self._fused_host_step += 1
            else:
                guard.last_step_skipped = False
                self._fused_state, outs, packed = self._fused.step(
                    self._fused_state, batch, guard=True)
        except RetraceError as e:
            self._adopt_retrace_result(e)
            raise
        # outputs computed in a 16-bit compute_dtype reach the host metric
        # and get_outputs as float32 (numpy has no bfloat16)
        self._fused_outputs = [NDArray(o.float() if o.dtype in (
            torch.bfloat16, torch.float16) else o) for o in outs]
        self._fused_dirty = True
        self._params_dirty = True
        if guard is not None:
            self._feed_guard_sentinels(guard, packed.cpu().numpy())
        return True

    def _dispatch_fused_steps(self, super_batch, guard=None):
        """fit's K-step fast path: one ``TrainStep.run_steps`` over a
        stacked superbatch, returning the device-resident
        :class:`~mxnet_tpu_torch.train_step.StepMetrics` without reading it
        back (fit's pipeline retires it in dispatch order, and advances the
        step mirror of a guarded dispatch then). None when the
        configuration needs the per-step path."""
        if not self._fused_ready():
            return None
        spec = self._fused_metric_spec
        if spec is None and not self._fused_metrics_ok:
            return None
        self._fused.health = guard.health if guard is not None else None
        try:
            self._fused_state, sums = self._fused.run_steps(
                self._fused_state, self._batch_dict(super_batch),
                guard=guard is not None, metric_spec=spec)
        except RetraceError as e:
            self._adopt_retrace_result(e)
            raise
        if guard is None:
            self._fused_host_step += super_batch.num_steps
        self._fused_outputs = None   # the outputs stay on the device
        self._fused_dirty = True
        self._params_dirty = True
        return sums

    def _sync_fused_to_executor(self):
        """Write the fused parameters and aux states back into the
        executor's arrays (copies)."""
        if not self._fused_dirty or self._fused_state is None:
            return
        ex = self._exec_group.executor
        # over a sharded mesh: the parameters assembled from their shards
        st = self._fused.whole_state(self._fused_state)
        for n in self._fused.param_names:
            ex.arg_dict[n]._set_data(st["params"][n].to(
                ex.arg_dict[n].data.device, copy=True))
        for n in self._fused.aux_names:
            # _set_data casts bfloat16 moving statistics (MXTPU_BF16_STATS)
            # back to the executor's float32, exactly
            ex.aux_dict[n]._set_data(st["aux"][n].to(
                ex.aux_dict[n].data.device, copy=True))
        self._fused_dirty = False

    def _sync_fused_opt_states(self):
        """Mirror the fused optimizer states into the updater's index-keyed
        dict, so save_optimizer_states writes them."""
        if self._fused_state is None:
            return
        updater = self._resolve_updater()
        if updater is None:
            return

        def to_nd(x):
            if x is None:
                return None
            if isinstance(x, tuple):
                return tuple(to_nd(i) for i in x)
            # bfloat16 states (MXTPU_BF16_STATS=opt) are written as float32:
            # the file format stays, and the round trip is exact
            if x.dtype == torch.bfloat16:
                return NDArray(x.detach().float())
            return NDArray(x.detach().clone())

        idx_of = {n: i for i, n in enumerate(self._exec_group.param_names)}
        for n, st in self._fused.whole_state(
                self._fused_state)["opt"].items():
            if n in idx_of:
                updater.states[idx_of[n]] = to_nd(st)

    def _snapshot_opt_states(self):
        """The optimizer states for the async checkpoint writer: device
        copies taken now (later steps update the states in place), and a
        callable that pickles them on the writer thread, the bytes
        ``save_optimizer_states`` writes. None when the kvstore holds the
        states (the manager then saves synchronously)."""
        if not self.optimizer_initialized or self._update_on_kvstore:
            return None
        self._sync_fused_opt_states()
        updater = self._resolve_updater()
        if updater is None:
            return None

        def cp(x):
            if isinstance(x, tuple):
                return tuple(cp(i) for i in x)
            return x.copy() if isinstance(x, NDArray) else x

        states = {k: cp(v) for k, v in updater.states.items()}
        return lambda: opt.Updater.serialize_states(states)

    # -- computation ----------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._sync_fused_to_executor()
        self._fused_outputs = None
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Apply the gradients through the per-index updater (or the
        kvstore)."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        # the executor's weights change here: a live fused state is stale
        self._fused_params_stale = True
        param_names = self._exec_group.param_names
        exec_ = self._exec_group.executor
        param_arrays = [exec_.arg_dict[n] for n in param_names]
        grad_arrays = [exec_.grad_dict.get(n) for n in param_names]
        if self._update_on_kvstore:
            _update_params_on_kvstore(param_arrays, grad_arrays,
                                      self._kvstore)
        else:
            _update_params(param_arrays, grad_arrays, updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        if self._fused_outputs is not None:
            return list(self._fused_outputs)
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        if self._fused_outputs is not None:
            eval_metric.update(labels, self._fused_outputs)
        else:
            self._exec_group.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """Install a :class:`~mxnet_tpu_torch.monitor.Monitor` on the
        executor; the module then trains through the executor, which calls
        the monitor on every op output (the fused step runs none)."""
        assert self.binded
        self._sync_fused_to_executor()
        self._monitor_installed = True
        mon.install(self._exec_group.executor)
