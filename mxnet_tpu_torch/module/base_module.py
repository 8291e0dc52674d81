"""BaseModule: the high-level training interface
(ref: python/mxnet/module/base_module.py).

Counterpart of ``mxnet_tpu/module/base_module.py``: ``forward_backward``,
``score``, ``iter_predict``, ``predict`` and ``fit``. ``fit`` keeps the
JAX package's dispatch structure:

- the per-step path: one fused ``TrainStep.step`` a batch where the module
  allows it (``_try_fused_fit_step``), else ``forward``/``backward``/
  ``update`` through the executor, with the metric updated on the host;
- the K-step path (``steps_per_dispatch=k``): a
  :class:`~mxnet_tpu_torch.data.DevicePrefetcher` stacks K batches, one
  ``TrainStep.run_steps`` a superbatch keeps the metric's declared sums
  on the device, and a :class:`_DispatchPipeline` of depth D reads dispatch
  N's sums back only after dispatch N+D is queued. Metric folds and
  ``batch_end_callback`` run in dispatch order (``_consume``).

Knobs resolve as explicit argument, then environment, then the committed
tuning DB (:func:`mxnet_tpu_torch.autotune.resolve_fit_knobs`, matched on
the module's symbol, batch and device kind), then the built-in default, as
in the JAX package; the log names each knob's source. ``guard=``
(``MXTPU_GUARD``), ``resume=``, ``checkpoint_prefix=``,
``checkpoint_every_n_batches=``, ``checkpoint_async=`` and ``monitor=``
raise naming themselves.
"""
from __future__ import annotations

import logging
import time
from collections import deque

from ..base import MXNetError, env_bool
from .. import autotune as _autotune
from .. import metric as _metric
from .. import ndarray as nd
from ..model import BatchEndParam
from ..obs import flight as _flight
from ..obs import trace as _obs_trace


def _as_list(obj):
    if isinstance(obj, list):
        return obj
    return [obj]


class _DispatchPipeline(object):
    """Deferred-readback window of the K-step dispatches.

    ``run_steps`` returns device-resident sums, and their read-back is the
    loop's one host block. With depth D, ``fit`` queues dispatch N+D before
    it reads dispatch N's sums, so the card has the next dispatch queued
    while the host waits; the sums then fold in dispatch order (FIFO).
    Depth 0 reads each dispatch back at once. ``host_stall`` sums the
    seconds spent blocked in read-backs."""

    __slots__ = ("depth", "_pending", "dispatches", "retired",
                 "host_stall")

    def __init__(self, depth):
        self.depth = max(0, int(depth))
        self._pending = deque()
        self.dispatches = 0
        self.retired = 0
        self.host_stall = 0.0

    def __len__(self):
        return len(self._pending)

    def push(self, sums, nsteps, nbatch, disp=None):
        """Queue one dispatch's sums; returns the ``(sums, nsteps, nbatch,
        disp)`` entries that left the window, read back."""
        if disp is None:
            disp = self.dispatches
        self.dispatches += 1
        self._pending.append((sums, nsteps, nbatch, disp))
        out = []
        while len(self._pending) > self.depth:
            out.append(self._fetch_one())
        return out

    def drain(self):
        """Read back everything still in flight."""
        out = []
        while self._pending:
            out.append(self._fetch_one())
        return out

    def _fetch_one(self):
        sums, nsteps, nbatch, disp = self._pending.popleft()
        t0 = time.perf_counter()
        sums.fetch()
        dt = time.perf_counter() - t0
        _obs_trace.complete("readback_stall", dt, dispatch=disp)
        self.host_stall += dt
        self.retired += 1
        return sums, nsteps, nbatch, disp


class BaseModule(object):
    """Abstract module: forward/backward/update plus the fit, predict and
    score loops."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- high-level loops ----------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Evaluate over ``eval_data`` (ref: base_module.py score)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - pad] for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Run prediction, collecting outputs (ref: base_module.py
        predict)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - pad].copy()
                       for out in self.get_outputs()]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            if any(len(out) != num_outputs for out in output_list):
                raise MXNetError("Cannot merge batches, as num of outputs is "
                                 "not the same in mini-batches. Maybe "
                                 "bucketing is used?")
            output_list2 = [nd.concatenate([out[i] for out in output_list])
                            for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, steps_per_dispatch=None, resume=None,
            checkpoint_prefix=None, checkpoint_every_n_batches=None,
            checkpoint_keep=3, checkpoint_async=None, guard=None,
            dispatch_pipeline=None):
        """The training loop (ref: base_module.py fit).

        ``steps_per_dispatch=k`` (default ``engine.bulk_size()``, 1) trains
        K steps a dispatch over stacked superbatches; ``nbatch`` still
        counts single batches, but ``batch_end_callback`` fires once a
        dispatch. It needs the fused path and a metric with a device-sum
        layout; otherwise fit warns, naming why, and trains with 1.
        ``dispatch_pipeline=d`` (env ``MXTPU_DISPATCH_PIPELINE``, default
        1) defers each dispatch's metric read-back until ``d`` more are
        queued; the folds and callbacks stay in dispatch order.
        """
        if num_epoch is None:
            raise MXNetError("fit: please specify number of epochs")
        for what, val in (("guard", guard), ("resume", resume),
                          ("checkpoint_prefix", checkpoint_prefix),
                          ("checkpoint_every_n_batches",
                           checkpoint_every_n_batches),
                          ("checkpoint_async", checkpoint_async),
                          ("monitor", monitor)):
            if val not in (None, False):
                raise MXNetError("fit(%s=...) is not ported yet" % what)
        if env_bool("MXTPU_GUARD"):
            raise MXNetError("MXTPU_GUARD (fit's training-health guard) is "
                             "not ported yet")
        from ..initializer import Uniform
        if initializer is None:
            initializer = Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        fused_step = getattr(self, "_try_fused_fit_step", None)
        fused_dispatch = getattr(self, "_dispatch_fused_steps", None)
        k, pl_depth, knob_src = _autotune.resolve_fit_knobs(
            self, train_data, steps_per_dispatch, dispatch_pipeline,
            logger=self.logger)
        self.logger.info(
            "Module.fit: steps_per_dispatch=%d (%s), dispatch_pipeline=%d "
            "(%s)", k, knob_src["steps_per_dispatch"], pl_depth,
            knob_src["dispatch_pipeline"])
        if k > 1:
            reason = None
            if fused_dispatch is None:
                reason = "this module has no fused multi-step path"
            elif not hasattr(train_data, "superbatch"):
                reason = "train_data is not a DataIter (no superbatch mode)"
            else:
                ok, why = self._can_bulk_dispatch(eval_metric)
                if not ok:
                    reason = why
            if reason is not None:
                self.logger.warning(
                    "steps_per_dispatch=%d unavailable (%s); training "
                    "with 1", k, reason)
                k = 1
        if k <= 1 or fused_dispatch is None:
            pl_depth = 0    # per-step training reads its outputs anyway
        pipeline = _DispatchPipeline(pl_depth)
        if k > 1:
            from .. import data as _data
            train_iter = _data.DevicePrefetcher(train_data, k,
                                                depth=pl_depth,
                                                device=self._device)
        else:
            train_iter = train_data
        iter_set_epoch = getattr(train_iter, "set_epoch", None)
        if iter_set_epoch is not None:
            iter_set_epoch(begin_epoch)
        data_stats = getattr(train_iter, "stats", None)

        def _consume(entries, epoch):
            """Retire dispatches in dispatch order: fold each one's sums
            into the metric, then fire its batch callback before the next
            fold, so every callback sees the metric as the eager mode
            would at the same nbatch."""
            for sums, nsteps, nb, disp in entries:
                _metric.update_from_device_sums(eval_metric, sums)
                _flight.note("dispatch_retired", dispatch=disp, nbatch=nb,
                             nsteps=nsteps)
                if batch_end_callback is not None:
                    cb_params = BatchEndParam(
                        epoch=epoch, nbatch=nb, eval_metric=eval_metric,
                        locals={"pipeline": pipeline,
                                "eval_metric": eval_metric, "self": self,
                                "data_stats": data_stats})
                    for callback in _as_list(batch_end_callback):
                        callback(cb_params)

        _flight.note("fit_start", epoch=begin_epoch)
        try:
            for epoch in range(begin_epoch, num_epoch):
                tic = time.time()
                eval_metric.reset()
                nbatch = -1
                for data_batch in train_iter:
                    sums = None
                    disp_id = getattr(data_batch, "sb_seq",
                                      pipeline.dispatches)
                    if (k > 1 and getattr(data_batch, "num_steps", 0) == k):
                        # the span is the enqueue; the device runs on and
                        # the read-back is the readback_stall span
                        with _obs_trace.span("dispatch", dispatch=disp_id,
                                             k=k, epoch=epoch):
                            sums = fused_dispatch(data_batch)
                    if sums is not None:
                        nbatch += data_batch.num_steps
                        _consume(pipeline.push(sums, data_batch.num_steps,
                                               nbatch, disp=disp_id), epoch)
                        continue
                    # per-step path, also the epoch tail (num_steps < k):
                    # eager, so whatever is in flight retires first
                    _consume(pipeline.drain(), epoch)
                    batches = (data_batch.unstack()
                               if hasattr(data_batch, "unstack")
                               else [data_batch])
                    for batch in batches:
                        nbatch += 1
                        if fused_step is None or not fused_step(batch):
                            self.forward_backward(batch)
                            self.update()
                        self.update_metric(eval_metric, batch.label)
                    if batch_end_callback is not None:
                        batch_end_params = BatchEndParam(
                            epoch=epoch, nbatch=nbatch,
                            eval_metric=eval_metric, locals=locals())
                        for callback in _as_list(batch_end_callback):
                            callback(batch_end_params)
                _consume(pipeline.drain(), epoch)

                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 time.time() - tic)
                arg_params, aux_params = self.get_params()
                self.set_params(arg_params, aux_params)
                if epoch_end_callback is not None:
                    for callback in _as_list(epoch_end_callback):
                        callback(epoch, self.symbol, arg_params, aux_params)
                if eval_data:
                    res = self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch)
                    for name, val in res:
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)
                if train_iter is train_data or epoch < num_epoch - 1:
                    train_iter.reset()
                else:
                    # last epoch of a superbatch wrapper: stop its producer
                    # and hand back a reset base iterator
                    train_iter.close()
                    train_data.reset()
        finally:
            if train_iter is not train_data:
                train_iter.close()

    # -- symbol / params accessors -------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def save_params(self, fname):
        from ..model import atomic_write_bytes, _param_save_bytes
        arg_params, aux_params = self.get_params()
        atomic_write_bytes(fname, _param_save_bytes(arg_params, aux_params))

    def load_params(self, fname):
        from ..context import cpu
        from ..model import _split_param_dict
        save_dict = nd.load(fname, ctx=cpu())
        arg_params, aux_params = _split_param_dict(save_dict, fname)
        self.set_params(arg_params, aux_params)

    # -- computation API (implemented by subclasses) --------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()

    def install_monitor(self, mon):
        raise NotImplementedError()

    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()
