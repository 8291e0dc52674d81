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
  ``batch_end_callback`` run in dispatch order (``_consume``);
- fault tolerance: ``checkpoint_prefix`` writes checkpoints through a
  :class:`~mxnet_tpu_torch.model.CheckpointManager` at every epoch end and
  every ``checkpoint_every_n_batches`` batches (on a dispatch boundary),
  on a background writer with ``checkpoint_async``; ``resume="auto"``
  restores the newest valid one and fast-forwards the iterator; SIGTERM
  seals an emergency checkpoint and raises
  :class:`~mxnet_tpu_torch.base.TrainingPreemptedError`;
- the training guard (``guard=``, ``MXTPU_GUARD``): guarded steps skip
  non-finite batches on the device, and a diverging loss rolls back to the
  newest known-good checkpoint with the learning rate scaled down
  (:mod:`~mxnet_tpu_torch.guard`);
- elastic distributed training (a dist kvstore): every dispatch runs
  eagerly (no deferred read-back), each batch feeds the kvstore's
  dead-node health check (warn, emergency checkpoint, then
  :class:`~mxnet_tpu_torch.kvstore.WorkerLostError`), and a lost worker
  makes the survivors seal an emergency checkpoint, re-form the ring at
  N-1, adopt the leader's newest checkpoint, re-derive the gradient
  rescale and their data shards (``train_data.reshard_workers(index,
  size)``) and resume; a late worker is admitted at an epoch boundary.

Knobs resolve as explicit argument, then environment, then the committed
tuning DB (:func:`mxnet_tpu_torch.autotune.resolve_fit_knobs`, matched on
the module's symbol, batch and device kind), then the built-in default, as
in the JAX package; the log names each knob's source. ``monitor=``
installs a :class:`~mxnet_tpu_torch.monitor.Monitor` and trains step by
step through the executor, with ``tic``/``toc_print`` around each batch.
"""
from __future__ import annotations

import logging
import os
import signal
import threading
import time
from collections import deque

from ..base import MXNetError, TrainingPreemptedError, env_bool, env_float
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

    def discard(self):
        """Drop the dispatches in flight unread (a divergence rollback:
        they cover the state being abandoned)."""
        self._pending.clear()

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

        ``checkpoint_prefix`` (a path prefix or a
        :class:`~mxnet_tpu_torch.model.CheckpointManager`) checkpoints at
        each epoch end and every ``checkpoint_every_n_batches`` batches
        (at a dispatch boundary), keeping the last ``checkpoint_keep``;
        ``checkpoint_async=True`` (env ``MXTPU_ASYNC_CKPT``) writes them on
        a background thread, the loop paying only for device copies and
        waiting at epoch ends, rollbacks and teardown. ``resume="auto"``
        restores the newest valid checkpoint (parameters, aux and optimizer
        states, the update clock, the random state, the metric's partial
        sums) and fast-forwards the iterator past the batches it holds, so
        a killed run continues bit for bit. With a manager, SIGTERM (unless
        ``MXTPU_SIGTERM_GRACEFUL_OFF``) seals an emergency checkpoint at
        the next batch boundary and raises
        :class:`~mxnet_tpu_torch.base.TrainingPreemptedError`, or exits
        with 124 after ``MXTPU_SIGTERM_DEADLINE`` seconds (30).

        ``guard=True``, a :class:`~mxnet_tpu_torch.guard.TrainingGuard`,
        or ``MXTPU_GUARD=1`` trains through guarded steps: non-finite steps
        are no-ops on the device and counted in ``guard.health``; on
        divergence fit rolls back to the newest known-good checkpoint with
        the lr scaled by ``guard.lr_factor``, and raises
        :class:`~mxnet_tpu_torch.guard.TrainingDivergedError` once
        ``guard.max_rollbacks`` is spent or there is nothing to roll back
        to. It needs the fused path; otherwise fit warns and trains
        unguarded.
        """
        if num_epoch is None:
            raise MXNetError("fit: please specify number of epochs")
        from ..initializer import Uniform
        from ..model import CheckpointManager
        ckpt_mgr = None
        resume_state = None
        if checkpoint_prefix is not None:
            if isinstance(checkpoint_prefix, CheckpointManager):
                ckpt_mgr = checkpoint_prefix
            else:
                ckpt_mgr = CheckpointManager(checkpoint_prefix,
                                             keep=checkpoint_keep,
                                             logger=self.logger)
        if resume in ("auto", True):
            if ckpt_mgr is None:
                raise MXNetError("fit(resume=%r) requires checkpoint_prefix"
                                 % (resume,))
            resume_state = ckpt_mgr.load_latest()
            if resume_state is None:
                self.logger.info("resume='auto': no valid checkpoint under "
                                 "%r, starting fresh", checkpoint_prefix)
            else:
                self.logger.info(
                    "resuming from checkpoint %s (epoch %d, %d batches "
                    "done)", resume_state.tag, resume_state.epoch,
                    resume_state.batches_done)
                arg_params = resume_state.arg_params
                aux_params = resume_state.aux_params
                force_init = True
                begin_epoch = resume_state.epoch
        elif resume not in (None, False):
            raise MXNetError("resume must be 'auto' or None, got %r"
                             % (resume,))
        if initializer is None:
            initializer = Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if resume_state is not None:
            self._apply_resume_state(resume_state)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        from ..guard import TrainingGuard, _DivergenceRollback
        if guard is None and env_bool("MXTPU_GUARD"):
            guard = True
        if guard in (None, False):
            guard = None
        else:
            if not isinstance(guard, TrainingGuard):
                guard = TrainingGuard(logger=self.logger)
            can = getattr(self, "_can_guard", None)
            ok, why = (can() if can is not None
                       else (False, "this module has no fused guard "
                             "support"))
            if not ok:
                self.logger.warning(
                    "guard: training-health guardrails unavailable (%s); "
                    "training UNGUARDED", why)
                guard = None
            elif ckpt_mgr is None:
                self.logger.warning(
                    "guard: no checkpoint_prefix — divergence cannot roll "
                    "back and will raise TrainingDivergedError")

        # the async writer is made after the guard, so that shed saves count
        # into this run's health
        writer_owned = False
        if ckpt_mgr is not None:
            if checkpoint_async is None:
                checkpoint_async = env_bool("MXTPU_ASYNC_CKPT")
            if checkpoint_async and ckpt_mgr.async_writer is None:
                from ..model import AsyncCheckpointWriter
                from .. import guard as _guard_mod
                ckpt_mgr.async_writer = AsyncCheckpointWriter(
                    logger=self.logger,
                    health=(guard.health if guard is not None
                            else _guard_mod.TRAINING_HEALTH))
                writer_owned = True

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
            if monitor is not None:
                reason = "a monitor needs per-step executor access"
            elif fused_dispatch is None:
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
        if getattr(self, "_is_dist_kvstore", lambda: False)():
            # every dist dispatch already waits on the cross-process sum,
            # so a peer's failure surfaces at its dispatch; deferred
            # read-backs would only widen the state a re-form discards
            pl_depth = 0
        pipeline = _DispatchPipeline(pl_depth)
        if k > 1:
            from .. import data as _data
            # over a mesh, superbatches land split per replica
            sharding = getattr(self, "_superbatch_sharding", None)
            train_iter = _data.DevicePrefetcher(
                train_data, k, depth=pl_depth, device=self._device,
                sharding=sharding() if sharding is not None else None)
        else:
            train_iter = train_data
        # a resumed run re-derives the data order of its absolute epoch
        iter_set_epoch = getattr(train_iter, "set_epoch", None)
        if iter_set_epoch is not None:
            iter_set_epoch(begin_epoch)
        data_stats = (getattr(train_iter, "stats", None)
                      or getattr(train_iter, "data_stats", None))
        note_retired = getattr(self, "_note_dispatch_retired", None)

        def _consume(entries, epoch):
            """Retire dispatches in dispatch order: fold each one's sums
            into the metric and the guard, then fire its batch callback
            before the next fold, so every callback sees the metric as the
            eager mode would at the same nbatch."""
            for sums, nsteps, nb, disp in entries:
                _metric.update_from_device_sums(eval_metric, sums)
                if guard is not None:
                    guard.on_dispatch(loss_sum=sums.loss_sum,
                                      nsamp=sums.num_samples,
                                      skipped=sums.skipped,
                                      grad_norm=sums.last_grad_norm,
                                      nsteps=nsteps)
                if note_retired is not None:
                    note_retired(sums, nsteps)
                _flight.note("dispatch_retired", dispatch=disp, nbatch=nb,
                             nsteps=nsteps)
                if batch_end_callback is not None:
                    cb_params = BatchEndParam(
                        epoch=epoch, nbatch=nb, eval_metric=eval_metric,
                        locals={"guard": guard, "pipeline": pipeline,
                                "eval_metric": eval_metric, "self": self,
                                "data_stats": data_stats})
                    for callback in _as_list(batch_end_callback):
                        callback(cb_params)

        from ..kvstore import WorkerLostError as _WorkerLost
        _flight.note("fit_start", epoch=begin_epoch)
        # graceful preemption: SIGTERM only sets a flag, checked once a loop
        # iteration (never mid-dispatch), and starts a hard deadline after
        # which the process exits; installed with a manager to seal the
        # emergency checkpoint into, and only on the main thread
        preempt = None
        prev_sigterm = None
        if (ckpt_mgr is not None
                and not env_bool("MXTPU_SIGTERM_GRACEFUL_OFF")
                and threading.current_thread() is threading.main_thread()):
            preempt = {"flag": False, "timer": None}
            deadline_s = env_float("MXTPU_SIGTERM_DEADLINE", 30.0)

            def _on_sigterm(signum, frame, _p=preempt, _d=deadline_s):
                if _p["flag"]:
                    return
                _p["flag"] = True
                t = threading.Timer(_d, os._exit, args=(124,))
                t.daemon = True
                t.start()
                _p["timer"] = t
            prev_sigterm = signal.getsignal(signal.SIGTERM)
            signal.signal(signal.SIGTERM, _on_sigterm)
        try:
            epoch = begin_epoch
            while epoch < num_epoch:
                tic = time.time()
                eval_metric.reset()
                nbatch = -1
                since_ckpt = 0
                resume_skip = 0
                if (resume_state is not None
                        and epoch == resume_state.epoch
                        and resume_state.batches_done > 0):
                    # mid-epoch resume (or rollback): replay the metric's
                    # partial sums and skip the batches already trained
                    resume_skip = resume_state.batches_done
                    self._restore_metric_state(eval_metric,
                                               resume_state.metric_state)
                    self.logger.info("resume: fast-forwarding %d batches "
                                     "of epoch %d", resume_skip, epoch)
                try:
                    for data_batch in train_iter:
                        tail_batches = None
                        stepped_eager = False
                        if resume_skip > 0:
                            n = getattr(data_batch, "num_steps", 1)
                            if n <= resume_skip:
                                resume_skip -= n
                                nbatch += n
                                continue
                            # the checkpoint cut a superbatch (k changed
                            # between runs): train its tail step by step
                            tail_batches = data_batch.unstack()[resume_skip:]
                            nbatch += resume_skip
                            resume_skip = 0
                        if monitor is not None:
                            monitor.tic()
                        sums = None
                        disp_id = getattr(data_batch, "sb_seq",
                                          pipeline.dispatches)
                        if (tail_batches is None and k > 1
                                and getattr(data_batch, "num_steps", 0) == k):
                            # the span is the enqueue; the device runs on and
                            # the read-back is the readback_stall span
                            with _obs_trace.span("dispatch", dispatch=disp_id,
                                                 k=k, epoch=epoch):
                                sums = fused_dispatch(data_batch, guard)
                        if sums is not None:
                            nbatch += data_batch.num_steps
                            since_ckpt += data_batch.num_steps
                            _consume(pipeline.push(sums, data_batch.num_steps,
                                                   nbatch, disp=disp_id),
                                     epoch)
                        else:
                            # per-step path, also the epoch tail (num_steps
                            # < k): eager, so whatever is in flight retires
                            # first
                            _consume(pipeline.drain(), epoch)
                            if tail_batches is None:
                                tail_batches = (data_batch.unstack()
                                                if hasattr(data_batch,
                                                           "unstack")
                                                else [data_batch])
                            for batch in tail_batches:
                                nbatch += 1
                                since_ckpt += 1
                                if guard is not None:
                                    guard.last_step_skipped = False
                                if (monitor is not None or fused_step is None
                                        or not fused_step(batch, guard)):
                                    self.forward_backward(batch)
                                    self.update()
                                # a skipped step adds nothing to the metric
                                if (guard is None
                                        or not guard.last_step_skipped):
                                    self.update_metric(eval_metric,
                                                       batch.label)
                            stepped_eager = True
                        if monitor is not None:
                            monitor.toc_print()
                        if guard is not None and guard.diverged:
                            # a diverged state is never sealed
                            raise _DivergenceRollback()
                        if (ckpt_mgr is not None
                                and checkpoint_every_n_batches
                                and since_ckpt >= checkpoint_every_n_batches):
                            # sealing needs every sentinel of the state it
                            # seals: drain, check again, then ask the guard
                            _consume(pipeline.drain(), epoch)
                            if guard is not None and guard.diverged:
                                raise _DivergenceRollback()
                            if guard is None or guard.ok_to_checkpoint():
                                # a state inside a loss spike is deferred,
                                # so the newest known-good one predates it
                                with _obs_trace.span("checkpoint",
                                                     dispatch=disp_id,
                                                     epoch=epoch,
                                                     nbatch=nbatch + 1):
                                    ckpt_mgr.save(self, epoch, nbatch + 1,
                                                  metric=eval_metric)
                                since_ckpt = 0
                        self._check_worker_health(
                            ckpt_mgr, eval_metric, epoch, nbatch,
                            drain_pipeline=lambda e=epoch: _consume(
                                pipeline.drain(), e),
                            guard=guard)
                        if preempt is not None and preempt["flag"]:
                            _consume(pipeline.drain(), epoch)
                            self._graceful_preempt(preempt, ckpt_mgr, guard,
                                                   eval_metric, epoch, nbatch)
                        if stepped_eager and batch_end_callback is not None:
                            batch_end_params = BatchEndParam(
                                epoch=epoch, nbatch=nbatch,
                                eval_metric=eval_metric, locals=locals())
                            for callback in _as_list(batch_end_callback):
                                callback(batch_end_params)
                    # epoch end: everything in flight retires before the
                    # epoch is sealed, and a divergence in those last
                    # sentinels still rolls back
                    _consume(pipeline.drain(), epoch)
                    if guard is not None and guard.diverged:
                        raise _DivergenceRollback()
                except _DivergenceRollback:
                    # restore the newest known-good checkpoint and re-enter
                    # the epoch loop at its cursor, as a resume; dispatches
                    # in flight cover the abandoned state and are dropped
                    _obs_trace.instant("divergence", epoch=epoch,
                                       nbatch=nbatch,
                                       reason=guard.diverged_reason)
                    pipeline.discard()
                    resume_state = self._guard_rollback(guard, ckpt_mgr)
                    epoch = resume_state.epoch
                    train_iter.reset()
                    if iter_set_epoch is not None:
                        iter_set_epoch(epoch)
                    continue
                except _WorkerLost as wle:
                    # a peer died mid-epoch: drop the dispatches in flight
                    # (their cross-worker sums never completed), re-form
                    # and re-enter the epoch loop as a resume
                    _obs_trace.instant("worker_lost", epoch=epoch,
                                       nbatch=nbatch)
                    pipeline.discard()
                    resume_state = self._elastic_reform(
                        wle, ckpt_mgr, guard, eval_metric, epoch, nbatch,
                        train_data)
                    epoch = resume_state.epoch
                    train_iter.reset()
                    if iter_set_epoch is not None:
                        iter_set_epoch(epoch)
                    continue

                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 time.time() - tic)
                if guard is not None:
                    h = guard.health.report()
                    if h["skipped"] or h["rollbacks"]:
                        self.logger.info(
                            "Epoch[%d] TrainingHealth: skipped=%d "
                            "rollbacks=%d divergences=%d last_grad_norm=%s",
                            epoch, h["skipped"], h["rollbacks"],
                            h["divergences"], h["last_grad_norm"])
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
                if ckpt_mgr is not None and (guard is None
                                             or guard.ok_to_checkpoint()):
                    # the epoch-end checkpoint points at the next epoch's
                    # start; an in-flight cadence save lands first (so this
                    # one is never shed), and it is on disk before the next
                    # epoch starts
                    ckpt_mgr.drain()
                    with _obs_trace.span("checkpoint", epoch=epoch + 1,
                                         nbatch=0):
                        ckpt_mgr.save(self, epoch + 1, 0)
                    ckpt_mgr.drain()
                # the epoch boundary is the only admission point for late
                # workers: a mid-epoch join would change the gradient's
                # denominator between checkpoints
                self._admit_dist_joiners(ckpt_mgr, train_data)
                if train_iter is train_data or epoch < num_epoch - 1:
                    train_iter.reset()
                else:
                    # last epoch of a superbatch wrapper: stop its producer
                    # and hand back a reset base iterator
                    train_iter.close()
                    train_data.reset()
                epoch += 1
        finally:
            if preempt is not None:
                signal.signal(signal.SIGTERM, prev_sigterm)
                if preempt["timer"] is not None:
                    preempt["timer"].cancel()
            if ckpt_mgr is not None and ckpt_mgr.async_writer is not None:
                # the in-flight save lands before fit returns; a writer fit
                # made is closed and detached (its counters stay on
                # last_async_writer), a caller's is only drained
                if writer_owned:
                    w = ckpt_mgr.async_writer
                    w.close()
                    ckpt_mgr.async_writer = None
                    ckpt_mgr.last_async_writer = w
                else:
                    ckpt_mgr.async_writer.drain()
            if train_iter is not train_data:
                train_iter.close()

    # -- fused-dispatch and fault-tolerance hooks -------------------------
    def _note_dispatch_retired(self, sums, nsteps):
        """Advance the fused step mirror of a guarded dispatch once its
        sentinels are read (skipped steps do not count); an unguarded
        dispatch advanced it when it was queued."""
        if getattr(sums, "guarded", False):
            self._fused_host_step += int(nsteps) - sums.skipped

    def _feed_guard_sentinels(self, guard, sent):
        """One guarded single step's host side: advance the step mirror
        (a skip does not count), feed the ``[loss, correct, nsamp, skipped,
        grad_norm]`` sentinels to the guard and tell fit whether the batch
        was skipped."""
        self._fused_host_step += 1 - int(sent[3] > 0)
        guard.on_dispatch(loss_sum=float(sent[0]), nsamp=float(sent[2]),
                          skipped=float(sent[3]),
                          grad_norm=float(sent[4]), nsteps=1)
        guard.last_step_skipped = bool(sent[3] > 0)

    def _graceful_preempt(self, preempt, ckpt_mgr, guard, eval_metric,
                          epoch, nbatch):
        """Honour a SIGTERM (the pipeline already drained): seal an
        emergency checkpoint with the async writer drained on both sides,
        dump the flight recorder, cancel the deadline and raise
        :class:`TrainingPreemptedError`. The checkpoint's cursor is
        ``nbatch + 1``, newer than the last cadence save."""
        tag = None
        if ckpt_mgr is not None and (guard is None
                                     or guard.ok_to_checkpoint()):
            ckpt_mgr.drain()
            with _obs_trace.span("checkpoint", epoch=epoch,
                                 nbatch=nbatch + 1, preempt=True):
                ckpt_mgr.save(self, epoch, nbatch + 1, metric=eval_metric)
            ckpt_mgr.drain()
            tag = "e%04d-b%08d" % (epoch, nbatch + 1)
        self.logger.warning(
            "SIGTERM: graceful preemption — emergency checkpoint %s sealed "
            "at epoch %d batch %d; re-launch with resume='auto' to "
            "continue", tag or "(none: guard mid-spike or no manager)",
            epoch, nbatch + 1)
        _flight.dump("TrainingPreemptedError: SIGTERM preemption",
                     extra={"epoch": epoch, "nbatch": nbatch, "tag": tag})
        if preempt["timer"] is not None:
            preempt["timer"].cancel()
        raise TrainingPreemptedError(
            "training preempted by SIGTERM at epoch %d batch %d "
            "(emergency checkpoint: %s) — resume='auto' continues from it"
            % (epoch, nbatch + 1, tag), epoch=epoch,
            batches_done=nbatch + 1, tag=tag)

    def _guard_rollback(self, guard, ckpt_mgr):
        """Divergence recovery: restore the newest known-good checkpoint,
        its trainer clock and random state, scale the lr by
        ``guard.lr_factor`` and return the restored cursor to fit's epoch
        loop. Raises :class:`~mxnet_tpu_torch.guard.TrainingDivergedError`
        when the rollback budget is spent or nothing safe exists."""
        from ..guard import TrainingDivergedError

        def _diverged(msg):
            _flight.dump("TrainingDivergedError: %s" % msg,
                         extra={"health": guard.health.report()})
            return TrainingDivergedError(msg, health=guard.health)

        if guard.health.rollbacks >= guard.max_rollbacks:
            raise _diverged(
                "training diverged again after %d rollback(s) "
                "(max_rollbacks=%d): %s"
                % (guard.health.rollbacks, guard.max_rollbacks,
                   guard.diverged_reason))
        if ckpt_mgr is None:
            raise _diverged(
                "training diverged (%s) and fit() has no checkpoint_prefix "
                "to roll back to — configure checkpoints or lower the lr"
                % (guard.diverged_reason,))
        # the search must see the newest async save whole on disk
        ckpt_mgr.drain()
        st = ckpt_mgr.load_latest()
        if st is None:
            raise _diverged(
                "training diverged (%s) and no known-good checkpoint "
                "exists under %r" % (guard.diverged_reason,
                                     ckpt_mgr.prefix))
        self.logger.warning(
            "TrainingGuard: rolling back to known-good checkpoint %s "
            "(epoch %d, %d batches done), reducing lr by x%g",
            st.tag, st.epoch, st.batches_done, guard.lr_factor)
        self.init_params(initializer=None, arg_params=st.arg_params,
                         aux_params=st.aux_params, allow_missing=False,
                         force_init=True)
        # the diverged fused state (its optimizer states poisoned) goes
        # before the checkpoint's is restored
        self._drop_fused_state()
        self._apply_resume_state(st)
        self._scale_lr(guard.lr_factor)
        _flight.dump("guard rollback to %s (%s)"
                     % (st.tag, guard.diverged_reason),
                     extra={"health": guard.health.report(),
                            "rollback_tag": st.tag,
                            "rollback_epoch": st.epoch})
        guard.note_rollback(st.tag)
        return st

    def _elastic_reform(self, err, ckpt_mgr, guard, eval_metric, epoch,
                        nbatch, train_data=None):
        """Worker-loss recovery: the survivors seal a durable emergency
        checkpoint, re-form the control-plane ring at N-1, adopt one
        authoritative state (the leader's newest checkpoint: survivors
        can be one step apart at the failure), re-derive the gradient
        rescale and this worker's data shard, and hand ``fit`` a resume
        cursor. Raises :class:`~mxnet_tpu_torch.kvstore.WorkerLostError`
        (with a flight dump) when the re-form budget
        (``MXTPU_KV_MAX_REFORMS``) is spent or the store cannot re-form."""
        from ..kvstore import WorkerLostError
        kv = getattr(self, "_kvstore", None)
        if kv is None or getattr(kv, "reform", None) is None \
                or ckpt_mgr is None:
            why = ("fit() has no checkpoint_prefix to recover through"
                   if kv is not None and ckpt_mgr is None
                   else "kvstore has no elastic re-form support")
            _flight.dump("WorkerLostError: %s" % err, extra={"elastic": why})
            raise err
        max_reforms = int(getattr(kv, "max_reforms", 0))
        if int(getattr(kv, "reforms", 0)) >= max_reforms:
            _flight.dump("WorkerLostError: re-form budget exhausted",
                         extra={"reforms": int(kv.reforms),
                                "max_reforms": max_reforms,
                                "liveness": kv.liveness_table()})
            raise WorkerLostError(
                "worker lost and the re-form budget is exhausted (%d "
                "re-form(s) this run, MXTPU_KV_MAX_REFORMS=%d): %s"
                % (kv.reforms, max_reforms, err)) from err
        self.logger.warning(
            "worker lost (%s): re-forming the ring (re-form %d/%d)",
            err, int(kv.reforms) + 1, max_reforms)
        # 1. this survivor's own durable emergency checkpoint before any
        # more ring traffic: if the re-form fails, the run stays resumable
        ckpt_mgr.drain()
        if guard is None or guard.ok_to_checkpoint():
            ckpt_mgr.save(self, epoch, nbatch + 1, metric=eval_metric)
        ckpt_mgr.drain()
        # 2. re-form at N-1 (plus any joiners already waiting)
        kv.reform()
        # 3. one authoritative state for the new ring
        st = self._adopt_leader_checkpoint(kv, ckpt_mgr)
        self.init_params(initializer=None, arg_params=st.arg_params,
                         aux_params=st.aux_params, allow_missing=False,
                         force_init=True)
        self._drop_fused_state()
        # the rescale before the optimizer states: set_optimizer makes a
        # fresh kvstore updater, which the resume state then fills
        self._refresh_dist_scale()
        self._apply_resume_state(st)
        self._reshard_train_data(kv, train_data)
        _flight.dump(
            "ring re-formed at %d worker(s), resuming from %s"
            % (kv.num_workers, st.tag),
            extra={"liveness": kv.liveness_table(),
                   "reforms": int(kv.reforms), "resume_tag": st.tag,
                   "resume_epoch": st.epoch,
                   "batches_done": st.batches_done})
        self.logger.warning(
            "ring re-formed: %d worker(s) (this rank now index %d), "
            "resuming from %s (epoch %d, %d batches done)",
            kv.num_workers, kv.worker_index, st.tag, st.epoch,
            st.batches_done)
        return st

    def _adopt_leader_checkpoint(self, kv, ckpt_mgr):
        """Broadcast the leader's newest checkpoint bytes over the ring
        and install and load them on every member, so the re-formed
        replicas are bitwise identical (and a fresh resume from the same
        prefix reproduces this state)."""
        payload = b""
        if kv.worker_index == 0:
            payload = ckpt_mgr.export_latest()
        blob = kv.broadcast_bytes(payload)
        if kv.worker_index != 0 and blob:
            ckpt_mgr.import_blob(blob)
        st = ckpt_mgr.load_latest()
        if st is None:
            raise MXNetError(
                "ring re-form: no loadable checkpoint after the leader "
                "broadcast (prefix %r)" % (ckpt_mgr.prefix,))
        return st

    def _reshard_train_data(self, kv, train_data):
        """This worker's data shard from its new (index, size) after a
        membership change, through ``train_data.reshard_workers``; other
        iterators keep their shard (correct but overlapping, so the run
        says so)."""
        if train_data is None:
            return
        reshard = getattr(train_data, "reshard_workers", None)
        if reshard is not None:
            reshard(kv.worker_index, kv.num_workers)
        else:
            self.logger.warning(
                "train_data has no reshard_workers(index, size): keeping "
                "the pre-reform shard (the dead worker's shard is not "
                "redistributed this run)")

    def _admit_dist_joiners(self, ckpt_mgr, train_data):
        """Epoch-boundary admission: when a late worker has asked to
        join, re-form the ring to include it and broadcast the leader's
        epoch-boundary checkpoint as its warm start; incumbents re-derive
        shards and rescale as after a loss. The decision rides a leader
        broadcast, so every incumbent reaches the same verdict."""
        kv = getattr(self, "_kvstore", None)
        if kv is None or "dist" not in getattr(kv, "type", ""):
            return
        poll = getattr(kv, "pending_joiners", None)
        bcast = getattr(kv, "broadcast_bytes", None)
        if poll is None or bcast is None or ckpt_mgr is None \
                or kv.num_workers <= 0:
            return
        import pickle
        payload = b""
        if kv.worker_index == 0:
            payload = pickle.dumps(sorted(poll()))
        blob = bcast(payload)
        if not blob:
            return  # no elastic transport: broadcast_bytes is identity
        pending = pickle.loads(blob)
        if not pending:
            return
        self.logger.info("admitting joining worker(s) %s at the epoch "
                         "boundary", list(pending))
        kv.reform()
        self._adopt_leader_checkpoint(kv, ckpt_mgr)
        self._drop_fused_state()
        self._refresh_dist_scale()
        self._reshard_train_data(kv, train_data)

    def _check_worker_health(self, ckpt_mgr, eval_metric, epoch, nbatch,
                             drain_pipeline=None, guard=None):
        """The dist kvstore's degradation policy, once a batch boundary:
        ``num_dead_node`` feeds warn, emergency checkpoint, then
        :class:`~mxnet_tpu_torch.kvstore.WorkerLostError`
        (``KVStore.check_health`` throttles the heartbeat scan). No-op for
        local stores."""
        kv = getattr(self, "_kvstore", None)
        if kv is None or "dist" not in getattr(kv, "type", ""):
            return
        on_degraded = None
        if ckpt_mgr is not None:
            def on_degraded():
                # sealing needs every dispatch in flight retired first,
                # and a diverged state is never sealed
                if drain_pipeline is not None:
                    drain_pipeline()
                if guard is not None and not guard.ok_to_checkpoint():
                    self.logger.warning(
                        "worker-loss emergency checkpoint skipped: the "
                        "guard reports the current state unsafe to seal")
                    return
                ckpt_mgr.drain()
                ckpt_mgr.save(self, epoch, nbatch + 1, metric=eval_metric)
                ckpt_mgr.drain()
        kv.check_health(on_degraded=on_degraded)

    def _refresh_dist_scale(self):
        """Hook: re-derive the gradient rescale (1 / global batch) after
        a dist membership change."""

    def _drop_fused_state(self):
        """Hook: discard any fused device state unwritten, so the next
        dispatch reseeds from the restored parameters."""

    def _scale_lr(self, factor):
        """Hook: scale the learning rate everywhere the next step reads
        it."""

    def _apply_resume_state(self, st):
        """Restore the optimizer states, the update clock and the random
        state from a validated checkpoint (the parameters came through
        ``init_params``)."""
        if st.opt_states_file and hasattr(self, "load_optimizer_states"):
            self.load_optimizer_states(st.opt_states_file)
        self._restore_trainer_clock(st.num_update, st.fused_step)
        st.restore_rng()

    def _restore_trainer_clock(self, num_update, fused_step=None):
        """Hook: continue the optimizer's update clock and the fused step
        counter from a checkpoint's."""

    @staticmethod
    def _restore_metric_state(eval_metric, state):
        """Replay a checkpointed metric's partial sums into a freshly reset
        metric (the plain pair only; composites skip)."""
        if not state or not hasattr(eval_metric, "sum_metric"):
            return
        try:
            s, n = state
        except (TypeError, ValueError):
            return
        eval_metric.sum_metric = s
        eval_metric.num_inst = n

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
