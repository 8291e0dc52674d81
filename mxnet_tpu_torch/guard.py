"""Training-health guardrails: numerical-fault detection and recovery.

The port's copy of ``mxnet_tpu/guard.py`` (pure Python; the port imports
nothing of the JAX package). One poisoned batch or an lr spike silently
NaNs the parameters and every later checkpoint, so ``resume='auto'``
would resume a dead run. The policy:

1. **Sentinels computed in the step** — the guarded fused step
   (``TrainStep.step``/``run_steps`` with ``guard=True``) computes a
   global gradient norm and an all-finite flag over loss and gradients on
   the device. A non-finite step keeps every piece of state unchanged
   (``torch.where`` selects the old values; no host readback inside the
   step), and the sentinels ride back with the step's metric sums.
2. **Bad-batch skip** — skipped steps are counted here (and left out of
   the metric's sums on the device) instead of poisoning the parameters.
3. **Divergence rollback** — a rolling loss window (a sustained spike
   against the EMA, or too many skips in a window) triggers a rollback
   through the ``CheckpointManager`` to the newest checkpoint whose
   manifest is marked *known-good* (finite parameters checked at save
   time), rewinds the trainer clock, scales the lr by ``lr_factor`` and
   fast-forwards the iterator again. After ``max_rollbacks`` the run
   raises :class:`TrainingDivergedError`.

Policy knobs default from the ``MXTPU_GUARD_*`` environment variables;
the fault sites ``guard.grad_nan``, ``guard.loss_spike`` and
``guard.param_nan`` make every path testable (:mod:`.faults`).
"""
from __future__ import annotations

import logging
import math
import threading

from .base import MXNetError, env_float as _env_float


class TrainingDivergedError(MXNetError):
    """Training diverged beyond what the guard policy can recover:
    ``max_rollbacks`` exhausted, or no known-good checkpoint to roll back
    to. The message carries the reason and the :class:`TrainingHealth`
    snapshot at the time of death."""

    def __init__(self, msg, health=None):
        self.health = health
        if health is not None:
            msg = "%s (TrainingHealth=%r)" % (msg, health.report())
        super().__init__(msg)


class _DivergenceRollback(Exception):
    """Internal control-flow signal: ``fit``'s batch loop raises this when
    the guard flags divergence, and its epoch loop catches it to perform the
    checkpoint rollback. Never escapes ``fit``."""


class TrainingHealth(object):
    """Thread-safe counters for numerical-health degradation, the training
    analog of :class:`io.DataHealth`. Every skipped batch, divergence and
    rollback is recorded here (and mirrored into the process-global
    ``guard.TRAINING_HEALTH`` aggregate), so a guarded run can report
    "healthy" vs "limping on skips" instead of silently eating bad batches.
    """

    def __init__(self, parent=None):
        self._lock = threading.Lock()
        self._parent = parent
        self.steps = 0
        self.skipped = 0
        self.divergences = 0
        self.rollbacks = 0
        self.ckpt_skipped = 0
        self.retraces = 0
        self.last_grad_norm = None
        self.last_loss = None
        self.last_event = None

    def record_retrace(self, site):
        """A watched dispatch key was dispatched with a new argument
        signature (``tracecheck.TraceWatcher`` names the offending argument
        in its log line or error). Counted here so a storm of them shows up
        in Speedometer lines and the epoch health report."""
        with self._lock:
            self.retraces += 1
            self.last_event = "unexpected retrace at %s" % (site,)
        if self._parent is not None:
            self._parent.record_retrace(site)

    def record_ckpt_skip(self):
        """An async checkpoint save was shed under back-pressure (the
        previous save was still in flight — model.AsyncCheckpointWriter).
        Counted here so a run quietly losing checkpoint cadence to a slow
        disk is diagnosable from its health report."""
        with self._lock:
            self.ckpt_skipped += 1
            self.last_event = "async checkpoint skipped (writer busy)"
        if self._parent is not None:
            self._parent.record_ckpt_skip()

    def record_steps(self, nsteps, skipped, grad_norm=None):
        with self._lock:
            self.steps += int(nsteps)
            self.skipped += int(skipped)
            if grad_norm is not None:
                self.last_grad_norm = float(grad_norm)
            if skipped:
                self.last_event = ("skipped %d non-finite step(s)"
                                   % int(skipped))
        if self._parent is not None:
            self._parent.record_steps(nsteps, skipped, grad_norm)

    def record_loss(self, loss):
        with self._lock:
            self.last_loss = float(loss)
        if self._parent is not None:
            self._parent.record_loss(loss)

    def record_divergence(self, reason):
        with self._lock:
            self.divergences += 1
            self.last_event = "divergence: %s" % (reason,)
        if self._parent is not None:
            self._parent.record_divergence(reason)

    def record_rollback(self, tag=None):
        with self._lock:
            self.rollbacks += 1
            self.last_event = ("rolled back to checkpoint %s" % tag
                               if tag else "rolled back")
        if self._parent is not None:
            self._parent.record_rollback(tag)

    def report(self):
        with self._lock:
            return {"steps": self.steps, "skipped": self.skipped,
                    "divergences": self.divergences,
                    "rollbacks": self.rollbacks,
                    "ckpt_skipped": self.ckpt_skipped,
                    "retraces": self.retraces,
                    "last_grad_norm": self.last_grad_norm,
                    "last_loss": self.last_loss,
                    "last_event": self.last_event}

    def reset(self):
        with self._lock:
            self.steps = 0
            self.skipped = 0
            self.divergences = 0
            self.rollbacks = 0
            self.ckpt_skipped = 0
            self.retraces = 0
            self.last_grad_norm = None
            self.last_loss = None
            self.last_event = None

    def __repr__(self):
        return "TrainingHealth(%r)" % (self.report(),)


#: process-global aggregate every per-run TrainingHealth mirrors into
#: (the numerical analog of ``io.DATA_HEALTH``; Speedometer reads it)
TRAINING_HEALTH = TrainingHealth()


class TrainingGuard(object):
    """Numerical-failure policy consumed by ``fit(guard=...)``.

    The module layer feeds every guarded dispatch's sentinels into
    :meth:`on_dispatch`; the guard counts skips, watches a rolling loss
    window, and flags divergence (``self.diverged``) when the policy trips.
    ``fit`` then rolls back to the newest known-good checkpoint (or raises
    :class:`TrainingDivergedError` once ``max_rollbacks`` is exhausted).

    Policy knobs (constructor arg > ``MXTPU_GUARD_*`` env > default):

    ====================== ============================== =======
    knob                   env                            default
    ====================== ============================== =======
    ``window``             ``MXTPU_GUARD_WINDOW``         50
    ``spike_factor``       ``MXTPU_GUARD_SPIKE_FACTOR``   4.0
    ``patience``           ``MXTPU_GUARD_PATIENCE``       5
    ``max_skips_per_window`` ``MXTPU_GUARD_MAX_SKIPS``    3
    ``lr_factor``          ``MXTPU_GUARD_LR_FACTOR``      0.5
    ``max_rollbacks``      ``MXTPU_GUARD_MAX_ROLLBACKS``  2
    ``ema_decay``          ``MXTPU_GUARD_EMA_DECAY``      0.9
    ====================== ============================== =======

    Divergence fires when EITHER the per-dispatch mean loss exceeds
    ``spike_factor`` × its EMA for ``patience`` consecutive dispatches, OR
    ``max_skips_per_window`` batches were skipped within a ``window``-step
    block. Spiked observations never update the EMA (the baseline must not
    chase the divergence it is measuring). Under ``steps_per_dispatch=k``
    one observation covers k steps, so ``patience`` counts dispatches.
    """

    def __init__(self, window=None, spike_factor=None, patience=None,
                 max_skips_per_window=None, lr_factor=None, max_rollbacks=None,
                 ema_decay=None, logger=None, health=None):
        self.window = int(window if window is not None
                          else _env_float("MXTPU_GUARD_WINDOW", 50))
        self.spike_factor = (spike_factor if spike_factor is not None
                             else _env_float("MXTPU_GUARD_SPIKE_FACTOR", 4.0))
        self.patience = int(patience if patience is not None
                            else _env_float("MXTPU_GUARD_PATIENCE", 5))
        self.max_skips_per_window = int(
            max_skips_per_window if max_skips_per_window is not None
            else _env_float("MXTPU_GUARD_MAX_SKIPS", 3))
        self.lr_factor = (lr_factor if lr_factor is not None
                          else _env_float("MXTPU_GUARD_LR_FACTOR", 0.5))
        self.max_rollbacks = int(
            max_rollbacks if max_rollbacks is not None
            else _env_float("MXTPU_GUARD_MAX_ROLLBACKS", 2))
        self.ema_decay = (ema_decay if ema_decay is not None
                          else _env_float("MXTPU_GUARD_EMA_DECAY", 0.9))
        for name in ("window", "patience", "max_skips_per_window"):
            if getattr(self, name) < 1:
                raise MXNetError("TrainingGuard: %s must be >= 1, got %r"
                                 % (name, getattr(self, name)))
        if not (0.0 < self.lr_factor <= 1.0):
            raise MXNetError("TrainingGuard: lr_factor must be in (0, 1], "
                             "got %r" % (self.lr_factor,))
        self.logger = logger or logging
        self.health = health if health is not None \
            else TrainingHealth(parent=TRAINING_HEALTH)
        self.diverged = False
        self.diverged_reason = None
        #: the module layer sets this per guarded single-step dispatch so
        #: fit can exclude the skipped batch from host-side metric updates
        self.last_step_skipped = False
        self._ema = None
        self._spike_run = 0
        self._win_steps = 0
        self._win_skips = 0
        self._warned_nonfinite_loss = False

    # ------------------------------------------------------------------
    def on_dispatch(self, loss_sum, nsamp, skipped, grad_norm, nsteps=1):
        """Feed one dispatch's device sentinels into the policy.

        ``loss_sum``/``nsamp`` cover only the NON-skipped steps (the guarded
        dispatch leaves skipped batches out of its sums), ``skipped``
        is the count of device-side no-op steps and ``grad_norm`` the last
        step's global gradient norm. Returns ``"rollback"`` when the policy
        flags divergence (also latched on ``self.diverged``), else None.
        """
        from . import faults as _faults
        skipped = int(round(float(skipped)))
        nsteps = int(nsteps)
        self.health.record_steps(nsteps, skipped, grad_norm)
        if skipped:
            self.logger.warning(
                "TrainingGuard: skipped %d non-finite step(s) on device "
                "(last grad norm %s)", skipped, grad_norm)
        reason = None
        self._win_steps += nsteps
        self._win_skips += skipped
        if self._win_skips >= self.max_skips_per_window:
            reason = ("%d batches skipped within a %d-step window"
                      % (self._win_skips, self.window))
        if self._win_steps >= self.window:
            self._win_steps = 0
            self._win_skips = 0
        if nsamp and nsamp > 0:
            loss = float(loss_sum) / float(nsamp)
            if _faults.fire_flag("guard.loss_spike"):
                base = self._ema if self._ema is not None \
                    else max(abs(loss), 1.0)
                loss = base * self.spike_factor * 10.0 + 1.0
            if not math.isfinite(loss):
                # a non-finite OBSERVATION with finite params/grads means
                # the in-graph CE doesn't fit this head (non-probability
                # outputs): folding it into the EMA would silently kill the
                # watcher for the rest of the run — warn once, skip it
                # (the skip-window divergence check above still applies)
                if not self._warned_nonfinite_loss:
                    self._warned_nonfinite_loss = True
                    self.logger.warning(
                        "TrainingGuard: non-finite loss observation (%r) "
                        "with finite params — the output head is not a "
                        "probability distribution? Loss-spike watching is "
                        "skipping these dispatches; skip/rollback guards "
                        "remain active", loss)
            else:
                self.health.record_loss(loss)
                if self._ema is None:
                    self._ema = loss
                elif loss > self.spike_factor * max(self._ema, 1e-12):
                    self._spike_run += 1
                    if self._spike_run >= self.patience and reason is None:
                        reason = ("loss %.6g > %gx EMA %.6g for %d "
                                  "consecutive dispatches"
                                  % (loss, self.spike_factor, self._ema,
                                     self._spike_run))
                else:
                    self._spike_run = 0
                    self._ema = (self.ema_decay * self._ema
                                 + (1.0 - self.ema_decay) * loss)
        if reason is not None and not self.diverged:
            self.diverged = True
            self.diverged_reason = reason
            self.health.record_divergence(reason)
            self.logger.warning("TrainingGuard: divergence detected (%s)",
                                reason)
        return "rollback" if self.diverged else None

    def ok_to_checkpoint(self):
        """False while the loss watcher is mid-spike (or divergence has
        latched): a state inside the patience window is SUSPECT — sealing
        it as a checkpoint would make it the rollback target, and the
        rollback would land on the very divergence it is escaping. ``fit``
        defers cadence checkpoints until the watcher is healthy again
        (device-side skips don't veto: a skipped step left params
        untouched)."""
        return self._spike_run == 0 and not self.diverged

    def note_rollback(self, tag=None):
        """Reset the divergence detectors after a successful rollback (the
        restored run starts a fresh loss baseline at the reduced lr)."""
        self.health.record_rollback(tag)
        self.diverged = False
        self.diverged_reason = None
        self.last_step_skipped = False
        self._ema = None
        self._spike_run = 0
        self._win_steps = 0
        self._win_skips = 0
