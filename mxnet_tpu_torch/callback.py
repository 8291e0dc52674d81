"""Training callbacks (ref: python/mxnet/callback.py).

Counterpart of ``mxnet_tpu/callback.py``: the epoch-end checkpoint
callbacks, ``log_train_metric``, ``Speedometer`` and ``ProgressBar``.
Under ``steps_per_dispatch=k`` a batch-end callback fires once per
dispatch with ``nbatch`` advanced by K, so the periodic callbacks fire on
crossing each period boundary. The ``Speedometer`` appends, from the
``fit`` that calls it, a sequence model's tokens/sec, the dispatch
pipeline's depth and read-back stall and the input tier's data stall since
its last line, a dist run's ring size and staleness, a guarded run's
training-health counters, and ``Retraces: N``, the retraces the analyzer's
watch recorded since the Speedometer's (re-)init.
"""
from __future__ import annotations

import logging
import math
import time


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end checkpoint callback for a Module (ref: callback.py)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end checkpoint via model.save_checkpoint (ref: callback.py)."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Log the metric every ``period`` batches (ref: callback.py)."""
    last = [-1]  # nbatch at the last fire; -1 keeps batch 0's fire

    def _callback(param):
        if param.nbatch < last[0]:
            last[0] = -1  # epoch restarted
        if param.nbatch // period > last[0] // period \
                and param.eval_metric is not None:
            last[0] = param.nbatch
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


def _local(param, name):
    loc = getattr(param, "locals", None)
    return loc.get(name) if isinstance(loc, dict) else None


class Speedometer(object):
    """Log samples/sec every ``frequent`` batches (ref: callback.py
    Speedometer), resetting the metric it prints. The stall suffixes are
    deltas since the previous line, each kept against the object it reads
    (a reused Speedometer or another run's callbacks never mix them)."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self._fired = 0
        self._base = {}     # suffix -> (source object, last reading)
        self._retraces0 = 0  # tracecheck.retrace_count() at the (re-)init

    def _delta(self, name, source, reading):
        """``reading`` less the last one taken from ``source`` for this
        suffix (the first reading from a source is its baseline)."""
        prev = self._base.get(name)
        base = prev[1] if prev is not None and prev[0] is source else reading
        self._base[name] = (source, reading)
        return max(0.0, reading - base)

    def _pipeline_suffix(self, param):
        p = _local(param, "pipeline")
        if p is None:
            return ""
        d = self._delta("pipeline", p, p.host_stall)
        if p.depth <= 0:
            return ""
        return "\tPipeline: depth=%d host_stall=%.3fs" % (p.depth, d)

    @staticmethod
    def _health_suffix(param):
        """This run's TrainingHealth counters when it is guarded and has
        something to report: the guard comes from ``fit``'s locals, never
        the process-wide aggregate, so one run's counters never reach
        another run's (or score()'s) lines."""
        g = _local(param, "guard")
        if g is None:
            return ""
        h = g.health.report()
        if not (h["skipped"] or h["rollbacks"] or h["divergences"]):
            return ""
        gn = ("%.4g" % h["last_grad_norm"]
              if h["last_grad_norm"] is not None else "n/a")
        return ("\tGuard: skipped=%d rollbacks=%d grad_norm=%s"
                % (h["skipped"], h["rollbacks"], gn))

    @staticmethod
    def _speed_scale(param):
        """The global-throughput factor of the training module in ``fit``'s
        locals (``Module._global_batch_scale``: 1 in one process, where the
        iterator yields the whole batch over every replica); score()
        streams and foreign callback params scale by 1."""
        scale = getattr(_local(param, "self"), "_global_batch_scale", None)
        return float(scale()) if callable(scale) else 1.0

    @staticmethod
    def _tokens_per_sample(param):
        """Label tokens per sample for the tokens/sec suffix, from the
        training module in ``fit``'s locals
        (``Module._speed_tokens_per_sample``: the label's sequence dim).
        score() streams, foreign callback params and scalar-label models
        give 1, so the suffix never reaches a vision run's lines."""
        tps = getattr(_local(param, "self"), "_speed_tokens_per_sample",
                      None)
        return max(1, int(tps())) if callable(tps) else 1

    def _data_suffix(self, param):
        st = _local(param, "data_stats")
        if st is None:
            return ""
        d = self._delta("data", st, st.stage_seconds("stall"))
        q = st.report().get("queue_depth_avg")
        return ("\tData: stall=%.3fs q=%s"
                % (d, "%.1f" % q if q is not None else "n/a"))

    @staticmethod
    def _dist_suffix(param):
        """``Dist: workers=N stale=S`` whenever the run trains through a
        dist kvstore: N is the current ring size (it shrinks in the log
        when a re-form drops a dead worker) and S the bounded-staleness
        lag at the last pull (0 under dist_sync), both read from this
        run's module."""
        kv = getattr(_local(param, "self"), "_kvstore", None)
        if kv is None or "dist" not in getattr(kv, "type", ""):
            return ""
        return ("\tDist: workers=%d stale=%d"
                % (kv.num_workers, int(getattr(kv, "staleness_lag", 0))))

    def _retrace_suffix(self, init=False):
        """``Retraces: N`` once any watched dispatch key has been
        dispatched with a new argument signature since this Speedometer's
        (re-)init, which baselines the count: a reused Speedometer never
        reports another run's retraces, and a clean window stays quiet."""
        from . import tracecheck
        n = tracecheck.retrace_count()
        if init:
            self._retraces0 = n
            return ""
        n -= self._retraces0
        return "\tRetraces: %d" % n if n else ""

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            # nbatch arrives in K-batch jumps under steps_per_dispatch:
            # fire on crossing each `frequent` boundary, with the speed over
            # the true batch delta since the last fire
            if count // self.frequent > self._fired // self.frequent:
                speed = ((count - self._fired) * self.batch_size
                         * self._speed_scale(param)
                         / (time.time() - self.tic))
                # a sequence model's line also carries tokens/sec
                tps = self._tokens_per_sample(param)
                tok = (" (%.1f tokens/sec)" % (speed * tps)
                       if tps > 1 else "")
                suffix = self._pipeline_suffix(param) \
                    + self._data_suffix(param) + self._dist_suffix(param) \
                    + self._health_suffix(param) + self._retrace_suffix()
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    param.eval_metric.reset()
                    for name, value in name_value:
                        logging.info(
                            "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                            "%s\tTrain-%s=%f%s", param.epoch, count, speed,
                            tok, name, value, suffix)
                else:
                    logging.info(
                        "Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec%s%s",
                        param.epoch, count, speed, tok, suffix)
                self._fired = count
                self.tic = time.time()
        else:
            self.init = True
            self._fired = count
            self.tic = time.time()
            # baseline the stall windows at the (re-)init
            self._pipeline_suffix(param)
            self._data_suffix(param)
            self._retrace_suffix(init=True)


class ProgressBar(object):
    """Text progress bar (ref: callback.py ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    @staticmethod
    def _dist_suffix(param):
        """``Dist: workers=N stale=S`` whenever the run trains through a
        dist kvstore: N is the current ring size (it shrinks in the log
        when a re-form drops a dead worker) and S the bounded-staleness
        lag at the last pull (0 under dist_sync), both read from this
        run's module."""
        kv = getattr(_local(param, "self"), "_kvstore", None)
        if kv is None or "dist" not in getattr(kv, "type", ""):
            return ""
        return ("\tDist: workers=%d stale=%d"
                % (kv.num_workers, int(getattr(kv, "staleness_lag", 0))))

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")
