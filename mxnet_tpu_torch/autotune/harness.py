"""In-process evaluation harnesses of the autotuner.

The port's copy of ``mxnet_tpu/autotune/harness.py``. The tuner grows no
measurement method of its own: training candidates run through the
steady-state K-step harness (:func:`measure_scan_ips`), extended with the
dispatch-pipeline readback discipline ``Module.fit`` runs
(:func:`measure_pipelined_ips`); serving candidates run through the
open-loop arrival client (:func:`open_loop_run`), which the serving
benchmarks drive the batcher with too. Every readback is a
``StepMetrics.fetch()`` or a synchronize.

Each harness also owns its **static pruner**: a
:mod:`mxnet_tpu_torch.memcheck` pass over the candidate's program set
against the device budget (``MXTPU_AUTOTUNE_BUDGET`` overrides, else the
memcheck budget). The JAX package prices a candidate by compiling it; the
port prices it by a shape-only dry run, so a pruned candidate allocates
nothing on the device and runs no forward:

- :class:`TrainHarness` prices ``run_steps`` at K over a fake state and
  superbatch;
- :class:`ServeHarness` prices the bucket set with
  ``ServingEngine.priced`` from the symbol, parameters and buckets: the
  port's engine warms every bucket up at load, so it is built only in
  :meth:`~ServeHarness.evaluate`;
- :class:`DecodeHarness` prices with ``DecodeLoop.priced`` before any
  loop's thread starts.

Every harness runs on ``device`` (default ``cuda:0``; ``"cpu"`` on a host
without a card).
"""
from __future__ import annotations

import sys
import threading
import time

import numpy as np

from ..base import MXNetError, env_str

#: steady-state measurement spec for training trials:
#: "short,long" TOTAL steps (not dispatches) so higher-K candidates do
#: comparable work — env ``MXTPU_AUTOTUNE_MEASURE``, default "8,24"
_MEASURE_DEFAULT = "8,24"


def prune_budget(device=None):
    """Byte budget the static pruner rejects candidates against:
    ``MXTPU_AUTOTUNE_BUDGET`` (bytes, K/M/G/T suffixes) when set, else the
    memcheck budget of ``device`` (``MXTPU_MEMCHECK_BUDGET``, else the
    card's memory)."""
    from .. import memcheck as _mc
    env = _mc._parse_bytes(env_str("MXTPU_AUTOTUNE_BUDGET"),
                           "MXTPU_AUTOTUNE_BUDGET")
    return env if env is not None else _mc.budget_bytes(device)


def budget_findings(reports, set_name, budget=None):
    """The prune decision: ONLY the does-it-fit lints (``hbm-budget`` per
    program + ``resident-set`` over the candidate's program set). Quality
    lints (donation-waste, temp-blowup) are bench/CI gates, not reasons to
    refuse to measure a config."""
    from .. import memcheck as _mc
    reports = list(reports)
    budget = prune_budget() if budget is None else int(budget)
    findings = []
    for rep in reports:
        findings += _mc.lint_report(rep, budget=budget,
                                    temp_mult=float("inf"))
    findings += _mc.lint_resident_set(reports, set_name, budget=budget)
    return [f for f in _mc.unsuppressed(findings)
            if f.lint in ("hbm-budget", "resident-set")]


def _measure_steps(k):
    """(n_short, n_long) DISPATCH counts from the step-denominated
    ``MXTPU_AUTOTUNE_MEASURE`` spec."""
    spec = env_str("MXTPU_AUTOTUNE_MEASURE", _MEASURE_DEFAULT).split(",")
    try:
        short, long_ = int(spec[0]), int(spec[1])
    except (ValueError, IndexError):
        raise MXNetError("MXTPU_AUTOTUNE_MEASURE must be 'short,long' "
                         "step counts, got %r"
                         % env_str("MXTPU_AUTOTUNE_MEASURE"))
    n_short = max(1, (short + k - 1) // k)
    n_long = max(n_short + 2, (long_ + k - 1) // k)
    return n_short, n_long


# ---------------------------------------------------------------------------
# shared measurement harnesses
# ---------------------------------------------------------------------------

def measure_scan_ips(step, state, sb, batch, k, n_short, n_long, rounds=2,
                     warmup=2):
    """Steady-state img/s of ``run_steps`` over a K-deep superbatch:
    short/long differencing (a fixed per-readback latency cancels), best
    of ``rounds`` so one scheduler hiccup costs a retry, not the
    measurement (a round whose timing inverts contributes nothing). Each
    timed run ends with the last dispatch's metric readback."""
    st = [state]

    def run(dispatches):
        t0 = time.perf_counter()
        metrics = None
        for _ in range(dispatches):
            st[0], metrics = step.run_steps(st[0], sb)
        metrics.fetch()     # the readback waits for every queued step
        return time.perf_counter() - t0

    run(warmup)
    best = 0.0
    for _ in range(rounds):
        t_short = run(n_short)
        t_long = run(n_long)
        if t_long > t_short:
            best = max(best, batch * k * (n_long - n_short)
                       / (t_long - t_short))
    if best == 0.0:
        # every round's timing inverted: the 0.0 a caller is about to
        # publish (or gate on) is a measurement failure, not a throughput
        print("WARNING: measure_scan_ips produced no valid sample — "
              "t_long <= t_short in all %d round(s); the host is too "
              "loaded for n_short=%d/n_long=%d dispatches"
              % (rounds, n_short, n_long), file=sys.stderr)
    return best


def measure_pipelined_ips(step, state, sb, batch, k, depth, n_short,
                          n_long, rounds=2, warmup=2):
    """Steady-state img/s with ``Module.fit``'s dispatch-pipeline readback
    discipline: every dispatch's :class:`StepMetrics` is fetched, but only
    after ``depth`` further dispatches are queued (depth 0 = fetch after
    each dispatch) — the host/device overlap
    ``fit(dispatch_pipeline=depth)`` runs, so the tuner measures the knob
    it is tuning. Same short/long differencing + best-of-rounds as
    :func:`measure_scan_ips`."""
    from collections import deque
    st = [state]

    def run(dispatches):
        pending = deque()
        t0 = time.perf_counter()
        for _ in range(dispatches):
            st[0], sums = step.run_steps(st[0], sb)
            pending.append(sums)
            while len(pending) > depth:
                pending.popleft().fetch()
        while pending:
            pending.popleft().fetch()
        return time.perf_counter() - t0

    run(warmup)
    best = 0.0
    for _ in range(rounds):
        t_short = run(n_short)
        t_long = run(n_long)
        if t_long > t_short:
            best = max(best, batch * k * (n_long - n_short)
                       / (t_long - t_short))
    return best


def open_loop_run(infer, inputs, qps, nreq, nclients=4):
    """Open-loop arrival client loop: request i is DUE at ``t0 + i/qps``
    regardless of how long earlier requests took — queueing delay shows up
    in the measured latency instead of silently lowering the offered
    load. ``infer`` is any blocking callable (``Batcher.infer``,
    ``FleetRouter.infer``); ``inputs`` is the request, or a callable
    ``inputs(i)`` giving request i. ``nclients`` threads share the
    requests (client c sends i = c, c + nclients, ...). Returns
    ``(latency-seconds list, error-repr list, wall seconds)``."""
    latencies = []
    errors = []
    lock = threading.Lock()
    interval = 1.0 / float(qps)
    t0 = time.perf_counter() + 0.05

    def client(cid):
        for i in range(cid, nreq, nclients):
            due = t0 + i * interval
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            t_start = time.perf_counter()
            try:
                infer(inputs(i) if callable(inputs) else inputs)
                dt = time.perf_counter() - t_start
                with lock:
                    latencies.append(dt)
            except Exception as e:
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(nclients)]
    wall0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return latencies, errors, time.perf_counter() - wall0


def serve_model(name):
    """Build ``(name, symbol, random params, per-example shape)`` for the
    serving bench/tuner: deploy-realistic shapes, random weights (weights
    don't affect latency)."""
    from .. import models
    if name == "lenet":
        sym = models.lenet(num_classes=10)
        shape = (1, 28, 28)
    elif name == "mlp":
        sym = models.mlp(num_classes=10, hidden=(128,))
        shape = (64,)
    else:
        raise MXNetError("serve model must be mlp|lenet, got %r" % (name,))
    probe = {"data": (2,) + shape, "softmax_label": (2,)}
    arg_shapes, _, _ = sym.infer_shape(
        **{k: v for k, v in probe.items()
           if k in sym.list_arguments()})
    rs = np.random.default_rng(0)
    params = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        params[n] = (rs.normal(size=s) * 0.1).astype(np.float32)
    return name, sym, params, shape


# ---------------------------------------------------------------------------
# harnesses
# ---------------------------------------------------------------------------

class TrainHarness(object):
    """Training-objective trials: ``run_steps`` over a synthetic
    device-resident superbatch, measured with ``fit``'s pipelined readback
    discipline. ``objective`` is ``img_per_sec`` or ``tokens_per_sec``
    (the latter scales by the label's token dim — the transformer LM).

    Knobs consumed: ``steps_per_dispatch`` (changes the program — the
    pruner's projection), ``dispatch_pipeline``.
    """

    kind = "train"
    program_knobs = ("steps_per_dispatch",)

    def __init__(self, model="mlp", batch=None, objective="img_per_sec",
                 rounds=2, logger=None, device=None):
        from ..tracecheck import ZOO
        from .. import models
        from ..train_step import TrainStep
        if model not in ZOO:
            raise MXNetError("autotune: unknown model %r (have %s)"
                             % (model, ", ".join(sorted(ZOO))))
        cfg = ZOO[model]
        self.model = model
        self.objective = objective
        self.rounds = int(rounds)
        self.batch = int(batch) if batch else 32
        dname = cfg.get("data_name", "data")
        lname = cfg.get("label_name", "softmax_label")
        self.symbol = models.get_symbol(model, **cfg["kwargs"])
        self.data_shapes = {dname: (self.batch,) + tuple(cfg["data"][1:])}
        self.label_shapes = {lname: (self.batch,) + tuple(cfg["label"][1:])}
        lshape = self.label_shapes[lname]
        self.tokens_per_sample = (int(np.prod(lshape[1:]))
                                  if len(lshape) > 1 else 1)
        if objective == "tokens_per_sec" and self.tokens_per_sample == 1:
            raise MXNetError(
                "autotune: objective 'tokens_per_sec' needs a sequence "
                "label; model %r has a scalar label" % (model,))
        self.unit = ("tokens/sec" if objective == "tokens_per_sec"
                     else "images/sec")
        self.ts = TrainStep(self.symbol, data_names=(dname,),
                            label_names=(lname,), optimizer="sgd",
                            learning_rate=0.1, momentum=0.9, device=device)
        self.device = self.ts.device
        self._dname, self._lname = dname, lname
        # one fixed host batch per harness: every candidate trains the
        # same numbers, so scores differ only by the knobs under test
        rng = np.random.default_rng(0)
        self._data_host = rng.normal(
            size=self.data_shapes[dname]).astype(np.float32)
        ncls = int(cfg["kwargs"].get("num_classes",
                                     cfg["kwargs"].get("vocab_size", 4)))
        self._label_host = rng.integers(
            0, max(2, ncls), self.label_shapes[lname]).astype(np.float32)

    def symbol_sig(self):
        from .db import symbol_signature
        return symbol_signature(self.symbol)

    # -- static pruner ---------------------------------------------------
    def prune(self, knobs):
        """memcheck the candidate's ``run_steps`` at K before it runs: a
        shape-only dry run over a fake state and superbatch, and an
        over-budget config never runs. Returns the budget findings (empty
        = admit)."""
        from .. import memcheck as _mc
        from ..tracecheck import train_step_programs
        k = int(knobs["steps_per_dispatch"])
        name = "autotune/%s/scan[bs=%d,k=%d]" % (self.model, self.batch, k)
        progs = train_step_programs(self.ts, self.data_shapes,
                                    self.label_shapes, k=k, guard=False,
                                    name=name)
        _, fn, args = progs[1]
        rep = _mc.analyze(fn, args, donate_argnums=(0,), name=name)
        return budget_findings([rep], name, budget=prune_budget(self.device))

    # -- measured trial --------------------------------------------------
    def evaluate(self, knobs):
        import torch
        k = int(knobs["steps_per_dispatch"])
        depth = int(knobs.get("dispatch_pipeline", 1))
        state = self.ts.init(self.data_shapes, self.label_shapes, seed=0)
        sb = {n: torch.from_numpy(np.stack([a] * k)).to(self.device)
              for n, a in ((self._dname, self._data_host),
                           (self._lname, self._label_host))}
        n_short, n_long = _measure_steps(k)
        ips = measure_pipelined_ips(self.ts, state, sb, self.batch, k,
                                    depth, n_short, n_long,
                                    rounds=self.rounds)
        if ips <= 0:
            raise MXNetError(
                "autotune trial produced no valid sample (timing inverted "
                "in every round) for knobs %r" % (knobs,))
        # the token multiplier applies ONLY to the tokens objective: an
        # img_per_sec sweep over a multi-dim-label model (ssd) keeps one
        # unit, one meaning
        if self.objective == "tokens_per_sec":
            return ips * self.tokens_per_sample
        return ips


class ServeHarness(object):
    """Serving-objective trials: a bucketed engine + dynamic batcher
    driven by the open-loop client loop at a fixed offered QPS; the score
    is ``-p99`` (or ``-p50``) latency in ms, so the driver's higher-is-
    better convention minimizes latency.

    Knobs consumed: ``buckets`` (comma spec — changes the program set, the
    pruner's projection), ``max_latency_ms``.
    """

    kind = "serve"
    program_knobs = ("buckets",)

    def __init__(self, model="mlp", objective="serve_p99", qps=100.0,
                 nreq=160, nclients=3, logger=None, device=None):
        from ..context import resolve_device
        if objective not in ("serve_p99", "serve_p50"):
            raise MXNetError("autotune: serve objective must be "
                             "serve_p99|serve_p50, got %r" % (objective,))
        self.model, self.symbol, self._params, self._shape = \
            serve_model(model)
        self.device = resolve_device(device, "ServeHarness")
        self.objective = objective
        self.pct = 99.0 if objective == "serve_p99" else 50.0
        self.qps = float(qps)
        self.nreq = int(nreq)
        self.nclients = int(nclients)
        self.unit = "ms_p%d_neg" % int(self.pct)
        self._engines = {}
        rs = np.random.default_rng(1)
        self._x1 = rs.normal(size=(1,) + self._shape).astype(np.float32)

    def symbol_sig(self):
        # sign the STRIPPED symbol: that is what a ServingEngine built from
        # the same checkpoint computes at resolution time
        from ..predictor import _strip_loss_heads
        from .db import symbol_signature
        return symbol_signature(_strip_loss_heads(self.symbol))

    def _engine_args(self, knobs):
        from .db import parse_buckets
        return ((self.symbol, dict(self._params), {"data": self._shape}),
                dict(buckets=parse_buckets(str(knobs["buckets"])),
                     device=self.device))

    def _engine(self, knobs):
        key = str(knobs["buckets"])
        if key not in self._engines:
            from ..serving import ServingEngine
            args, kwargs = self._engine_args(knobs)
            self._engines[key] = ServingEngine(*args, **kwargs)
        return self._engines[key]

    def prune(self, knobs):
        """Price the candidate's bucket set before any engine is built
        (``ServingEngine.priced``: the port's engine warms every bucket up
        at load); an over-budget bucket set never serves a request."""
        from ..serving import ServingEngine
        args, kwargs = self._engine_args(knobs)
        reports = ServingEngine.priced(*args, **kwargs)
        return budget_findings(reports.values(),
                               "autotune/%s/buckets[%s]"
                               % (self.model, knobs["buckets"]),
                               budget=prune_budget(self.device))

    def evaluate(self, knobs):
        from ..serving import Batcher
        eng = self._engine(knobs)
        batcher = Batcher(eng,
                          max_latency_ms=float(knobs.get("max_latency_ms",
                                                         5.0)))
        try:
            batcher.infer({"data": self._x1})  # warm the smallest bucket
            lat, errors, _wall = open_loop_run(
                batcher.infer, {"data": self._x1}, self.qps, self.nreq,
                nclients=self.nclients)
        finally:
            batcher.close()
        if not lat:
            raise MXNetError("autotune serve trial completed no requests: "
                             "%s" % errors[:3])
        lat_ms = np.asarray(lat) * 1e3
        return -float(np.percentile(lat_ms, self.pct))


def _lm_params(symbol, seq_len, seed):
    """Random f32 params for a ``models.transformer`` symbol (weights
    don't affect decode throughput)."""
    arg_shapes, _, _ = symbol.infer_shape(data=(1, seq_len),
                                          softmax_label=(1, seq_len))
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(symbol.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


class DecodeHarness(object):
    """Decode-objective trials (``decode_tokens_per_sec``): a
    :class:`~mxnet_tpu_torch.serving.DecodeLoop` over a tiny transformer
    LM with a 1-layer co-resident draft, driven by a fixed request batch
    whose prompts share a common prefix — so the prefix-cache and
    speculative knobs both have something to win on. The score is
    emitted tokens per wall second.

    Knobs consumed: ``spec_k`` (0 disables speculation; changes the
    program set — verify+draft bodies), ``prefix_cache`` (0/1; adds the
    prefix get/put programs). Both are program knobs, so the pruner's
    memcheck pass sees each candidate's real resident set, the
    draft+target pair included.
    """

    kind = "decode"
    program_knobs = ("spec_k", "prefix_cache")

    #: tiny-but-real LM: 2 target layers + 1 draft layer, one shared
    #: vocab — big enough that spec/prefix change the work, small enough
    #: for a trial inside the trial timeout
    _CFG = dict(vocab_size=32, embed=16, num_heads=2, num_layers=2,
                seq_len=48)

    def __init__(self, model="lm", objective="decode_tokens_per_sec",
                 nreq=6, max_new=16, logger=None, device=None):
        from .. import models
        from ..context import resolve_device
        if objective != "decode_tokens_per_sec":
            raise MXNetError("autotune: decode objective must be "
                             "decode_tokens_per_sec, got %r" % (objective,))
        self.model = model
        self.objective = objective
        self.unit = "tokens/sec"
        self.device = resolve_device(device, "DecodeHarness")
        self.nreq = int(nreq)
        self.max_new = int(max_new)
        cfg = dict(self._CFG)
        self.symbol = models.transformer(**cfg)
        self._cfg = cfg
        self._params = _lm_params(self.symbol, cfg["seq_len"], seed=0)
        dcfg = dict(cfg)
        dcfg["num_layers"] = 1
        self._draft = _lm_params(models.transformer(**dcfg),
                                 cfg["seq_len"], seed=1)
        rs = np.random.RandomState(2)
        self._shared = [int(t) for t in
                        rs.randint(1, cfg["vocab_size"], 6)]
        self._tails = [[int(t) for t in rs.randint(1, cfg["vocab_size"],
                                                   2 + i % 3)]
                       for i in range(self.nreq)]
        self._loops = {}

    def symbol_sig(self):
        # decode loops are built from raw params, not a Symbol — entries
        # match on the PARAM signature the loop's own resolution computes
        from .db import param_signature
        return param_signature(self._params)

    def _loop_kwargs(self, knobs):
        k = int(knobs["spec_k"])
        return dict(num_layers=self._cfg["num_layers"],
                    num_heads=self._cfg["num_heads"],
                    max_len=self._cfg["seq_len"], slots=4, spec_k=k,
                    draft_params=(self._draft if k else None),
                    draft_num_layers=1,
                    prefix_cache=bool(int(knobs.get("prefix_cache", 1))),
                    quantize="none", device=self.device)

    def _loop(self, knobs):
        key = (int(knobs["spec_k"]), int(knobs.get("prefix_cache", 1)))
        if key not in self._loops:
            from ..serving import DecodeLoop
            self._loops[key] = DecodeLoop(self._params,
                                          **self._loop_kwargs(knobs))
        return self._loops[key]

    def prune(self, knobs):
        """Price the candidate's program set with ``DecodeLoop.priced``,
        before any loop is built or its thread started."""
        from ..serving import DecodeLoop
        reports = DecodeLoop.priced(self._params, **self._loop_kwargs(knobs))
        return budget_findings(
            reports.values(),
            "autotune/%s/decode[spec_k=%s,prefix=%s]"
            % (self.model, knobs["spec_k"],
               knobs.get("prefix_cache", 1)),
            budget=prune_budget(self.device))

    def evaluate(self, knobs):
        loop = self._loop(knobs)
        prefix = bool(int(knobs.get("prefix_cache", 1)))
        plen = len(self._shared) if prefix else 0

        def run():
            futs = [loop.generate(self._shared + tail, self.max_new,
                                  temperature=0.8, seed=7 + i,
                                  prefix_len=plen)
                    for i, tail in enumerate(self._tails)]
            return sum(len(f.result(timeout=120.0)) for f in futs)

        run()  # warmup: prime the prefix cache and the card's kernels
        t0 = time.perf_counter()
        toks = run()
        dt = time.perf_counter() - t0
        if toks <= 0 or dt <= 0:
            raise MXNetError("autotune decode trial emitted no tokens "
                             "for knobs %r" % (knobs,))
        return toks / dt

    def close(self):
        for loop in self._loops.values():
            loop.close()
        self._loops.clear()
