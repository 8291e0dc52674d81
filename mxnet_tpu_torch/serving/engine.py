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

Not ported: ``contexts=`` (model-parallel engines over several cards,
ROADMAP.md A.7c) and the static audits (``memory_report``,
``comms_report``, ``check``), which walk XLA programs; they raise.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..base import MXNetError, env_str
from ..context import resolve_device
from ..executor import _build_graph_runner
from ..ops.nn import conv_precision
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


def _not_ported(what, who="ServingEngine"):
    return MXNetError(
        "%s.%s walks XLA programs and is not ported yet "
        "(ROADMAP.md A.12)" % (who, what))


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
    engine warns and warms up afresh.
    """

    def __init__(self, symbol_json_or_file, param_file_or_dict, input_shapes,
                 buckets=None, output_names=None, allow_missing=False,
                 input_dtypes=None, executables=None, health=None,
                 name=None, contexts=None, quantize=None, device=None):
        self.quant_mode = _quant.resolve_mode(
            quantize if quantize is not None
            else env_str("MXTPU_SERVE_QUANT", "none"))
        ncontexts = (contexts if isinstance(contexts, int)
                     else len(contexts or ()))
        if ncontexts > 1:
            raise MXNetError("ServingEngine: contexts= (a model-parallel "
                             "engine across cards) is not ported yet "
                             "(ROADMAP.md A.7c)")
        self.device = resolve_device(device, "ServingEngine")
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
            n: (host(aux_params[n], aux_shape_of[n]) if n in aux_params
                else zeros(aux_shape_of[n])).to(self.device)
            for n in self._symbol.list_auxiliary_states()}
        #: the served (params, aux) pair: ``infer`` reads it once, and
        #: ``update_params`` replaces it with one assignment
        self._state = (params, aux)
        self._run, _ = _build_graph_runner(self._symbol)
        # per-output row factor: outputs whose leading dim is a multiple of
        # the batch (e.g. an LM's (batch*seq, vocab) head) slice by it
        self._out_row_factor = []
        for s in out_shapes:
            lead = int(s[0]) if s else 0
            self._out_row_factor.append(
                lead // self.buckets[0]
                if lead and lead % self.buckets[0] == 0 else None)
        if executables is not None:
            logging.warning(
                "ServingEngine: could not import executables from %s (a "
                "PyTorch engine runs its forward eagerly, and cannot "
                "serialize it or its CUDA state) — warming up afresh",
                executables)
        for b in self.buckets:
            self._forward({n: np.zeros((b,) + self._input_shapes[n],
                                       self._input_dtypes[n])
                           for n in self._input_names})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        the device: a tensor, or an int8 ``{"q", "s"}`` pair."""
        stored = _quant.quantize_array(host_tensor, self.quant_mode)
        if _quant.is_quantized_leaf(stored):
            return {k: v.to(self.device) for k, v in stored.items()}
        return stored.to(self.device)

    def _full_shapes(self, b):
        return {n: (b,) + self._input_shapes[n] for n in self._input_names}

    @property
    def max_batch(self):
        return self.buckets[-1]

    @property
    def model_devices(self):
        """Number of cards one replica of this engine spans (always 1:
        ``contexts=`` is not ported)."""
        return 1

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
        quantized engine re-quantizes it on the host. The copies land on
        the device before one assignment swaps the ``(params, aux)`` pair,
        so a concurrent ``infer`` serves the old set or the new one, never
        a mix."""
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
                    stored = _quant.quantize_array(t.to(torch.float32),
                                                   self.quant_mode)
                    out[n] = {k: v.to(self.device)
                              for k, v in stored.items()}
                    continue
                if t.dtype != resident.dtype:
                    if not t.is_floating_point():
                        raise MXNetError(
                            "update_params: %s %r dtype %s does not match "
                            "the resident %s" % (kind, n, t.dtype,
                                                 resident.dtype))
                    t = t.to(resident.dtype)
                out[n] = t.to(self.device)
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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
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
        with torch.inference_mode(), conv_precision(self.device):
            args = (dict(params) if self.quant_mode == "none"
                    else _quant.dequant_tree(params))
            args.update({k: torch.from_numpy(np.ascontiguousarray(v))
                         .to(self.device) for k, v in batch.items()})
            outs, _ = self._run(args, aux)
            return [(o[:n * f] if f and n is not None else o).cpu().numpy()
                    for o, f in zip(outs, self._out_row_factor)]

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

    def weight_bytes(self):
        """Resident device bytes of the engine's (possibly quantized)
        parameters and aux states, from dtypes and shapes."""
        params, aux = self._state
        return _quant.tree_bytes(params) + _quant.tree_bytes(aux)

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
        raise _not_ported("memory_report")

    def comms_report(self):
        raise _not_ported("comms_report")

    def check(self, const_bytes=None, memory=False, budget=None,
              comms=False, min_eff=0.0):
        raise _not_ported("check")
