"""Shape-bucketed serving engine over a saved checkpoint.

Counterpart of ``mxnet_tpu/serving/engine.py:ServingEngine``. The engine
loads a symbol and its parameters once, moves the parameters to its device
once, and serves any request size: ``infer`` pads a batch up to the
smallest covering bucket, chunks requests above the largest bucket, and
slices the pad rows off again. Inference is per-example independent, so
padding never leaks into real rows.

The JAX package compiles one program per bucket ahead of time; here the
forward runs eagerly, under ``torch.inference_mode()``, on the engine's
device. Entry points run on the card: ``device=None`` means ``cuda:0``,
and without CUDA the engine raises instead of falling back to the CPU
(pass ``device="cpu"`` to serve on the CPU, as the tests do).

Float32 convolutions run in full FP32 (``ops.nn.CONV_TF32`` is False).

Still to port from the JAX engine: tracecheck registration, the autotune
bucket DB, ``quantize=``, ``contexts=``, ``executables=`` and
``export_compiled``, the memory/comms audits, and ``update_params``. The
arguments that select them raise until they are ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, env_str
from ..context import resolve_device
from ..executor import _build_graph_runner
from ..ops.nn import conv_precision
from ..predictor import (_strip_loss_heads, load_symbol, load_param_dict,
                         pick_partial_outputs, check_missing_params)
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


class ServingEngine(object):
    """Shape-bucketed forward over a saved checkpoint.

    ``input_shapes`` maps input name -> PER-EXAMPLE shape (no batch dim),
    e.g. ``{"data": (3, 300, 300)}``; ``buckets`` is the set of batch sizes
    served (explicit ``buckets=``, else ``MXTPU_SERVE_BUCKETS``, else
    (1, 8, 32)). ``infer`` accepts any request size: n <= max(buckets)
    dispatches one padded bucket, larger requests are chunked over the
    largest bucket. ``device``: where the engine runs (default ``cuda:0``).
    """

    def __init__(self, symbol_json_or_file, param_file_or_dict, input_shapes,
                 buckets=None, output_names=None, allow_missing=False,
                 input_dtypes=None, executables=None, health=None,
                 name=None, contexts=None, quantize=None, device=None):
        qmode = (quantize if quantize is not None
                 else env_str("MXTPU_SERVE_QUANT", "none"))
        if qmode != "none":
            raise MXNetError("ServingEngine: quantize=%r is not ported yet "
                             "(weight-only quantization)" % (qmode,))
        if contexts is not None:
            raise MXNetError("ServingEngine: contexts= is not ported yet "
                             "(model-parallel engines)")
        if executables is not None:
            raise MXNetError("ServingEngine: executables= is not ported yet "
                             "(serialized compiled buckets)")
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
        self.buckets = tuple(sorted(set(
            int(b) for b in (buckets or default_buckets()))))
        if not self.buckets or self.buckets[0] < 1:
            raise MXNetError("ServingEngine: buckets must be positive "
                             "batch sizes, got %r" % (self.buckets,))
        self.health = health or ServingHealth(parent=SERVING_HEALTH)
        self.name = name or "serving(%s)" % (self._symbol.name,)

        # parameter shapes are batch-independent: infer at the smallest
        # bucket, then move every parameter to the device once
        arg_shapes, out_shapes, aux_shapes = \
            self._symbol.infer_shape(**self._full_shapes(self.buckets[0]))
        shape_of = dict(zip(self._symbol.list_arguments(), arg_shapes))
        aux_shape_of = dict(zip(self._symbol.list_auxiliary_states(),
                                aux_shapes))

        def as_dev(v, shape):
            t = _host_array(v)
            if tuple(t.shape) != tuple(shape):
                raise MXNetError(
                    "ServingEngine: parameter shape %s does not match the "
                    "graph's %s" % (tuple(t.shape), tuple(shape)))
            return t.to(self.device)

        def zeros(shape):         # allow_missing=True: deliberate zero-fill
            return torch.zeros(shape, dtype=torch.float32, device=self.device)

        self._params = {
            n: (as_dev(arg_params[n], shape_of[n]) if n in arg_params
                else zeros(shape_of[n]))
            for n in self._symbol.list_arguments()
            if n not in self._input_names}
        self._aux = {
            n: (as_dev(aux_params[n], aux_shape_of[n]) if n in aux_params
                else zeros(aux_shape_of[n]))
            for n in self._symbol.list_auxiliary_states()}
        self._run, _ = _build_graph_runner(self._symbol)
        # per-output row factor: outputs whose leading dim is a multiple of
        # the batch (e.g. an LM's (batch*seq, vocab) head) slice by it
        self._out_row_factor = []
        for s in out_shapes:
            lead = int(s[0]) if s else 0
            self._out_row_factor.append(
                lead // self.buckets[0]
                if lead and lead % self.buckets[0] == 0 else None)

    # ------------------------------------------------------------------
    def _full_shapes(self, b):
        return {n: (b,) + self._input_shapes[n] for n in self._input_names}

    @property
    def max_batch(self):
        return self.buckets[-1]

    def bucket_for(self, n):
        """Smallest bucket covering ``n`` examples."""
        for b in self.buckets:
            if b >= n:
                return b
        raise MXNetError("ServingEngine: no bucket covers %d examples "
                         "(buckets %s); chunk the request or add a bucket"
                         % (n, list(self.buckets)))

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
        with torch.inference_mode(), conv_precision(self.device):
            args = dict(self._params)
            args.update({k: torch.from_numpy(np.ascontiguousarray(v))
                         .to(self.device) for k, v in host.items()})
            outs, _ = self._run(args, self._aux)
            res = [(o[:n * f] if f else o).cpu().numpy()
                   for o, f in zip(outs, self._out_row_factor)]
        self.health.record_batch(n, b - n)
        return res
