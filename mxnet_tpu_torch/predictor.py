"""The standalone predictor, and the checkpoint helpers the serving tier
shares with it.

Counterpart of ``mxnet_tpu/predictor.py`` (ref: the reference's
``c_predict_api``): loss-head stripping, symbol and param loading,
partial-output picking, the missing-parameter check, and
:class:`Predictor`, which binds the stripped symbol through
``Symbol.bind`` and serves variable batch sizes with ``reshape``.
"""
from __future__ import annotations

from collections import OrderedDict

from .base import MXNetError, attr_bool
from .context import Context, cpu, gpu
from . import ndarray as nd
from . import symbol as sym
from .ops import registry as _reg

# loss heads -> inference-time equivalent op on the head's data input
# (ref: c_predict_api binds the net for prediction; the loss ops' forward is
# label-independent, so stripping the head drops the label argument entirely)
_LOSS_HEADS = {
    "SoftmaxOutput": "SoftmaxActivation",
    "LogisticRegressionOutput": "sigmoid",
    "LinearRegressionOutput": "identity",
    "MAERegressionOutput": "identity",
    "SVMOutput": "identity",
    "MakeLoss": "identity",
    "IdentityAttachKLSparseReg": "identity",
}


def _strip_loss_heads(symbol):
    """Rewrite loss-head outputs to their inference transform so binding
    needs no label arrays (labels vanish from list_arguments)."""
    new_outputs = []
    changed = False
    for node, idx in symbol._outputs:
        if (not node.is_variable) and node.op.name in _LOSS_HEADS:
            repl = _LOSS_HEADS[node.op.name]
            attrs = {}
            if repl == "SoftmaxActivation":
                mo = attr_bool(node.attrs.get("multi_output", False), False)
                attrs["mode"] = "channel" if mo else "instance"
            new = sym._Node(_reg.get(repl), node.name, attrs,
                            [node.inputs[0]], node._user_attr)
            new_outputs.append((new, 0))
            changed = True
        else:
            new_outputs.append((node, idx))
    return sym.Symbol(new_outputs) if changed else symbol


def load_symbol(symbol_json_or_file):
    """Accept a Symbol, a JSON string, or a path to a -symbol.json file."""
    if isinstance(symbol_json_or_file, str):
        if symbol_json_or_file.lstrip().startswith("{"):
            return sym.load_json(symbol_json_or_file)
        return sym.load(symbol_json_or_file)
    return symbol_json_or_file


def load_param_dict(param_file_or_dict):
    """Split a saved-params file (or an already-loaded dict, with or without
    ``arg:``/``aux:`` prefixes) into (arg_params, aux_params)."""
    if isinstance(param_file_or_dict, str):
        loaded = nd.load(param_file_or_dict, ctx=cpu())
    else:
        loaded = param_file_or_dict
    arg_params = {}
    aux_params = {}
    for k, v in loaded.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def pick_partial_outputs(symbol, output_names):
    """Partial-output binding: group only the requested internal heads
    (ref: MXPredCreatePartialOut, c_predict_api.h:92-102)."""
    internals = symbol.get_internals()
    avail = internals.list_outputs()
    picked = []
    for key in output_names:
        cand = key if key in avail else key + "_output"
        if cand not in avail:
            raise MXNetError(
                "partial output %r not found (have e.g. %s)"
                % (key, avail[-5:]))
        picked.append(internals[avail.index(cand)])
    return sym.Group(picked)


def check_missing_params(symbol, input_names, arg_params, aux_params,
                         who="Predictor"):
    """Raise an MXNetError naming every parameter/auxiliary state the
    loaded dict does NOT cover. A typo'd or truncated key must fail loudly:
    silently zero-filling a weight serves garbage predictions."""
    missing = [n for n in symbol.list_arguments()
               if n not in input_names and n not in arg_params
               # labels are inputs, not checkpoint parameters (the
               # "<name>_label" default-naming convention)
               and not n.endswith("_label")]
    missing += ["aux:" + n for n in symbol.list_auxiliary_states()
                if n not in aux_params]
    if missing:
        raise MXNetError(
            "%s: checkpoint is missing parameter(s) %s — a stale or "
            "mismatched params file would serve garbage predictions "
            "(pass allow_missing=True to zero-fill deliberately)"
            % (who, sorted(missing)))


class Predictor(object):
    """Forward-only executor over a checkpoint (the reference's
    ``MXPredCreate``/``MXPredReshape``/``MXPredForward``).

    ``input_shapes`` maps input name -> FULL shape (batch included).
    ``ctx`` is where it runs: ``gpu(0)`` by default. The JAX package's
    default is ``current_context()``; the port's entry points run on the
    card unless the caller asks for the CPU (``ctx=cpu()``).

    The parameters move to ``ctx`` once. Executors are cached by the full
    input-shape tuple, so :meth:`reshape` between a set of batch sizes
    binds each shape once; the cache keeps the 16 most recently used.
    """

    #: executor-cache LRU bound (distinct input-shape tuples kept alive)
    _EXEC_CACHE_CAP = 16

    def __init__(self, symbol_json_or_file, param_file_or_dict, input_shapes,
                 ctx=None, output_names=None, allow_missing=False):
        ctx = gpu(0) if ctx is None else ctx
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        self._symbol = _strip_loss_heads(load_symbol(symbol_json_or_file))
        if output_names:
            self._symbol = pick_partial_outputs(self._symbol, output_names)
        arg_params, aux_params = load_param_dict(param_file_or_dict)
        if not allow_missing:
            check_missing_params(self._symbol, set(input_shapes),
                                 arg_params, aux_params)
        self._input_names = list(input_shapes.keys())
        self._arg_params = {k: self._on_ctx(v) for k, v in arg_params.items()}
        self._aux_params = {k: self._on_ctx(v) for k, v in aux_params.items()}
        self._exec_cache = OrderedDict()
        self._executor = self._bind(
            {k: tuple(v) for k, v in input_shapes.items()})

    def _on_ctx(self, v):
        if isinstance(v, nd.NDArray):
            return v.as_in_context(self._ctx)
        if hasattr(v, "asnumpy"):            # an NDArray of another package
            v = v.asnumpy()
        return nd.array(v, ctx=self._ctx)

    def _shape_key(self, input_shapes):
        return tuple(sorted((n, tuple(s)) for n, s in input_shapes.items()))

    def _bind(self, input_shapes):
        key = self._shape_key(input_shapes)
        cached = self._exec_cache.get(key)
        if cached is not None:
            self._exec_cache.move_to_end(key)
            return cached
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**input_shapes)
        args = {}
        for name, shape in zip(self._symbol.list_arguments(), arg_shapes):
            if name in self._arg_params:
                p = self._arg_params[name]
                if tuple(p.shape) != tuple(shape):
                    raise MXNetError(
                        "bind changes parameter %s: %s -> %s (only input "
                        "shapes may change)" % (name, tuple(p.shape),
                                                tuple(shape)))
                args[name] = p
            else:
                args[name] = nd.zeros(shape, ctx=self._ctx)
        aux = {}
        for name, shape in zip(self._symbol.list_auxiliary_states(),
                               aux_shapes):
            if name in self._aux_params:
                a = self._aux_params[name]
                if tuple(a.shape) != tuple(shape):
                    raise MXNetError(
                        "bind changes auxiliary state %s: %s -> %s (only "
                        "input shapes may change)" % (name, tuple(a.shape),
                                                      tuple(shape)))
                aux[name] = a
            else:
                aux[name] = nd.zeros(shape, ctx=self._ctx)
        executor = self._symbol.bind(self._ctx, args, aux_states=aux)
        self._exec_cache[key] = executor
        while len(self._exec_cache) > self._EXEC_CACHE_CAP:
            self._exec_cache.popitem(last=False)
        return executor

    def reshape(self, input_shapes):
        """Rebind for new input shapes, keeping the loaded parameters —
        the ``MXPredReshape`` capability. Inputs not named keep their
        current shapes. Returns self."""
        full = {n: tuple(self._executor.arg_dict[n].shape)
                for n in self._input_names}
        unknown = set(input_shapes) - set(full)
        if unknown:
            raise MXNetError("reshape: unknown inputs %s (have %s)"
                             % (sorted(unknown), self._input_names))
        full.update({k: tuple(v) for k, v in input_shapes.items()})
        try:
            self._executor = self._bind(full)
        except MXNetError as e:
            raise MXNetError(str(e).replace("bind changes",
                                            "reshape changes"))
        self._input_names = list(full.keys())
        return self

    def forward(self, **inputs):
        """Run the forward on the named inputs (numpy arrays, tensors or
        NDArrays of the bound shapes); returns self."""
        for k in inputs:
            if k not in self._input_names:
                raise MXNetError("unknown input %r (have %s)"
                                 % (k, self._input_names))
        self._executor.forward(is_train=False, **inputs)
        return self

    def get_output(self, index=0):
        return self._executor.outputs[index]

    @property
    def outputs(self):
        return self._executor.outputs
