"""Checkpoint helpers shared by the serving tier.

Counterparts of the helpers in ``mxnet_tpu/predictor.py`` that the engine
imports: loss-head stripping, symbol and param loading, partial-output
picking and the missing-parameter check. The standalone ``Predictor``
class comes in a later slice.
"""
from __future__ import annotations

from .base import MXNetError, attr_bool
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
        loaded = nd.load(param_file_or_dict)
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
