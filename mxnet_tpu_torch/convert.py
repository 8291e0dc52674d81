"""Parameters between the JAX package and the port.

Both packages read and write the same ``.params`` files, so a checkpoint
written by ``mxnet_tpu`` (``prefix-symbol.json`` plus ``prefix-0000.params``)
opens directly in the port's ``ServingEngine``. For parameters held in
memory, :func:`from_reference_params` takes the JAX package's dicts as
numpy arrays (or anything with ``asnumpy()``, as its NDArrays and
``Module.get_params`` give them) and returns the port's tensors;
:func:`to_reference_params` goes back to numpy. :func:`from_reference_state`
and :func:`to_reference_state` do the same for a whole ``TrainStep`` state
(params, aux, optimizer state, step counter), whose keys are the same in
both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .ndarray import _to_numpy, _to_tensor


def _host(v):
    if isinstance(v, torch.Tensor):
        return v
    return _to_tensor(v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v))


def from_reference_params(arg_params, aux_params, device="cpu"):
    """``({name: array}, {name: array})`` -> the same dicts of tensors on
    ``device``, with values and dtypes unchanged."""
    dev = torch.device(device)
    return ({k: _host(v).to(dev) for k, v in arg_params.items()},
            {k: _host(v).to(dev) for k, v in (aux_params or {}).items()})


def to_reference_params(arg_params, aux_params):
    """The port's ``({name: tensor}, {name: tensor})`` -> numpy dicts, as
    the JAX package's ``nd.array`` takes them."""
    return ({k: _to_numpy(v) for k, v in arg_params.items()},
            {k: _to_numpy(v) for k, v in (aux_params or {}).items()})


def _tree(v, fn):
    """Apply ``fn`` to every array of an optimizer-state tree (an array,
    None, or a tuple of them)."""
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return tuple(_tree(x, fn) for x in v)
    return fn(v)


def from_reference_state(state, device="cpu"):
    """A JAX ``TrainStep`` state (``{"params", "aux", "opt", "step"}`` of
    arrays) -> the port's state of tensors on ``device``, values and dtypes
    unchanged; ``step`` becomes a 0-d int32 tensor."""
    dev = torch.device(device)

    def put(v):
        return _host(v).to(dev).clone()

    return {"params": {k: put(v) for k, v in state["params"].items()},
            "aux": {k: put(v) for k, v in state["aux"].items()},
            "opt": {k: _tree(v, put) for k, v in state["opt"].items()},
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}


def to_reference_state(state):
    """The port's ``TrainStep`` state -> the same dict of numpy arrays
    (``step`` a 0-d int32 array), as the JAX package's state holds them.
    The arrays are copies: ``TrainStep`` updates its state in place."""
    def copy(v):
        return _to_numpy(v).copy()

    return {"params": {k: copy(v) for k, v in state["params"].items()},
            "aux": {k: copy(v) for k, v in state["aux"].items()},
            "opt": {k: _tree(v, copy) for k, v in state["opt"].items()},
            "step": np.asarray(int(state["step"]), np.int32)}
