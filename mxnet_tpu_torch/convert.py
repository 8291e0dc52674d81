"""Parameters between the JAX package and the port.

Both packages read and write the same ``.params`` files, so a checkpoint
written by ``mxnet_tpu`` (``prefix-symbol.json`` plus ``prefix-0000.params``)
opens directly in the port's ``ServingEngine``. For parameters held in
memory, :func:`from_reference_params` takes the JAX package's dicts as
numpy arrays (or anything with ``asnumpy()``, as its NDArrays and
``Module.get_params`` give them) and returns the port's tensors;
:func:`to_reference_params` goes back to numpy.
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
