"""RNN checkpoint helpers (ref: python/mxnet/rnn/rnn.py): save and load
parameters with the cells packing and unpacking their weights.
Counterpart of ``mxnet_tpu/rnn/rnn.py``; the files are the JAX package's."""
from __future__ import annotations

from .. import model as _model


def _cells(cells):
    return list(cells) if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Pack each cell's weights, then save the checkpoint."""
    for cell in _cells(cells):
        arg_params = cell.pack_weights(arg_params)
    _model.save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load a checkpoint, then unpack each cell's weights."""
    sym, arg, aux = _model.load_checkpoint(prefix, epoch)
    for cell in _cells(cells):
        arg = cell.unpack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """An epoch-end callback that saves an RNN checkpoint every
    ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
