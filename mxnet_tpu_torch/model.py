"""Model-level helpers (ref: python/mxnet/model.py).

Counterpart of the part of ``mxnet_tpu/model.py`` that ``Module`` uses:
the kvstore decision table and update helpers, the atomic file write, the
optimizer-states reader, and ``save_checkpoint``/``load_checkpoint`` in the
dmlc ``.params`` layout, so a checkpoint from either package opens in the
other. ``load_checkpoint`` puts the arrays on the host; the module that
binds them copies them to its device. ``CheckpointManager``,
``AsyncCheckpointWriter`` and ``FeedForward`` are not ported yet.
"""
from __future__ import annotations

import logging
import os
from collections import namedtuple

import numpy as np

from .base import MXNetError
from . import dmlc_serial
from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym
from .context import cpu

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """The reference's decision table (ref: model.py _create_kvstore):
    ``(kvstore or None, update_on_kvstore)``. One device needs no store."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(np.prod(param.shape)
                               for param in arg_params.values())
                if max_size < 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return (kv, update_on_kvstore)


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """ref: model.py _initialize_kvstore."""
    for idx, param_on_devs in enumerate(param_arrays):
        kvstore.init(idx, arg_params[param_names[idx]])
        if update_on_kvstore:
            kvstore.pull(idx, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """Push each gradient, pull the updated weight back (ref: model.py)."""
    for index, (arg, grad) in enumerate(zip(param_arrays, grad_arrays)):
        if grad is None:
            continue
        kvstore.push(index, grad, priority=-index)
        kvstore.pull(index, arg, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """Aggregate on the kvstore (where there is one), update locally
    (ref: model.py _update_params)."""
    for index, (arg, grad) in enumerate(zip(param_arrays, grad_arrays)):
        if grad is None:
            continue
        if kvstore:
            kvstore.push(index, grad, priority=-index)
            kvstore.pull(index, grad, priority=-index)
        updater(index, grad, arg)


def _fsync_dir(dirname):
    """Make a rename durable (the directory entry needs its own fsync);
    best effort where directories cannot be opened."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path, data):
    """Publish ``data`` at ``path`` atomically: temp file, fsync, rename. A
    crash mid-write leaves the previous file, never a truncated one."""
    path = os.fspath(path)
    tmp = "%s.tmp-%d" % (path, os.getpid())
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def apply_optimizer_states(set_states, fname):
    """Read an optimizer-states file and feed it to ``set_states``; read
    errors and unpickling failures become MXNetErrors naming the file."""
    try:
        with open(fname, "rb") as fin:
            data = fin.read()
    except OSError as e:
        raise MXNetError(
            "cannot read optimizer states %r: %s — save them with "
            "save_optimizer_states (or Module.save_checkpoint("
            "save_optimizer_states=True)) before loading" % (fname, e))
    try:
        set_states(data)
    except MXNetError:
        raise
    except Exception as e:
        raise MXNetError(
            "optimizer states file %r is corrupt or truncated (%s: %s); "
            "re-save it or fall back to an earlier checkpoint"
            % (fname, type(e).__name__, e))


def _param_save_bytes(arg_params, aux_params):
    """The dmlc ``.params`` bytes of ``arg:``/``aux:`` prefixed arrays."""
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    names = list(save_dict.keys())
    arrs = [v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)
            for v in (save_dict[k] for k in names)]
    return dmlc_serial.dumps(arrs, names)


def _split_param_dict(save_dict, fname):
    """Split a loaded ``{prefix:name: NDArray}`` dict into (arg, aux),
    rejecting malformed keys with an error naming the file and key."""
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        if ":" not in k:
            raise MXNetError(
                "invalid parameter file %r: key %r is malformed (expected "
                "'arg:<name>' or 'aux:<name>')" % (fname, k))
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            raise MXNetError(
                "invalid parameter file %r: key %r has unknown prefix %r "
                "(expected 'arg' or 'aux')" % (fname, k, tp))
    return arg_params, aux_params


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Save ``prefix-symbol.json`` and ``prefix-%04d.params`` (each
    atomically)."""
    if symbol is not None:
        atomic_write_bytes("%s-symbol.json" % prefix,
                           symbol.tojson().encode())
    param_name = "%s-%04d.params" % (prefix, epoch)
    atomic_write_bytes(param_name, _param_save_bytes(arg_params, aux_params))
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint, the arrays on
    the host."""
    symbol = sym.load("%s-symbol.json" % prefix)
    fname = "%s-%04d.params" % (prefix, epoch)
    save_dict = nd.load(fname, ctx=cpu())
    arg_params, aux_params = _split_param_dict(save_dict, fname)
    return (symbol, arg_params, aux_params)
