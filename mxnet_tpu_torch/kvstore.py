"""KVStore: the key-value store of data-parallel gradient aggregation,
``local`` mode (ref: python/mxnet/kvstore.py, src/kvstore/kvstore_local.h).

Counterpart of ``mxnet_tpu/kvstore.py:KVStore``: ``push`` sums each key's
values across the given device list and applies the updater to the stored
value (or stores the sum), ``pull`` copies the stored value into each
output. ``set_optimizer`` round-trips the optimizer through pickle, as the
reference's controller command does, and the optimizer states save and
load in the JAX package's ``.states`` layout. The fault policy (deadlines,
retries, health checks) and the ``dist_*`` modes are not ported yet:
``create("dist_*")`` raises naming the mode.
"""
from __future__ import annotations

import pickle

from .base import MXNetError
from . import optimizer as opt
from .ndarray import NDArray


def _key_value(key, value):
    """Normalize to (keys, list of value lists)."""
    if isinstance(key, (int, str)):
        return [key], [value if isinstance(value, (list, tuple))
                       else [value]]
    if len(key) != len(value):
        raise MXNetError("kvstore: %d keys but %d values"
                         % (len(key), len(value)))
    return list(key), [v if isinstance(v, (list, tuple)) else [v]
                       for v in value]


class KVStore(object):
    """Single-process KVStore (types ``local`` and ``device``)."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        keys, values = _key_value(key, value)
        for k, vlist in zip(keys, values):
            if k in self._store:
                raise MXNetError("init: key %r already initialized" % (k,))
            self._store[k] = vlist[0].copy()

    def push(self, key, value, priority=0):
        """Sum each key's values and update (or replace) the stored value.
        ``priority`` is accepted for parity; pushes run in call order."""
        keys, values = _key_value(key, value)
        for k, vlist in zip(keys, values):
            if k not in self._store:
                raise MXNetError("push: key %r not initialized" % (k,))
            stored = self._store[k]
            merged = vlist[0].data.to(stored.data.device)
            for v in vlist[1:]:
                merged = merged + v.data.to(merged.device)
            if self._updater is not None:
                self._updater(k, NDArray(merged), stored)
            else:
                stored._set_data(merged)

    def pull(self, key, out=None, priority=0):
        if out is None:
            raise MXNetError("pull: out= is required")
        keys, outs = _key_value(key, out)
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("pull: key %r not initialized" % (k,))
            for o in olist:
                self._store[k].copyto(o)

    def set_optimizer(self, optimizer):
        """Update through an :class:`~mxnet_tpu_torch.optimizer.Updater`
        of a pickled copy of ``optimizer``."""
        self._updater = opt.get_updater(pickle.loads(pickle.dumps(optimizer)))

    def save_optimizer_states(self, fname):
        """Write the updater's states; returns the bytes written."""
        if self._updater is None:
            raise MXNetError("save_optimizer_states: this kvstore has no "
                             "optimizer (call set_optimizer first)")
        from .model import atomic_write_bytes
        data = self._updater.get_states()
        atomic_write_bytes(fname, data)
        return data

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("load_optimizer_states: this kvstore has no "
                             "optimizer (call set_optimizer first)")
        from .model import apply_optimizer_states
        apply_optimizer_states(self._updater.set_states, fname)


def create(name="local"):
    """Create a KVStore: ``local`` or ``device`` (one implementation).
    The ``dist_*`` modes raise naming themselves (not ported yet)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if "dist" in name:
        raise MXNetError("kvstore %r: the distributed kvstore modes are not "
                         "ported yet" % name)
    if name in ("local", "device", "local_allreduce_cpu",
                "local_allreduce_device"):
        return KVStore(name)
    raise MXNetError("unknown kvstore type %r" % name)
