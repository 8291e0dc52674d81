"""Optimizers (ref: python/mxnet/optimizer.py).

Counterpart of ``mxnet_tpu/optimizer.py``: the registry and
:func:`create`, the :class:`Optimizer` base (``rescale_grad``,
``clip_gradient``, ``lr_mult``/``wd_mult`` resolved from symbol attrs,
``num_update`` and the per-index update counts, an ``lr_scheduler``),
:class:`SGD`, and the per-index :class:`Updater` that ``Module.update``
and the kvstore drive.

Two update paths, with the same arithmetic: ``fused_update`` (``TrainStep``)
updates the weight and its state tensors in place under
``torch.no_grad()``, where the JAX package returns new arrays; ``update``
(the ``Updater``) takes NDArrays and runs the ``sgd_mom_update`` op, as the
JAX package's does. ``Updater.get_states`` pickles ``{index: numpy array or
tuple}`` exactly as the JAX package writes it, so a ``.states`` file opens
in either package. The other optimizers come in a later slice.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from .base import MXNetError
from . import ndarray as nd
from .ndarray import NDArray

_OPT_REGISTRY = {}


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class Optimizer(object):
    """Base optimizer. ``fused_update`` receives the gradient already
    multiplied by ``rescale_grad``; ``lr`` and ``wd`` arrive with the
    parameter's multipliers applied."""

    fused_supported = False

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() not in _OPT_REGISTRY:
            raise MXNetError("optimizer %r not registered" % name)
        return _OPT_REGISTRY[name.lower()](**kwargs)

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        """Update the NDArray ``weight`` (and ``state``) from ``grad``, the
        per-index path of :class:`Updater`."""
        raise NotImplementedError()

    def create_fused_state(self, weight):
        """The state the fused update carries for ``weight`` (a tensor,
        or None)."""
        return self.create_state(0, weight)

    def fused_update(self, name, weight, grad, state, lr, wd, t):
        """Update ``weight`` and ``state`` in place; returns them."""
        raise MXNetError("optimizer %s has no fused update"
                         % type(self).__name__)

    def _fused_clip(self, g):
        if self.clip_gradient is None:
            return g
        return torch.clamp(g, -self.clip_gradient, self.clip_gradient)

    # -- lr / wd multipliers (attr-aware, ref: optimizer.py) ------------
    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)


    # -- per-index clock and hyper-parameters (ref: optimizer.py) --------
    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd


def create(name, **kwargs):
    """Create a registered optimizer by name (ref: mx.optimizer.create)."""
    return Optimizer.create_optimizer(name, **kwargs)


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay:
    ``m = momentum * m - lr * (g + wd * w); w += m``."""

    fused_supported = True

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        if isinstance(weight, NDArray):
            return NDArray(torch.zeros_like(weight.data))
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = {"lr": self._get_lr(index), "wd": self._get_wd(index),
                 "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            attrs["clip_gradient"] = self.clip_gradient
        if state is not None:
            nd.sgd_mom_update(weight, grad, state, out=[weight, state],
                              momentum=self.momentum, **attrs)
        else:
            nd.sgd_update(weight, grad, out=weight, **attrs)

    @torch.no_grad()
    def fused_update(self, name, weight, grad, state, lr, wd, t):
        g = self._fused_clip(grad)
        if state is None:
            weight.sub_(lr * (g + wd * weight))
            return weight, None
        state.mul_(self.momentum).sub_(lr * (g + wd * weight))
        weight.add_(state)
        return weight, state


def _on_device(state, device):
    """``state`` (an NDArray, a tuple of them or None) on ``device``."""
    if isinstance(state, tuple):
        return tuple(_on_device(s, device) for s in state)
    if isinstance(state, NDArray) and state.data.device != device:
        return NDArray(state.data.to(device))
    return state


class Updater(object):
    """Stateful per-index weight updater (ref: optimizer.py Updater): the
    object ``Module.update`` calls and the kvstore's ``set_optimizer``
    builds."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        else:
            # loaded states land on the host: move them once, to the weight
            self.states[index] = _on_device(self.states[index],
                                            weight.data.device)
        self.optimizer.update(index, weight, grad, self.states[index])

    def set_states(self, states):
        """Load pickled ``{index: numpy array or tuple}`` states (either
        package's ``get_states``); arrays land on the host and move to the
        weight's device at the next update."""
        def dev(x):
            if isinstance(x, np.ndarray):
                return NDArray(torch.from_numpy(np.array(x)))
            if isinstance(x, tuple):
                return tuple(dev(i) for i in x)
            return x
        self.states = {k: dev(v) for k, v in pickle.loads(states).items()}

    @staticmethod
    def serialize_states(states):
        """Pickle an ``{index: state}`` dict with the arrays as host numpy
        arrays: the bytes the JAX package writes for the same states."""
        def host(x):
            if isinstance(x, NDArray):
                return x.asnumpy()
            if isinstance(x, tuple):
                return tuple(host(i) for i in x)
            return x
        return pickle.dumps({k: host(v) for k, v in states.items()})

    def get_states(self):
        return self.serialize_states(self.states)


def get_updater(optimizer):
    return Updater(optimizer)
