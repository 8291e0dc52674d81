"""Optimizers (ref: python/mxnet/optimizer.py).

Counterpart of ``mxnet_tpu/optimizer.py``, the fused path that
``TrainStep`` drives: the registry and :func:`create`, the
:class:`Optimizer` base (``rescale_grad``, ``clip_gradient``,
``lr_mult``/``wd_mult`` resolved from symbol attrs, ``num_update``, an
``lr_scheduler``), and :class:`SGD`. ``fused_update`` updates the weight
and its state in place under ``torch.no_grad()``, where the JAX package
returns new arrays; the arithmetic is the same. The imperative ``Updater``
path and the other optimizers come in a later slice.
"""
from __future__ import annotations

import torch

from .base import MXNetError

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
        return torch.zeros_like(weight)

    @torch.no_grad()
    def fused_update(self, name, weight, grad, state, lr, wd, t):
        g = self._fused_clip(grad)
        if state is None:
            weight.sub_(lr * (g + wd * weight))
            return weight, None
        state.mul_(self.momentum).sub_(lr * (g + wd * weight))
        weight.add_(state)
        return weight, state
