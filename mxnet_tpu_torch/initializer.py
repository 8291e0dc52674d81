"""Weight initializers (ref: python/mxnet/initializer.py).

Counterpart of ``mxnet_tpu/initializer.py``, with the same dispatch: an
Initializer is called with an :class:`InitDesc` (name and symbol attrs) and
routes by name suffix (``*weight`` to the method, ``*bias``, ``*beta`` and
``*moving_mean`` to zero, ``*gamma`` and ``*moving_var`` to one), with an
``__init__`` attr overriding it. It fills a tensor (or an NDArray's) in
place, drawing from the tensor's device generator in ``random.py``; the
values therefore differ from the JAX package's for the same seed, while
their distribution is the same.
"""
from __future__ import annotations

import json
import math

import torch

from .base import MXNetError
from . import random as _random

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def _tensor(arr):
    """The tensor to fill: ``arr`` itself or an NDArray's."""
    return arr if isinstance(arr, torch.Tensor) else arr.data


class InitDesc(str):
    """Name + attrs descriptor (ref: initializer.py InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer(object):
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        t = _tensor(arr)
        init = desc.attrs.get("__init__", "")
        if init:
            klass, kwargs = json.loads(init)
            if klass.lower() not in _INIT_REGISTRY:
                raise MXNetError("initializer %r is not ported" % klass)
            _INIT_REGISTRY[klass.lower()](**kwargs)._init_weight(desc, t)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, t)
        elif name.endswith("bias") or name.endswith("beta"):
            t.zero_()
        elif name.endswith("gamma"):
            t.fill_(1.0)
        elif name.endswith("moving_mean") or name.endswith("moving_avg"):
            t.zero_()
        elif name.endswith("moving_var") or name.endswith("moving_inv_var"):
            t.fill_(1.0)
        else:
            self._init_default(desc, t)

    def _init_weight(self, desc, t):
        raise NotImplementedError()

    def _init_default(self, desc, t):
        self._init_weight(desc, t)


def _uniform_(t, low, high):
    with torch.no_grad():
        t.uniform_(low, high, generator=_random.generator(t.device))


def _normal_(t, std):
    with torch.no_grad():
        t.normal_(0.0, std, generator=_random.generator(t.device))


@register
class Zero(Initializer):
    """Explicit constant choice overrides suffix dispatch."""

    def __call__(self, desc, arr):
        _tensor(arr).zero_()

    def _init_weight(self, _, t):
        t.zero_()


@register
class One(Initializer):
    def __call__(self, desc, arr):
        _tensor(arr).fill_(1.0)

    def _init_weight(self, _, t):
        t.fill_(1.0)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, t):
        _uniform_(t, -self.scale, self.scale)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, t):
        _normal_(t, self.sigma)


@register
class Xavier(Initializer):
    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, _, t):
        shape = t.shape
        hw_scale = 1.0
        if len(shape) > 2:
            hw_scale = float(math.prod(shape[2:]))
        fan_in = shape[1] * hw_scale if len(shape) > 1 else shape[0]
        fan_out = shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError("Xavier: bad factor_type %r" % self.factor_type)
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _uniform_(t, -scale, scale)
        elif self.rnd_type == "gaussian":
            _normal_(t, scale)
        else:
            raise MXNetError("Xavier: bad rnd_type %r" % self.rnd_type)
