"""Weight initializers (ref: python/mxnet/initializer.py).

Counterpart of ``mxnet_tpu/initializer.py``, with the same dispatch: an
Initializer is called with an :class:`InitDesc` (name and symbol attrs) and
routes by name suffix (``*weight`` to the method, ``*bias``, ``*beta`` and
``*moving_mean`` to zero, ``*gamma`` and ``*moving_var`` to one), with an
``__init__`` attr overriding it. It fills a tensor (or an NDArray's) in
place, drawing from the tensor's device generator in ``random.py``; the
values of the random initializers therefore differ from the JAX package's
for the same seed, while their distribution is the same. ``Zero``,
``One``, ``Constant``, ``Bilinear``, ``LSTMBias``, ``Load`` and ``Mixed``
give the same values, and so does ``FusedRNN`` over one of them.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
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
        elif name.endswith("bias"):
            self._init_bias(desc, t)
        elif name.endswith("gamma"):
            self._init_gamma(desc, t)
        elif name.endswith("beta"):
            self._init_beta(desc, t)
        elif name.endswith("moving_mean") or name.endswith("moving_avg"):
            t.zero_()
        elif name.endswith("moving_var") or name.endswith("moving_inv_var"):
            t.fill_(1.0)
        else:
            self._init_default(desc, t)

    # -- leaf rules, which a subclass may override (LSTMBias) -------------
    def _init_bias(self, _, t):
        t.zero_()

    def _init_gamma(self, _, t):
        t.fill_(1.0)

    def _init_beta(self, _, t):
        t.zero_()

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


def _fill_(t, values):
    """Copy ``values`` (a tensor, or anything numpy takes) into ``t``."""
    src = (values if isinstance(values, torch.Tensor)
           else torch.from_numpy(np.array(values)))
    with torch.no_grad():
        t.copy_(src.reshape(t.shape))


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
class Constant(Initializer):
    """Every array, whatever its name, to ``value``."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def __call__(self, desc, arr):
        _tensor(arr).fill_(self.value)

    def _init_weight(self, _, t):
        t.fill_(self.value)


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


@register
class MSRAPrelu(Xavier):
    """Xavier gaussian with magnitude ``2 / (1 + slope^2)`` (He et al.,
    for PReLU; ref: initializer.py MSRAPrelu)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor of an SVD of a random
    (rows, rest) matrix, uniform in [-1, 1] or standard normal (ref:
    initializer.py Orthogonal). Drawn and factored in float64 on the
    CPU."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, t):
        nout = t.shape[0]
        nin = int(math.prod(t.shape[1:]))
        tmp = torch.empty((nout, nin), dtype=torch.float64)
        gen = _random.generator("cpu")
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=gen)
        else:
            tmp.normal_(0.0, 1.0, generator=gen)
        u, _s, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        _fill_(t, (self.scale * q).to(t.dtype))


@register
class Bilinear(Initializer):
    """A bilinear upsampling kernel over the last two axes (ref:
    initializer.py Bilinear)."""

    def _init_weight(self, _, t):
        shape = t.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(int(np.prod(shape)))
        x = (i % shape[3]).astype(np.float64)
        y = ((i // shape[3]) % shape[2]).astype(np.float64)
        w = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        _fill_(t, w.astype(np.float32))


@register
class LSTMBias(Initializer):
    """The forget gate's bias to ``forget_bias``, the other gates' to 0
    (ref: initializer.py LSTMBias; gate order i, f, c, o)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, t):
        num_hidden = t.shape[0] // 4
        with torch.no_grad():
            t.zero_()
            t[num_hidden:2 * num_hidden] = self.forget_bias

    _init_bias = _init_weight
    _init_default = _init_weight


class Load(object):
    """Initialize from a dict of arrays (numpy, tensors or either
    package's NDArrays; ``arg:``/``aux:`` prefixes dropped), falling back
    to ``default_init`` (ref: initializer.py Load)."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {
            (k[4:] if k.startswith("arg:") or k.startswith("aux:") else k): v
            for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        name = str(name)
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(_tensor(arr).shape):
                raise MXNetError("Load: shape mismatch for %s" % name)
            if hasattr(src, "asnumpy"):
                src = src.asnumpy()
            _fill_(_tensor(arr), src)
        else:
            if self.default_init is None:
                raise MXNetError("Load: no init for %r" % name)
            self.default_init(name, arr)


class Mixed(object):
    """The first initializer whose regex pattern matches the name (ref:
    initializer.py Mixed)."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise MXNetError("Mixed: no matching pattern for %r" % str(name))


@register
class FusedRNN(Initializer):
    """Initialize a FusedRNNCell's packed parameter vector (ref:
    initializer.py FusedRNN): unpack it into each cell's i2h/h2h weights
    and biases, apply ``init`` (or the global initializer) to each, set the
    LSTM forget-gate bias slice to ``forget_bias``, and pack it back."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = _INIT_REGISTRY[klass.lower()](**kwargs)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, t):
        from .rnn import rnn_cell
        from .ndarray import NDArray
        cell = rnn_cell.FusedRNNCell(
            self._num_hidden, self._num_layers, self._mode,
            self._bidirectional, forget_bias=self._forget_bias, prefix="")
        args = cell.unpack_weights({"parameters": NDArray(t.detach())})
        h = self._num_hidden
        for name, sub in args.items():
            sub_desc = InitDesc(name, global_init=desc.global_init)
            if self._init is None:
                if desc.global_init is None:
                    raise MXNetError(
                        "FusedRNN: no init given and no global initializer")
                desc.global_init(sub_desc, sub)
            else:
                self._init(sub_desc, sub)
            if self._mode == "lstm" and name.endswith("_bias"):
                # gate order i, f, c, o (ops/rnn_op.py): the forget slice
                # gets the bias that keeps early memory open
                with torch.no_grad():
                    sub.data[h:2 * h] = self._forget_bias
        with torch.no_grad():
            t.copy_(cell.pack_weights(args)["parameters"].data)
