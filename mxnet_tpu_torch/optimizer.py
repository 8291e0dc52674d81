"""Optimizers (ref: python/mxnet/optimizer.py).

Counterpart of ``mxnet_tpu/optimizer.py``: the registry and
:func:`create`, the :class:`Optimizer` base (``rescale_grad``,
``clip_gradient``, ``clip_global_norm``, ``lr_mult``/``wd_mult`` resolved
from symbol attrs, ``num_update`` and the per-index update counts, an
``lr_scheduler``), :func:`global_norm` and :func:`clip_by_global_norm`,
the optimizers ``SGD``, ``NAG``, ``SGLD``, ``ccSGD``, ``DCASGD``, ``Adam``,
``AdaGrad``, ``RMSProp``, ``AdaDelta``, ``Ftrl`` and ``Test``, and the
per-index :class:`Updater` that ``Module.update`` and the kvstore drive.

Two update paths, with the same arithmetic in the same order as the JAX
package's:

- ``fused_update`` (``TrainStep``) updates the weight and its state
  tensors in place under ``torch.no_grad()``, where the JAX package returns
  new arrays. It receives the gradient already multiplied by
  ``rescale_grad`` (and scaled by ``clip_global_norm``), ``lr`` and ``wd``
  with the parameter's multipliers applied, ``t`` the 1-based update count
  as a float32 tensor on the device, and ``key`` a ``torch.Generator`` for
  an optimizer that draws noise (``fused_needs_key``).
- ``update`` (the ``Updater``) takes NDArrays and runs the update ops of
  ``ops/optimizer_op.py`` (``sgd_mom_update``, ``adam_update``,
  ``rmsprop_update``, ...) or ``nd`` arithmetic, as the JAX package's does.

``Updater.get_states`` pickles ``{index: numpy array or tuple}`` exactly as
the JAX package writes it, so a ``.states`` file opens in either package.
"""
from __future__ import annotations

import math
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


def _zeros_like(weight):
    """A zero state buffer like ``weight`` (an NDArray or a tensor)."""
    if isinstance(weight, NDArray):
        return NDArray(torch.zeros_like(weight.data))
    return torch.zeros_like(weight)


def _copy(weight):
    """A copy of ``weight`` (an NDArray or a tensor)."""
    if isinstance(weight, NDArray):
        return weight.copy()
    return weight.detach().clone()


class Optimizer(object):
    """Base optimizer. ``clip_global_norm`` is applied by the fused step
    across every gradient at once; the per-index :class:`Updater` cannot
    see them all and raises (use :func:`clip_by_global_norm` first)."""

    fused_supported = False

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, clip_global_norm=None,
                 learning_rate=0.01, lr_scheduler=None, sym=None,
                 begin_num_update=0):
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
        self.clip_global_norm = clip_global_norm
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
        """The state the fused update carries for the tensor ``weight``:
        :meth:`create_state`'s structure (None, a tensor, or a tuple)."""
        return self.create_state(0, weight)

    def fused_update(self, name, weight, grad, state, lr, wd, t, key=None):
        """Update ``weight`` and ``state`` in place; returns them."""
        raise MXNetError("optimizer %s has no fused update"
                         % type(self).__name__)

    def _fused_clip(self, g):
        if self.clip_gradient is None:
            return g
        return torch.clamp(g, -self.clip_gradient, self.clip_gradient)

    def _clip(self, g):
        """``g`` (an NDArray) clipped by ``clip_gradient``."""
        if self.clip_gradient is None:
            return g
        return nd.clip(g, a_min=-self.clip_gradient, a_max=self.clip_gradient)

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

    def _base_attrs(self, index):
        a = {"lr": self._get_lr(index), "wd": self._get_wd(index),
             "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            a["clip_gradient"] = self.clip_gradient
        return a


def create(name, **kwargs):
    """Create a registered optimizer by name (ref: mx.optimizer.create)."""
    return Optimizer.create_optimizer(name, **kwargs)


# -- global-norm clipping: the per-index side of clip_global_norm ------------

def global_norm(arrays):
    """sqrt(sum of squared L2 norms) over a list of NDArray/array
    gradients, accumulated in float32 per array (as the JAX package's)."""
    total = 0.0
    for a in arrays:
        v = a.asnumpy() if isinstance(a, NDArray) else np.asarray(a)
        total += float(np.sum(np.square(v.astype(np.float32))))
    return float(np.sqrt(total))


def clip_by_global_norm(arrays, max_norm):
    """Scale every NDArray in ``arrays`` in place by ``min(1, max_norm /
    global_norm)``. Returns the global norm before the clip."""
    norm = global_norm(arrays)
    scale = min(1.0, float(max_norm) / max(norm, 1e-12))
    if scale < 1.0:
        for a in arrays:
            a *= scale
    return norm


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
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._base_attrs(index)
        if state is not None:
            nd.sgd_mom_update(weight, grad, state, out=[weight, state],
                              momentum=self.momentum, **attrs)
        else:
            nd.sgd_update(weight, grad, out=weight, **attrs)

    @torch.no_grad()
    def fused_update(self, name, weight, grad, state, lr, wd, t, key=None):
        g = self._fused_clip(grad)
        if state is None:
            weight.sub_(lr * (g + wd * weight))
            return weight, None
        state.mul_(self.momentum).sub_(lr * (g + wd * weight))
        weight.add_(state)
        return weight, state


@register
class NAG(SGD):
    """Nesterov accelerated SGD (ref: optimizer.py NAG)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._clip(grad * self.rescale_grad)
        if state is not None:
            mom = state
            mom *= self.momentum
            g += wd * weight
            mom += g
            g += self.momentum * mom
            weight += -lr * g
        else:
            weight += -lr * (g + wd * weight)

    @torch.no_grad()
    def fused_update(self, name, weight, grad, state, lr, wd, t, key=None):
        g = self._fused_clip(grad)
        if state is None:
            weight.sub_(lr * (g + wd * weight))
            return weight, None
        g = g + wd * weight
        state.mul_(self.momentum).add_(g)
        weight.sub_(lr * (g + self.momentum * state))
        return weight, state


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics (ref: optimizer.py SGLD):
    ``w += -lr/2 (g + wd w) + N(0, lr)``."""

    fused_supported = True
    fused_needs_key = True

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._clip(grad * self.rescale_grad)
        noise = nd.normal(loc=0, scale=math.sqrt(lr), shape=weight.shape,
                          ctx=weight.context)
        weight += -lr / 2 * (g + wd * weight) + noise

    @torch.no_grad()
    def fused_update(self, name, weight, grad, state, lr, wd, t, key=None):
        g = self._fused_clip(grad)
        noise = math.sqrt(lr) * torch.randn(
            weight.shape, generator=key, device=weight.device,
            dtype=weight.dtype)
        weight.sub_(lr / 2 * (g + wd * weight)).add_(noise)
        return weight, None


@register
class ccSGD(SGD):
    """Kept for API parity; same math as SGD (ref: optimizer.py ccSGD)."""


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (ref: optimizer.py DCASGD)."""

    fused_supported = True

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, _copy(weight))
        return (_zeros_like(weight), _copy(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._clip(grad * self.rescale_grad)
        mom, previous_weight = state
        comp = g + wd * weight + self.lamda * g * g * (weight - previous_weight)
        if mom is not None:
            mom *= self.momentum
            mom += -lr * comp
            d = mom
        else:
            d = -lr * comp
        previous_weight[:] = weight
        weight += d

    @torch.no_grad()
    def fused_update(self, name, weight, grad, state, lr, wd, t, key=None):
        g = self._fused_clip(grad)
        mom, prev_w = state
        comp = g + wd * weight + self.lamda * g * g * (weight - prev_w)
        if mom is not None:
            d = mom.mul_(self.momentum).sub_(lr * comp)
        else:
            d = -lr * comp
        prev_w.copy_(weight)
        weight.add_(d)
        return weight, state


@register
class Adam(Optimizer):
    """Adam (ref: optimizer.py Adam): ``wd * w`` is added to the gradient
    before the clip, and the bias correction is folded into the rate."""

    fused_supported = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        mean, var = state
        attrs = self._base_attrs(index)
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        attrs["lr"] = attrs["lr"] * math.sqrt(coef2) / coef1
        nd.adam_update(weight, grad, mean, var, out=[weight, mean, var],
                       beta1=self.beta1, beta2=self.beta2,
                       epsilon=self.epsilon, **attrs)

    @torch.no_grad()
    def fused_update(self, name, weight, grad, state, lr, wd, t, key=None):
        mean, var = state
        g = self._fused_clip(grad + wd * weight)
        mean.mul_(self.beta1).add_((1 - self.beta1) * g)
        var.mul_(self.beta2).add_((1 - self.beta2) * g * g)
        lr_t = lr * torch.sqrt(1 - torch.pow(self.beta2, t)) \
            / (1 - torch.pow(self.beta1, t))
        weight.sub_(lr_t * mean / (torch.sqrt(var) + self.epsilon))
        return weight, state


@register
class AdaGrad(Optimizer):
    """AdaGrad (ref: optimizer.py AdaGrad)."""

    fused_supported = True

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._clip(grad * self.rescale_grad)
        history = state
        history += g * g
        weight += -lr * (g / nd.sqrt(history + self.float_stable_eps)
                         + wd * weight)

    @torch.no_grad()
    def fused_update(self, name, weight, grad, state, lr, wd, t, key=None):
        g = self._fused_clip(grad)
        state.add_(g * g)
        weight.sub_(lr * (g / torch.sqrt(state + self.float_stable_eps)
                          + wd * weight))
        return weight, state


@register
class RMSProp(Optimizer):
    """RMSProp, plain or centered (ref: optimizer.py RMSProp)."""

    fused_supported = True

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))
        return (_zeros_like(weight),)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._base_attrs(index)
        attrs.update(gamma1=self.gamma1, epsilon=self.epsilon)
        if self.clip_weights:
            attrs["clip_weights"] = self.clip_weights
        if not self.centered:
            (n,) = state
            nd.rmsprop_update(weight, grad, n, out=[weight, n], **attrs)
        else:
            n, g_avg, delta = state
            nd.rmspropalex_update(weight, grad, n, g_avg, delta,
                                  out=[weight, n, g_avg, delta],
                                  gamma2=self.gamma2, **attrs)

    def _clip_weights(self, w):
        if self.clip_weights:
            w.clamp_(-self.clip_weights, self.clip_weights)

    @torch.no_grad()
    def fused_update(self, name, weight, grad, state, lr, wd, t, key=None):
        g = self._fused_clip(grad + wd * weight)
        if not self.centered:
            (n,) = state
            n.mul_(self.gamma1).add_((1 - self.gamma1) * g * g)
            weight.sub_(lr * g / torch.sqrt(n + self.epsilon))
            self._clip_weights(weight)
            return weight, state
        n, g_avg, delta = state
        n.mul_(self.gamma1).add_((1 - self.gamma1) * g * g)
        g_avg.mul_(self.gamma1).add_((1 - self.gamma1) * g)
        delta.mul_(self.gamma2).sub_(
            lr * g / torch.sqrt(n - g_avg * g_avg + self.epsilon))
        weight.add_(delta)
        self._clip_weights(weight)
        return weight, state


@register
class AdaDelta(Optimizer):
    """AdaDelta (ref: optimizer.py AdaDelta); takes no learning rate."""

    fused_supported = True

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        g = self._clip(grad * self.rescale_grad)
        acc_g, acc_delta = state
        acc_g[:] = self.rho * acc_g + (1.0 - self.rho) * g * g
        current_delta = (nd.sqrt(acc_delta + self.epsilon)
                         / nd.sqrt(acc_g + self.epsilon)) * g
        acc_delta[:] = self.rho * acc_delta + (1.0 - self.rho) \
            * current_delta * current_delta
        weight[:] = weight - current_delta - wd * weight

    @torch.no_grad()
    def fused_update(self, name, weight, grad, state, lr, wd, t, key=None):
        g = self._fused_clip(grad)
        acc_g, acc_delta = state
        acc_g.mul_(self.rho).add_((1.0 - self.rho) * g * g)
        cur = (torch.sqrt(acc_delta + self.epsilon)
               / torch.sqrt(acc_g + self.epsilon)) * g
        acc_delta.mul_(self.rho).add_((1.0 - self.rho) * cur * cur)
        decay = wd * weight
        weight.sub_(cur).sub_(decay)
        return weight, state


@register
class Ftrl(Optimizer):
    """FTRL-proximal (ref: optimizer.py Ftrl)."""

    fused_supported = True

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight),    # z
                _zeros_like(weight))    # n

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._clip(grad * self.rescale_grad)
        z, n = state
        sigma = -nd.sqrt(n)
        n += g * g
        sigma += nd.sqrt(n)
        sigma /= lr
        z += g - sigma * weight
        weight[:] = (nd.sign(z) * self.lamda1 - z) \
            / ((self.beta + nd.sqrt(n)) / lr + wd) * (nd.abs(z) > self.lamda1)

    @torch.no_grad()
    def fused_update(self, name, weight, grad, state, lr, wd, t, key=None):
        g = self._fused_clip(grad)
        z, n = state
        sqrt_n = torch.sqrt(n)
        n.add_(g * g)
        sqrt_new = torch.sqrt(n)
        sigma = (sqrt_new - sqrt_n) / lr
        z.add_(g).sub_(sigma * weight)
        w = (torch.sign(z) * self.lamda1 - z) \
            / ((self.beta + sqrt_new) / lr + wd) \
            * (torch.abs(z) > self.lamda1)
        weight.copy_(w)
        return weight, state


@register
class Test(Optimizer):
    """Adds the gradient; the state holds the new weight (ref:
    optimizer.py Test, for kvstore tests)."""

    fused_supported = True

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        weight += grad * self.rescale_grad
        state[:] = weight

    @torch.no_grad()
    def fused_update(self, name, weight, grad, state, lr, wd, t, key=None):
        weight.add_(grad)
        state.copy_(weight)
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
        if getattr(self.optimizer, "clip_global_norm", None):
            raise MXNetError(
                "clip_global_norm is applied by the fused train step, which "
                "sees every gradient at once; the per-index updater cannot. "
                "Use clip_gradient (elementwise), or call "
                "optimizer.clip_by_global_norm(grads, max_norm) over the "
                "full gradient list before updating.")
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
