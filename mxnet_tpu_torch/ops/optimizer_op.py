"""Optimizer update operators.

Counterpart of ``mxnet_tpu/ops/optimizer_op.py`` (ref:
src/operator/optimizer_op-inl.h): ``sgd_update``, ``sgd_mom_update``,
``adam_update``, ``rmsprop_update`` and ``rmspropalex_update``, each a
plain PyTorch expression returning the new weight and states (the
imperative API writes them back through ``out=``). SGD clips the
rescaled gradient before adding weight decay; Adam and RMSProp add
``wd * weight`` first and clip the sum, as the JAX package does.
"""
from __future__ import annotations

import torch

from ..base import attr_float
from .registry import OpDef, register_def


def _common(attrs):
    lr = attr_float(attrs.get("lr"))
    wd = attr_float(attrs.get("wd", 0.0), 0.0)
    rescale = attr_float(attrs.get("rescale_grad", 1.0), 1.0)
    clip = attr_float(attrs.get("clip_gradient", -1.0), -1.0)
    return lr, wd, rescale, clip


def _clip(g, clip):
    return torch.clamp(g, -clip, clip) if clip is not None and clip > 0 else g


def _sgd_update(op_ctx, attrs, inputs, aux):
    weight, grad = inputs
    lr, wd, rescale, clip = _common(attrs)
    g = _clip(grad * rescale, clip)
    return (weight - lr * (g + wd * weight),)


def _sgd_mom_update(op_ctx, attrs, inputs, aux):
    weight, grad, mom = inputs
    lr, wd, rescale, clip = _common(attrs)
    momentum = attr_float(attrs.get("momentum", 0.0), 0.0)
    g = _clip(grad * rescale, clip)
    new_mom = momentum * mom - lr * (g + wd * weight)
    return (weight + new_mom, new_mom)


def _adam_update(op_ctx, attrs, inputs, aux):
    weight, grad, mean, var = inputs
    lr, wd, rescale, clip = _common(attrs)
    beta1 = attr_float(attrs.get("beta1", 0.9), 0.9)
    beta2 = attr_float(attrs.get("beta2", 0.999), 0.999)
    eps = attr_float(attrs.get("epsilon", 1e-8), 1e-8)
    g = _clip(grad * rescale + wd * weight, clip)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    return (weight - lr * new_mean / (torch.sqrt(new_var) + eps),
            new_mean, new_var)


def _clip_weights(w, attrs):
    c = attr_float(attrs.get("clip_weights", -1.0), -1.0)
    return torch.clamp(w, -c, c) if c is not None and c > 0 else w


def _rmsprop_update(op_ctx, attrs, inputs, aux):
    weight, grad, n = inputs
    lr, wd, rescale, clip = _common(attrs)
    gamma1 = attr_float(attrs.get("gamma1", 0.95), 0.95)
    eps = attr_float(attrs.get("epsilon", 1e-8), 1e-8)
    g = _clip(grad * rescale + wd * weight, clip)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    return (_clip_weights(weight - lr * g / torch.sqrt(new_n + eps), attrs),
            new_n)


def _rmspropalex_update(op_ctx, attrs, inputs, aux):
    # centered RMSProp (ref: rmspropalex_update, Graves 2013)
    weight, grad, n, g_avg, delta = inputs
    lr, wd, rescale, clip = _common(attrs)
    gamma1 = attr_float(attrs.get("gamma1", 0.95), 0.95)
    gamma2 = attr_float(attrs.get("gamma2", 0.9), 0.9)
    eps = attr_float(attrs.get("epsilon", 1e-8), 1e-8)
    g = _clip(grad * rescale + wd * weight, clip)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_g = (1 - gamma1) * g + gamma1 * g_avg
    new_delta = gamma2 * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_g) + eps)
    return (_clip_weights(weight + new_delta, attrs), new_n, new_g, new_delta)


register_def(OpDef("sgd_update", _sgd_update, inputs=("weight", "grad")))
register_def(OpDef("sgd_mom_update", _sgd_mom_update,
                   inputs=("weight", "grad", "mom"),
                   outputs=("weight", "mom")))
register_def(OpDef("adam_update", _adam_update,
                   inputs=("weight", "grad", "mean", "var"),
                   outputs=("weight", "mean", "var")))
register_def(OpDef("rmsprop_update", _rmsprop_update,
                   inputs=("weight", "grad", "n"),
                   outputs=("weight", "n")))
register_def(OpDef("rmspropalex_update", _rmspropalex_update,
                   inputs=("weight", "grad", "n", "g", "delta"),
                   outputs=("weight", "n", "g", "delta")))
