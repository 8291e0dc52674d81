"""Torch plugin: PyTorch modules as operators (ref:
plugin/torch/torch_module.cc TorchModule/TorchCriterion, which embedded Lua
Torch layers).

Counterpart of ``mxnet_tpu/plugin/torch_module.py``, with the same API. The
JAX package's op copies its input to a host numpy array, runs the module on
the CPU and copies the result back. Here the op is a ``CustomOp`` whose
arrays are the op's own device tensors: the wrapped ``nn.Module`` runs on
them with no copy to the host, and its input gradient comes from torch's
autograd over them. The module's parameters move to the op's device at
its first use there (and its parameter gradients accumulate in the module,
as in the JAX package).

Example::

    import torch.nn as tnn
    op = TorchModule(tnn.Linear(4, 3))
    y = op(mt.nd.ones((2, 4)))                   # imperative
    s = op.get_symbol(mt.sym.Variable("data"))   # symbolic, differentiable
"""
from __future__ import annotations

import torch

from .. import operator as mxop

_TORCH_COUNTER = [0]


def _on(module, device):
    """``module`` with its parameters and buffers on ``device``."""
    for t in list(module.parameters()) + list(module.buffers()):
        if t.device != device:
            return module.to(device)
    return module


def _device_of(module):
    for t in list(module.parameters()) + list(module.buffers()):
        return t.device
    return torch.device("cpu")


class TorchModule(object):
    """Wrap a ``torch.nn.Module`` as an operator with one input and one
    output; the gradient reaches the graph's input through torch's
    autograd."""

    def __init__(self, module):
        self.module = module
        _TORCH_COUNTER[0] += 1
        self._reg_name = "_torch_module_%d" % _TORCH_COUNTER[0]
        self._register()

    def _register(self):
        mod = self.module

        class _TorchOp(mxop.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                x = in_data[0].data
                y = _on(mod, x.device)(x)
                self.assign(out_data[0], req[0], y.detach())

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                x = in_data[0].data.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = _on(mod, x.device)(x)
                    y.backward(out_grad[0].data)
                self.assign(in_grad[0], req[0], x.grad)

        class _TorchProp(mxop.CustomOpProp):
            def __init__(self):
                super().__init__(need_top_grad=True)

            def list_arguments(self):
                return ["data"]

            def list_outputs(self):
                return ["output"]

            def infer_shape(self, in_shape):
                with torch.no_grad():
                    y = mod(torch.zeros(*in_shape[0],
                                        device=_device_of(mod)))
                return in_shape, [list(y.shape)], []

            def create_operator(self, ctx, shapes, dtypes):
                return _TorchOp()

        mxop.register(self._reg_name)(lambda **kw: _TorchProp())

    def __call__(self, x):
        from .. import ndarray as nd
        return nd.Custom(x, op_type=self._reg_name)

    def get_symbol(self, data, name=None):
        from .. import symbol as sym
        return sym.Custom(data=data, op_type=self._reg_name, name=name)


class TorchCriterion(object):
    """Wrap a torch loss (ref: TorchCriterion): forward computes the loss
    as a one-element array, backward emits d(loss)/d(input) and a zero
    gradient for the label, like the reference's loss layers."""

    def __init__(self, criterion):
        self.criterion = criterion
        _TORCH_COUNTER[0] += 1
        self._reg_name = "_torch_criterion_%d" % _TORCH_COUNTER[0]
        self._register()

    def _register(self):
        crit = self.criterion

        class _CritOp(mxop.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                x, t = in_data[0].data, in_data[1].data
                loss = _on(crit, x.device)(x, t)
                self.assign(out_data[0], req[0],
                            loss.detach().reshape(1).to(x.dtype))

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                x = in_data[0].data.detach().requires_grad_(True)
                t = in_data[1].data
                with torch.enable_grad():
                    _on(crit, x.device)(x, t).backward()
                self.assign(in_grad[0], req[0], x.grad)
                self.assign(in_grad[1], req[1], torch.zeros_like(t))

        class _CritProp(mxop.CustomOpProp):
            def __init__(self):
                super().__init__(need_top_grad=False)

            def list_arguments(self):
                return ["data", "label"]

            def list_outputs(self):
                return ["loss"]

            def infer_shape(self, in_shape):
                return in_shape, [[1]], []

            def create_operator(self, ctx, shapes, dtypes):
                return _CritOp()

        mxop.register(self._reg_name)(lambda **kw: _CritProp())

    def __call__(self, data, label):
        from .. import ndarray as nd
        return nd.Custom(data, label, op_type=self._reg_name)
