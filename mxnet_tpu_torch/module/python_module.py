"""Modules computed in Python: steps without parameters in a module
chain (ref: python/mxnet/module/python_module.py). Counterpart of
``mxnet_tpu/module/python_module.py``: :class:`PythonModule` (parameter and
optimizer calls are no-ops; subclasses give ``forward``/``backward`` and
``_compute_output_shapes``) and :class:`PythonLossModule`, a loss head
whose gradient a Python function computes, so host code (custom losses,
constraint projections) can sit between ``SequentialModule`` stages.
"""
from __future__ import annotations

import logging

from .. import ndarray as nd
from ..initializer import Uniform
from .base_module import BaseModule


class PythonModule(BaseModule):
    """A module whose computation is defined in Python rather than by a
    Symbol. Parameter/optimizer APIs default to no-ops; subclasses override
    ``forward``/``backward`` and ``_compute_output_shapes``."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names) if label_names is not None else None
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None
        self.params_initialized = True      # no params to initialize

    # -- symbol information --------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    # -- shapes --------------------------------------------------------
    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # -- parameters (none by default) ----------------------------------
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        pass

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is None:
            return
        eval_metric.update(labels, self.get_outputs())

    # -- setup ---------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if grad_req != "write":
            raise ValueError("PythonModule only supports grad_req='write'")
        if [x[0] for x in data_shapes] != self._data_names:
            raise ValueError("data_shapes names %r != %r"
                             % ([x[0] for x in data_shapes], self._data_names))
        if (label_shapes is not None and self._label_names is not None
                and [x[0] for x in label_shapes] != self._label_names):
            raise ValueError("label_shapes names mismatch")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        pass


class PythonLossModule(PythonModule):
    """A loss head defined by a Python gradient function: forward passes
    scores through; backward calls ``grad_func(scores, labels)`` to produce
    the gradient w.r.t. the scores (ref: python_module.py PythonLossModule)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names,
                         [name + "_output"], logger=logger)
        if len(self._data_names) != 1:
            raise ValueError("PythonLossModule takes exactly one data")
        if self._label_names is not None and len(self._label_names) != 1:
            raise ValueError("PythonLossModule takes at most one label")
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None and not callable(grad_func):
            raise TypeError("grad_func must be callable")
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context is True
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "loss module: out_grads must be None"
        assert self.for_training
        self._backward_impl()

    def _backward_impl(self):
        if self._grad_func is None:
            raise NotImplementedError(
                "pass grad_func or override _backward_impl")
        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, nd.NDArray):
            # the gradient goes where the scores are
            grad = nd.array(grad, ctx=self._scores.context)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context is True
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
