"""DataParallelExecutorGroup (ref: python/mxnet/module/executor_group.py).

Counterpart of ``mxnet_tpu/module/executor_group.py``: one executor built
by the port's ``simple_bind``, the grad_req table the reference builds,
and the batch fed into the bound arrays. Several distinct contexts make a
'data' mesh of replicas (:func:`_create_mesh`): the executor then splits
each batch across the replicas at every forward, keeps one copy of the
parameters (replicated to every replica by the forward), and merges the
outputs in batch order and the gradients as their sum over the replicas.
Contexts that repeat one another (``[gpu(0), gpu(0)]``) build no mesh, as
the JAX package's duplicate devices do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, resolve_device
from ..executor import simple_bind
from ..parallel.mesh import AXIS_DATA, Mesh, layout_axes


def _name_shape(d):
    return (d.name, d.shape) if hasattr(d, "name") else (d[0], d[1])


def _create_mesh(contexts):
    """A one-axis 'data' mesh with a replica per context; None for one
    context or contexts that repeat one another. A GPU context past the
    visible cards raises: requested devices are never folded onto one."""
    if len(contexts) < 2 or len(set(contexts)) != len(contexts):
        return None
    devices = []
    for c in contexts:
        dev = resolve_device(c, "DataParallelExecutorGroup")
        if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
            raise MXNetError(
                "context %s: only %d CUDA device(s) are visible"
                % (c, torch.cuda.device_count()))
        devices.append(dev)
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid, (AXIS_DATA,))


class DataParallelExecutorGroup(object):
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad, shared_group=None,
                 logger=None, fixed_param_names=None, grad_req="write",
                 state_names=None):
        self.contexts = [c if isinstance(c, Context) else Context(c)
                         for c in contexts]
        self._mesh = _create_mesh(self.contexts)
        self.symbol = symbol
        self.workload = workload
        self.param_names = list(param_names)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.state_names = list(state_names or [])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_names = [_name_shape(x)[0] for x in data_shapes]
        self.label_names = [_name_shape(x)[0] for x in (label_shapes or [])]
        # dim 0 of the first input, as the JAX package's (Module's default
        # rescale_grad); the split over a mesh follows each input's layout
        self.batch_size = _name_shape(data_shapes[0])[1][0]
        self.batch_axes = layout_axes(list(data_shapes)
                                      + list(label_shapes or []))

        # grad_req per argument (ref: executor_group.py)
        if self.for_training:
            req = {}
            for name in self.arg_names:
                if name in self.param_names:
                    req[name] = ("null" if name in self.fixed_param_names
                                 else (grad_req if isinstance(grad_req, str)
                                       else grad_req.get(name, "write")))
                elif name in self.data_names:
                    req[name] = "write" if inputs_need_grad else "null"
                else:
                    req[name] = "null"
            self.grad_req = req
        else:
            self.grad_req = {name: "null" for name in self.arg_names}

        shapes = dict(_name_shape(d) for d in data_shapes)
        shapes.update(_name_shape(d) for d in (label_shapes or []))
        shared = shared_group.executor if shared_group is not None else None
        self.executor = simple_bind(
            symbol, self.contexts[0], grad_req=self.grad_req,
            shared_exec=shared, mesh=self._mesh,
            batch_names=self.data_names + self.label_names,
            batch_axes=self.batch_axes, **shapes)
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        feed = dict(zip(self.data_names, data_batch.data))
        if self.label_names and data_batch.label:
            feed.update(zip(self.label_names, data_batch.label))
        self.executor.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        self.executor.backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        return list(self.executor.outputs)

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True to get input "
                             "grads")
        return [self.executor.grad_dict[n] for n in self.data_names]

    def get_grads(self):
        return [self.executor.grad_dict[n] for n in self.param_names
                if n in self.executor.grad_dict]

    def set_params(self, arg_params, aux_params):
        self.executor.copy_params_from(arg_params, aux_params,
                                       allow_extra_params=True)

    def get_params(self, arg_params, aux_params):
        """Copy the current parameters into the given dicts."""
        for name in self.param_names:
            arg_params[name] = self.executor.arg_dict[name].copy()
        for name in self.aux_names:
            aux_params[name] = self.executor.aux_dict[name].copy()

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())
