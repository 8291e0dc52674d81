"""Legacy executor-manager API (ref: python/mxnet/executor_manager.py:278).

Counterpart of ``mxnet_tpu/executor_manager.py``: the FeedForward-era
data-parallel training helper. The work is done by
``module/executor_group.py``'s group over the contexts (a 'data' mesh of
replicas for several); this module keeps the old surface,
``_split_input_slice``'s workload-weighted batch slices and
``DataParallelExecutorManager``, so scripts written against
``mt.executor_manager`` run unchanged.
"""
from __future__ import annotations

import logging

from .base import MXNetError
from .module.executor_group import DataParallelExecutorGroup


def _split_input_slice(batch_size, work_load_list):
    """Workload-weighted batch slices (ref: executor_manager.py:14-49)."""
    total = sum(work_load_list)
    nums = [round(w * batch_size / total) for w in work_load_list]
    if sum(nums) < batch_size:
        nums[-1] += batch_size - sum(nums)
    slices = []
    end = 0
    for n in nums:
        begin = int(min(end, batch_size))
        end = int(min(begin + n, batch_size))
        if begin >= end:
            raise ValueError(
                "Too many slices such that some splits are empty")
        slices.append(slice(begin, end))
    return slices


def _check_arguments(symbol):
    """Reject duplicate argument/aux names (ref: executor_manager.py:51)."""
    arg_names = symbol.list_arguments()
    if len(set(arg_names)) != len(arg_names):
        raise ValueError("Find duplicated argument name: %s" % arg_names)
    aux_names = symbol.list_auxiliary_states()
    if len(set(aux_names)) != len(aux_names):
        raise ValueError("Find duplicated auxiliary name: %s" % aux_names)


class DataParallelExecutorManager(object):
    """Multi-device train-loop helper (ref: executor_manager.py:278-427).
    Delegates to DataParallelExecutorGroup; kept for FeedForward and legacy
    scripts."""

    def __init__(self, symbol, ctx, train_data, arg_names=None,
                 param_names=None, aux_names=None, work_load_list=None,
                 logger=None, sym_gen=None):
        if logger is None:
            logger = logging
        self.symbol = symbol
        self.ctx = ctx if isinstance(ctx, (list, tuple)) else [ctx]
        num_device = len(self.ctx)
        logger.info("Start training with %s", str(self.ctx))
        if work_load_list is None:
            work_load_list = [1] * num_device
        if len(work_load_list) != num_device:
            raise MXNetError("Invalid settings for work load.")
        self.work_load_list = work_load_list
        _check_arguments(symbol)
        self.arg_names = arg_names or symbol.list_arguments()
        self.aux_names = aux_names or symbol.list_auxiliary_states()
        data_names = [d[0] for d in train_data.provide_data]
        label_names = [l[0] for l in (train_data.provide_label or [])]
        self.param_names = param_names or [
            n for n in self.arg_names
            if n not in data_names and n not in label_names]
        self.sym_gen = sym_gen
        self.execgrp = DataParallelExecutorGroup(
            symbol, self.ctx, work_load_list,
            train_data.provide_data, train_data.provide_label,
            for_training=True, inputs_need_grad=False,
            param_names=self.param_names)
        self.execgrp_bucket = {}
        if sym_gen is not None:
            self.execgrp_bucket[train_data.default_bucket_key] = self.execgrp
        self.curr_execgrp = self.execgrp

    # -- parameters ----------------------------------------------------
    def set_params(self, arg_params, aux_params):
        self.execgrp.set_params(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        self.execgrp.get_params(arg_params, aux_params)

    @property
    def param_arrays(self):
        ex = self.curr_execgrp.executor
        return [ex.arg_dict[n] for n in self.param_names]

    @property
    def grad_arrays(self):
        ex = self.curr_execgrp.executor
        return [ex.grad_dict.get(n) for n in self.param_names]

    @property
    def aux_arrays(self):
        ex = self.curr_execgrp.executor
        return [ex.aux_dict[n] for n in self.aux_names]

    # -- stepping ------------------------------------------------------
    def load_data_batch(self, data_batch):
        if self.sym_gen is not None:
            key = data_batch.bucket_key
            if key not in self.execgrp_bucket:
                symbol = self.sym_gen(key)
                self.execgrp_bucket[key] = DataParallelExecutorGroup(
                    symbol, self.ctx, self.work_load_list,
                    data_batch.provide_data, data_batch.provide_label,
                    for_training=True, inputs_need_grad=False,
                    param_names=self.param_names,
                    shared_group=self.execgrp)
            self.curr_execgrp = self.execgrp_bucket[key]
        self._batch = data_batch

    def forward(self, is_train=False):
        self.curr_execgrp.forward(self._batch, is_train=is_train)

    def backward(self):
        self.curr_execgrp.backward()

    def update_metric(self, metric, labels):
        self.curr_execgrp.update_metric(metric, labels)

    def install_monitor(self, monitor):
        monitor.install(self.curr_execgrp.executor)
