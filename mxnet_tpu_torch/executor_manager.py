"""Batch slicing and the legacy ``DataParallelExecutorManager`` (port of
``mxnet_tpu/executor_manager.py:15-105``; reference
python/mxnet/executor_manager.py).  The manager is a thin adapter over
``module.DataParallelExecutorGroup`` and runs on one context, as the
group does."""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["_split_input_slice", "_load_data", "_load_label",
           "DataParallelExecutorManager"]


def _split_input_slice(batch_size, work_load_list):
    """Split a batch into per-device slices proportional to workload
    (reference executor_manager.py:15)."""
    total = sum(work_load_list)
    if batch_size < len(work_load_list):
        raise MXNetError("batch size smaller than number of devices")
    slices = []
    start = 0
    for i, load in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            end = batch_size
        else:
            end = start + int(round(batch_size * load / float(total)))
        slices.append(slice(start, end))
        start = end
    return slices


def _load_general(data, targets, batch_axis=0):
    """Copy each source's batch slices into the per-device arrays
    ``targets`` (lists of ``(slice, NDArray)``), on their devices and in
    their dtypes (reference executor_group.py:_load_general)."""
    for d_src, d_targets in zip(data, targets):
        for slice_idx, d_dst in d_targets:
            if batch_axis == 0:
                src = d_src[slice_idx]
            else:
                idx = [slice(None)] * batch_axis + [slice_idx]
                src = d_src[tuple(idx)]
            raw = src._data if hasattr(src, "_data") else torch.as_tensor(src)
            d_dst._data = raw.to(d_dst._data.device, d_dst._data.dtype)


def _load_data(batch, targets, batch_axis=0):
    _load_general(batch.data, targets, batch_axis)


def _load_label(batch, targets, batch_axis=0):
    _load_general(batch.label, targets, batch_axis)


class DataParallelExecutorManager(object):
    """The legacy manager of ``model.FeedForward``'s training loop
    (reference executor_manager.py:DataParallelExecutorManager), over a
    ``DataParallelExecutorGroup`` bound for training on ``ctx``."""

    def __init__(self, symbol, ctx, train_data, arg_names, param_names,
                 aux_names, work_load_list=None, logger=None, sym_gen=None):
        from .module.executor_group import DataParallelExecutorGroup
        self.arg_names = arg_names
        self.param_names = param_names
        self.aux_names = aux_names
        self.ctx = ctx
        self.execgrp = DataParallelExecutorGroup(
            symbol, ctx, work_load_list,
            [(d.name, d.shape) for d in train_data.provide_data],
            [(l.name, l.shape) for l in train_data.provide_label],
            param_names, for_training=True, inputs_need_grad=False)

    def install_monitor(self, monitor):
        self.execgrp.install_monitor(monitor)

    def set_params(self, arg_params, aux_params):
        self.execgrp.set_params(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        self.execgrp.get_params(arg_params, aux_params)

    @property
    def param_arrays(self):
        return self.execgrp.param_arrays

    @property
    def grad_arrays(self):
        return self.execgrp.grad_arrays

    @property
    def aux_arrays(self):
        return self.execgrp.aux_arrays

    def load_data_batch(self, data_batch):
        self._cur_batch = data_batch

    def forward(self, is_train=False):
        self.execgrp.forward(self._cur_batch, is_train=is_train)

    def backward(self):
        self.execgrp.backward()

    def update_metric(self, metric, labels):
        self.execgrp.update_metric(metric, labels)
