"""DataParallelExecutorGroup on one context (port of
``mxnet_tpu/module/executor_group.py:31-345``; reference
python/mxnet/module/executor_group.py).

Binds one executor over the group's context, copies each batch into its
input arrays, runs forward/backward, and exposes the parameter, gradient
and aux arrays as per-device lists (of one), the shape the kvstore
helpers of ``model.py`` take.  Parameter NDArrays may be shared with
another group (``shared_group``, BucketingModule's contract): sharing
works by sharing the NDArray cells.  More than one context comes with the
multi-GPU slice and raises until then.
"""
from __future__ import annotations

import copy
import logging

import torch

from ..base import MXNetError
from ..executor_manager import _split_input_slice
from ..io import DataDesc
from ..ndarray import concatenate, zeros as nd_zeros

__all__ = ["DataParallelExecutorGroup"]


def _as_data_desc(shapes):
    if shapes is None:
        return None
    return [s if isinstance(s, DataDesc) else DataDesc(s[0], s[1])
            for s in shapes]


class DataParallelExecutorGroup(object):
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write"):
        if len(contexts) != 1:
            raise MXNetError(
                "DataParallelExecutorGroup over %d contexts is not ported "
                "yet (more than one device comes with the multi-GPU slice "
                "of mxnet_tpu_torch)" % len(contexts))
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload if workload else [1] * len(contexts)
        self.param_names = list(param_names)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.logger = logger

        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()

        if shared_group is not None:
            self.shared_data_arrays = shared_group.shared_data_arrays
        else:
            self.shared_data_arrays = [{} for _ in contexts]

        data_names = [d.name if isinstance(d, DataDesc) else d[0]
                      for d in data_shapes]
        self.grad_req = {}
        for name in self.arg_names:
            if name in self.param_names:
                self.grad_req[name] = ("null" if name in self.fixed_param_names
                                       or not for_training else grad_req)
            elif inputs_need_grad and name in data_names:
                self.grad_req[name] = grad_req
            else:
                self.grad_req[name] = "null"

        self.execs = []
        self.data_shapes = None
        self.label_shapes = None
        self.slices = None
        self.batch_size = None
        self.bind_exec(data_shapes, label_shapes, shared_group)

    # -- binding ----------------------------------------------------------
    def decide_slices(self, data_shapes):
        """Per-device batch slices along the layout batch axis (reference
        executor_group.py:207)."""
        assert len(data_shapes) > 0
        major_axis = [DataDesc.get_batch_axis(getattr(d, "layout", "NCHW"))
                      for d in data_shapes]
        for desc, axis in zip(data_shapes, major_axis):
            if axis == -1:
                continue
            batch_size = desc.shape[axis]
            if self.batch_size is not None:
                assert batch_size == self.batch_size, \
                    ("all data must have the same batch size: "
                     + ("batch_size = %d, but " % self.batch_size)
                     + ("%s has shape %s" % (desc.name, desc.shape)))
            else:
                self.batch_size = batch_size
                self.slices = _split_input_slice(self.batch_size,
                                                 self.workload)
        return major_axis

    def bind_exec(self, data_shapes, label_shapes, shared_group=None):
        data_shapes = _as_data_desc(data_shapes)
        label_shapes = _as_data_desc(label_shapes)
        self.batch_size = None
        self.data_major_axis = self.decide_slices(data_shapes)
        if label_shapes is not None and len(label_shapes):
            self.label_major_axis = self.decide_slices(label_shapes)
        else:
            self.label_major_axis = []
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.execs = [self._bind_ith_exec(i, data_shapes, label_shapes,
                                          shared_group)
                      for i in range(len(self.contexts))]
        self._wire_arrays()

    def _wire_arrays(self):
        """Rebuild the array-list views over self.execs."""
        data_shapes, label_shapes = self.data_shapes, self.label_shapes
        self.data_arrays = [
            [(self.slices[i], e.arg_dict[d.name])
             for i, e in enumerate(self.execs)] for d in data_shapes]
        if label_shapes is not None:
            self.label_arrays = [
                [(self.slices[i], e.arg_dict[name])
                 for i, e in enumerate(self.execs)]
                for name in [l.name for l in label_shapes]
                if name in self.execs[0].arg_dict]
        else:
            self.label_arrays = None
        self.param_arrays = [[e.arg_dict[name] for e in self.execs]
                             for name in self.param_names
                             if name in self.arg_names]
        if self.for_training:
            self.grad_arrays = [
                [e.grad_dict.get(name) for e in self.execs]
                for name in self.param_names if name in self.arg_names]
        else:
            self.grad_arrays = [[None] * len(self.execs)
                                for _ in self.param_names]
        if self.inputs_need_grad:
            self.input_grad_arrays = [
                [e.grad_dict.get(d.name) for e in self.execs]
                for d in data_shapes]
        else:
            self.input_grad_arrays = None
        self.aux_arrays = [[e.aux_dict[name] for e in self.execs]
                           for name in self.aux_names]

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind the executors for new input shapes, sharing the existing
        parameter, gradient and aux cells (reference executor_group.py
        reshape).  Executor sets are cached per shape signature, all
        sharing one set of parameter cells, so alternating between shapes
        costs one bind each."""
        data_shapes = _as_data_desc(data_shapes)
        label_shapes = _as_data_desc(label_shapes)
        if not hasattr(self, "_reshape_cache"):
            self._reshape_cache = {self._shape_sig(
                self.data_shapes, self.label_shapes): self.execs}
        sig = self._shape_sig(data_shapes, label_shapes)
        cached = self._reshape_cache.get(sig)
        if cached is not None and cached is not self.execs:
            self.batch_size = None
            self.data_major_axis = self.decide_slices(data_shapes)
            if label_shapes:
                self.label_major_axis = self.decide_slices(label_shapes)
            self.data_shapes = data_shapes
            self.label_shapes = label_shapes
            self.execs = cached
            self._wire_arrays()
            return
        if cached is None:
            prev = copy.copy(self)   # shallow: exposes .execs for sharing
            self.bind_exec(data_shapes, label_shapes, shared_group=prev)
            self._reshape_cache[sig] = self.execs

    @staticmethod
    def _shape_sig(data_shapes, label_shapes):
        return (tuple((d.name, tuple(d.shape)) for d in data_shapes),
                tuple((l.name, tuple(l.shape))
                      for l in (label_shapes or [])))

    def _sliced_shape(self, shapes, i, major_axis):
        """Shape of the i-th device slice."""
        sliced = []
        for desc, axis in zip(shapes, major_axis):
            shape = list(desc.shape)
            if axis >= 0:
                shape[axis] = self.slices[i].stop - self.slices[i].start
            sliced.append(DataDesc(desc.name, tuple(shape), desc.dtype,
                                   desc.layout))
        return sliced

    def _bind_ith_exec(self, i, data_shapes, label_shapes, shared_group):
        ctx = self.contexts[i]
        shared_data = self.shared_data_arrays[i]
        d_shapes = self._sliced_shape(data_shapes, i, self.data_major_axis)
        input_shapes = {d.name: d.shape for d in d_shapes}
        if label_shapes is not None:
            l_shapes = self._sliced_shape(label_shapes, i,
                                          self.label_major_axis)
            input_shapes.update({l.name: l.shape for l in l_shapes})
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        args = {}
        grads = {}
        shared_exec = shared_group.execs[i] if shared_group else None
        for name, shape in zip(self.arg_names, arg_shapes):
            if name in self.param_names:
                if shared_exec is not None and name in shared_exec.arg_dict:
                    # share parameter cells across buckets / reshapes
                    args[name] = shared_exec.arg_dict[name]
                    if shared_exec.grad_dict.get(name) is not None:
                        grads[name] = shared_exec.grad_dict[name]
                else:
                    args[name] = nd_zeros(shape, ctx=ctx)
                    if self.grad_req.get(name, "null") != "null":
                        grads[name] = nd_zeros(shape, ctx=ctx)
            else:
                # inputs: share only an exact-shape cell, else allocate
                if name in shared_data and \
                        shared_data[name].shape == tuple(shape):
                    args[name] = shared_data[name]
                else:
                    args[name] = nd_zeros(shape, ctx=ctx)
                    shared_data[name] = args[name]
                if self.grad_req.get(name, "null") != "null":
                    grads[name] = nd_zeros(shape, ctx=ctx)
        aux = {}
        for name, shape in zip(self.aux_names, aux_shapes):
            if shared_exec is not None and name in shared_exec.aux_dict:
                aux[name] = shared_exec.aux_dict[name]
            else:
                aux[name] = nd_zeros(shape, ctx=ctx)
        return self.symbol.bind(ctx, args, args_grad=grads or None,
                                grad_req=self.grad_req, aux_states=aux)

    # -- parameter sync ----------------------------------------------------
    def set_params(self, arg_params, aux_params):
        for e in self.execs:
            e.copy_params_from(arg_params, aux_params,
                               allow_extra_params=True)

    def get_params(self, arg_params, aux_params):
        """Copy the weights (averaged over devices) into the given host
        dicts (reference executor_group.py:get_params)."""
        for name, block in zip([n for n in self.param_names
                                if n in self.arg_names], self.param_arrays):
            _average_into(block, arg_params[name])
        for name, block in zip(self.aux_names, self.aux_arrays):
            _average_into(block, aux_params[name])

    def release_device_buffers(self):
        """Free the device memory behind this group's executors (arg,
        grad and aux cells shrink to 0-size placeholders).  Module calls
        it when the fused SPMDTrainer step takes over the parameters; a
        later set_params() re-materializes the cells."""
        for e in self.execs:
            for d in (e.arg_dict, e.grad_dict, e.aux_dict):
                for arr in d.values():
                    if arr is not None:
                        arr._data = torch.zeros((0,), dtype=arr._data.dtype,
                                                device=arr._data.device)

    # -- execution ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        for name_arrays, src in zip(self.data_arrays, data_batch.data):
            for slc, dst in name_arrays:
                dst._data = src[slc]._data.to(dst._data.device,
                                              dst._data.dtype)
        if self.label_arrays is not None and data_batch.label:
            for name_arrays, src in zip(self.label_arrays, data_batch.label):
                for slc, dst in name_arrays:
                    dst._data = src[slc]._data.to(dst._data.device,
                                                  dst._data.dtype)
        for e in self.execs:
            e.forward(is_train=is_train)

    def backward(self, out_grads=None):
        assert self.for_training, \
            "re-bind with for_training=True to run backward"
        for i, e in enumerate(self.execs):
            if out_grads is None:
                e.backward()
            else:
                e.backward([g[self.slices[i]] if g is not None else None
                            for g in out_grads])

    def get_outputs(self, merge_multi_context=True):
        outputs = [[e.outputs[i] for e in self.execs]
                   for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            return [x[0] if len(x) == 1 else concatenate(x, axis=0)
                    for x in outputs]
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        if merge_multi_context:
            return [x[0] if len(x) == 1 else concatenate(x, axis=0)
                    for x in self.input_grad_arrays]
        return self.input_grad_arrays

    def update_metric(self, eval_metric, labels):
        for i, e in enumerate(self.execs):
            labels_slice = [label[self.slices[i]] for label in labels]
            eval_metric.update(labels_slice, e.outputs)


def _average_into(block, dst):
    """``dst[:] = mean(block)``, summed on the host."""
    if len(block) == 1:
        src = block[0]._data
    else:
        src = sum(w._data.to("cpu") for w in block) / len(block)
    dst._data.copy_(src.to(dst._data.device, dst._data.dtype))
