"""Pure-Python modules (port of ``mxnet_tpu/module/python_module.py``;
reference python/mxnet/module/python_module.py).

``PythonModule`` stubs the Module API for computation written directly
in Python (no Symbol, no executor); ``PythonLossModule`` is the loss-
as-module variant: it treats its input as scores and backpropagates a
user-supplied gradient function — composable behind a network module
via ``SequentialModule`` (example/module/python_loss.py).
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from ..ndarray import NDArray, array as nd_array
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Module-API adapter for Python-defined computation: parameter and
    optimizer hooks default to no-ops; subclasses implement forward/
    backward and ``_compute_output_shapes``."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super(PythonModule, self).__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names) if label_names is not None \
            else None
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # -- symbol information ----------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    # -- shapes ----------------------------------------------------------
    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # -- parameters (none by default) ------------------------------------
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False):
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.params_initialized = True

    def update(self):
        pass

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is None:
            return   # no labels: nothing to evaluate against
        eval_metric.update(labels, self.get_outputs())

    # -- setup -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if grad_req != "write":
            raise MXNetError("PythonModule only supports grad_req='write'")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        names = [d[0] if isinstance(d, tuple) else d.name
                 for d in data_shapes]
        if names != self._data_names:
            raise MXNetError("data_shapes %s do not match data_names %s"
                             % (names, self._data_names))
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError()


class PythonLossModule(PythonModule):
    """Loss as a module: forward passes scores through; backward calls
    ``grad_func(scores, labels) -> d(loss)/d(scores)``."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super(PythonLossModule, self).__init__(
            data_names, label_names, [name + "_output"], logger=logger)
        self._name = name
        if len(self._data_names) != 1 or len(self._label_names) != 1:
            raise MXNetError("PythonLossModule expects exactly one data "
                             "and one label name")
        if grad_func is not None and not callable(grad_func):
            raise MXNetError("grad_func must be callable")
        self._grad_func = grad_func
        self._scores = None
        self._labels = None
        self._scores_grad = None

    def _compute_output_shapes(self):
        shape = self._data_shapes[0][1] \
            if isinstance(self._data_shapes[0], tuple) \
            else self._data_shapes[0].shape
        return [(self._name + "_output", shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise MXNetError("for a loss module, out_grads must be None")
        assert self.for_training
        self._backward_impl()

    def _backward_impl(self):
        if self._grad_func is None:
            raise NotImplementedError(
                "pass grad_func= or override _backward_impl")
        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, NDArray):
            # on the scores' device, where the module before it runs
            grad = nd_array(grad, ctx=self._scores.context)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
