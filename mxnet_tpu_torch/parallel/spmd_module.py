"""SPMDModule — Module-API adapter over SPMDTrainer (port of
``mxnet_tpu/parallel/spmd_module.py``).

Gives reference scripts (``mod.fit(train_iter, ...)``) the fused step,
data-parallel across processes under a ``mesh`` (one rank a device; each
rank feeds its own batch) or over an in-process mesh (the global batch
split over ``dp``, ``param_shardings`` rules over ``tp``):
forward_backward and update are one fused
step (update() is then a no-op), matching BaseModule.fit's call order.
``sharding_plan`` is the bound trainer's descriptive
:class:`~mxnet_tpu_torch.parallel.planner.ShardingPlan`.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from ..module.base_module import BaseModule
from ..ndarray import NDArray
from .trainer import SPMDTrainer

__all__ = ["SPMDModule"]


def _batch_factor(mesh, axis):
    """The global batch over one process's rows: the ranks of a
    one-rank-a-position ``dp`` mesh, the dp coordinates over this
    process's on a mesh of positions (1 on a mesh inside one process)."""
    if mesh is None:
        return 1
    if not getattr(mesh, "over_ranks", False) or any(
            size > 1 for name, size in mesh.shape.items() if name != axis):
        held = {mesh.coords(i)[axis] for i in mesh.local}
        return mesh.shape[axis] // max(1, len(held))
    return mesh.shape[axis]


class SPMDModule(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, mesh=None,
                 param_shardings=None, data_axis="dp", compute_dtype=None,
                 grad_sync=None, plan=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._mesh = mesh
        self._param_shardings = param_shardings
        self._data_axis = data_axis
        self._compute_dtype = compute_dtype
        # 'allreduce' | 'zero' | 'zero3' (None follows MXNET_GRAD_SYNC);
        # forwarded to the SPMDTrainer built at init_optimizer
        self._grad_sync = grad_sync
        # a planner.ShardingPlan (or its doc) supplies grad_sync /
        # sharding rules / compute dtype as one artifact instead of the
        # ad-hoc arguments above (explicit arguments still win)
        self._plan = plan
        self._trainer = None
        self._optimizer_spec = ("sgd", {})

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        assert not inputs_need_grad, "SPMDModule: inputs_need_grad unsupported"
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self.for_training = for_training
        self.binded = True

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        assert self.binded
        self._init_args = (initializer, arg_params, aux_params)
        self.params_initialized = True

    def init_optimizer(self, kvstore="tpu", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        optimizer_params = dict(optimizer_params)
        batch = self._data_shapes[0][1][0] if not hasattr(
            self._data_shapes[0], "shape") else self._data_shapes[0].shape[0]
        # gradients are summed over the global batch: each rank's rows
        # times the ranks (an in-process mesh's batch is already global)
        optimizer_params.setdefault("rescale_grad", 1.0 / (
            batch * _batch_factor(self._mesh, self._data_axis)))
        self._trainer = SPMDTrainer(
            self._symbol, optimizer, optimizer_params,
            mesh=self._mesh if self._mesh is not None else None,
            data_axis=self._data_axis,
            param_shardings=self._param_shardings,
            compute_dtype=self._compute_dtype,
            grad_sync=self._grad_sync, plan=self._plan)
        self._trainer.bind(self._data_shapes, self._label_shapes)
        initializer, arg_params, aux_params = self._init_args
        self._trainer.init_params(initializer, arg_params, aux_params)
        self.optimizer_initialized = True

    # fused: forward_backward does the whole step; update is a no-op
    def forward_backward(self, data_batch):
        from ..io import StagedBatch
        if isinstance(data_batch, StagedBatch):
            # inputs already on the device (DevicePrefetchIter): the
            # step skips the host-to-device copy
            self._trainer.step(data_batch)
            return
        arrays = list(data_batch.data) + list(data_batch.label or [])
        self._trainer.step(*arrays)

    def forward(self, data_batch, is_train=None):
        if is_train:
            return self.forward_backward(data_batch)
        from ..io import StagedBatch
        if isinstance(data_batch, StagedBatch):
            self._eval_outputs = self._trainer.eval_step(data_batch)
            return
        arrays = list(data_batch.data) + list(data_batch.label or [])
        if len(arrays) < len(self._trainer.input_names):
            # predict without labels: pad with zeros of the right shape
            import numpy as np
            for name in self._trainer.input_names[len(arrays):]:
                shape = dict((d.name, d.shape) if hasattr(d, "name") else d
                             for d in (self._label_shapes or []))[name]
                arrays.append(np.zeros(shape, dtype="float32"))
        self._eval_outputs = self._trainer.eval_step(*arrays)

    def backward(self, out_grads=None):
        pass  # folded into forward_backward

    def update(self):
        pass  # folded into forward_backward

    def get_outputs(self, merge_multi_context=True):
        if getattr(self, "_eval_outputs", None) is not None:
            outs = [NDArray._from_torch(o, self._trainer._ctx)
                    for o in self._eval_outputs]
            self._eval_outputs = None
            return outs
        return self._trainer.outputs

    def _deferred_metric_trainer(self):
        return self._trainer  # None before init_optimizer

    def update_metric(self, eval_metric, labels):
        if getattr(self, "_eval_outputs", None) is None and \
                self._deferred_metric_update(eval_metric):
            # train-step path with in-graph accumulation: the step already
            # counted this batch (guard-skipped steps excluded in-graph)
            return
        if getattr(self, "_eval_outputs", None) is None and \
                self._trainer.step_guard:
            # train-step outputs: a guard-skipped step's outputs are
            # non-finite — keep them out of summing metrics
            self._trainer.flush_step_guard()
            if self._trainer.last_step_skipped:
                return
        eval_metric.update(labels, self.get_outputs())

    def get_params(self):
        return self._trainer.get_params()

    def get_optimizer_states(self):
        """Serialized optimizer state for fit(checkpoint=...): collective
        under sharded params (every rank calls it together)."""
        return self._trainer.get_states()

    def set_optimizer_states(self, states):
        self._trainer.set_states(states)

    @property
    def sharding_plan(self):
        """The descriptive :class:`~mxnet_tpu_torch.parallel.planner.
        ShardingPlan` of the bound trainer (None before
        init_optimizer) — ``.explain()`` renders the layout."""
        return None if self._trainer is None \
            else self._trainer.sharding_plan

    @property
    def skipped_update_count(self):
        """Updates skipped by the fused step's NaN/Inf guard."""
        return self._trainer.skipped_steps

    @property
    def consecutive_bad_steps(self):
        """Current run of guard-skipped updates."""
        return self._trainer.consecutive_bad_steps

    def install_monitor(self, mon):
        raise MXNetError("SPMDModule does not support Monitor taps (use "
                         "mx.mod.Module for monitored debugging)")
