"""Module — the primary high-level interface (port of
``mxnet_tpu/module/module.py:27-713``; reference
python/mxnet/module/module.py).

Two routes, as in the JAX package:

- the **executor-group route** (any kvstore but 'tpu'/'dist'): one
  ``DataParallelExecutorGroup`` binds the symbol on the module's context;
  ``forward``/``backward`` run its executor, ``update`` applies the
  optimizer per parameter through the kvstore helpers of ``model.py``;
- the **fused route** (``kvstore='tpu'``, fit.py's default): the
  port's one-device ``SPMDTrainer`` owns the parameters and runs forward,
  backward, the step guard and the optimizer in one ``step``; the
  module's ``forward(is_train=True)`` defers to ``update`` so the
  reference's forward -> backward -> update contract holds with one step.
  It falls back to the executor route for the JAX package's reasons.

Parameters kept by the module (``get_params``) are host (``cpu()``)
NDArrays, as in the reference.  Several contexts in one process take
one fused step over an in-process ``dp`` mesh (``kvstore='tpu'``) or the
executor group; ``dist`` stores run the module across processes; a
Monitor keeps the executor-group route, whose executors it taps.
"""
from __future__ import annotations

import logging

from .. import optimizer as opt
from .. import random as _random
from ..base import MXNetError
from ..context import Context, cpu, current_context
from ..initializer import InitDesc, Uniform
from ..io import DataDesc
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint,
                     save_checkpoint, write_atomically)
from ..ndarray import NDArray, zeros as nd_zeros
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    """Module over a Symbol (reference module.py:Module)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, shared_params=False):
        """``shared_params=True`` declares that this module's parameter
        cells will be shared with other executors (BucketingModule's
        contract); the fused route then never engages, since the trainer
        owns its parameters exclusively."""
        super().__init__(logger=logger)
        self._shared_across_buckets = bool(shared_params)
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        self._context = context
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        assert len(work_load_list) == len(self._context)
        self._work_load_list = work_load_list

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = list(state_names or [])
        self._output_names = symbol.list_outputs()
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param",
                           True)

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False

        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None

        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

        # the fused route (kvstore='tpu'): SPMDTrainer runs forward,
        # backward, the guard and the update in one step
        self._fused = None
        self._fused_batch = None
        self._fused_key = None
        self._fused_outputs = None
        self._fused_outputs_from_update = False
        self._monitor_installed = False

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """Create a Module from a checkpoint (reference module.py:97)."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        blocking=None):
        """Save symbol + params (+ optimizer states) (reference
        module.py:135); every file lands atomically (temp + fsync +
        rename).

        ``blocking=False`` (default: the ``MXTPU_CKPT_ASYNC`` env) returns
        after copying params to the host (and serializing the optimizer
        state); the shared background writer does the file IO in one job:
        drain with ``resilience.wait_checkpoints()``."""
        from ..resilience import (atomic_write, checkpoint_async,
                                  snapshot_params, submit_checkpoint)
        if blocking is None:
            blocking = not checkpoint_async()
        states = self.get_optimizer_states() if save_optimizer_states \
            else None
        arg_params, aux_params = self.get_params()
        sym_json = self._symbol.tojson()
        state_name = "%s-%04d.states" % (prefix, epoch)

        def _write_states():
            if states is not None:
                atomic_write(state_name, states)
                logging.info("Saved optimizer state to \"%s\"", state_name)

        if blocking:
            save_checkpoint(prefix, epoch, sym_json, arg_params, aux_params,
                            blocking=True)
            _write_states()
        else:
            # ONE job for params and states: the writer holds one job at
            # a time, so a second submit would block this caller for the
            # whole first write, the stall async mode exists to remove
            arg_params = snapshot_params(arg_params)
            aux_params = snapshot_params(aux_params)

            def _write_all():
                save_checkpoint(prefix, epoch, sym_json, arg_params,
                                aux_params, blocking=True)
                _write_states()

            submit_checkpoint(_write_all, "%s epoch %d" % (prefix, epoch))

    # -- properties --------------------------------------------------------
    @property
    def skipped_update_count(self):
        """Updates skipped by the fused step's NaN/Inf guard (0 on the
        executor route, which has no guard)."""
        return self._fused.skipped_steps if self._fused is not None else 0

    @property
    def consecutive_bad_steps(self):
        """Current run of guard-skipped updates (0 on the executor
        route)."""
        return self._fused.consecutive_bad_steps \
            if self._fused is not None else 0

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        shapes = {}
        for d in (self._data_shapes or []) + (self._label_shapes or []):
            if isinstance(d, DataDesc):
                shapes[d.name] = d.shape
            else:
                shapes[d[0]] = tuple(d[1])
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, out_shapes))

    # -- params ------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """reference module.py:init_params: host copies initialized from
        ``arg_params``/``aux_params`` or ``initializer``, then placed on
        the device (executor group or fused trainer)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        host = cpu()
        if self._arg_params is None:
            self._arg_params = {
                name: nd_zeros(arr[0].shape, ctx=host,
                               dtype=arr[0]._data.dtype)
                for name, arr in zip(
                    [n for n in self._param_names
                     if n in self._symbol.list_arguments()],
                    self._exec_group.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {
                name: nd_zeros(arr[0].shape, ctx=host,
                               dtype=arr[0]._data.dtype)
                for name, arr in zip(self._aux_names,
                                     self._exec_group.aux_arrays)}
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None:
                if name in cache:
                    cache_arr = cache[name]
                    if cache_arr is not arr:
                        arr[:] = cache_arr
                else:
                    if not allow_missing:
                        raise RuntimeError("%s is not presented" % name)
                    if initializer is not None:
                        initializer(InitDesc(name, attrs.get(name)), arr)
            elif initializer is not None:
                initializer(InitDesc(name, attrs.get(name)), arr)

        for name, arr in sorted(self._arg_params.items()):
            _impl(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(name, arr, aux_params)

        self.params_initialized = True
        self._params_dirty = False
        if self._fused is not None:
            # the trainer holds the live copy; exec_group buffers stay
            # released
            self._fused.set_params(self._arg_params, self._aux_params)
        else:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init)
            return
        if self.params_initialized and not force_init:
            return
        if self._fused is not None:
            self._fused.set_params(arg_params, aux_params)
        else:
            self._exec_group.set_params(arg_params, aux_params)
        self._params_dirty = True
        self.params_initialized = True

    # -- binding -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """reference module.py:bind"""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        if not for_training:
            assert not inputs_need_grad
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes

        if shared_module is not None:
            assert isinstance(shared_module, Module) and \
                shared_module.binded and shared_module.params_initialized
            if shared_module._fused is not None:
                raise MXNetError(
                    "shared_module runs the fused SPMDTrainer route (its "
                    "executor buffers are released and its optimizer state "
                    "lives in the trainer); construct both modules with "
                    "shared_params=True before init_optimizer, or use a "
                    "non-tpu kvstore")
            # the parent's parameter cells are now shared: it must never
            # fuse later either
            shared_module._shared_across_buckets = True
            self._shared_across_buckets = True
            shared_group = shared_module._exec_group
        else:
            shared_group = None

        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list, data_shapes,
            label_shapes, self._param_names, for_training, inputs_need_grad,
            shared_group, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req)

        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            # bind() after load(): push params to the device
            self._exec_group.set_params(self._arg_params, self._aux_params)

        if shared_module is not None and shared_module.optimizer_initialized:
            self.borrow_optimizer(shared_module)

    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        self._fused = None
        self._fused_batch = None
        self._fused_key = None
        self._fused_outputs = None
        self._fused_outputs_from_update = False
        self._monitor_installed = False
        if getattr(self, "_deferred_metric", None) is not None:
            self._deferred_metric.detach_deferred_source()
        self._deferred_metric = None
        self._deferred_interval = 0
        self._deferred_calls = 0

    def reshape(self, data_shapes, label_shapes=None):
        """Re-bind for new input shapes keeping parameters and optimizer
        state (reference module.py:405).  The executor group shares its
        parameter cells into the re-bound executors; the fused trainer
        re-binds its step."""
        assert self.binded
        self._data_shapes = [d if isinstance(d, DataDesc)
                             else DataDesc(d[0], d[1]) for d in data_shapes]
        self._label_shapes = [l if isinstance(l, DataDesc)
                              else DataDesc(l[0], l[1])
                              for l in (label_shapes or [])] or None
        self._exec_group.reshape(self._data_shapes, self._label_shapes)
        if self._fused is not None:
            self._fused.bind(self._data_shapes, self._label_shapes or [])

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """reference module.py:432-508"""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return

        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self._context), self._arg_params)

        batch_size = self._exec_group.batch_size
        # sync-replicated stores sum gradients across workers: rescale by
        # the global batch (reference module.py:461-462)
        if kvstore and ("tpu" in kvstore.type or
                        ("dist" in kvstore.type and "_sync" in kvstore.type)):
            batch_size *= kvstore.num_workers
        rescale_grad = 1.0 / batch_size

        if isinstance(optimizer, str):
            idx2name = {}
            if update_on_kvstore:
                idx2name.update(enumerate(self._exec_group.param_names))
            else:
                for k in range(len(self._context)):
                    idx2name.update(
                        {i * len(self._context) + k: n
                         for i, n in enumerate(self._exec_group.param_names)})
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)

        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None

        was_fused = self._fused is not None
        if self._params_dirty:
            # re-initializing mid-training: capture the trained weights
            # from whichever side owns them before ownership may change
            self._sync_params_from_devices()
        self._fused = self._maybe_init_fused(kvstore, optimizer)
        if self._fused is not None:
            self.logger.info(
                "kvstore '%s': using the fused SPMDTrainer step (forward, "
                "backward, guard and update in one step)", kvstore.type)
            # the trainer holds the live params now: drop the executor
            # group's duplicate device buffers
            self._exec_group.release_device_buffers()
        else:
            if was_fused:
                # buffers were released while the trainer owned the params
                self._exec_group.set_params(self._arg_params,
                                            self._aux_params)
            if kvstore:
                _initialize_kvstore(
                    kvstore=kvstore,
                    param_arrays=self._exec_group.param_arrays,
                    arg_params=self._arg_params,
                    param_names=self._param_names,
                    update_on_kvstore=update_on_kvstore)
            if update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
            else:
                self._updater = opt.get_updater(optimizer)

        self.optimizer_initialized = True

        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _maybe_init_fused(self, kvstore, optimizer):
        """Build the fused SPMDTrainer for a 'tpu' kvstore (over the
        process group's ``dp`` mesh when there are several workers, over
        an in-process ``dp`` mesh of several distinct contexts), or
        None when the configuration needs the executor-group route (the
        JAX package's reasons, module.py:445-531); 'dist_sync' stores
        take the executor route with the collective store."""
        if kvstore is None or "tpu" not in kvstore.type:
            return None
        if not self.for_training:
            return None
        reasons = []
        if self._shared_across_buckets:
            reasons.append("bucketed shape sharing")
        if self._state_names:
            reasons.append("state_names")
        if self.inputs_need_grad:
            reasons.append("inputs_need_grad")
        if self._fixed_param_names:
            reasons.append("fixed_param_names")
        if self._monitor_installed:
            reasons.append("an installed Monitor (needs per-op taps)")
        if any(self._exec_group.grad_req.get(n) not in (None, "null", "write")
               for n in self._param_names):
            reasons.append("grad_req != 'write'")
        from ..parallel.trainer import SUPPORTED_OPTIMIZERS
        kind = type(optimizer).__name__.lower()
        if kind not in SUPPORTED_OPTIMIZERS:
            reasons.append("optimizer %r (no in-step rule)" % kind)
        if reasons:
            self.logger.info(
                "kvstore '%s': falling back to the executor-group route "
                "(fused step unavailable with %s)", kvstore.type,
                ", ".join(reasons))
            return None
        from ..parallel import SPMDTrainer, build_mesh, local_mesh
        if len(self._context) > 1:
            n = len(self._context)
            world = kvstore.num_workers
            # several devices: ONE fused step dp-sharded over exactly
            # those contexts (in every process under a process group: a
            # mesh over ranks x contexts, the JAX package's processes x
            # local devices); an indivisible global batch, or a context
            # given twice (the reference's idiom for oversubscribing one
            # device), takes the executor-group route, as in the JAX
            # package
            if (self._exec_group.batch_size * world) % (n * world):
                self.logger.info(
                    "kvstore '%s': global batch %d not divisible by %d "
                    "devices; falling back to the executor-group path",
                    kvstore.type, self._exec_group.batch_size * world,
                    n * world)
                return None
            if len(set(self._context)) != n:
                self.logger.info(
                    "kvstore '%s': duplicate devices in context list; "
                    "falling back to the executor-group path",
                    kvstore.type)
                return None
            if world > 1:
                from .. import distributed
                devices = distributed.global_devices(self._context)
                if len(devices) != n * world:
                    self.logger.info(
                        "kvstore '%s': the ranks hold different numbers "
                        "of contexts; falling back to the executor-group "
                        "path", kvstore.type)
                    return None
                mesh = build_mesh({"dp": n * world}, devices)
            else:
                mesh = build_mesh({"dp": n}, list(self._context))
        else:
            mesh = local_mesh() if kvstore.num_workers > 1 else None
        trainer = SPMDTrainer(self._symbol, optimizer, mesh=mesh,
                              ctx=self._context[0])
        trainer.bind(self._data_shapes, self._label_shapes)
        trainer.init_params(None, self._arg_params, self._aux_params)
        return trainer

    def _fused_feed(self, data_batch):
        """The trainer's input list (data then labels) from a DataBatch,
        with zero labels where the batch has none (the predict path;
        labels only matter for the backward).  A StagedBatch (inputs
        already on the device, from DevicePrefetchIter/stage_batch) passes
        through whole: the trainer consumes it and skips the copy."""
        from ..io import StagedBatch
        if isinstance(data_batch, StagedBatch):
            return [data_batch]
        arrays = list(data_batch.data)
        labels = list(data_batch.label or [])
        if len(labels) < len(self._fused.label_names):
            labels = labels + [
                nd_zeros(self._fused.arg_shapes[name], ctx=cpu())
                for name in self._fused.label_names[len(labels):]]
        return arrays + labels

    def borrow_optimizer(self, shared_module):
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # -- execution ---------------------------------------------------------
    def _wrap(self, outs):
        return [NDArray._from_torch(o, self._context[0]) for o in outs]

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if self._fused is not None:
            if is_train is None:
                is_train = self.for_training
            if is_train:
                # the train step is deferred to update() so the
                # reference's forward -> backward -> update contract (the
                # metric sees outputs of the pre-update weights) holds
                # with one fused step; its seed is drawn lazily (preview
                # or update), so a forward never followed by either
                # leaves the seed stream untouched
                self._fused_batch = self._fused_feed(data_batch)
                self._fused_key = None
                self._fused_outputs = None
                self._fused_outputs_from_update = False
            else:
                self._fused_outputs = self._wrap(
                    self._fused.eval_step(*self._fused_feed(data_batch)))
                self._fused_outputs_from_update = False
            return
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        if self._fused is not None:
            assert out_grads is None, \
                "custom head gradients need the executor route (use a " \
                "non-tpu kvstore)"
            return
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """reference module.py:553 -> model.py:88-123"""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        if self._fused is not None:
            assert self._fused_batch is not None, \
                "update() without a prior forward(is_train=True)"
            self._fused_outputs = self._wrap(self._fused.step(
                *self._fused_batch, key=self._draw_fused_key()))
            self._fused_outputs_from_update = True
            self._fused_batch = None
            self._fused_key = None
            return
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._exec_group.param_arrays,
                                      self._exec_group.grad_arrays,
                                      self._kvstore)
        else:
            _update_params(self._exec_group.param_arrays,
                           self._exec_group.grad_arrays,
                           updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore)

    def _draw_fused_key(self):
        """The deferred step's seed, drawn on first need; a repeated call
        (preview, then update) returns the same seed."""
        if self._fused_key is None:
            self._fused_key = _random.next_seed()
        return self._fused_key

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        if self._fused is not None:
            if self._fused_outputs is None and self._fused_batch is not None:
                # outputs asked for between forward_backward() and
                # update(): a train-mode forward with the seed the
                # deferred step will take
                self._fused_outputs = self._wrap(self._fused.forward_only(
                    *self._fused_batch, key=self._draw_fused_key()))
            return list(self._fused_outputs or [])
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context)

    def _deferred_metric_trainer(self):
        return self._fused  # None on the executor route

    def update_metric(self, eval_metric, labels):
        if self._fused is not None:
            if self._fused_outputs_from_update and \
                    self._deferred_metric_update(eval_metric):
                # the step itself added (sum, count) on the device:
                # nothing to copy this step
                return
            if self._fused_outputs_from_update and self._fused.step_guard:
                # a guard-skipped step's outputs are non-finite: keep them
                # out of the metric (the flush reads what the outputs'
                # read below waits for anyway)
                self._fused.flush_step_guard()
                if self._fused.last_step_skipped:
                    return
            eval_metric.update(list(labels or []), self.get_outputs())
            return
        self._exec_group.update_metric(eval_metric, labels)

    def _sync_params_from_devices(self):
        if self._fused is not None:
            self._arg_params, self._aux_params = self._fused.get_params()
        else:
            self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    def get_optimizer_states(self):
        """Serialized optimizer state (bytes), from whichever side owns it
        (fused trainer / kvstore updater / local updater)."""
        assert self.optimizer_initialized
        if self._fused is not None:
            return self._fused.get_states()
        if self._update_on_kvstore:
            return self._kvstore.get_optimizer_states()
        return self._updater.get_states()

    def set_optimizer_states(self, states):
        assert self.optimizer_initialized
        if self._fused is not None:
            self._fused.set_states(states)
        elif self._update_on_kvstore:
            self._kvstore.set_optimizer_states(states)
        else:
            self._updater.set_states(states)

    def save_optimizer_states(self, fname):
        write_atomically(fname, self.get_optimizer_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self.set_optimizer_states(f.read())

    def install_monitor(self, mon):
        """Install a Monitor on the executor group's executors.  The fused
        ``kvstore='tpu'`` route has no per-op taps: install the monitor
        before ``init_optimizer`` (``fit`` does), and the Module then keeps
        the executor-group route, as in the JAX package
        (``mxnet_tpu/module/module.py:706-713``)."""
        assert self.binded
        if self._fused is not None:
            raise MXNetError(
                "Monitor taps need per-op execution; install the monitor "
                "before init_optimizer or use a non-tpu kvstore")
        self._monitor_installed = True
        self._exec_group.install_monitor(mon)
