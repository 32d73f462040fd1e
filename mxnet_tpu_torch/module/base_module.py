"""BaseModule — the high-level train/predict lifecycle (port of
``mxnet_tpu/module/base_module.py:21-445``; reference
python/mxnet/module/base_module.py: bind -> init_params -> init_optimizer
-> fit/forward_backward/update/score/predict).

``fit`` keeps the reference's loop: ``eval_metric``, ``epoch_end_callback``,
``batch_end_callback``, ``eval_data`` with ``validation_metric``,
``begin_epoch``, ``monitor``.  The JAX package's resilience arguments
(``checkpoint=``, ``resume=``, ``preemption_safe=``, ``watchdog=``) and
its environment knobs ``MXTPU_RESUME``, ``MXTPU_ON_PREEMPT``,
``MXTPU_STEP_TIMEOUT`` and ``MXTPU_PROFILE_DIR`` come with the resilience
slice: setting any of them raises instead of being ignored.
"""
from __future__ import annotations

import logging
import os
import time

from .. import metric as metric_mod
from ..base import MXNetError, register_env
from ..initializer import Uniform
from ..model import BatchEndParam
from ..ndarray import concatenate

__all__ = ["BaseModule"]

#: the JAX package's resilience and profiling knobs, registered so a
#: setting is recognised and refused rather than silently ignored
RESILIENCE_ENVS = tuple(register_env(
    name, default=None, doc="The JAX package's %s; comes with the "
    "resilience slice of mxnet_tpu_torch (fit raises when it is set)"
    % what) for name, what in (
        ("MXTPU_RESUME", "fit auto-resume"),
        ("MXTPU_ON_PREEMPT", "graceful-preemption mode"),
        ("MXTPU_STEP_TIMEOUT", "hung-step watchdog budget"),
        ("MXTPU_PROFILE_DIR", "step-trace capture directory")))


def _as_list(obj):
    if obj is None:
        return []
    if isinstance(obj, (list, tuple)):
        return list(obj)
    return [obj]


def _check_input_names(symbol, names, typename, throw):
    args = symbol.list_arguments()
    for name in names:
        if name not in args:
            msg = "You created Module with Module(..., %s_names=%s) but " \
                  "input with name '%s' is not found in " \
                  "symbol.list_arguments(). Did you mean one of:\n\t%s\n" % (
                      typename, str(names), name, "\n\t".join(args))
            if throw:
                raise ValueError(msg)
            logging.warning(msg)


def _refuse_resilience(checkpoint, resume, preemption_safe, watchdog):
    given = [n for n, v in (("checkpoint=", checkpoint is not None),
                            ("resume=", bool(resume)),
                            ("preemption_safe=", bool(preemption_safe)),
                            ("watchdog=", bool(watchdog))) if v]
    given += [n for n in RESILIENCE_ENVS if os.environ.get(n, "")]
    if given:
        raise MXNetError(
            "fit: %s not ported yet (managed checkpoints, resume, graceful "
            "preemption, the step watchdog and step traces come with the "
            "resilience slice of mxnet_tpu_torch)" % ", ".join(given))


class BaseModule(object):
    """reference base_module.py:BaseModule."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- high level API ----------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Run prediction on eval_data and evaluate (base_module.py:score)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - pad] for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Collect predictions (base_module.py:predict)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - pad].copy()
                       for out in self.get_outputs()]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                assert len(out) == num_outputs, \
                    "Cannot merge batches, as num of outputs is not the " \
                    "same in mini-batches. Maybe bucketing is used?"
            output_list2 = [concatenate([out[i] for out in output_list])
                            for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, checkpoint=None, resume=False,
            preemption_safe=None, watchdog=None):
        """The canonical training loop (reference base_module.py:368-520):
        bind, init_params, init_optimizer, then per epoch every batch's
        forward_backward -> update -> update_metric -> batch-end callbacks,
        the epoch's Train-* metric log, a parameter sync, the epoch-end
        callbacks (``do_checkpoint``) and, with ``eval_data``, a score.

        ``checkpoint``, ``resume``, ``preemption_safe`` and ``watchdog``
        (and their environment knobs) raise: they come with the
        resilience slice."""
        assert num_epoch is not None, "please specify number of epochs"
        _refuse_resilience(checkpoint, resume, preemption_safe, watchdog)

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    batch_end_params = BatchEndParam(
                        epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                        locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(batch_end_params)

            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            toc = time.time()
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, toc - tic)

            # sync aux params across devices
            arg_params_, aux_params_ = self.get_params()
            self.set_params(arg_params_, aux_params_)

            if epoch_end_callback is not None:
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_params_, aux_params_)

            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

            # end of 1 epoch, reset the data-iter for another epoch
            train_data.reset()

    # -- symbol / params ---------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def get_params(self):
        raise NotImplementedError

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def save_params(self, fname):
        """Save ``arg:``/``aux:`` params to ``fname`` (atomically)."""
        from .. import ndarray as nd
        from ..model import _replace_atomically
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        _replace_atomically(fname, lambda tmp: nd.save(tmp, save_dict))

    def load_params(self, fname):
        from .. import ndarray as nd
        save_dict = nd.load(fname)
        arg_params = {}
        aux_params = {}
        for k, value in save_dict.items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    def get_optimizer_states(self):
        raise NotImplementedError

    def set_optimizer_states(self, states):
        raise NotImplementedError

    # -- abstract interface ------------------------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def install_monitor(self, mon):
        raise NotImplementedError
