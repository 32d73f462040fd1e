"""BaseModule — the high-level train/predict lifecycle (port of
``mxnet_tpu/module/base_module.py:21-445``; reference
python/mxnet/module/base_module.py: bind -> init_params -> init_optimizer
-> fit/forward_backward/update/score/predict).

``fit`` keeps the reference's loop: ``eval_metric``, ``epoch_end_callback``,
``batch_end_callback``, ``eval_data`` with ``validation_metric``,
``begin_epoch``, ``monitor``; and the JAX package's resilience
(``checkpoint=``, ``resume=``, ``preemption_safe=``, ``watchdog=``, with
the knobs ``MXTPU_RESUME``, ``MXTPU_ON_PREEMPT``, ``MXTPU_STEP_TIMEOUT``)
and deferred train metrics on the fused route.  ``MXTPU_PROFILE_DIR``
captures a ``torch.profiler`` trace of steps 10-15 of the first epoch
(``profiler.StepTraceCapture``).
"""
from __future__ import annotations

import logging
import os
import signal
import time

from .. import metric as metric_mod
from ..base import MXNetError
from ..initializer import Uniform
from ..model import BatchEndParam
from ..ndarray import concatenate

__all__ = ["BaseModule"]

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

        ``checkpoint`` (a :class:`~mxnet_tpu_torch.resilience.
        CheckpointManager` or a directory) turns on managed epoch-end
        checkpoints: params and optimizer state land atomically after
        every epoch.  ``resume=True`` (or ``MXTPU_RESUME=1``, which
        ``tools/supervise.py`` sets on a relaunch) restores the newest
        checkpoint first (params, optimizer state, epoch).  A mid-epoch
        checkpoint (graceful preemption, below) also carries the step and
        the random state: the resumed run skips the consumed batches of
        the iterator (which must replay its order after ``reset()``) and
        restores the random stream, so it ends bit-identical to an
        uninterrupted run.

        ``preemption_safe=True`` (or ``MXTPU_ON_PREEMPT=save``) installs a
        SIGTERM/SIGINT handler: the next step boundary saves a mid-epoch
        checkpoint and exits with ``resilience.PREEMPT_EXIT_CODE``.  Needs
        ``checkpoint=``.

        ``watchdog``: True or a :class:`~mxnet_tpu_torch.resilience.
        StepWatchdog` arms a hung-step monitor around every batch; None
        follows ``MXTPU_STEP_TIMEOUT`` (seconds, or ``auto``).  An
        overrunning step dumps every thread's stack and the ``torch.cuda``
        memory state and exits ``resilience.WATCHDOG_EXIT_CODE``.

        On the fused route the train metric accumulates on the device
        where it has a rule (``metric.try_install_deferred``; see
        ``MXTPU_METRIC_INTERVAL``/``MXTPU_METRIC_BLOCKING``)."""
        assert num_epoch is not None, "please specify number of epochs"
        from contextlib import nullcontext
        from ..base import get_env
        from .. import resilience
        from ..resilience import (CheckpointManager, PreemptionHandler,
                                  StepWatchdog, faults, preempted_exit)
        if checkpoint is not None and not hasattr(checkpoint, "restore"):
            checkpoint = CheckpointManager(checkpoint)
        if not resume and str(get_env(resilience.ENV_RESUME, "0")) == "1":
            # a supervise.py relaunch: same command line, resume forced
            resume = checkpoint is not None
        restored_states = None
        resume_step_state = None
        if resume:
            assert checkpoint is not None, "fit(resume=True) needs checkpoint="
            if checkpoint.latest() is not None:
                _, arg_restored, aux_restored, restored_states, ck_epoch = \
                    checkpoint.restore()
                arg_params, aux_params = arg_restored, aux_restored
                entry = checkpoint.entry(ck_epoch) or {}
                resume_step_state = entry.get("step_state")
                if resume_step_state is not None:
                    # partial (preemption) checkpoint: re-enter the
                    # interrupted epoch, not the one after it
                    begin_epoch = max(begin_epoch,
                                      int(resume_step_state["epoch"]))
                else:
                    begin_epoch = max(begin_epoch, ck_epoch)
                force_init = True
                self.logger.info("fit(resume=True): restored checkpoint "
                                 "epoch %d%s from %s", ck_epoch,
                                 " (mid-epoch, step %d)"
                                 % resume_step_state["step"]
                                 if resume_step_state else "",
                                 checkpoint.directory)

        if preemption_safe is None:
            preemption_safe = checkpoint is not None and str(
                get_env(resilience.ENV_ON_PREEMPT, "")).lower() in \
                ("save", "1")
        if preemption_safe and checkpoint is None:
            raise MXNetError("fit(preemption_safe=True) needs checkpoint= "
                             "(there is nowhere to save the mid-epoch "
                             "state)")

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
        if restored_states is not None:
            try:
                self.set_optimizer_states(restored_states)
            except NotImplementedError:
                # the module cannot carry optimizer state (mirrors the
                # save side): resume params and epoch only
                self.logger.warning(
                    "fit(resume=True): %s has no optimizer-state support; "
                    "resuming params and epoch only",
                    type(self).__name__)

        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        # deferred metrics: fused modules fold the train metric's
        # (sum, count) into the step so update_metric copies nothing to
        # the host (no-op on the executor route, for metrics without a
        # device rule and under MXTPU_METRIC_BLOCKING)
        self._install_deferred_metric(eval_metric)

        # mid-epoch resume: restore the random stream the interrupted run
        # saved at the preemption boundary (after init: the restore must
        # win over what initialization drew) and skip the batches of
        # begin_epoch it already trained on
        fast_forward = 0
        if resume_step_state is not None:
            fast_forward = int(resume_step_state.get("step", 0))
            if resume_step_state.get("rng") is not None:
                from .. import random as _random
                _random.set_state(resume_step_state["rng"])

        # preemption and the watchdog are set up inside the try, so a
        # failure anywhere in bring-up still runs the finally: a leaked
        # signal handler would swallow the process's next Ctrl-C, a leaked
        # monitor thread its memory
        preempt = None
        wd = None
        trace = None
        own_watchdog = False
        fused_trainer = self._deferred_metric_trainer()
        try:
            if preemption_safe:
                # flag set by SIGTERM/SIGINT, consumed at the step
                # boundaries below
                preempt = PreemptionHandler(logger=self.logger).install()
            # fit owns the watchdog's monitor thread; the fused trainer
            # (when present) is armed too so its step context lands in
            # the hang report
            if watchdog is None:
                watchdog = resilience.step_timeout_configured()
            if isinstance(watchdog, StepWatchdog):
                wd = watchdog
            elif watchdog:
                wd = StepWatchdog(logger=self.logger)
                own_watchdog = True
            if wd is not None:
                wd.start()
                if fused_trainer is not None:
                    fused_trainer.install_watchdog(wd)

            # MXTPU_PROFILE_DIR: capture a torch.profiler trace of steps
            # 10-15 of the first epoch (None when the env is unset)
            from .. import profiler as _profiler
            trace = _profiler.StepTraceCapture.from_env()

            for epoch in range(begin_epoch, num_epoch):
                tic = time.time()
                eval_metric.reset()
                data_stream = iter(train_data)
                nbatch = -1
                if epoch == begin_epoch and fast_forward > 0:
                    # skip the batches the interrupted run trained on
                    # (deterministic iterators replay the same order)
                    t_ff = time.perf_counter()
                    for _ in range(fast_forward):
                        try:
                            next(data_stream)
                        except StopIteration:
                            break
                        nbatch += 1
                    self.logger.info(
                        "fit(resume=True): fast-forwarded %d batches of "
                        "epoch %d in %.6f s", nbatch + 1, epoch,
                        time.perf_counter() - t_ff)
                while True:
                    # the armed window covers the data fetch too: a wedged
                    # staging thread hangs the consumer in next()
                    with wd.armed("epoch %d batch %d"
                                  % (epoch, nbatch + 1)) \
                            if wd is not None else nullcontext():
                        try:
                            data_batch = next(data_stream)
                        except StopIteration:
                            break
                        nbatch += 1
                        if trace is not None:
                            trace.on_batch(nbatch)
                        if monitor is not None:
                            monitor.tic()
                        self.forward_backward(data_batch)
                        self.update()
                        self.update_metric(eval_metric, data_batch.label)
                        if monitor is not None:
                            monitor.toc_print()
                        if batch_end_callback is not None:
                            batch_end_params = BatchEndParam(
                                epoch=epoch, nbatch=nbatch,
                                eval_metric=eval_metric, locals=locals())
                            for callback in _as_list(batch_end_callback):
                                callback(batch_end_params)
                    # step boundary: consume a pending preemption —
                    # checkpoint mid-epoch and exit for the supervisor to
                    # relaunch with resume
                    if preempt is not None:
                        if faults.consume("preempt"):
                            # in-band drill: deliver a real signal so the
                            # whole handler path is what gets tested
                            os.kill(os.getpid(), signal.SIGTERM)
                            time.sleep(0.05)  # let the handler run
                        triggered = preempt.triggered
                        if resilience._world() > 1:
                            # every rank takes the same branch at the
                            # same boundary (any rank signaled => all
                            # save) instead of one entering the
                            # checkpoint gather while another enters the
                            # next step's collectives
                            from .. import distributed as _dist
                            triggered = _dist.agree_flag(triggered)
                        if triggered:
                            self._save_preemption_checkpoint(
                                checkpoint, epoch, nbatch + 1)
                            preempted_exit()

                if trace is not None:
                    trace.stop()  # epoch shorter than the window: close
                    trace = None  # first epoch only

                # one epoch of training is finished
                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                toc = time.time()
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 toc - tic)

                # sync aux params across devices
                arg_params_, aux_params_ = self.get_params()
                self.set_params(arg_params_, aux_params_)

                if epoch_end_callback is not None:
                    for callback in _as_list(epoch_end_callback):
                        callback(epoch, self.symbol, arg_params_,
                                 aux_params_)

                if checkpoint is not None:
                    try:
                        states = self.get_optimizer_states()
                    except NotImplementedError:
                        states = None
                    checkpoint.save(epoch + 1, self.symbol, arg_params_,
                                    aux_params_, optimizer_states=states)

                if eval_data:
                    res = self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch)
                    for name, val in res:
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)

                # end of 1 epoch, reset the data-iter for another epoch
                train_data.reset()
            # drain the async checkpoint writers so every epoch's save is
            # durable (and a background write failure surfaces here)
            # before fit returns: the manager's own writer and the shared
            # default writer behind prefix-based saves (do_checkpoint's);
            # the writer threads are daemons, which interpreter exit kills
            if checkpoint is not None and hasattr(checkpoint, "wait"):
                checkpoint.wait()
            resilience.wait_checkpoints()
        finally:
            if trace is not None:
                trace.stop()    # a fit that raised inside the window
            if preempt is not None:
                preempt.uninstall()
            if wd is not None:
                if fused_trainer is not None:
                    fused_trainer.install_watchdog(None)
                if own_watchdog:
                    wd.stop()

    def _save_preemption_checkpoint(self, checkpoint, epoch, step):
        """Mid-epoch checkpoint at a step boundary: params and optimizer
        state under the epoch number the epoch-end save will use
        (epoch + 1), plus a ``step_state`` manifest record (epoch index,
        batches consumed, the random state as JSON) that
        ``fit(resume=True)`` fast-forwards from.  The later epoch-end save
        of the same number replaces the partial entry.

        The exit-85 contract needs the checkpoint on disk when the process
        exits: an in-flight async save is drained first (bounded; this
        blocking save supersedes whatever a failed write would have
        published) and this save is blocking, MXTPU_CKPT_ASYNC
        notwithstanding."""
        from .. import random as _random
        from ..resilience import (PREEMPT_EXIT_CODE, CheckpointManager,
                                  wait_checkpoints)
        try:
            wait_checkpoints(timeout=CheckpointManager.DRAIN_TIMEOUT / 2)
        except Exception as e:  # noqa: BLE001 — superseded below
            self.logger.warning(
                "preemption: in-flight async checkpoint write failed "
                "(%s: %s) — the blocking preemption save below "
                "supersedes it", type(e).__name__, e)
        arg_params_, aux_params_ = self.get_params()
        try:
            states = self.get_optimizer_states()
        except NotImplementedError:
            states = None
        checkpoint.save(epoch + 1, self.symbol, arg_params_, aux_params_,
                        optimizer_states=states, blocking=True,
                        step_state={"epoch": int(epoch), "step": int(step),
                                    "rng": _random.get_state()})
        self.logger.warning(
            "preemption: saved mid-epoch checkpoint (epoch %d, step %d) "
            "to %s; exiting with code %d — relaunch with resume to "
            "continue", epoch, step, checkpoint.directory,
            PREEMPT_EXIT_CODE)

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
        from ..resilience import atomic_path
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        with atomic_path(fname) as tmp:
            nd.save(tmp, save_dict)

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

    def _deferred_metric_trainer(self):
        """The fused SPMDTrainer that can carry on-device metrics, or
        None: the base has none, so every module type keeps the blocking
        path unless it overrides this."""
        return None

    def _install_deferred_metric(self, eval_metric):
        """fit() hook: move the train metric's accumulation into the
        fused step (``metric.try_install_deferred``).  Detaches a metric
        installed before and removes a stale device rule when the new
        metric cannot defer, so a second fit() never keeps the first's
        accumulators or takes its deltas."""
        prev = getattr(self, "_deferred_metric", None)
        if prev is not None:
            prev.detach_deferred_source()
        self._deferred_metric = None
        self._deferred_interval = 0
        self._deferred_calls = 0
        trainer = self._deferred_metric_trainer()
        if trainer is None:
            return
        interval = metric_mod.try_install_deferred(trainer, eval_metric)
        if interval is None:
            if getattr(trainer, "_metric_fn", None) is not None:
                trainer.install_metric(None)
            return
        self._deferred_metric = eval_metric
        self._deferred_interval = interval

    def _deferred_metric_update(self, eval_metric):
        """True when ``eval_metric`` accumulates on the device for train
        steps (the per-step host update is skipped); folds the device
        totals every ``_deferred_interval`` calls."""
        if getattr(self, "_deferred_metric", None) is not eval_metric:
            return False
        self._deferred_calls += 1
        if self._deferred_interval > 0 and \
                self._deferred_calls % self._deferred_interval == 0:
            eval_metric.fold_deferred()
        return True

    def get_optimizer_states(self):
        """Serialized optimizer state (bytes), for managed checkpoints.
        Modules with an optimizer implement this; the base raises, so
        ``fit(checkpoint=...)`` degrades to params-only checkpoints."""
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
