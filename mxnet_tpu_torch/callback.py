"""Training callbacks (port of ``mxnet_tpu/callback.py``; reference
python/mxnet/callback.py), with ``PreemptionCheckpoint`` for custom
training loops and ``do_checkpoint`` over a ``CheckpointManager``."""
from __future__ import annotations

import logging
import math
import sys
import time

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint", "log_train_metric",
           "module_checkpoint", "PreemptionCheckpoint"]


class PreemptionCheckpoint(object):
    """Batch-end callback giving custom training loops the graceful-
    preemption exit ``fit(preemption_safe=True)`` has built in: installs
    a :class:`~mxnet_tpu_torch.resilience.PreemptionHandler`, and at the
    first batch boundary after SIGTERM/SIGINT saves a mid-epoch
    checkpoint (step and RNG state in the manifest) through ``manager``
    and exits with ``resilience.PREEMPT_EXIT_CODE`` for a supervisor to
    relaunch.

    Use it as a context manager (or call :meth:`close`) so the signal
    handlers are restored when the loop finishes without a preemption::

        man = mx.resilience.CheckpointManager("ckpt/")
        with mx.callback.PreemptionCheckpoint(mod, man) as cb:
            for epoch in ...:
                for nbatch, batch in enumerate(train_iter):
                    mod.forward_backward(batch); mod.update()
                    cb(mx.model.BatchEndParam(epoch, nbatch, metric,
                                              locals()))
    """

    def __init__(self, mod, manager, handler=None):
        from .resilience import PreemptionHandler
        self.mod = mod
        self.manager = manager
        self.handler = handler or PreemptionHandler()
        self.handler.install()

    def __call__(self, param):
        if not self.handler.triggered:
            return
        from .resilience import preempted_exit
        self.mod._save_preemption_checkpoint(self.manager, param.epoch,
                                             param.nbatch + 1)
        self.handler.uninstall()
        preempted_exit()

    def close(self):
        """Restore the original signal handlers (idempotent)."""
        self.handler.uninstall()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
        return False


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving prefix-symbol.json + prefix-%04d.params
    (reference callback.py:do_checkpoint).  Writes are atomic; ``prefix``
    may also be a :class:`~mxnet_tpu_torch.resilience.CheckpointManager`,
    which adds manifest discovery, per-file checksums and keep_last
    retention.  Under ``MXTPU_CKPT_ASYNC=1`` both forms return after the
    host copy and a background writer does the file IO: drain with
    ``manager.wait()`` / ``resilience.wait_checkpoints()``."""
    from .model import save_checkpoint
    period = int(max(1, period))
    managed = hasattr(prefix, "save") and hasattr(prefix, "latest")

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            if managed:
                prefix.save(iter_no + 1, sym, arg, aux)
            else:
                save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback checkpointing a Module (reference
    callback.py:module_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the metric every ``period`` batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer(object):
    """Samples/sec throughput logging (reference callback.py:Speedometer).
    The rate is on the host clock between two callback calls ``frequent``
    batches apart; it reads the metric, which reads the outputs, so it
    waits for the device."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / \
                    (time.time() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    param.eval_metric.reset()
                    for name, value in name_value:
                        logging.info(
                            "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                            "\tTrain-%s=%f", param.epoch, count, speed, name,
                            value)
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec", param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class ProgressBar(object):
    """Text progress bar (reference callback.py:ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        sys.stdout.write("[%s] %s%s\r" % (prog_bar, percents, "%"))
