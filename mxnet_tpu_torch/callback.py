"""Training callbacks (port of ``mxnet_tpu/callback.py:62-156``;
reference python/mxnet/callback.py).  ``PreemptionCheckpoint`` comes with
the resilience slice and raises until then."""
from __future__ import annotations

import logging
import math
import sys
import time

from .base import MXNetError

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint", "log_train_metric",
           "module_checkpoint", "PreemptionCheckpoint"]


class PreemptionCheckpoint(object):
    """Graceful-preemption batch-end callback: not ported yet."""

    def __init__(self, mod, manager, handler=None):
        raise MXNetError("callback.PreemptionCheckpoint is not ported yet "
                         "(it comes with the resilience slice of "
                         "mxnet_tpu_torch)")


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving prefix-symbol.json + prefix-%04d.params
    (reference callback.py:do_checkpoint); the writes are atomic."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
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
