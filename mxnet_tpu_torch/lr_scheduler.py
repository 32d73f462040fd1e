"""Learning-rate schedulers (port of ``mxnet_tpu/lr_scheduler.py``:
``FactorScheduler``, ``MultiFactorScheduler``, ``PolyScheduler`` and
``CosineScheduler``)."""
from __future__ import annotations

import logging
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler(object):
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates (lr_scheduler.py FactorScheduler)."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("Update[%d]: now learning rate arrived at %0.5e, "
                             "will not change in the future", num_update,
                             self.base_lr)
            else:
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each listed step (lr_scheduler.py MultiFactorScheduler)."""

    def __init__(self, step, factor=1.0):
        super().__init__()
        assert isinstance(step, list) and len(step) >= 1
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError("Schedule step must be an increasing list")
            if _step < 1:
                raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay to zero over ``max_update`` steps:
    ``base_lr * (1 - t / max_update) ** pwr`` (lr_scheduler.py
    PolyScheduler); past ``max_update`` the last rate stays."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        self.max_update = max_update
        self.power = pwr
        self.base_lr_orig = base_lr

    def __call__(self, num_update):
        if num_update <= self.max_update:
            self.base_lr = self.base_lr_orig * \
                pow(1.0 - float(num_update) / self.max_update, self.power)
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Linear warm-up over ``warmup_steps``, then cosine decay from
    ``base_lr`` to ``final_lr`` at ``max_update`` (lr_scheduler.py
    CosineScheduler)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0,
                 warmup_steps=0):
        super().__init__(base_lr)
        self.max_update = max_update
        self.final_lr = final_lr
        self.warmup_steps = warmup_steps
        self.base_lr_orig = base_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.base_lr_orig * num_update / max(1, self.warmup_steps)
        t = min(num_update - self.warmup_steps,
                self.max_update - self.warmup_steps)
        T = max(1, self.max_update - self.warmup_steps)
        return self.final_lr + (self.base_lr_orig - self.final_lr) * \
            0.5 * (1 + math.cos(math.pi * t / T))
