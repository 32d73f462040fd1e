"""Monitor: tap intermediate outputs and weights during training (port of
``mxnet_tpu/monitor.py``; reference python/mxnet/monitor.py, wired through
MXExecutorSetMonitorCallback).

``Monitor.install`` sets an executor's per-node tap
(:meth:`Executor.set_monitor_callback`): while one is installed the
executor interprets the plain, unfused plan and hands the callback each
node's outputs as ``<node>_output`` (``<node>_output<i>`` for several),
with ``monitor_all`` the arguments and aux states first, as in the JAX
package.  Statistics stay where ``stat_func`` leaves them (an NDArray on
the card for ``mx.nd.norm``) until ``toc`` formats them.
"""
from __future__ import annotations

import re

from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor(object):
    """Collect per-node statistics every ``interval`` batches (reference
    monitor.py:Monitor).

    Parameters
    ----------
    interval : int
        Sample every N calls of ``tic()``.
    stat_func : callable(NDArray) -> NDArray or number, optional
        The statistic; default mean(|x|), as in the reference.
    pattern : str
        Regex on tap names to include.
    sort : bool
        Sort stats by name in ``toc()``.
    monitor_all : bool
        Also tap arguments and aux states, not just op outputs.
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_all=False):
        if stat_func is None:
            def asum_stat(x):
                return abs(x).asnumpy().mean()
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self.monitor_all = monitor_all
        self._guard_sources = []

        def stat_helper(name, array):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(array)))
        self.stat_helper = stat_helper

    def install(self, exe):
        """Attach to an executor (reference monitor.py:install)."""
        exe.set_monitor_callback(self.stat_helper, self.monitor_all)
        self.exes.append(exe)

    def install_step_guard(self, source):
        """Also report the NaN/Inf step guard's counters at each ``toc()``:
        ``source`` is a Module (``skipped_update_count``) or an
        SPMDTrainer (``skipped_steps``/``consecutive_bad_steps``, which
        read the device counters); the rows are ``step_guard_skipped`` and
        ``step_guard_consecutive_bad``."""
        self._guard_sources.append(source)

    def tic(self):
        """Start collecting for this batch if it is a sampled one
        (reference monitor.py:tic)."""
        if self.step % self.interval == 0:
            for exe in self.exes:
                for array in exe.arg_arrays:
                    array.wait_to_read()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Finish the batch; return a list of (step, name, stat string)
        (reference monitor.py:toc)."""
        if not self.activated:
            return []
        for src in self._guard_sources:
            skipped = getattr(src, "skipped_update_count",
                              getattr(src, "skipped_steps", 0))
            self.queue.append((self.step, "step_guard_skipped",
                               float(skipped)))
            self.queue.append((self.step, "step_guard_consecutive_bad",
                               float(getattr(src, "consecutive_bad_steps",
                                             0) or 0)))
        for exe in self.exes:
            for array in exe.arg_arrays:
                array.wait_to_read()
        self.activated = False
        res = []
        queue = self.queue
        if self.sort:
            queue = sorted(queue, key=lambda x: x[1])
        for n, k, v_list in queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            res.append((n, k, str(v_list)))
        self.queue = []
        return res

    def toc_print(self):
        """Collect and print stats (reference monitor.py:toc_print)."""
        res = self.toc()
        for n, k, v in res:
            print("Batch: {:7d} {:30s} {}".format(n, k, v))
        return res
