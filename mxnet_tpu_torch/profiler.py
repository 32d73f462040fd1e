"""Profiler control (port of ``mxnet_tpu/profiler.py``; reference
python/mxnet/profiler.py over MXSetProfilerConfig/MXSetProfilerState/
MXDumpProfile).

Two collectors, as in the JAX package:

- the host dependency engine's per-op timings (modes ``symbolic`` and
  ``all``), dumped as Chrome ``traceEvents`` by :func:`dump_profile`;
- the device trace (mode ``all_xla``, the JAX package's name kept for
  parity): ``torch.profiler`` with CUDA activity on a card (CPU activity
  only on a CPU context), written as Chrome trace JSON under
  ``trace_dir``.  While it runs, the executor wraps every symbol node in
  ``torch.profiler.record_function(node.name)``
  (:func:`executor.node_ranges`), so :func:`get_op_stats` attributes
  device time to graph nodes.  Backward kernels run on autograd's
  threads, outside those ranges: they are attributed through the forward
  op's sequence number, which the profiler records on the forward op (an
  ``autograd.Function`` such as ``bn_act``'s included) and on the
  backward node that autograd runs for it, as ``_backward_<node>``.

``MXTPU_PROFILE_DIR`` makes ``fit`` trace steps 10-15 of its first epoch
(:class:`StepTraceCapture`).  ``MXNET_PROFILER_AUTOSTART=1`` starts the
host profiler at import (reference parity).
"""
from __future__ import annotations

import glob
import json
import os

from .base import MXNetError, get_env, register_env

__all__ = ["profiler_set_config", "profiler_set_state", "dump_profile",
           "dumps", "get_op_stats", "State", "Mode", "StepTraceCapture",
           "ENV_PROFILE_DIR", "attribute_trace", "latest_device_trace"]

#: when set, fit() captures a torch.profiler trace of steps 10-15 of the
#: first epoch into this directory (Chrome trace JSON: Perfetto)
ENV_PROFILE_DIR = register_env(
    "MXTPU_PROFILE_DIR",
    doc="fit() captures a torch.profiler trace of steps 10-15 of the "
        "first epoch into this directory")
ENV_PROFILER_AUTOSTART = register_env(
    "MXNET_PROFILER_AUTOSTART", default=0,
    doc="1 starts the host profiler at import (reference parity)")

#: the prefix of every device trace file this module writes
TRACE_PREFIX = "mxtrace-"

#: the name kernels no node range or backward node claims are listed under
UNATTRIBUTED = "[unattributed]"

#: kernels a device trace launches after CUPTI is on and before its
#: window opens: in a process that has traced windows before, a trace
#: can lose the kernel records of its window's first launches (none in a
#: fresh process, up to 21 after five minutes of windows on an H100
#: host, none in a window after 256 of these; chip_smoke.py
#: ``phase_tools_profile_windows``).  They fall before the window, so
#: the trace holds none of them.
WARMUP_LAUNCHES = 1024

_BACKWARD = "autograd::engine::evaluate_function: "
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class _DeviceTrace(object):
    """One ``torch.profiler`` session written as Chrome trace JSON into
    ``directory`` when stopped, with the executor's node ranges on while
    it runs."""

    def __init__(self, directory):
        self.directory = os.fspath(directory)
        self.path = None
        self._prof = None

    def start(self):
        import torch
        from . import executor
        from .context import current_context
        acts = [torch.profiler.ProfilerActivity.CPU]
        if current_context().device_type == "gpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(self.directory, exist_ok=True)
        self._prof = torch.profiler.profile(activities=acts)
        executor.node_ranges(True)
        try:
            self._prof.prepare_trace()
            if len(acts) > 1 and WARMUP_LAUNCHES > 0 and \
                    torch.cuda.is_available():
                x = torch.zeros(1, device=current_context().torch_device)
                for _ in range(WARMUP_LAUNCHES):
                    x.add_(1)
                torch.cuda.synchronize()
            self._prof.start_trace()
        except Exception:
            executor.node_ranges(False)
            raise

    def stop(self):
        import time
        import torch
        from . import executor
        try:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self._prof.stop()
        finally:
            executor.node_ranges(False)
        self.path = os.path.join(self.directory, "%s%d-%d.json" % (
            TRACE_PREFIX, os.getpid(), time.time_ns()))
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        return self.path


class StepTraceCapture(object):
    """Window-bounded ``torch.profiler`` trace for a training loop.

    Captures steps ``[start_step, stop_step]`` (default 10-15) of the
    epoch it is driven through: the caller invokes :meth:`on_batch` with
    the 0-based batch index before each step and :meth:`stop` at epoch
    end (closing a window the epoch cut short).  A steady-state window —
    not step 0 — so the trace shows the pipeline, not the first-call
    setup (cuDNN autotuning, kernel builds)."""

    def __init__(self, directory, start_step=10, stop_step=15):
        self.directory = os.fspath(directory)
        self.start_step = int(start_step)
        self.stop_step = int(stop_step)
        self._trace = None
        self._done = False

    @classmethod
    def from_env(cls):
        """A capture configured from MXTPU_PROFILE_DIR, or None."""
        directory = get_env(ENV_PROFILE_DIR)
        return cls(directory) if directory else None

    def on_batch(self, nbatch):
        if self._done:
            return
        if self._trace is None and nbatch >= self.start_step:
            self._trace = _DeviceTrace(self.directory)
            self._trace.start()
        elif self._trace is not None and nbatch > self.stop_step:
            self.stop()

    def stop(self):
        if self._trace is None:
            return
        path = self._trace.stop()
        self._trace = None
        self._done = True
        import logging
        logging.getLogger(__name__).info(
            "StepTraceCapture: wrote steps %d-%d trace to %s",
            self.start_step, self.stop_step, path)


class Mode(object):
    SYMBOLIC = "symbolic"       # kOnlySymbolic
    ALL = "all"                 # kAllOperator
    ALL_XLA = "all_xla"         # + the device trace via torch.profiler


class State(object):
    STOP = "stop"               # kNotRunning
    RUN = "run"                 # kRunning


_config = {"mode": Mode.ALL, "filename": "profile.json", "trace_dir": None}
_state = [State.STOP]
_device_trace = [None]


def _trace_dir(trace_dir=None):
    return trace_dir or _config["trace_dir"] or \
        os.path.splitext(_config["filename"])[0] + "_xla"


def profiler_set_config(mode="symbolic", filename="profile.json",
                        trace_dir=None):
    """Set profiler mode and output file (reference profiler.py:
    profiler_set_config / MXSetProfilerConfig)."""
    if mode not in (Mode.SYMBOLIC, Mode.ALL, Mode.ALL_XLA):
        raise MXNetError("invalid profiler mode %r" % (mode,))
    _config["mode"] = mode
    _config["filename"] = filename
    _config["trace_dir"] = trace_dir


def profiler_set_state(state="stop"):
    """Start/stop profiling (reference profiler.py:profiler_set_state /
    MXSetProfilerState).  In mode ``all_xla`` the device trace starts and
    stops with it; stopping writes it under ``trace_dir``."""
    from . import engine
    if state not in (State.RUN, State.STOP):
        raise MXNetError("invalid profiler state %r" % (state,))
    running = state == State.RUN
    engine.get().set_profiler_state(running)
    if running and _config["mode"] == Mode.ALL_XLA and \
            _device_trace[0] is None:
        trace = _DeviceTrace(_trace_dir())
        trace.start()
        _device_trace[0] = trace
    elif not running and _device_trace[0] is not None:
        trace, _device_trace[0] = _device_trace[0], None
        trace.stop()
    _state[0] = state


def dump_profile(finished=True):
    """Write the collected host-engine trace as Chrome traceEvents JSON to
    the configured filename (reference profiler.py:dump_profile /
    MXDumpProfile)."""
    del finished
    from . import engine
    data = engine.get().dump_profile()
    with open(_config["filename"], "w") as f:
        f.write(data)
    return _config["filename"]


def latest_device_trace(trace_dir=None):
    """Newest ``<trace_dir>/mxtrace-*.json`` this module wrote."""
    trace_dir = _trace_dir(trace_dir)
    cands = glob.glob(os.path.join(trace_dir, TRACE_PREFIX + "*.json"))
    if not cands:
        raise MXNetError(
            "no device trace under %r — profile with mode='all_xla' "
            "first" % (trace_dir,))
    return max(cands, key=os.path.getmtime)


class _Spans(object):
    """Named ``(start, end)`` host intervals of one thread, for the
    innermost-interval lookup: with properly nested intervals the one
    that holds ``ts`` with the latest start is the innermost."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [sp[0] for sp in self.spans]

    def innermost(self, ts):
        import bisect
        for i in range(bisect.bisect_right(self.starts, ts) - 1, -1, -1):
            start, end, name = self.spans[i]
            if ts <= end:
                return name
        return None


def attribute_trace(events):
    """``[(node, us, event)]`` for one Chrome trace's events: each device
    kernel, copy and set (``event`` its name) under the graph node whose
    range (or whose backward node, ``_backward_<node>``) launched it.  A
    trace with no device activity (a CPU context) gives each node range
    and backward node its own host duration instead."""
    ranges = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and \
                not e.get("name", "").startswith("ProfilerStep"):
            ranges.setdefault(e.get("tid"), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
    lookups = {tid: _Spans(v) for tid, v in ranges.items()}
    seq_node = {}
    backward = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "cpu_op":
            continue
        seq = (e.get("args") or {}).get("Sequence number")
        if seq is None:
            continue
        if e["name"].startswith(_BACKWARD):
            backward.append(e)
        elif seq not in seq_node:
            look = lookups.get(e.get("tid"))
            node = None if look is None else look.innermost(e["ts"])
            if node is not None:
                seq_node[seq] = node
    spans = {tid: list(v) for tid, v in ranges.items()}
    back_spans = []
    for e in backward:
        node = seq_node.get(e["args"]["Sequence number"])
        if node is not None:
            span = (e["ts"], e["ts"] + e.get("dur", 0), "_backward_" + node)
            spans.setdefault(e.get("tid"), []).append(span)
            back_spans.append(span)
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    if not device:
        out = [(name, end - start, name) for v in ranges.values()
               for start, end, name in v]
        return out + [(name, end - start, name)
                      for start, end, name in back_spans]
    lookups = {tid: _Spans(v) for tid, v in spans.items()}
    launch = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("cat") in _LAUNCH_CATS:
            launch[corr] = (e.get("tid"), e["ts"])
    out = []
    for e in device:
        at = launch.get((e.get("args") or {}).get("correlation"))
        name = None
        if at is not None and at[0] in lookups:
            name = lookups[at[0]].innermost(at[1])
        out.append((name or UNATTRIBUTED, float(e.get("dur", 0)),
                    e.get("name", "")))
    return out


def get_op_stats(trace_dir=None):
    """Per-graph-node device-time stats from the newest device trace:
    ``{name: {"count": n, "total_us": t, "avg_us": a, "min_us": m,
    "max_us": M}}`` for forward nodes and ``_backward_<node>`` (one count
    per kernel; on a CPU context, per node range)."""
    with open(latest_device_trace(trace_dir)) as f:
        events = json.load(f).get("traceEvents", [])
    stats = {}
    for name, us, _event in attribute_trace(events):
        s = stats.setdefault(name, {"count": 0, "total_us": 0.0,
                                    "min_us": float("inf"), "max_us": 0.0})
        s["count"] += 1
        s["total_us"] += us
        s["min_us"] = min(s["min_us"], us)
        s["max_us"] = max(s["max_us"], us)
    for s in stats.values():
        s["total_us"] = round(s["total_us"], 3)
        s["min_us"] = round(s["min_us"], 3)
        s["max_us"] = round(s["max_us"], 3)
        s["avg_us"] = round(s["total_us"] / s["count"], 3)
    return stats


def dumps(reset=False, trace_dir=None):
    """Per-node device-time table from the newest device trace (reference
    mx.profiler.dumps / profiler.cc:134-216 per-op stats).  ``reset`` is
    accepted for API parity (each trace is its own run already)."""
    del reset
    stats = get_op_stats(trace_dir)
    order = sorted(stats.items(), key=lambda kv: -kv[1]["total_us"])
    w = max([len("Name")] + [len(k) for k, _ in order]) + 2
    lines = ["Profile Statistics (device time by graph node)",
             "%-*s %10s %12s %12s %12s %12s" % (
                 w, "Name", "Count", "Total-us", "Min-us", "Max-us",
                 "Avg-us")]
    for name, s in order:
        lines.append("%-*s %10d %12.3f %12.3f %12.3f %12.3f" % (
            w, name, s["count"], s["total_us"], s["min_us"], s["max_us"],
            s["avg_us"]))
    return "\n".join(lines) + "\n"


if str(get_env(ENV_PROFILER_AUTOSTART, "0")) == "1":
    profiler_set_state(State.RUN)
