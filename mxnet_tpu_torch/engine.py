"""Host-side dependency engine (port of ``mxnet_tpu/engine.py``, the same
code over the port's copy of the native engine).

The engine orders host work (data-pipeline stages, RecordIO IO, Python
callbacks) with the reference's contract (reference
include/mxnet/engine.h:75-229, src/engine/threaded_engine.h:44-394):

* an op declares ``const_vars`` (reads) and ``mutable_vars`` (writes);
* reads of a var may run concurrently; a write serializes against all
  other access, in push order;
* ``wait_for_var`` blocks until everything already pushed touching the var
  has completed; ``wait_for_all`` drains the engine;
* variable deletion is dependency-ordered.

Device work is ordered by CUDA streams, not by this engine.  Two
backends: the native C++ engine (``native/engine.cc``, threaded pool)
loaded via ctypes, and a pure-Python one with identical semantics
(``MXNET_NO_NATIVE=1`` or ``force_python=True``).  ``MXNET_ENGINE_TYPE``
selects ``ThreadedEngine`` (default) or ``NaiveEngine`` (synchronous, for
debugging — reference src/engine/engine.cc:14-27).
"""
from __future__ import annotations

import ctypes
import itertools
import json
import threading
import traceback
from collections import deque

from . import native
from .base import MXNetError, get_env, register_env

ENV_ENGINE_TYPE = register_env(
    "MXNET_ENGINE_TYPE", default="ThreadedEngine",
    doc="Host dependency engine; NaiveEngine serializes every op on the "
        "caller thread for debugging")

__all__ = ["Engine", "get", "set_engine_type", "EngineVar"]


class EngineVar(object):
    """Opaque dependency variable handle."""

    __slots__ = ("id", "_engine")

    def __init__(self, var_id, engine):
        self.id = var_id
        self._engine = engine


class _NativeEngine(object):
    """ctypes wrapper over the C++ engine (native/engine.cc)."""

    def __init__(self, naive=False, num_workers=0):
        self._lib = native.get_lib()
        assert self._lib is not None
        self._handle = self._lib.MXTEngineCreate(0 if naive else 1,
                                                   num_workers)
        self._cb_lock = threading.Lock()
        self._callbacks = {}
        self._counter = itertools.count(1)
        self._errors = []
        # The dispatcher must outlive every pending op; bind it to self.
        self._dispatcher = native.ENGINE_CB(self._dispatch)
        self._closed = False

    def _dispatch(self, payload):
        token = int(payload)
        with self._cb_lock:
            fn = self._callbacks.pop(token, None)
        if fn is None:
            return
        try:
            fn()
        except BaseException:  # never propagate into C++
            with self._cb_lock:
                self._errors.append(traceback.format_exc())

    def _check_errors(self):
        with self._cb_lock:
            errs, self._errors = self._errors, []
        if errs:
            raise MXNetError(
                "engine op(s) raised:\n%s" % "\n---\n".join(errs))

    def new_variable(self):
        return EngineVar(self._lib.MXTEngineNewVar(self._handle), self)

    def delete_variable(self, var):
        self._lib.MXTEngineDeleteVar(self._handle, var.id)

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0, name=""):
        token = next(self._counter)
        with self._cb_lock:
            self._callbacks[token] = fn
        n_c, n_m = len(const_vars), len(mutable_vars)
        c_arr = (ctypes.c_uint64 * max(n_c, 1))(*[v.id for v in const_vars])
        m_arr = (ctypes.c_uint64 * max(n_m, 1))(*[v.id for v in mutable_vars])
        ret = self._lib.MXTEnginePushAsync(
            self._handle, self._dispatcher, ctypes.c_void_p(token),
            c_arr, n_c, m_arr, n_m, priority, name.encode())
        if ret != 0:
            with self._cb_lock:
                self._callbacks.pop(token, None)
            err = self._lib.MXTEngineLastError(self._handle)
            raise MXNetError("engine push failed: %s"
                            % (err.decode() if err else "unknown"))

    def wait_for_var(self, var):
        self._lib.MXTEngineWaitForVar(self._handle, var.id)
        self._check_errors()

    def wait_for_all(self):
        self._lib.MXTEngineWaitForAll(self._handle)
        self._check_errors()

    def num_pending(self):
        return self._lib.MXTEngineNumPending(self._handle)

    def set_profiler_state(self, running):
        self._lib.MXTProfilerSetState(self._handle, 1 if running else 0)

    def dump_profile(self):
        ptr = self._lib.MXTProfilerDump(self._handle)
        try:
            return ctypes.string_at(ptr).decode()
        finally:
            self._lib.MXTFree(ptr)

    def shutdown(self):
        if not self._closed:
            self._closed = True
            self._lib.MXTEngineWaitForAll(self._handle)
            self._lib.MXTEngineShutdown(self._handle)

    @property
    def is_native(self):
        return True


class _PyVar(object):
    __slots__ = ("queue", "running_reads", "write_granted", "version")

    def __init__(self):
        self.queue = deque()
        self.running_reads = 0
        self.write_granted = False
        self.version = 0


class _PyOpr(object):
    __slots__ = ("fn", "const_vars", "mutable_vars", "wait", "priority",
                 "name", "seq")

    def __init__(self):
        self.wait = 0


class _PythonEngine(object):
    """Pure-Python engine with the same semantics (fallback backend)."""

    def __init__(self, naive=False, num_workers=0):
        self._naive = naive
        self._lock = threading.Lock()
        self._pending = 0
        self._all_done = threading.Condition(self._lock)
        self._errors = []
        self._profiling = False
        self._events = []
        self._seq = itertools.count()
        if not naive:
            if num_workers <= 0:
                import os as _os
                # Host work is IO-bound; keep a floor above core count.
                num_workers = max(4, min(16, _os.cpu_count() or 4))
            self._ready = deque()
            self._ready_cv = threading.Condition()
            self._stop = False
            self._workers = [
                threading.Thread(target=self._worker_loop, daemon=True)
                for _ in range(num_workers)]
            for t in self._workers:
                t.start()

    def new_variable(self):
        return EngineVar(_PyVar(), self)

    def delete_variable(self, var):
        # Dependency-ordered no-op: Python GC owns reclamation.
        self.push(lambda: None, mutable_vars=(var,), name="DeleteVariable")

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0, name=""):
        cset = {id(v) for v in const_vars}
        for v in mutable_vars:
            if id(v) in cset:
                raise MXNetError("var appears in both const and mutable list")
        if len({id(v) for v in mutable_vars}) != len(mutable_vars) or \
                len(cset) != len(const_vars):
            raise MXNetError("duplicate var in dependency list")
        op = _PyOpr()
        op.fn = fn
        op.const_vars = [v.id for v in const_vars]
        op.mutable_vars = [v.id for v in mutable_vars]
        op.priority = priority
        op.name = name
        op.seq = next(self._seq)
        with self._lock:
            self._pending += 1
        op.wait = 1 + len(op.const_vars) + len(op.mutable_vars)
        for v in op.const_vars:
            self._append_dep(v, op, write=False)
        for v in op.mutable_vars:
            self._append_dep(v, op, write=True)
        self._on_granted(op)

    def _append_dep(self, v, op, write):
        grant = False
        with self._lock:
            if write:
                if not v.queue and v.running_reads == 0 and \
                        not v.write_granted:
                    v.write_granted = True
                    grant = True
                else:
                    v.queue.append((op, True))
            else:
                if not v.queue and not v.write_granted:
                    v.running_reads += 1
                    grant = True
                else:
                    v.queue.append((op, False))
        if grant:
            self._on_granted(op)

    def _complete_access(self, v, write):
        granted = []
        with self._lock:
            if write:
                v.write_granted = False
                v.version += 1
            else:
                v.running_reads -= 1
            while v.queue:
                op, w = v.queue[0]
                if w:
                    if v.running_reads == 0 and not v.write_granted:
                        v.write_granted = True
                        granted.append(op)
                        v.queue.popleft()
                    break
                if v.write_granted:
                    break
                v.running_reads += 1
                granted.append(op)
                v.queue.popleft()
        for op in granted:
            self._on_granted(op)

    def _on_granted(self, op):
        with self._lock:
            op.wait -= 1
            fire = op.wait == 0
        if fire:
            if self._naive:
                self._execute(op)
            else:
                with self._ready_cv:
                    self._ready.append(op)
                    self._ready_cv.notify()

    def _execute(self, op):
        import time
        start = time.time() if self._profiling else 0
        try:
            op.fn()
        except BaseException:
            with self._lock:
                self._errors.append(traceback.format_exc())
        if self._profiling:
            end = time.time()
            with self._lock:
                self._events.append((op.name or "op", int(start * 1e6),
                                     int(end * 1e6),
                                     threading.get_ident()))
        for v in op.const_vars:
            self._complete_access(v, write=False)
        for v in op.mutable_vars:
            self._complete_access(v, write=True)
        with self._lock:
            self._pending -= 1
            if self._pending == 0:
                self._all_done.notify_all()

    def _worker_loop(self):
        while True:
            with self._ready_cv:
                while not self._ready and not self._stop:
                    self._ready_cv.wait()
                if self._stop and not self._ready:
                    return
                op = self._ready.popleft()
            self._execute(op)

    def wait_for_var(self, var):
        done = threading.Event()
        self.push(done.set, const_vars=(var,), name="WaitForVar")
        done.wait()
        self._check_errors()

    def wait_for_all(self):
        with self._lock:
            while self._pending:
                self._all_done.wait()
        self._check_errors()

    def _check_errors(self):
        with self._lock:
            errs, self._errors = self._errors, []
        if errs:
            raise MXNetError(
                "engine op(s) raised:\n%s" % "\n---\n".join(errs))

    def num_pending(self):
        with self._lock:
            return self._pending

    def set_profiler_state(self, running):
        self._profiling = bool(running)

    def dump_profile(self):
        with self._lock:
            events = list(self._events)
        trace = []
        for name, start, end, tid in events:
            trace.append({"name": name, "cat": "operator", "ph": "B",
                          "ts": start, "pid": 0, "tid": tid})
            trace.append({"name": name, "cat": "operator", "ph": "E",
                          "ts": end, "pid": 0, "tid": tid})
        return json.dumps({"traceEvents": trace, "displayTimeUnit": "ms"},
                          indent=2)

    def shutdown(self):
        self.wait_for_all()
        if not self._naive:
            with self._ready_cv:
                self._stop = True
                self._ready_cv.notify_all()

    @property
    def is_native(self):
        return False


class Engine(object):
    """Facade choosing the native or Python backend."""

    def __new__(cls, engine_type=None, num_workers=0, force_python=False):
        if engine_type is None:
            engine_type = get_env(ENV_ENGINE_TYPE, "ThreadedEngine")
        naive = "naive" in engine_type.lower()
        if not force_python and native.get_lib() is not None:
            inst = _NativeEngine(naive=naive, num_workers=num_workers)
        else:
            inst = _PythonEngine(naive=naive, num_workers=num_workers)
        _track(inst)
        return inst


_engine = None
_engine_lock = threading.RLock()
_all_engines = None
_atexit_registered = False


def _track(inst):
    """Every engine (incl. private ones owned by data iterators) must be
    drained and stopped before interpreter teardown — native workers left
    running abort the process ('terminate called ...')."""
    global _all_engines, _atexit_registered
    import weakref
    with _engine_lock:
        if _all_engines is None:
            _all_engines = weakref.WeakSet()
        _all_engines.add(inst)
        if not _atexit_registered:
            import atexit
            atexit.register(_shutdown_global)
            _atexit_registered = True


def _shutdown_global():
    global _engine
    with _engine_lock:
        for eng in list(_all_engines or ()):
            try:
                eng.shutdown()
            except Exception:
                pass
        _engine = None


def get():
    """The process-global engine (reference Engine::Get())."""
    global _engine
    if _engine is None:
        with _engine_lock:
            if _engine is None:
                _engine = Engine()
    return _engine


def set_engine_type(engine_type):
    """Replace the global engine (drains and stops the old one first)."""
    global _engine
    with _engine_lock:
        if _engine is not None:
            _engine.shutdown()
        else:
            import atexit
            atexit.register(_shutdown_global)
        _engine = Engine(engine_type)
    return _engine
