"""Supervised children under the exit-code discipline of the port's
resilience layer (the counterpart of the JAX package's
``tools/supervise.py:74-`` ``Supervisor``, in the standard library only).

- 0: the child finished — the role is ``done``.
- 85 (:data:`~mxnet_tpu_torch.resilience.PREEMPT_EXIT_CODE`: a
  checkpoint was just saved) or 87 (:data:`~mxnet_tpu_torch.resilience.
  WATCHDOG_EXIT_CODE`: the run hung and aborted): relaunch with
  ``MXTPU_RESUME=1`` while the restart budget lasts.
- anything else propagates (the role is ``failed``), unless
  ``retry_any`` spends the same budget on any death (the region's chaos
  roles, whose SIGKILLs must respawn).
"""
import os
import signal
import subprocess
import sys
import threading

from ..resilience import ENV_RESUME, PREEMPT_EXIT_CODE, WATCHDOG_EXIT_CODE

__all__ = ["Supervisor", "relaunch_decision", "RESUME_ENV",
           "PREEMPT_EXIT_CODE", "WATCHDOG_EXIT_CODE"]

RESUME_ENV = ENV_RESUME


def relaunch_decision(rc, restarts, max_restarts, retry_any=False):
    """The exit-code policy: ``(verdict, why)`` with verdict ``"done"``
    (rc 0), ``"relaunch"`` (preempt or watchdog, or any death under
    ``retry_any``, with budget left) or ``"propagate"``."""
    if rc == 0:
        return "done", "completed"
    resumable = rc in (PREEMPT_EXIT_CODE, WATCHDOG_EXIT_CODE)
    why = {PREEMPT_EXIT_CODE: "graceful preemption",
           WATCHDOG_EXIT_CODE: "watchdog abort (hung step)"}.get(
               rc, "exit code %d" % rc)
    if not resumable and not retry_any:
        return "propagate", why + " (not a preempt/watchdog code)"
    if restarts >= max_restarts:
        return "propagate", why + " (restart budget %d spent)" \
            % max_restarts
    return "relaunch", why


class Supervisor(object):
    """One role's child under :func:`relaunch_decision`, watched by its
    own monitor thread so one orchestrator runs a tree of heterogeneous
    roles without blocking on any one.

    ``command`` is a list or ``(restarts) -> list``; ``env`` a dict or
    ``(restarts) -> dict`` (default: ``os.environ``), so a respawn can
    change flags or world size and drop a fault armed for the first
    spawn.  Respawns get ``MXTPU_RESUME=1``.  ``on_exit(role, rc,
    relaunching)`` runs on every child death.  :meth:`kill` is a chaos
    death the policy judges; :meth:`drain` stops supervising and ends the
    child."""

    def __init__(self, role, command, env=None, max_restarts=3,
                 backoff=0.5, retry_any=False, log=None, on_exit=None,
                 stdout=None, stderr=None):
        self.role = role
        self._command = command
        self._env = env
        self.max_restarts = max_restarts
        self.backoff = backoff
        self.retry_any = retry_any
        self.restarts = 0
        self.last_rc = None
        self.state = "new"       # new/running/backoff/done/failed/stopped
        self._log = log or (lambda m: sys.stderr.write(m + "\n"))
        self._on_exit = on_exit
        self._stdout, self._stderr = stdout, stderr
        self._proc = None
        self._stopping = threading.Event()
        self._thread = None
        self._lock = threading.Lock()

    # -- observation -------------------------------------------------------
    @property
    def pid(self):
        proc = self._proc
        return proc.pid if proc is not None and proc.poll() is None \
            else None

    def snapshot(self):
        return {"role": self.role, "state": self.state, "pid": self.pid,
                "restarts": self.restarts, "last_rc": self.last_rc}

    def running(self):
        return self._thread is not None and self._thread.is_alive()

    # -- lifecycle ---------------------------------------------------------
    def _spawn(self):
        command = self._command(self.restarts) \
            if callable(self._command) else list(self._command)
        env = self._env(self.restarts) if callable(self._env) \
            else dict(os.environ if self._env is None else self._env)
        if self.restarts > 0:
            env[RESUME_ENV] = "1"
        self._proc = subprocess.Popen(command, env=env,
                                      stdout=self._stdout,
                                      stderr=self._stderr)
        self.state = "running"
        return self._proc

    def start(self):
        """Spawn the child and the monitor thread; returns self."""
        with self._lock:
            if self.running():
                return self
            self._stopping.clear()
            self._spawn()
        self._thread = threading.Thread(
            target=self._monitor, name="supervise-%s" % self.role,
            daemon=True)
        self._thread.start()
        return self

    def _monitor(self):
        while True:
            rc = self._proc.wait()
            self.last_rc = rc
            if self._stopping.is_set():
                self.state = "stopped"
                if self._on_exit is not None:
                    self._on_exit(self.role, rc, False)
                return
            verdict, why = relaunch_decision(
                rc, self.restarts, self.max_restarts,
                retry_any=self.retry_any)
            if self._on_exit is not None:
                self._on_exit(self.role, rc, verdict == "relaunch")
            if verdict == "done":
                self.state = "done"
                return
            if verdict == "propagate":
                self.state = "failed"
                self._log("supervise[%s]: %s — giving up (rc %d)"
                          % (self.role, why, rc))
                return
            with self._lock:
                self.restarts += 1
            self._log("supervise[%s]: %s — relaunch %d/%d with %s=1"
                      % (self.role, why, self.restarts,
                         self.max_restarts, RESUME_ENV))
            self.state = "backoff"
            if self._stopping.wait(self.backoff):
                self.state = "stopped"
                return
            with self._lock:
                if self._stopping.is_set():
                    self.state = "stopped"
                    return
                self._spawn()

    def kill(self, sig=signal.SIGKILL):
        """Send ``sig`` to the current child (the monitor applies the
        policy to its death); returns the pid, or None between
        children."""
        with self._lock:
            proc = self._proc
            if proc is None or proc.poll() is not None:
                return None
            try:
                proc.send_signal(sig)
            except OSError:
                return None
            return proc.pid

    def drain(self, timeout=30.0, sig=signal.SIGTERM):
        """Stop supervising, send ``sig``, await the exit; returns the
        final rc (None when the child had to be SIGKILLed)."""
        self._stopping.set()
        with self._lock:
            proc = self._proc
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(sig)
            except OSError:
                pass
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                self.last_rc = None
                self.state = "stopped"
                if self._thread is not None:
                    self._thread.join(timeout=5.0)
                return None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self.state not in ("done", "failed"):
            self.state = "stopped"
        return self.last_rc
