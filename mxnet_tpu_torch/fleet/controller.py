"""Replica lifecycle: spawn N daemons, supervise, respawn (port of
``mxnet_tpu/fleet/controller.py``).

Each replica is a REAL serving daemon in its own OS process
(``serving/serve_main.py``: its own interpreter, its own GIL, its own
CUDA context and caching allocator, its card set via
``manifest.replica_device_env`` and ``--context``), launched with plain
``subprocess`` exactly like ``tools/supervise.py`` launches training —
and supervised by the same exit-code discipline, extended for serving:

- rc 85 (preempt) / 87 (watchdog: a wedged forward was aborted) are
  RESUMABLE: relaunch with ``MXTPU_RESUME=1`` in the child env.
- ANY other unexpected death (SIGKILL, OOM, crash — a serving fleet
  treats replica death as capacity loss, not job failure) also
  relaunches, without the resume env.
- a relaunch streak is budgeted (``max_restarts``); a replica that
  stays up ``stable_s`` seconds resets its streak, so transient deaths
  over a long-lived fleet never accumulate into a permanent hole.  A
  replica whose streak exhausts is left dead in state ``failed`` — the
  router routes around it.
- during a fleet drain nothing is relaunched; each replica gets the
  SIGTERM forwarded and drains to rc 0 on its own (the daemon's
  contract).

Each replica writes its port file and its log under the run directory
(``replica-<i>.port``, ``replica-<i>.log``); a respawn appends to the
same log, so the daemon's drain lines (``mxserve: launches {...}``)
of every drained run are there.  ``warm_store`` is exported to every
replica as ``MXTPU_COMPILE_CACHE``, so each daemon's ``--warmup`` (a
respawn's too) loads its bucket programs from the store.
Host cores are partitioned only among ``cpu`` replicas.
"""
from __future__ import annotations

import os
import signal
import subprocess
import threading
import time

from ..base import MXNetError
from ..resilience import PREEMPT_EXIT_CODE, WATCHDOG_EXIT_CODE
from .manifest import default_serve_py, replica_device_env

__all__ = ["Replica", "ReplicaController"]

RESUME_ENV = "MXTPU_RESUME"         # the supervise.py relaunch contract


class Replica(object):
    """One supervised serving daemon (bookkeeping only — the process
    itself is a ``subprocess.Popen``)."""

    __slots__ = ("id", "argv", "env", "port_file", "log_path", "proc",
                 "port", "restarts", "streak", "state", "last_rc",
                 "spawned_at", "affinity")

    def __init__(self, rid, argv, env, port_file, log_path,
                 affinity=None):
        self.id = rid
        self.argv = argv
        self.env = env
        self.port_file = port_file
        self.log_path = log_path
        self.proc = None
        self.port = None
        self.restarts = 0           # lifetime relaunch count (stats)
        self.streak = 0             # consecutive relaunches (the budget)
        self.state = "starting"
        self.last_rc = None
        self.spawned_at = None
        self.affinity = affinity

    def snapshot(self):
        return {"id": self.id, "state": self.state, "port": self.port,
                "pid": self.proc.pid if self.proc is not None else None,
                "restarts": self.restarts, "last_rc": self.last_rc}


class ReplicaController(object):
    """Spawns ``manifest.replicas`` daemons and keeps them alive."""

    def __init__(self, manifest, run_dir, serve_py=None, python=None,
                 warm_store=None, max_restarts=3, backoff=0.5,
                 stable_s=30.0, cpu_affinity=None, extra_env=None,
                 extra_env_by_rid=None, log=None):
        self.manifest = manifest
        self.run_dir = run_dir
        self.serve_py = serve_py or default_serve_py()
        self.python = python
        self.warm_store = warm_store
        self.max_restarts = int(max_restarts)
        self.backoff = float(backoff)
        self.stable_s = float(stable_s)
        self.extra_env = dict(extra_env or {})
        #: {rid: {NAME: VALUE}} — per-replica env on top of extra_env;
        #: how a drill arms a fault (e.g. MXTPU_FAULTS=slow_replica:N)
        #: on exactly ONE replica of the fleet
        self.extra_env_by_rid = {int(k): dict(v) for k, v
                                 in (extra_env_by_rid or {}).items()}
        self._log = log or (lambda msg: None)
        self._lock = threading.Lock()
        self._draining = False
        self._threads = []
        os.makedirs(run_dir, exist_ok=True)
        if cpu_affinity is None:
            # auto: partition host cores iff the replicas are CPU-pinned
            # co-tenants that would otherwise fight over one thread pool
            cpu_affinity = (manifest.device_sets == "cpu"
                            and manifest.replicas > 1)
        affinities = self._affinity_sets(manifest.replicas) \
            if cpu_affinity else [None] * manifest.replicas
        self.replicas = []
        for i in range(manifest.replicas):
            self.replicas.append(self._make_replica(
                i, affinity=affinities[i]))

    def _make_replica(self, rid, affinity=None):
        port_file = os.path.join(self.run_dir, "replica-%d.port" % rid)
        log_path = os.path.join(self.run_dir, "replica-%d.log" % rid)
        argv = self.manifest.serve_argv(self.serve_py,
                                        port_file=port_file, port=0,
                                        python=self.python)
        env = dict(os.environ)
        env.update(replica_device_env(self.manifest.device_sets, rid))
        env.update(self.extra_env)
        env.update(self.extra_env_by_rid.get(rid, {}))
        if self.warm_store:
            env["MXTPU_COMPILE_CACHE"] = self.warm_store
        return Replica(rid, argv, env, port_file, log_path,
                       affinity=affinity)

    @staticmethod
    def _affinity_sets(n):
        """Partition this process's CPU set into ``n`` contiguous
        chunks (replica *i* -> chunk *i*); hosts with fewer cores than
        replicas share everything (nothing to partition)."""
        if not hasattr(os, "sched_getaffinity"):
            return [None] * n       # pragma: no cover — non-Linux
        cores = sorted(os.sched_getaffinity(0))
        if len(cores) < 2 * n:
            return [None] * n
        per = len(cores) // n
        return [set(cores[i * per:(i + 1) * per]) if i < n - 1
                else set(cores[(n - 1) * per:]) for i in range(n)]

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        for rep in self.replicas:
            self._spawn(rep, resume=False)
            self._watch(rep)
        return self

    def _watch(self, rep):
        t = threading.Thread(target=self._supervise, args=(rep,),
                             name="mxfleet-sup-%d" % rep.id,
                             daemon=True)
        t.start()
        self._threads.append(t)
        return t

    # -- autoscaling (fleet/autoscale.py) ----------------------------------
    def add_replica(self):
        """Scale-up: spawn ONE new replica (next free id) and supervise
        it like the rest.  It joins routing the moment its port file
        appears (after its warmup) and a probe succeeds.
        Dynamic replicas get no CPU pinning — the boot-time core
        partition is not re-balanced under scale."""
        with self._lock:
            if self._draining:
                raise MXNetError("fleet is draining — no scale-up")
            rid = max((r.id for r in self.replicas), default=-1) + 1
            rep = self._make_replica(rid)
            self.replicas.append(rep)
        self._spawn(rep, resume=False)
        self._watch(rep)
        return rep

    def stop_replica(self, rid, timeout=30.0):
        """Scale-down endpoint: SIGTERM ONE replica (it drains its
        accepted work and exits 0 — the daemon's contract) and never
        respawn it.  The CALLER owns the safety dance first: fence the
        replica at the router/publisher (the capacity floor is checked
        there) and wait out its queue — this method just retires the
        process.  Returns the exit code."""
        with self._lock:
            rep = next((r for r in self.replicas if r.id == rid), None)
            if rep is None:
                raise MXNetError("no replica %s to stop" % (rid,))
            rep.state = "scaling_down"
            proc = rep.proc
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:         # pragma: no cover — just died
                pass
        rc = None
        if proc is not None:
            try:
                rc = proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
                self._log("fleet: replica %d did not drain in %.0fs on "
                          "scale-down — killed" % (rep.id, timeout))
        with self._lock:
            rep.state = "scaled_down"
            rep.last_rc = rc
        # a scaled-down replica's port must never route again
        try:
            os.unlink(rep.port_file)
        except OSError:
            pass
        self._log("fleet: replica %d scaled down (rc=%s)" % (rid, rc))
        return rc

    def _spawn(self, rep, resume):
        env = dict(rep.env)
        if resume:
            env[RESUME_ENV] = "1"
        # a stale port file must never route traffic to a dead port
        try:
            os.unlink(rep.port_file)
        except OSError:
            pass
        rep.port = None
        log_f = open(rep.log_path, "ab")
        try:
            rep.proc = subprocess.Popen(rep.argv, env=env,
                                        stdout=log_f, stderr=log_f)
        finally:
            log_f.close()           # the child holds its own fd now
        rep.spawned_at = time.monotonic()
        rep.state = "starting"
        if rep.affinity:
            try:
                os.sched_setaffinity(rep.proc.pid, rep.affinity)
            except OSError:  # pragma: no cover — race with child death
                pass
        self._log("fleet: replica %d spawned (pid %d)"
                  % (rep.id, rep.proc.pid))

    def _supervise(self, rep):
        """One thread per replica: wait, classify the exit, relaunch
        per the policy above."""
        while True:
            rc = rep.proc.wait()
            with self._lock:
                rep.last_rc = rc
                if self._draining:
                    rep.state = "drained" if rc == 0 else "exited"
                    return
                if rep.state in ("scaling_down", "scaled_down"):
                    # the autoscaler retired this replica on purpose —
                    # its death is the plan, not a capacity loss
                    rep.state = "scaled_down"
                    return
                lived = time.monotonic() - rep.spawned_at
                if lived >= self.stable_s:
                    rep.streak = 0
                if rep.streak >= self.max_restarts:
                    rep.state = "failed"
                    self._log("fleet: replica %d exit rc=%s — restart "
                              "budget (%d) exhausted, leaving dead"
                              % (rep.id, rc, self.max_restarts))
                    return
                rep.streak += 1
                rep.restarts += 1
            resumable = rc in (PREEMPT_EXIT_CODE, WATCHDOG_EXIT_CODE)
            self._log("fleet: replica %d exit rc=%s (%s) — relaunch "
                      "%d/%d%s" % (rep.id, rc,
                                   "resumable" if resumable else "death",
                                   rep.streak, self.max_restarts,
                                   " with %s=1" % RESUME_ENV
                                   if resumable else ""))
            if self.backoff > 0:
                time.sleep(self.backoff)
            with self._lock:
                if self._draining:
                    rep.state = "exited"
                    return
                if rep.state in ("scaling_down", "scaled_down"):
                    rep.state = "scaled_down"
                    return
                self._spawn(rep, resume=resumable)

    # -- observation -------------------------------------------------------
    def ports(self):
        """{replica id: port or None} — a replica's port appears once
        its daemon finished warmup and wrote the port file (re-read
        after every respawn: ephemeral ports change)."""
        out = {}
        with self._lock:
            reps = list(self.replicas)
        for rep in reps:
            if rep.state == "scaled_down":
                continue            # retired on purpose — never routes
            if rep.port is None and os.path.exists(rep.port_file):
                try:
                    with open(rep.port_file) as f:
                        rep.port = int(f.read().split(":")[1])
                    if rep.state == "starting":
                        rep.state = "serving"
                except (OSError, ValueError, IndexError):
                    rep.port = None
            out[rep.id] = rep.port
        return out

    def snapshot(self):
        self.ports()
        with self._lock:
            reps = list(self.replicas)
        return [rep.snapshot() for rep in reps]

    def wait_ready(self, timeout=300.0):
        """Block until every replica wrote its port file (i.e. finished
        its warmup and is accepting); raises on timeout or if a replica
        fails permanently first."""
        deadline = time.monotonic() + timeout
        while True:
            ports = self.ports()
            if all(p is not None for p in ports.values()):
                return ports
            if self._draining:
                # a fleet-wide drain landed during bring-up: replicas
                # drained to rc 0 and will never write port files —
                # waiting out the timeout would just hang the drain
                raise MXNetError("fleet drained during bring-up")
            with self._lock:
                failed = [r.id for r in self.replicas
                          if r.state == "failed"]
            if failed:
                raise MXNetError(
                    "replica(s) %s failed during bring-up — see logs "
                    "under %r" % (failed, self.run_dir))
            if time.monotonic() > deadline:
                raise MXNetError(
                    "replicas %s never became ready within %.0fs"
                    % ([i for i, p in ports.items() if p is None],
                       timeout))
            time.sleep(0.1)

    # -- shutdown ----------------------------------------------------------
    def drain(self, timeout=60.0):
        """Fleet-wide drain: forward SIGTERM to every live replica
        (each finishes its accepted work and exits 0 — the daemon's
        contract), wait, return {id: rc}.  Stops all relaunching."""
        with self._lock:
            self._draining = True
            procs = [(rep, rep.proc) for rep in self.replicas
                     if rep.proc is not None]
        for rep, proc in procs:
            if proc.poll() is None:
                try:
                    proc.send_signal(signal.SIGTERM)
                except OSError:     # pragma: no cover — just died
                    pass
        deadline = time.monotonic() + timeout
        rcs = {}
        for rep, proc in procs:
            left = max(0.1, deadline - time.monotonic())
            try:
                rcs[rep.id] = proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                proc.kill()
                rcs[rep.id] = proc.wait()
                self._log("fleet: replica %d did not drain in %.0fs — "
                          "killed" % (rep.id, timeout))
        return rcs

    def kill(self):
        """SIGKILL everything (test cleanup, not a drain)."""
        with self._lock:
            self._draining = True
            reps = list(self.replicas)
        for rep in reps:
            if rep.proc is not None and rep.proc.poll() is None:
                rep.proc.kill()
                rep.proc.wait()
