"""Shared fleet view: ONE controller-side prober, N stateless router
workers (the sharded front end; port of ``mxnet_tpu/fleet/view.py``).

One Python router process reads every request body, forwards it and
writes every answer under one GIL, so past some request rate the router
itself, not the replicas behind it, bounds the fleet.  The fix is the
classic SO_REUSEPORT shard: N router WORKER processes all listen on the
SAME public port (the kernel hashes each connection to one worker at
SYN time, so an established keep-alive connection stays put), and the
single-process ceiling multiplies by the worker count.

What keeps N workers coherent without coordination is this module's
split:

- :class:`FleetViewPublisher` — the ONE prober.  It wraps a non-serving
  :class:`~.router.FleetRouter` (probe loop + fence state + the N-1
  capacity floor, reused verbatim) and publishes the routing inputs —
  replica addresses, health, per-replica ``/stats``, the fenced set —
  into an atomically-replaced JSON snapshot stamped with a monotonically
  increasing **generation** counter.  Fencing (rolling swaps, autoscale
  scale-down) happens HERE, controller-side; the snapshot is how workers
  learn of it.
- :class:`FleetViewReader` — the worker-side consumer: re-reads the
  snapshot on a refresh period, keeps the last good document when a read
  races the publisher or the publisher is briefly gone (a worker on a
  stale generation keeps routing to the last-known-healthy set — SAFE,
  because a replica that died since then is absorbed by the router's
  keyed one-resend-elsewhere discipline), and never moves BACKWARD in
  generations.
- :class:`RouterWorkerSet` — spawns + supervises the N
  ``fleet_main.py router-worker`` processes (same exit-code discipline
  as the replica controller: unexpected deaths respawn within a streak
  budget, drains respawn nothing).  A worker imports neither torch nor
  jax (the stub-package import of ``fleet_main.py``): a respawn pays no
  torch import and no worker holds a CUDA context beside the replicas.

Why a JSON file and not mmap: the snapshot is kB-scale at any plausible
fleet size, ``os.replace`` gives atomic whole-document swaps with zero
reader locking, and the file doubles as a live debugging surface
(``cat run/fleet-view.json``).

Workers never probe and never talk to each other; each keeps its OWN
:class:`~..serving.frontend.Stats` counters and periodically dumps them
next to the view file, so ANY worker can answer ``/stats`` for the
whole front end by merging the sibling dumps with its live counters
(see ``FleetRouter.stats_payload`` in view mode).
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

from ..base import MXNetError, get_env, register_env

__all__ = ["FleetViewPublisher", "FleetViewReader", "RouterWorkerSet",
           "OutlierDetector", "reserve_port", "worker_stats_path",
           "default_fleet_py", "VIEW_BASENAME", "ENV_FLEET_WORKERS",
           "ENV_FLEET_VIEW_REFRESH_S", "ENV_FLEET_EJECT_X"]

ENV_FLEET_WORKERS = register_env(
    "MXTPU_FLEET_WORKERS", default=1,
    doc="Router worker processes sharing the public port via "
        "SO_REUSEPORT (`fleet_main.py serve --workers`); 1 keeps the "
        "single-process in-line router")
ENV_FLEET_VIEW_REFRESH_S = register_env(
    "MXTPU_FLEET_VIEW_REFRESH_S", default=0.25,
    doc="Shared-fleet-view cadence: the controller-side prober "
        "publishes the routing snapshot and each router worker re-reads "
        "it (and dumps its own counters) this often")
ENV_FLEET_EJECT_X = register_env(
    "MXTPU_FLEET_EJECT_X", default=0.0,
    doc="Gray-failure outlier ejection: temporarily eject a replica "
        "whose recent-p99 latency EWMA exceeds this multiple of the "
        "fleet median (or whose forward errors streak), folded into "
        "the published healthy bit like fencing; 0 disables ejection")

#: the snapshot file name under the fleet run dir
VIEW_BASENAME = "fleet-view.json"

#: what a reader answers before the first successful snapshot read —
#: nothing routable, which the worker surfaces as 503 (identical to a
#: fleet whose replicas have not probed healthy yet)
_EMPTY_DOC = {"generation": 0, "published_at": 0.0, "replicas": {},
              "fenced": [], "models": []}


def reserve_port(host="127.0.0.1", port=0):
    """Claim the fleet's public port for the worker shard: bind a
    SO_REUSEPORT socket WITHOUT listening and keep it open for the
    fleet's lifetime.

    A bound-but-not-listening socket takes no connections (the kernel
    only balances across *listening* reuseport sockets), so the parent
    holds the port steady — ``port=0`` resolves the ephemeral pick
    once, and the port cannot be stolen by an unrelated process in the
    gap while a dead worker respawns.  Returns ``(socket, port)``; the
    caller owns closing the socket."""
    if not hasattr(socket, "SO_REUSEPORT"):
        raise MXNetError(
            "SO_REUSEPORT is not available on this platform — the "
            "sharded front end (--workers > 1) needs Linux")
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        sock.bind((host, int(port)))
    except OSError:
        sock.close()
        raise
    return sock, sock.getsockname()[1]


def worker_stats_path(run_dir, worker_id):
    """Where router worker ``worker_id`` dumps its counters (and what
    any sibling merges on ``/stats``)."""
    return os.path.join(run_dir, "rworker-%d.stats.json" % int(worker_id))


def default_fleet_py():
    """``fleet_main.py`` in this package (the router-worker binary)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fleet_main.py")


class OutlierDetector(object):
    """Controller-side gray-failure detection (Envoy-style outlier
    ejection, per "The Tail at Scale"): the ONE prober tracks each
    replica's recent-p99 latency as an EWMA plus its forward-error
    streak, and temporarily EJECTS a replica that has gone
    slow-but-alive — p99 EWMA beyond ``MXTPU_FLEET_EJECT_X`` times the
    fleet median, or ``error_streak`` consecutive probe passes with new
    transport errors.  Ejection folds into the published view's healthy
    bit exactly like fencing, so every router worker stops routing to
    the outlier within one snapshot refresh.

    Guard rails:

    - **max-eject fraction / N-1 floor**: at most ``max_eject_frac`` of
      the routable set may be ejected at once, and never the last
      routable replica (``eject_blocked_floor`` counts refusals) — a
      detector gone wrong must degrade to the old behavior, not take
      the fleet down;
    - **half-open re-probe**: after ``hold_s`` the replica rejoins
      routing on probation (its EWMA is reset — fresh eyes); the next
      pass with a latency sample either re-ejects it (still an outlier)
      or reinstates it for good (``eject_rejoins``).

    The latency signal is each replica's ``latency_ms.p99_recent`` from
    its own ``/stats`` (a small-window tail percentile — see
    ``Stats.RECENT_WINDOW``), NOT the probe round-trip: a gray-failing
    replica answers its cheap ``/healthz`` promptly while its serving
    path crawls."""

    def __init__(self, eject_x=None, alpha=0.4, min_samples=3,
                 max_eject_frac=0.5, hold_s=2.0, error_streak=3):
        self.eject_x = float(get_env(ENV_FLEET_EJECT_X)
                             if eject_x is None else eject_x)
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self.max_eject_frac = float(max_eject_frac)
        self.hold_s = float(hold_s)
        self.error_streak = int(error_streak)
        self._lock = threading.Lock()
        self._ewma = {}          # rid -> (ewma_ms, sample_count)
        self._errors = {}        # rid -> last cumulative error count
        self._streaks = {}       # rid -> consecutive error passes
        self._ejected = {}       # rid -> eject deadline (monotonic)
        self._half_open = set()  # rids on post-eject probation
        self.counters = {"ejects": 0, "eject_rejoins": 0,
                         "eject_blocked_floor": 0}

    @property
    def enabled(self):
        return self.eject_x > 0.0

    def ejected(self, now=None):
        """Rids currently held out of routing (half-open rids are
        routable — that IS the re-probe)."""
        if not self.enabled:
            return set()
        now = time.monotonic() if now is None else now
        with self._lock:
            expired = [r for r, until in self._ejected.items()
                       if now >= until]
            for rid in expired:
                del self._ejected[rid]
                self._half_open.add(rid)
                # probation judges fresh samples, not the slow spell
                # that caused the eject
                self._ewma.pop(rid, None)
                self._streaks.pop(rid, None)
            return set(self._ejected)

    def _median(self, rids):
        vals = sorted(self._ewma[r][0] for r in rids
                      if r in self._ewma
                      and self._ewma[r][1] >= self.min_samples)
        if not vals:
            return None
        return vals[len(vals) // 2]

    def update(self, routable, latency_ms, errors, now=None):
        """One detector pass, fed by the prober: ``routable`` = rids
        routable before ejection, ``latency_ms`` = {rid: recent p99},
        ``errors`` = {rid: cumulative forward+probe error count}.
        Returns the counter increments for this pass (the router folds
        them into its /stats counters)."""
        if not self.enabled:
            return {}
        now = time.monotonic() if now is None else now
        held = self.ejected(now)        # also promotes expired -> half-open
        events = {"ejects": 0, "eject_rejoins": 0,
                  "eject_blocked_floor": 0}
        with self._lock:
            gone = [r for r in self._ewma if r not in routable
                    and r not in held]
            for rid in gone:            # evicted/scaled-down: forget it
                self._ewma.pop(rid, None)
                self._streaks.pop(rid, None)
                self._errors.pop(rid, None)
                self._half_open.discard(rid)
            for rid in routable:
                if rid in held:
                    continue
                sample = latency_ms.get(rid)
                if sample is not None:
                    ewma, n = self._ewma.get(rid, (float(sample), 0))
                    ewma += self.alpha * (float(sample) - ewma)
                    self._ewma[rid] = (ewma, n + 1)
                errs = int(errors.get(rid, 0))
                last = self._errors.get(rid)
                self._errors[rid] = errs
                if last is not None and errs > last:
                    self._streaks[rid] = self._streaks.get(rid, 0) + 1
                else:
                    self._streaks[rid] = 0
            active = [r for r in routable if r not in held]
            median = self._median(active)
            max_eject = min(int(self.max_eject_frac * len(active)),
                            len(active) - 1)
            for rid in active:
                outlier = self._streaks.get(rid, 0) >= self.error_streak
                ewma, n = self._ewma.get(rid, (0.0, 0))
                if not outlier and median and n >= self.min_samples:
                    outlier = ewma > self.eject_x * median
                if rid in self._half_open:
                    if n < 1:
                        continue        # no fresh sample yet: stay open
                    self._half_open.discard(rid)
                    if not outlier:
                        self.counters["eject_rejoins"] += 1
                        events["eject_rejoins"] += 1
                        continue        # reinstated; fall through ejects
                if not outlier:
                    continue
                if len(self._ejected) + 1 > max_eject:
                    self.counters["eject_blocked_floor"] += 1
                    events["eject_blocked_floor"] += 1
                    continue
                self._ejected[rid] = now + self.hold_s
                self.counters["ejects"] += 1
                events["ejects"] += 1
        return events

    def export(self, now=None):
        """Per-rid eject state for the published view / stats table."""
        now = time.monotonic() if now is None else now
        held = self.ejected(now)
        with self._lock:
            out = {}
            for rid in set(self._ewma) | held | set(self._half_open):
                ewma = self._ewma.get(rid)
                out[rid] = {
                    "ejected": rid in held,
                    "eject_left_s":
                        round(self._ejected[rid] - now, 3)
                        if rid in self._ejected else None,
                    "half_open": rid in self._half_open,
                    "latency_ewma_ms":
                        round(ewma[0], 3) if ewma else None}
            return out


class FleetViewPublisher(object):
    """The one prober: probe the fleet through ``router`` (a
    :class:`~.router.FleetRouter` that never serves HTTP — the parent
    process builds it purely for its probe loop, fence state and
    capacity-floor checks) and publish the routing snapshot to
    ``path`` after every pass."""

    def __init__(self, router, path, period_s=None, log=None):
        self.router = router
        self.path = path
        self.period_s = float(get_env(ENV_FLEET_VIEW_REFRESH_S)
                              if period_s is None else period_s)
        self.generation = 0
        self.publishes = 0
        self.publish_errors = 0
        # serializes publish_once: the publish loop owns the cadence,
        # but the autoscaler (and tests) call publish_once directly to
        # push a fence out early — two interleaved passes would race
        # the generation bump and could write snapshots out of order
        self._lock = threading.Lock()
        self._log = log or (lambda msg: None)
        self._stop = threading.Event()
        self._thread = None

    def publish_once(self, probe=True):
        """One probe pass + one atomic snapshot write; returns the
        published document."""
        from ..resilience import atomic_write
        if probe:
            self.router.probe()
        with self._lock:
            self.generation += 1
            doc = {"generation": self.generation,
                   "published_at": time.time(),
                   "heartbeat_s": self.router.heartbeat_s,
                   "evict_s": self.router.evict_s,
                   "replicas": self.router.view_export(),
                   "fenced": list(self.router.fenced()),
                   "models": self.router.manifest.names()}
            if self.router.deploy is not None:
                doc["rollout"] = self.router.deploy.stats()
            atomic_write(self.path, json.dumps(doc).encode("utf-8"),
                         fault_point="view_publish")
            self.publishes += 1
        return doc

    def _loop(self):
        while not self._stop.wait(self.period_s):
            try:
                self.publish_once()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                with self._lock:
                    self.publish_errors += 1
                self._log("fleet view: publish failed (%s: %s)"
                          % (type(e).__name__, e))

    def start(self):
        """Publish one synchronous snapshot (workers started right
        after must never read an absent file), then keep publishing on
        the period."""
        if self._thread is not None:
            return self
        self.publish_once()
        self._thread = threading.Thread(target=self._loop,
                                        name="mxfleet-view-pub",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        return self

    def stats(self):
        return {"generation": self.generation,
                "publishes": self.publishes,
                "publish_errors": self.publish_errors,
                "period_s": self.period_s}


class FleetViewReader(object):
    """Worker-side snapshot consumer: cheap cached reads on a refresh
    period, last-good-document semantics on any read failure (torn
    replace race, publisher briefly absent), generations never move
    backward."""

    def __init__(self, path, refresh_s=None):
        self.path = path
        self.refresh_s = float(get_env(ENV_FLEET_VIEW_REFRESH_S)
                               if refresh_s is None else refresh_s)
        self._lock = threading.Lock()
        self._doc = None
        self._read_at = 0.0
        self.reads = 0
        self.read_errors = 0

    def doc(self, force=False):
        """The current view document (re-read at most every
        ``refresh_s`` unless forced); never raises — a worker must keep
        routing on the last good snapshot through publisher hiccups."""
        now = time.monotonic()
        with self._lock:
            if not force and self._doc is not None \
                    and now - self._read_at < self.refresh_s:
                return self._doc
        try:
            with open(self.path) as f:
                fresh = json.load(f)
        except (OSError, ValueError):
            with self._lock:
                self.read_errors += 1
                self._read_at = now     # do not hammer a missing file
                return self._doc if self._doc is not None else _EMPTY_DOC
        with self._lock:
            self.reads += 1
            self._read_at = now
            if self._doc is None or int(fresh.get("generation", 0)) >= \
                    int(self._doc.get("generation", 0)):
                self._doc = fresh
            return self._doc

    @property
    def generation(self):
        return int(self.doc().get("generation", 0))

    def age_s(self):
        """Wall-clock age of the held snapshot (the worker's staleness
        gauge; same host, so wall clocks agree)."""
        published = float(self.doc().get("published_at", 0.0))
        if not published:
            return None
        return max(0.0, time.time() - published)

    def replicas(self):
        """{rid: entry} with the ORIGINAL replica ids (JSON stringifies
        dict keys; each entry carries its real ``id``)."""
        out = {}
        for key, ent in (self.doc().get("replicas") or {}).items():
            out[ent.get("id", key)] = ent
        return out

    def fenced(self):
        return list(self.doc().get("fenced") or [])


class _Worker(object):
    """Bookkeeping for one supervised router-worker process."""

    __slots__ = ("id", "argv", "log_path", "proc", "restarts", "streak",
                 "state", "last_rc", "spawned_at")

    def __init__(self, wid, argv, log_path):
        self.id = wid
        self.argv = argv
        self.log_path = log_path
        self.proc = None
        self.restarts = 0
        self.streak = 0
        self.state = "starting"
        self.last_rc = None
        self.spawned_at = None

    def snapshot(self):
        return {"id": self.id, "state": self.state,
                "pid": self.proc.pid if self.proc is not None else None,
                "restarts": self.restarts, "last_rc": self.last_rc}


class RouterWorkerSet(object):
    """Spawn + supervise N ``fleet_main.py router-worker`` processes,
    all binding the same reserved public port via SO_REUSEPORT.

    Same supervision discipline as :class:`~.controller
    .ReplicaController`: an unexpected death respawns within a streak
    budget (``stable_s`` of uptime resets the streak), a drain respawns
    nothing.  Workers are pure-host processes (no torch, no jax) — a
    respawn is fast, and the kernel keeps balancing new connections over
    the survivors meanwhile."""

    def __init__(self, manifest_path, view_path, host, port, workers,
                 run_dir, slo_ms=0.0, request_timeout=60.0,
                 spill_queue=None, python=None, fleet_py=None,
                 max_restarts=3, backoff=0.5, stable_s=30.0, log=None):
        if int(workers) < 1:
            raise MXNetError("a worker set needs at least one worker")
        self.run_dir = run_dir
        self.max_restarts = int(max_restarts)
        self.backoff = float(backoff)
        self.stable_s = float(stable_s)
        self._log = log or (lambda msg: None)
        self._lock = threading.Lock()
        self._draining = False
        self._threads = []
        os.makedirs(run_dir, exist_ok=True)
        python = python or sys.executable
        fleet_py = fleet_py or default_fleet_py()
        self.workers = []
        for i in range(int(workers)):
            argv = [python, fleet_py, "router-worker",
                    "--manifest-file", manifest_path,
                    "--view", view_path,
                    "--host", host, "--port", str(int(port)),
                    "--worker-id", str(i),
                    "--run-dir", run_dir,
                    "--slo-ms", str(float(slo_ms)),
                    "--request-timeout", str(float(request_timeout))]
            if spill_queue is not None:
                argv += ["--spill-queue", str(int(spill_queue))]
            self.workers.append(_Worker(
                i, argv, os.path.join(run_dir, "rworker-%d.log" % i)))

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        for w in self.workers:
            # a stale dump must not satisfy wait_ready before the new
            # process actually bound the port
            try:
                os.unlink(worker_stats_path(self.run_dir, w.id))
            except OSError:
                pass
            self._spawn(w)
            t = threading.Thread(target=self._supervise, args=(w,),
                                 name="mxfleet-rworker-sup-%d" % w.id,
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def _spawn(self, w):
        log_f = open(w.log_path, "ab")
        try:
            w.proc = subprocess.Popen(w.argv, stdout=log_f, stderr=log_f)
        finally:
            log_f.close()
        w.spawned_at = time.monotonic()
        w.state = "starting"
        self._log("fleet: router worker %d spawned (pid %d)"
                  % (w.id, w.proc.pid))

    def _supervise(self, w):
        while True:
            rc = w.proc.wait()
            with self._lock:
                w.last_rc = rc
                if self._draining:
                    w.state = "drained" if rc == 0 else "exited"
                    return
                if time.monotonic() - w.spawned_at >= self.stable_s:
                    w.streak = 0
                if w.streak >= self.max_restarts:
                    w.state = "failed"
                    self._log("fleet: router worker %d exit rc=%s — "
                              "restart budget (%d) exhausted"
                              % (w.id, rc, self.max_restarts))
                    return
                w.streak += 1
                w.restarts += 1
            self._log("fleet: router worker %d exit rc=%s — relaunch "
                      "%d/%d" % (w.id, rc, w.streak, self.max_restarts))
            if self.backoff > 0:
                time.sleep(self.backoff)
            with self._lock:
                if self._draining:
                    w.state = "exited"
                    return
                try:
                    os.unlink(worker_stats_path(self.run_dir, w.id))
                except OSError:
                    pass
                self._spawn(w)

    # -- observation -------------------------------------------------------
    def ready(self):
        """Worker ids whose first stats dump landed (a worker dumps
        immediately after binding the shared port — the readiness
        marker)."""
        out = []
        for w in self.workers:
            if os.path.exists(worker_stats_path(self.run_dir, w.id)):
                if w.state == "starting":
                    w.state = "serving"
                out.append(w.id)
        return out

    def wait_ready(self, timeout=60.0):
        deadline = time.monotonic() + timeout
        while True:
            ready = self.ready()
            if len(ready) == len(self.workers):
                return ready
            with self._lock:
                failed = [w.id for w in self.workers
                          if w.state == "failed"]
            if failed:
                raise MXNetError(
                    "router worker(s) %s failed during bring-up — see "
                    "logs under %r" % (failed, self.run_dir))
            if time.monotonic() > deadline:
                raise MXNetError(
                    "router workers %s never became ready within %.0fs"
                    % (sorted(set(w.id for w in self.workers)
                              - set(ready)), timeout))
            time.sleep(0.05)

    def snapshot(self):
        with self._lock:
            return [w.snapshot() for w in self.workers]

    # -- shutdown ----------------------------------------------------------
    def drain(self, timeout=30.0):
        """SIGTERM every worker (each fences new work, finishes its
        in-flight forwards, exits 0), wait, return {id: rc}."""
        with self._lock:
            self._draining = True
            procs = [(w, w.proc) for w in self.workers
                     if w.proc is not None]
        for w, proc in procs:
            if proc.poll() is None:
                try:
                    proc.send_signal(signal.SIGTERM)
                except OSError:     # pragma: no cover — just died
                    pass
        deadline = time.monotonic() + timeout
        rcs = {}
        for w, proc in procs:
            left = max(0.1, deadline - time.monotonic())
            try:
                rcs[w.id] = proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                proc.kill()
                rcs[w.id] = proc.wait()
                self._log("fleet: router worker %d did not drain in "
                          "%.0fs — killed" % (w.id, timeout))
        return rcs

    def kill(self):
        """SIGKILL everything (test cleanup, not a drain)."""
        with self._lock:
            self._draining = True
        for w in self.workers:
            if w.proc is not None and w.proc.poll() is None:
                w.proc.kill()
                w.proc.wait()
