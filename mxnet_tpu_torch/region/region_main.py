#!/usr/bin/env python
"""The composed region drill on the port (the counterpart of the JAX
package's ``tools/region.py``): one command that stands up every tier
the port has, wired the way a deployment wires them, and in ``storm``
mode runs it under a scheduled fault schedule.

::

    data#0..N   data_service/server_main.py hosts (the remote batch plane)
        |            .. feeding, over TCP with reconnect-resume ..
    trainer     region/trainer_main.py: a supervised elastic zero3
        |       SPMDTrainer on local_mesh("dp", [ctx] * world), resumed
        |       with MXTPU_RESUME=1 on every respawn
        |            .. publishing verified checkpoints into ..
    ckpt dir    watched by the fleet's RollingSwap (--watch)
        |            .. rolled replica-by-replica across ..
    fleet       fleet/fleet_main.py serve: N replicas behind the router
        |            .. serving closed-loop clients ..
    clients     in-process threads POSTing /predict (drop = contract bug)

Every process runs under a :class:`~mxnet_tpu_torch.region.supervisor.
Supervisor` (0 done / 85 preempt / 87 watchdog / retry-any for chaos
roles), each death a counted named event on ``/region/stats``.

::

    python mxnet_tpu_torch/region/region_main.py smoke --context cpu
    python mxnet_tpu_torch/region/region_main.py storm   # on gpu(0)
    python mxnet_tpu_torch/region/region_main.py run --spec region.json
    python mxnet_tpu_torch/region/region_main.py storm --report out.json \\
        --run-dir /tmp/r

``--context gpu(N)`` (the default ``gpu(0)``) puts every trainer mesh
position on card N and every replica on it too (``--device-sets
cuda:N``, co-tenants); ``--context cpu`` runs the whole region on the
host.  STORM mode drives a declarative fault schedule (one event per
line, ``resilience.parse_fault_schedule``) through the tree::

    2  kill   data#0                  # SIGKILL a data host mid-epoch
    5  resize trainer 4               # SIGKILL + respawn at world 4
    8  arm    trainer rot_checkpoint:1  # next publish is bit-rotted
    9  rot    trainer shard#1         # next publish: shard blob 1 rotted
    11 kill   replica#1               # SIGKILL a serving replica

The window opens only after the trainer's first publish is served by
every replica and the clients run: the trainer holds after that publish
until the region appends ``go`` to its command file, so every scheduled
fault lands on a live publish.

Acceptance (checked, reported, exit code): zero dropped or errored client
requests, no 502 leaked to a client, a bit-verified served-epoch advance
across the whole storm (``verify_promotion`` on the epoch every replica
ends on), and every scheduled fault observed as a counted named event
on ``/region/stats``: a seam failure surfaces as a number, never a hang.

IMPORT DISCIPLINE: this process never imports torch or jax (a control
plane that created a CUDA context would hold device memory beside its
children).  It imports the torch-free ``resilience`` and the
``Supervisor`` through a stub ``mxnet_tpu_torch`` package whose
``__path__`` points at the real directory, as ``fleet/fleet_main.py``
does; the trainer and the dataset builder run in their own processes.
"""
import argparse
import http.client
import importlib.machinery
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG_DIR = os.path.dirname(_HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path.pop(0)

SERVER_MAIN = os.path.join(_PKG_DIR, "data_service", "server_main.py")
TRAINER_MAIN = os.path.join(_HERE, "trainer_main.py")
FLEET_MAIN = os.path.join(_PKG_DIR, "fleet", "fleet_main.py")


def bootstrap():
    """Install the package-path stub (unless the real package is already
    imported) and return the torch-free ``resilience``."""
    if "mxnet_tpu_torch" not in sys.modules:
        pkg = types.ModuleType("mxnet_tpu_torch")
        pkg.__path__ = [_PKG_DIR]
        pkg.__spec__ = importlib.machinery.ModuleSpec(
            "mxnet_tpu_torch", None, is_package=True)
        pkg.__spec__.submodule_search_locations = pkg.__path__
        sys.modules["mxnet_tpu_torch"] = pkg
    from mxnet_tpu_torch import resilience as res
    return res


if __package__:        # imported from the package
    from .. import resilience
    from .supervisor import Supervisor
else:                  # a script, or imported beside it: the stub package
    resilience = bootstrap()
    from mxnet_tpu_torch.region.supervisor import Supervisor  # noqa: E402


def _log(msg):
    sys.stderr.write("region: " + msg + "\n")
    sys.stderr.flush()


# ---------------------------------------------------------------------------
# region spec: the declarative inventory (processes, ports, schedule)
# ---------------------------------------------------------------------------

STORM_SCHEDULE = """\
2  kill   data#0
5  resize trainer 4
8  arm    trainer rot_checkpoint:1
9  rot    trainer shard#1
11 kill   replica#1
"""


class RegionSpec(object):
    """The declarative region: process inventory + fault schedule.

    ``mode`` presets: ``run`` (full topology, no schedule), ``storm``
    (full topology + :data:`STORM_SCHEDULE`), ``smoke`` (1 data server,
    1 replica, 1 device, rot-publish only — the tier-1-sized variant).
    A ``--spec`` JSON file overrides any field.  The fields, presets and
    :meth:`as_dict` are the JAX package's (``tools/region.py:262-322``).
    """

    FIELDS = ("data_servers", "replicas", "router_workers", "devices",
              "epochs", "epoch_gap_s", "batch", "records", "clients",
              "client_pause_s", "schedule", "faults",
              "bringup_timeout_s", "settle_timeout_s")

    def __init__(self, mode="run", overrides=None):
        self.mode = mode
        self.data_servers = 2
        self.replicas = 2
        # >1 shards the fleet front end into SO_REUSEPORT router
        # workers (fleet_main.py --workers)
        self.router_workers = 1
        self.devices = 2
        self.epochs = 16
        self.epoch_gap_s = 0.8
        self.batch = 8
        self.records = 48
        self.clients = 4
        self.client_pause_s = 0.02
        self.schedule = STORM_SCHEDULE if mode == "storm" else ""
        if mode == "storm":
            # the storm rides the sharded front end: two reuseport
            # router workers between the clients and the replicas
            self.router_workers = 2
        self.faults = {}          # role -> MXTPU_FAULTS spec at spawn 0
        self.bringup_timeout_s = 420.0
        self.settle_timeout_s = 420.0
        if mode == "smoke":
            self.data_servers = 1
            self.replicas = 1
            self.devices = 1
            # enough epochs x gap that the trainer is still publishing
            # when the storm's rot lands (it must rot a LIVE publish:
            # the trainer also holds after its first publish until the
            # region's ``go``, see Region._open)
            self.epochs = 8
            self.epoch_gap_s = 0.8
            self.clients = 2
            self.schedule = "1 arm trainer rot_checkpoint:1\n"
        for key, value in (overrides or {}).items():
            if key not in self.FIELDS:
                raise SystemExit("unknown region spec field: %r" % key)
            setattr(self, key, value)

    @classmethod
    def for_mode(cls, mode, spec_file=None):
        overrides = None
        if spec_file:
            with open(spec_file) as f:
                overrides = json.load(f)
        return cls(mode, overrides)

    def as_dict(self):
        return {k: getattr(self, k) for k in self.FIELDS}


# ---------------------------------------------------------------------------
# the orchestrator
# ---------------------------------------------------------------------------

class Region(object):
    """Bring-up, supervision, chaos, observation, and drain for one
    region.  Single-threaded control flow plus three service threads
    (fleet poller, storm scheduler, stats HTTP server) and the client
    pool; all shared counters sit behind one lock."""

    MODEL = "mlp"
    FEATS = 3 * 8 * 8

    def __init__(self, spec, run_dir, res, stats_port=0, context="gpu(0)"):
        self.spec = spec
        self.run_dir = run_dir
        self.res = res
        self.stats_port = stats_port
        self.context = context
        self.ckpt_dir = os.path.join(run_dir, "ckpt")
        self.fleet_dir = os.path.join(run_dir, "fleet")
        self.status_file = os.path.join(run_dir, "trainer-status.json")
        self.cmd_file = os.path.join(run_dir, "trainer-commands")
        self.rec = os.path.join(run_dir, "region.rec")
        self.idx = os.path.join(run_dir, "region.idx")
        self.schedule = res.parse_fault_schedule(spec.schedule)
        self.sups = {}
        self._lock = threading.Lock()
        self._events = {}
        self._clients = {"requests": 0, "ok": 0, "retried": 0,
                         "dropped": 0, "retries": 0}
        self._world = spec.devices
        self._data_addrs = [None] * spec.data_servers
        self._fleet_port = None
        self._fleet_stats = {}
        self._counters = {}       # monotonic sources already credited
        self._recon = {"pid": None, "base": 0, "last": 0}
        self._first_served = None
        self._storm_fired = 0
        self._storm_t0 = None
        self._stop = threading.Event()
        self._threads = []
        self._logs = []
        self._httpd = None
        self.stats_addr = None

    # -- named events ------------------------------------------------------
    def _count(self, name, n=1):
        with self._lock:
            self._events[name] = self._events.get(name, 0) + n

    def _credit(self, name, value):
        """Turn a monotonic source counter (rollout.rejected, replica
        restarts, ...) into a named event by crediting only the delta."""
        with self._lock:
            seen = self._counters.get(name, 0)
            if value > seen:
                self._events[name] = self._events.get(name, 0) \
                    + (value - seen)
                self._counters[name] = value

    def _on_exit(self, role, rc, relaunching):
        self._count("exit:%s:rc=%s" % (role, rc))
        if not relaunching and not self._stop.is_set():
            _log("%s exited rc=%s (not relaunching)" % (role, rc))

    # -- helpers -----------------------------------------------------------
    def _logfile(self, name):
        f = open(os.path.join(self.run_dir, name + ".log"), "ab")
        self._logs.append(f)
        return f

    def _tail(self, name, n=2000):
        path = os.path.join(self.run_dir, name + ".log")
        try:
            with open(path, "rb") as f:
                return f.read()[-n:].decode("utf-8", "replace")
        except OSError:
            return "<no %s.log>" % name

    def _wait(self, cond, timeout, what):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            value = cond()
            if value:
                return value
            time.sleep(0.1)
        snaps = {r: s.snapshot() for r, s in self.sups.items()}
        raise RuntimeError(
            "region: timed out waiting for %s\nroles: %s\n"
            "trainer log tail:\n%s\nfleet log tail:\n%s"
            % (what, json.dumps(snaps), self._tail("trainer"),
               self._tail("fleet")))

    def _read_port_file(self, path):
        try:
            with open(path) as f:
                txt = f.read().strip()
            return txt or None
        except OSError:
            return None

    def _base_env(self, arm=()):
        return self.res.region_faults_env(os.environ, arm=arm)

    def _device_sets(self):
        """The fleet's ``--device-sets`` for the region's context: every
        replica on card N for ``gpu(N)`` (co-tenants), else the host."""
        m = re.fullmatch(r"\s*gpu\s*(?:\(\s*(\d+)\s*\))?\s*",
                         self.context)
        return "cuda:%s" % (m.group(1) or "0") if m else "cpu"

    # -- bring-up ----------------------------------------------------------
    def up(self):
        os.makedirs(self.ckpt_dir, exist_ok=True)
        os.makedirs(self.fleet_dir, exist_ok=True)
        open(self.cmd_file, "w").close()
        self._build_dataset()
        self._start_data_servers()
        self._start_trainer()
        self._wait_first_publish()
        self._start_fleet()
        self._start_stats_server()
        self._start_poller()
        self._start_clients()
        self._open()
        _log("region is up: %d data server(s), trainer(world=%d), "
             "%d replica(s), %d client(s); stats at http://%s/region/stats"
             % (self.spec.data_servers, self._world, self.spec.replicas,
                self.spec.clients, self.stats_addr))

    def _build_dataset(self):
        res = subprocess.run(
            [sys.executable, os.path.join(_HERE, "dataset_main.py"),
             self.rec, self.idx, str(self.spec.records)],
            env=self._base_env(), capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("dataset build failed:\n%s" % res.stderr)
        _log("dataset: %d records at %s" % (self.spec.records, self.rec))

    def _start_data_servers(self):
        for i in range(self.spec.data_servers):
            role = "data#%d" % i
            port_file = os.path.join(self.run_dir, "data-%d.port" % i)

            def command(restarts, i=i, port_file=port_file):
                # first spawn takes an ephemeral port; respawns PIN the
                # recorded one so the trainer's reconnect machinery
                # redials the same well-known address
                port = "0"
                if restarts > 0 and self._data_addrs[i]:
                    port = self._data_addrs[i].rsplit(":", 1)[1]
                return [sys.executable, SERVER_MAIN,
                        "--port", port, "--port-file", port_file]

            def env(restarts, role=role):
                arm = self.spec.faults.get(role, "") if restarts == 0 \
                    else ""
                return self._base_env(arm=arm)

            sup = Supervisor(role, command, env=env, retry_any=True,
                             max_restarts=8, backoff=0.3, log=_log,
                             on_exit=self._on_exit,
                             stdout=self._logfile(role.replace("#", "-")),
                             stderr=subprocess.STDOUT)
            with self._lock:
                self.sups[role] = sup.start()
            addr = self._wait(
                lambda pf=port_file: self._read_port_file(pf),
                60, "%s port file" % role)
            self._data_addrs[i] = addr
            _log("%s listening at %s" % (role, addr))

    def _start_trainer(self):
        def env(restarts):
            arm = self.spec.faults.get("trainer", "") if restarts == 0 \
                else ""
            e = self._base_env(arm=arm)
            e.update({
                "REGION_WORLD": str(self._world),
                "REGION_CONTEXT": self.context,
                "REGION_CKPT_DIR": self.ckpt_dir,
                "REGION_STATUS_FILE": self.status_file,
                "REGION_CMD_FILE": self.cmd_file,
                "REGION_DATA_SERVERS": ",".join(self._data_addrs),
                "REGION_REC": self.rec,
                "REGION_IDX": self.idx,
                "REGION_EPOCHS": str(self.spec.epochs),
                "REGION_EPOCH_GAP_S": str(self.spec.epoch_gap_s),
                "REGION_BATCH": str(self.spec.batch),
                # the region trainer publishes sharded-native: every
                # zero3 shard its own verified blob, so the storm's
                # ``rot shard#k`` events have blobs to damage and the
                # resize event proves elastic resume FROM shard blobs
                "MXTPU_CKPT_SHARDED": "1",
                # a dead data host must be noticed in seconds, not the
                # production default 30
                "MXTPU_DATA_NET_TIMEOUT_S": "3",
                "MXTPU_DATA_NET_RECONNECT_S": "0.3",
                "MXTPU_DATA_NET_RETRIES": "60",
            })
            return e

        sup = Supervisor("trainer", [sys.executable, TRAINER_MAIN], env=env,
                         retry_any=True, max_restarts=8, backoff=0.5,
                         log=_log, on_exit=self._on_exit,
                         stdout=self._logfile("trainer"),
                         stderr=subprocess.STDOUT)
        with self._lock:
            self.sups["trainer"] = sup.start()

    def _wait_first_publish(self):
        def published():
            epoch, problems = self.res.verify_promotion(self.ckpt_dir)
            return epoch if epoch and not problems else None

        epoch = self._wait(published, self.spec.bringup_timeout_s,
                           "first verified checkpoint publish")
        _log("trainer published verified epoch %d" % epoch)

    def _start_fleet(self):
        port_file = os.path.join(self.run_dir, "fleet.port")
        command = [
            sys.executable, FLEET_MAIN, "serve",
            "--model", "%s=%s" % (self.MODEL, self.ckpt_dir),
            "--input-shape", "%s:data=%d" % (self.MODEL, self.FEATS),
            "--replicas", str(self.spec.replicas),
            "--workers", str(self.spec.router_workers),
            "--device-sets", self._device_sets(), "--buckets", "1,2,4",
            "--run-dir", self.fleet_dir, "--port", "0",
            "--port-file", port_file, "--max-restarts", "6", "--watch",
        ]

        def env(restarts):
            e = self._base_env(arm=self.spec.faults.get("fleet", "")
                               if restarts == 0 else "")
            e.update({"MXTPU_FLEET_HEARTBEAT_S": "0.3",
                      "MXTPU_FLEET_EVICT_S": "1.5",
                      "MXTPU_SERVE_MAX_WAIT_MS": "1",
                      "MXTPU_SWAP_POLL_S": "0.2"})
            return e

        # the fleet is its own supervisor for its replicas; the region
        # does not relaunch the router (a dead router is a failed drill)
        sup = Supervisor("fleet", command, env=env, retry_any=False,
                         max_restarts=0, log=_log, on_exit=self._on_exit,
                         stdout=self._logfile("fleet"),
                         stderr=subprocess.STDOUT)
        with self._lock:
            self.sups["fleet"] = sup.start()
        port = self._wait(lambda: self._read_port_file(port_file),
                          self.spec.bringup_timeout_s, "fleet port file")
        self._fleet_port = int(port.rsplit(":", 1)[1]) if ":" in port \
            else int(port)
        _log("fleet router on port %d" % self._fleet_port)

    # -- observation -------------------------------------------------------
    def _http_json(self, port, path, timeout=10):
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                return None
            return json.loads(body.decode("utf-8"))
        except (OSError, ValueError):
            return None
        finally:
            conn.close()

    def _trainer_status(self):
        try:
            with open(self.status_file) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _replica_epochs(self, stats=None):
        stats = self._fleet_stats if stats is None else stats
        out = {}
        for rid, entry in (stats.get("replicas") or {}).items():
            epoch = (entry.get("epochs") or {}).get(self.MODEL)
            if epoch is not None:
                out[rid] = epoch
        return out

    def _poll_once(self):
        if self._fleet_port is None:
            return
        stats = self._http_json(self._fleet_port, "/stats", timeout=5)
        if not stats:
            return
        self._fleet_stats = stats
        epochs = self._replica_epochs(stats)
        if self._first_served is None and \
                len(epochs) == self.spec.replicas:
            self._first_served = min(epochs.values())
        # monotonic sources -> counted named events
        rollout = (stats.get("rollout") or {})
        self._credit("publish_rejected", rollout.get("rejected", 0))
        self._credit("rollout_halted", rollout.get("halted", 0))
        self._credit("rollouts", rollout.get("rollouts", 0))
        for rid, entry in (stats.get("replicas") or {}).items():
            self._credit("replica_respawn:%s" % rid,
                         entry.get("restarts", 0) or 0)
        status = self._trainer_status()
        if status:
            self._reconnect_total(status)

    def _reconnect_total(self, status):
        """Accumulate data-plane reconnects across trainer generations
        (each respawned trainer restarts its iterator counters)."""
        pid, cur = status.get("pid"), status.get("reconnects", 0)
        r = self._recon
        with self._lock:
            if r["pid"] is None:
                r["pid"] = pid
            if pid != r["pid"]:
                r["base"] += r["last"]
                r["pid"], r["last"] = pid, 0
            if cur > r["last"]:
                self._events["data_reconnect"] = \
                    self._events.get("data_reconnect", 0) \
                    + (cur - r["last"])
                r["last"] = cur
            return r["base"] + r["last"]

    def _start_poller(self):
        def loop():
            while not self._stop.is_set():
                try:
                    self._poll_once()
                except Exception as e:  # noqa: BLE001 — observer must
                    _log("poll error: %r" % e)       # outlive any seam
                self._stop.wait(0.4)

        t = threading.Thread(target=loop, name="region-poll", daemon=True)
        t.start()
        self._threads.append(t)
        self._wait(lambda: self._replica_epochs() or None,
                   self.spec.bringup_timeout_s,
                   "replicas to serve the first epoch")

    # -- the stats endpoint ------------------------------------------------
    def stats_payload(self):
        with self._lock:
            events = dict(self._events)
            clients = dict(self._clients)
            recon = self._recon["base"] + self._recon["last"]
        fleet = self._fleet_stats or {}
        rollout = fleet.get("rollout") or {}
        status = self._trainer_status()
        epoch, problems = self.res.verify_promotion(self.ckpt_dir)
        published = epoch if epoch and not problems else None
        epochs = self._replica_epochs(fleet)
        return {
            "roles": {r: s.snapshot() for r, s in self.sups.items()},
            "trainer": {"epoch": status.get("epoch"),
                        "world": status.get("world"),
                        "batches": status.get("batches")},
            "published_epoch": published,
            "served_epochs": epochs,
            "first_served_epoch": self._first_served,
            "data_reconnects": recon,
            "freshness_ms": (fleet.get("fleet") or {}).get("freshness_ms"),
            "fleet": {
                "healthy": (fleet.get("fleet") or {}).get(
                    "replicas_healthy"),
                "freshness_ms": (fleet.get("fleet")
                                 or {}).get("freshness_ms"),
                "rollout": {k: rollout.get(k) for k in
                            ("polls", "rollouts", "rejected", "halted")},
            },
            "clients": clients,
            "events": events,
            "storm": {"scheduled": len(self.schedule),
                      "fired": self._storm_fired,
                      "labels": [e.label for e in self.schedule],
                      "window_s": None if self._storm_t0 is None else
                      round(time.monotonic() - self._storm_t0, 1)},
        }

    def _start_stats_server(self):
        region = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.startswith("/region/stats"):
                    body = json.dumps(region.stats_payload(),
                                      sort_keys=True).encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.stats_port),
                                          Handler)
        self._httpd.daemon_threads = True
        t = threading.Thread(target=self._httpd.serve_forever,
                             name="region-stats", daemon=True)
        t.start()
        self._threads.append(t)
        self.stats_addr = "127.0.0.1:%d" % self._httpd.server_address[1]
        with open(os.path.join(self.run_dir, "region.port"), "w") as f:
            f.write(self.stats_addr)

    # -- clients -----------------------------------------------------------
    def _start_clients(self):
        body = json.dumps(
            {"inputs": {"data": [0.5] * self.FEATS}}).encode("utf-8")
        headers = {"Content-Type": "application/json"}

        def one_request():
            with self._lock:
                self._clients["requests"] += 1
            retried = False
            for _attempt in range(40):
                if self._stop.is_set() and _attempt > 0:
                    break
                try:
                    conn = http.client.HTTPConnection(
                        "127.0.0.1", self._fleet_port, timeout=60)
                    conn.request("POST", "/predict/%s" % self.MODEL,
                                 body=body, headers=headers)
                    resp = conn.getresponse()
                    resp.read()
                    code = resp.status
                    conn.close()
                except OSError as e:
                    self._count("client_drop:%s" % type(e).__name__)
                    break
                if code == 200:
                    with self._lock:
                        self._clients["ok"] += 1
                        if retried:
                            self._clients["retried"] += 1
                    return
                if code in (502, 503):
                    # with the exactly-once layer the ROUTER absorbs a
                    # dead replica (one keyed resend elsewhere), so no
                    # storm should ever produce a client_retry:502 —
                    # that event means the fleet leaked a dead-replica
                    # failure to its clients (the no_502_leak check).
                    # 503 retries are different: a kill overlapping a
                    # rolling swap's fence on a small fleet leaves a
                    # legitimate no-routable-replica window, and this
                    # loop is the backstop that rides it out
                    retried = True
                    with self._lock:
                        self._clients["retries"] += 1
                    self._count("client_retry:%d" % code)
                    time.sleep(0.15)
                    continue
                self._count("client_drop:http%d" % code)
                break
            with self._lock:
                self._clients["dropped"] += 1

        def loop():
            while not self._stop.is_set():
                one_request()
                self._stop.wait(self.spec.client_pause_s)

        for i in range(self.spec.clients):
            t = threading.Thread(target=loop, name="region-client-%d" % i,
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _open(self):
        """Open the drill: once every replica serves the first publish
        and the clients run, append ``go`` to the trainer's command file.
        The trainer holds after its first publish until then, so the
        storm window opens with the trainer's remaining epochs all ahead
        of it and every scheduled arm or rot lands on a live publish
        (the JAX package's smoke could open its window after the
        trainer's last command poll)."""
        self._wait(lambda: self._first_served is not None,
                   self.spec.bringup_timeout_s,
                   "every replica to serve the first epoch")
        with open(self.cmd_file, "a") as f:
            f.write("go\n")
        _log("trainer released (go) at served epoch %d"
             % self._first_served)

    # -- STORM -------------------------------------------------------------
    def storm(self):
        """Run the fault schedule (threaded), then settle the region:
        trainer to its final epoch, every replica serving it."""
        storm_thread = None
        if self.schedule:
            storm_thread = threading.Thread(target=self._run_schedule,
                                            name="region-storm",
                                            daemon=True)
            storm_thread.start()
        self._settle(storm_thread)

    def _run_schedule(self):
        self._storm_t0 = time.monotonic()
        _log("STORM window opens: %d scheduled event(s)"
             % len(self.schedule))
        for ev in self.schedule:
            wait = ev.at_s - (time.monotonic() - self._storm_t0)
            if wait > 0 and self._stop.wait(wait):
                return
            try:
                self._fire(ev)
                self._count(ev.label)
                with self._lock:
                    self._storm_fired += 1
                _log("STORM fired %s (t=%.1fs)"
                     % (ev.label,
                        time.monotonic() - self._storm_t0))
            except Exception as e:  # noqa: BLE001 — a missed event is a
                self._count(ev.label + ":missed")    # counted failure,
                _log("STORM event %s failed: %r" % (ev.label, e))

    def _fire(self, ev):
        if ev.action == "kill" and ev.target.startswith("data#"):
            pid = self.sups[ev.target].kill()
            if pid is None:
                raise RuntimeError("%s had no live child" % ev.target)
        elif ev.action == "kill" and ev.target.startswith("replica#"):
            rid = ev.target.split("#", 1)[1]
            pid = None
            deadline = time.monotonic() + 5
            while pid is None and time.monotonic() < deadline:
                entry = (self._fleet_stats.get("replicas")
                         or {}).get(rid) or {}
                pid = entry.get("pid")
                if pid is None:
                    time.sleep(0.2)
            if pid is None:
                raise RuntimeError("no pid for %s in fleet stats"
                                   % ev.target)
            os.kill(pid, signal.SIGKILL)
        elif ev.action == "resize" and ev.target == "trainer":
            # the elastic story: SIGKILL + respawn at a different world
            # size; env_fn reads self._world on the respawn, and
            # MXTPU_RESUME=1 makes it a checkpoint resume
            self._world = int(ev.arg)
            if self.sups["trainer"].kill() is None:
                raise RuntimeError("trainer had no live child to resize")
        elif ev.action == "arm":
            if ev.target != "trainer":
                raise RuntimeError("arm targets the trainer (got %r)"
                                   % ev.target)
            with open(self.cmd_file, "a") as f:
                f.write("arm %s\n" % ev.arg)
        elif ev.action == "rot":
            # sugar over arm: ``rot trainer shard#k`` arms rot_shard so
            # the k-th post-publish consume (index order) damages
            # exactly blob k of the next sharded publish
            if ev.target != "trainer":
                raise RuntimeError("rot targets the trainer (got %r)"
                                   % ev.target)
            k = int(ev.arg.split("#", 1)[1])
            with open(self.cmd_file, "a") as f:
                f.write("arm rot_shard:1@%d\n" % k)
        else:
            raise RuntimeError("unhandled event %r" % ev)

    def _settle(self, storm_thread):
        deadline = self.spec.settle_timeout_s

        def storm_done():
            return storm_thread is None or not storm_thread.is_alive()

        self._wait(storm_done, deadline, "storm schedule to finish")

        def trainer_done():
            return self.sups["trainer"].state == "done" and \
                self._trainer_status().get("epoch") == self.spec.epochs

        self._wait(trainer_done, deadline,
                   "trainer to reach epoch %d" % self.spec.epochs)

        def converged():
            epochs = self._replica_epochs()
            return len(epochs) == self.spec.replicas and \
                set(epochs.values()) == {self.spec.epochs}

        self._wait(converged, deadline,
                   "every replica to serve epoch %d" % self.spec.epochs)
        _log("settled: all %d replica(s) serve epoch %d"
             % (self.spec.replicas, self.spec.epochs))

    # -- acceptance --------------------------------------------------------
    def checks(self):
        with self._lock:
            events = dict(self._events)
            clients = dict(self._clients)
        epochs = self._replica_epochs()
        final = min(epochs.values()) if epochs else None
        _epoch, problems = self.res.verify_promotion(
            self.ckpt_dir, epoch=final) if final else (None, ["unserved"])
        drops = clients["dropped"] + sum(
            n for name, n in events.items()
            if name.startswith("client_drop:"))
        out = {
            "drop_free": drops == 0 and clients["requests"] > 0,
            # the exactly-once contract's client-visible face: the
            # router absorbs dead replicas by keyed resend, so no
            # client ever retried a 502.  (503 no-routable windows —
            # a kill overlapping a rolling swap's fence on a small
            # fleet — stay the backstop loop's business and are not a
            # leak.)
            "no_502_leak": events.get("client_retry:502", 0) == 0,
            "storm_fired": self._storm_fired == len(self.schedule),
            "events_counted": all(ev.label in events
                                  for ev in self.schedule),
            "served_epoch_advance": final is not None and
            self._first_served is not None and final > self._first_served,
            "served_epoch_verified": not problems,
            "trainer_completed":
                self.sups["trainer"].state == "done",
        }
        if any((ev.action == "arm" and "rot" in (ev.arg or ""))
               or ev.action == "rot" for ev in self.schedule):
            out["rot_publish_rejected"] = \
                events.get("publish_rejected", 0) >= 1
        return out

    def report(self, elapsed_s):
        checks = self.checks()
        with self._lock:
            client_retries = self._clients["retries"]
        return {"mode": self.spec.mode, "ok": all(checks.values()),
                "elapsed_s": round(elapsed_s, 1), "checks": checks,
                # total backstop retries, 503 churn windows included —
                # the exactly-once signal itself is the no_502_leak
                # check (zero client_retry:502 events)
                "client_retries": client_retries,
                "spec": self.spec.as_dict(),
                "stats": self.stats_payload()}

    # -- drain -------------------------------------------------------------
    def down(self):
        self._stop.set()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=10)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        rcs = {}
        with self._lock:
            fleet_sup = self.sups.get("fleet")
            trainer_sup = self.sups.get("trainer")
            data_sups = [(role, sup) for role, sup in self.sups.items()
                         if role.startswith("data#")]
        if fleet_sup is not None:
            rcs["fleet"] = fleet_sup.drain(timeout=90)
        if trainer_sup is not None:
            rcs["trainer"] = trainer_sup.drain(timeout=30)
        for role, sup in data_sups:
            rcs[role] = sup.drain(timeout=15)
        for f in self._logs:
            try:
                f.close()
            except OSError:
                pass
        _log("drained: %s" % json.dumps(rcs, sort_keys=True))
        return rcs


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    parser = argparse.ArgumentParser(
        description="the composed region drill on the port")
    parser.add_argument("mode", choices=("run", "smoke", "storm"),
                        help="run: no chaos; smoke: 1x1 rot-only "
                             "(~a minute); storm: the full drill")
    parser.add_argument("--spec", default=None,
                        help="JSON file overriding RegionSpec fields")
    parser.add_argument("--run-dir", default=None,
                        help="working directory (default: a temp dir, "
                             "removed on success)")
    parser.add_argument("--stats-port", type=int, default=0,
                        help="/region/stats port (default ephemeral; "
                             "written to <run-dir>/region.port)")
    parser.add_argument("--report", default=None,
                        help="also write the JSON report here")
    parser.add_argument("--keep", action="store_true",
                        help="keep the run dir even on success")
    parser.add_argument("--context", default="gpu(0)",
                        help="the trainer's context and the replicas' "
                             "device: gpu(N) (every replica co-tenant on "
                             "card N) or cpu (default gpu(0))")
    args = parser.parse_args(argv)
    if not re.fullmatch(r"\s*(cpu|gpu)\s*(\(\s*\d+\s*\))?\s*",
                        args.context):
        parser.error("--context: want gpu(N) or cpu, got %r"
                     % args.context)

    res = resilience
    spec = RegionSpec.for_mode(args.mode, args.spec)
    run_dir = args.run_dir or tempfile.mkdtemp(prefix="mxregion-")
    os.makedirs(run_dir, exist_ok=True)
    keep = args.keep or args.run_dir is not None
    region = Region(spec, run_dir, res, stats_port=args.stats_port,
                    context=args.context)
    t0 = time.monotonic()
    report = None
    try:
        region.up()
        region.storm()
        report = region.report(time.monotonic() - t0)
    finally:
        try:
            region.down()
        except Exception as e:  # noqa: BLE001 — drain best-effort on a
            _log("drain error: %r" % e)           # failed bring-up
    print("REGION_REPORT " + json.dumps(report, sort_keys=True))
    for name, ok in sorted(report["checks"].items()):
        _log("check %-24s %s" % (name, "PASS" if ok else "FAIL"))
    stats = report["stats"]
    _log("clients: %s" % json.dumps(stats["clients"], sort_keys=True))
    _log("events:  %s" % json.dumps(stats["events"], sort_keys=True))
    _log("freshness_ms=%s served=%s->%s"
         % (stats["freshness_ms"], stats["first_served_epoch"],
            stats["served_epochs"]))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    if report["ok"] and not keep:
        shutil.rmtree(run_dir, ignore_errors=True)
    elif not report["ok"]:
        _log("run dir kept for post-mortem: %s" % run_dir)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
