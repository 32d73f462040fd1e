"""A real fleet of the port on the CPU: ``fleet_main.py serve
--device-sets cpu`` with two port daemons as replicas, serving an MLP (a
``save_checkpoint`` pair) and a small conv net (a ``CheckpointManager``
directory), both written by the JAX package, with JAX unimportable in
every fleet process.

- answers through the router equal the port's local ``Predictor`` bit
  for bit, and the JAX package's ``Predictor`` within rtol 1e-5 /
  atol 1e-6; the same bytes sent straight to each replica come back
  bit-equal;
- SIGKILL of the home replica under two client threads: every answer
  200 (the in-flight ones ``retried: true``), eviction within the
  heartbeat + eviction window (plus 2 s of polling slack), the
  controller's respawn rejoins and ``replicas_healthy`` is 2 again;
- ``MXTPU_FAULTS=dup_request:1``: the router re-delivers the first
  request once (``dup_requests`` 1) and the replica's dedup cache
  collapses it (``completed`` 1, one dedup hit or join);
- SIGTERM with requests in flight: they are answered, the router and
  every replica exit 0.

Each test runs against its own deadline (``DRILL_S``): every wait draws
on it and every process is killed on the way out.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.serving import ServeClient

from test_torch_serving import (conv_sym, j_nd, mlp_sym, np_params,
                                ref_predictor, t_sym)

pytestmark = pytest.mark.serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_MAIN = os.path.join(REPO, "mxnet_tpu_torch", "fleet", "fleet_main.py")
CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-6)
HEARTBEAT_S, EVICT_S = 0.3, 1.2
DRILL_S = 180.0         # the longest one test may take
SAMPLES = {"mlp": (32,), "conv": (3, 8, 8)}
BURSTS = 3              # rounds of 32 new connections at once


class Deadline(object):
    def __init__(self, seconds):
        self.end = time.monotonic() + seconds

    def left(self):
        left = self.end - time.monotonic()
        assert left > 0, "the drill ran out of time"
        return left

    def wait(self, pred, what):
        while not pred():
            assert time.monotonic() < self.end, "timed out: %s" % what
            time.sleep(0.05)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The JAX package writes both checkpoints; returns {model: (jax
    symbol, numpy args, numpy auxs, target)}."""
    from mxnet_tpu.model import save_checkpoint
    from mxnet_tpu.resilience import CheckpointManager as JMan
    tmp = tmp_path_factory.mktemp("fleet_models")
    out = {}
    sym = mlp_sym()
    args, auxs = np_params(sym, (1,) + SAMPLES["mlp"], seed=11)
    save_checkpoint(str(tmp / "mlp"), 1, sym, j_nd(args), j_nd(auxs),
                    blocking=True)
    out["mlp"] = (sym, args, auxs, "%s:1" % (tmp / "mlp"))
    sym = conv_sym()
    args, auxs = np_params(sym, (1,) + SAMPLES["conv"], seed=12)
    JMan(str(tmp / "conv")).save(1, symbol=sym, arg_params=j_nd(args),
                                 aux_params=j_nd(auxs))
    out["conv"] = (sym, args, auxs, str(tmp / "conv"))
    return out


class Fleet(object):
    """One ``fleet_main.py serve`` process (2 replicas, cpu), killed with
    its replicas on close if still alive."""

    def __init__(self, tmp_path, models, deadline, env_extra=None):
        poison = tmp_path / "poison" / "jax"
        poison.mkdir(parents=True)
        (poison / "__init__.py").write_text(
            "raise ImportError('a fleet process imported jax')\n")
        self.run_dir = str(tmp_path / "run")
        self.port_file = str(tmp_path / "fleet.port")
        env = dict(os.environ)
        for k in ("MXTPU_FAULTS", "MXTPU_RESUME", "MXTPU_COMPILE_CACHE",
                  "MXTPU_STEP_TIMEOUT", "CUDA_VISIBLE_DEVICES"):
            env.pop(k, None)
        env.update(PYTHONPATH=str(tmp_path / "poison"),
                   MXTPU_FLEET_HEARTBEAT_S=str(HEARTBEAT_S),
                   MXTPU_FLEET_EVICT_S=str(EVICT_S),
                   MXTPU_SERVE_MAX_WAIT_MS="1")
        env.update(env_extra or {})
        cmd = [sys.executable, FLEET_MAIN, "serve", "--replicas", "2",
               "--device-sets", "cpu", "--buckets", "1,2,4",
               "--run-dir", self.run_dir, "--port", "0",
               "--port-file", self.port_file]
        for name, (_, _, _, target) in sorted(models.items()):
            cmd += ["--model", "%s=%s" % (name, target), "--input-shape",
                    "%s:data=%s" % (name, ",".join(map(str,
                                                       SAMPLES[name])))]
        self.err_path = str(tmp_path / "fleet.err")
        with open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(cmd, env=env, cwd=str(tmp_path),
                                         stdout=subprocess.DEVNULL,
                                         stderr=err)
        self.deadline = deadline
        deadline.wait(lambda: os.path.exists(self.port_file)
                      or self.proc.poll() is not None, "the fleet's port")
        assert self.proc.poll() is None, self.stderr()
        self.port = int(open(self.port_file).read().split(":")[1])

    def stderr(self):
        with open(self.err_path) as f:
            return f.read()

    def replica_port(self, rid):
        with open(os.path.join(self.run_dir, "replica-%d.port" % rid)) as f:
            return int(f.read().split(":")[1])

    def replica_log(self, rid):
        with open(os.path.join(self.run_dir, "replica-%d.log" % rid)) as f:
            return f.read()

    def client(self, port=None):
        return ServeClient("127.0.0.1", port or self.port, timeout=30)

    def stats(self, port=None):
        cli = self.client(port)
        try:
            status, payload = cli.stats()
        finally:
            cli.close()
        assert status == 200, payload
        return payload

    def term(self):
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=self.deadline.left())
        return rc, self.stderr()

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        # replicas outlive a SIGKILLed fleet process: kill them too (each
        # one's command line names its port file under the run dir)
        subprocess.run(["pkill", "-KILL", "-f", self.run_dir],
                       capture_output=True, timeout=30)


def _ask(cli, model, x):
    status, payload = cli.predict(model, x, npy=True)
    assert status == 200, payload
    return np.asarray(payload["outputs"][0], dtype=np.float32)


def _jax_predict(sym, args, auxs, x):
    blob = {"arg:%s" % k: v for k, v in j_nd(args).items()}
    blob.update({"aux:%s" % k: v for k, v in j_nd(auxs).items()})
    pred = jmx.predict.Predictor(sym, blob, {"data": x.shape})
    return np.asarray(pred.forward(data=x).get_output(0))


def test_fleet_answers_equal_predictor_and_jax(tmp_path, models):
    deadline = Deadline(DRILL_S)
    fleet = Fleet(tmp_path, models, deadline)
    try:
        rs = np.random.RandomState(5)
        for name in sorted(models):
            sym, args, auxs, _ = models[name]
            x = rs.standard_normal(SAMPLES[name]).astype("f")
            cli = fleet.client()
            routed = _ask(cli, name, x)
            cli.close()
            ref = ref_predictor(t_sym(sym), args, auxs, (1,) + x.shape)
            local = ref.forward(data=x[None]).get_output(0)[0]
            assert np.array_equal(routed, local), name
            np.testing.assert_allclose(
                routed, _jax_predict(sym, args, auxs, x[None])[0], **TOL)
            direct = []
            for rid in (0, 1):
                cli = fleet.client(fleet.replica_port(rid))
                direct.append(_ask(cli, name, x))
                cli.close()
            assert np.array_equal(direct[0], direct[1]), name
            assert np.array_equal(direct[0], routed), name
        rc, err = fleet.term()
    finally:
        fleet.close()
    assert rc == 0, err[-3000:]
    assert "replica exit codes {0: 0, 1: 0}" in err


def test_fleet_sigkill_home_replica_every_answer_200(tmp_path, models):
    deadline = Deadline(DRILL_S)
    fleet = Fleet(tmp_path, models, deadline)
    results, errors = [], []
    stop = threading.Event()

    def traffic(i):
        cli = fleet.client()
        x = np.full(SAMPLES["mlp"], 0.1 * i, "f")
        try:
            while not stop.is_set():
                try:
                    results.append(cli.predict("mlp", x, npy=True))
                except Exception as e:  # noqa: BLE001 — a dropped answer
                    errors.append(repr(e))
                time.sleep(0.01)
        finally:
            cli.close()

    threads = [threading.Thread(target=traffic, args=(i,))
               for i in range(2)]
    try:
        home = tmx.fleet.FleetManifest(
            {n: models[n][3] for n in models}, replicas=2).home("mlp")
        for t in threads:
            t.start()
        deadline.wait(lambda: len(results) >= 20, "baseline traffic")
        victim = fleet.stats()["replicas"][str(home)]["pid"]
        assert victim
        cli = fleet.client()
        t_kill = time.monotonic()
        os.kill(victim, signal.SIGKILL)
        deadline.wait(lambda: cli.healthz()[1]["replicas_healthy"] == 1,
                      "eviction")
        evicted_s = time.monotonic() - t_kill
        base = len(results)
        deadline.wait(lambda: len(results) >= base + 20, "rerouted traffic")
        deadline.wait(lambda: cli.healthz()[1]["replicas_healthy"] == 2,
                      "the respawned replica's rejoin")
        stats = fleet.stats()
        assert stats["replicas"][str(home)]["restarts"] >= 1
        assert stats["replicas"][str(home)]["pid"] != victim
        base = len(results)
        deadline.wait(lambda: len(results) >= base + 10, "traffic after")
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        cli.close()
        counters = fleet.stats()["router"]["counters"]
        rc, err = fleet.term()
    finally:
        stop.set()
        fleet.close()
    assert not errors, errors[:3]
    statuses = sorted(set(s for s, _ in results))
    assert statuses == [200], statuses
    retried = sum(1 for s, p in results if p.get("retried") is True)
    assert retried >= 1, "the SIGKILL was never client-visible"
    assert counters.get("replica_errors", 0) == 0
    assert counters.get("retry_ok", 0) >= retried
    assert evicted_s <= HEARTBEAT_S + EVICT_S + 2.0, evicted_s
    assert rc == 0, err[-3000:]
    assert "replica exit codes {0: 0, 1: 0}" in err


def test_fleet_dup_request_collapsed_by_the_replica(tmp_path, models):
    deadline = Deadline(DRILL_S)
    fleet = Fleet(tmp_path, models, deadline,
                  env_extra={"MXTPU_FAULTS": "dup_request:1"})
    try:
        x = np.random.RandomState(6).standard_normal(
            SAMPLES["mlp"]).astype("f")
        cli = fleet.client()
        first = _ask(cli, "mlp", x)
        second = _ask(cli, "mlp", x)
        cli.close()
        assert np.array_equal(first, second)
        router = fleet.stats()["router"]["counters"]
        per = [fleet.stats(fleet.replica_port(rid))["counters"]
               for rid in (0, 1)]
        rc, err = fleet.term()
    finally:
        fleet.close()
    assert router["dup_requests"] == 1 and router["routed"] == 2
    assert sum(c.get("completed", 0) for c in per) == 2
    assert sum(c.get("dedup_hits", 0) + c.get("dedup_joined", 0)
               for c in per) == 1
    assert rc == 0, err[-3000:]


def test_fleet_sigterm_drains_router_and_every_replica(tmp_path, models):
    deadline = Deadline(DRILL_S)
    fleet = Fleet(tmp_path, models, deadline)
    answers = []

    def one(i):
        cli = fleet.client()
        try:
            answers.append(cli.predict("conv", np.full(SAMPLES["conv"],
                                                       0.01 * i, "f"),
                                       npy=True)[0])
        except Exception as e:  # noqa: BLE001 — recorded, asserted below
            answers.append(repr(e))
        finally:
            cli.close()

    try:
        cli = fleet.client()
        accepted = sum(fleet.stats(fleet.replica_port(r))["counters"]
                       .get("accepted", 0) for r in (0, 1))
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        deadline.wait(lambda: len(answers) == 4 or sum(
            fleet.stats(fleet.replica_port(r))["counters"]
            .get("accepted", 0) for r in (0, 1)) >= accepted + 4,
            "the requests in flight")
        cli.close()
        rc, err = fleet.term()
        for t in threads:
            t.join(timeout=30)
    finally:
        fleet.close()
    assert rc == 0, err[-3000:]
    assert answers == [200] * 4, answers
    assert "replica exit codes {0: 0, 1: 0}" in err
    for rid in (0, 1):
        log = fleet.replica_log(rid)
        assert "mxserve: drained — exiting 0" in log
        launches = json.loads(log.split("mxserve: launches ")[-1]
                              .splitlines()[0])
        assert set(launches.values()) == {0}    # plain versions on the CPU


#: runs serve_main.py and, once it listens, three threads that keep the
#: GIL busy, as a replica's handler and dispatcher threads do under load
BUSY_WRAPPER = """
import os, runpy, sys, threading, time
def spin():
    while not os.path.exists(%(port_file)r):
        time.sleep(0.05)
    while True:
        x = 0
        for i in range(100000):
            x += i
for _ in range(3):
    threading.Thread(target=spin, daemon=True).start()
sys.argv = [%(main)r] + sys.argv[1:]
runpy.run_path(%(main)r, run_name="__main__")
"""


def test_daemon_takes_a_burst_of_new_connections(tmp_path, models):
    """32 clients connecting at once, each with a 602,112-byte body (a
    ResNet-50 x-npy request), to a daemon whose accept loop waits for the
    GIL: every connection gets its HTTP answer (a 400 here: the body is
    not the model's shape), none is reset.  socketserver's listen backlog
    of 5 reset some of them; the daemon and the router listen with
    SOMAXCONN."""
    import http.client
    deadline = Deadline(DRILL_S)
    port_file = str(tmp_path / "port")
    wrapper = tmp_path / "busy_serve.py"
    wrapper.write_text(BUSY_WRAPPER % {"main": os.path.join(
        REPO, "mxnet_tpu_torch", "serving", "serve_main.py"),
        "port_file": port_file})
    env = dict(os.environ)
    for k in ("MXTPU_FAULTS", "MXTPU_RESUME", "MXTPU_COMPILE_CACHE"):
        env.pop(k, None)
    proc = subprocess.Popen(
        [sys.executable, str(wrapper), "--context", "cpu", "--model",
         "conv=%s" % models["conv"][3], "--port", "0", "--port-file",
         port_file], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    body = np.zeros((3, 224, 224), "f").tobytes()
    statuses, errors = [], []

    def one(port):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request("POST", "/predict/conv", body=body,
                         headers={"Content-Type": "application/x-npy"})
            statuses.append(conn.getresponse().status)
        except Exception as e:  # noqa: BLE001 — counted, asserted below
            errors.append(repr(e))
        finally:
            conn.close()

    try:
        deadline.wait(lambda: os.path.exists(port_file)
                      or proc.poll() is not None, "the daemon's port")
        assert proc.poll() is None
        port = int(open(port_file).read().split(":")[1])
        for _ in range(BURSTS):
            threads = [threading.Thread(target=one, args=(port,))
                       for _ in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=deadline.left())
    finally:
        proc.kill()
        proc.wait(timeout=30)
    assert not errors, (len(errors), errors[:2])
    assert statuses == [400] * (32 * BURSTS)
