"""The region drill on the port (``mxnet_tpu_torch/region/``) against the
JAX package's ``tools/region.py``, on the CPU.

- ``RegionSpec.as_dict()`` of every preset (and a ``--spec`` override)
  equals the JAX package's, whose file is loaded through its own
  ``_bootstrap`` stub in a process where jax is unimportable; the STORM
  and smoke schedules parse to the same ``FaultEvent`` s;
- ``Region.checks()`` and ``Region.stats_payload()`` of both packages on
  the same synthetic states, over a checkpoint directory the port wrote;
- the ``Supervisor`` copy: the exit-code policy equals
  ``tools/supervise.py``'s, a respawn carries ``MXTPU_RESUME=1``,
  ``kill`` respawns under ``retry_any`` and ``drain`` stops;
- in process, with no subprocess: the drill's MLP trainer
  (``trainer_main.build``) at world 1 and 2 against the JAX zero3
  trainer on 1 and 2 host devices from the same weights over the same
  batches, 3 steps, within rtol 1e-5 / atol 1e-6; a world-2
  sharded-native publish restored at world 4 bit-equal (params, momentum,
  update count); the world-1 whole-blob publish and then the world-2
  sharded one served bit-equal by a ``CheckpointWatcher``;
- ``region_main.py smoke --context cpu`` end to end (chaos, 300 s of its
  own), asserting what the JAX package's ``test_region_smoke_drill``
  asserts with ``rot_publish_rejected`` true, and the full ``storm``
  (slow, chaos), asserting what ``test_region_storm_drill`` asserts.
  Every drill process runs with jax unimportable.
"""
import http.client
import json
import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import jax

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch.region import region_main, supervisor, trainer_main
from mxnet_tpu_torch.serving import ModelPool
from mxnet_tpu_torch.serving.deploy import CheckpointWatcher

from test_torch_serving import ref_predictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGION_MAIN = os.path.join(REPO, "mxnet_tpu_torch", "region",
                           "region_main.py")
JAX_REGION = os.path.join(REPO, "tools", "region.py")
MODES = ("run", "smoke", "storm")
#: the port's trainer against the JAX package's after 3 steps
TOL = dict(rtol=1e-5, atol=1e-6)
BATCH = 8


# ---------------------------------------------------------------------------
# the spec and the schedule
# ---------------------------------------------------------------------------

_JAX_SPEC_SCRIPT = r"""
import importlib.util, json, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
spec = importlib.util.spec_from_file_location("jax_region", sys.argv[1])
region = importlib.util.module_from_spec(spec)
spec.loader.exec_module(region)
res = region._bootstrap()
out = {"specs": {m: region.RegionSpec(m).as_dict()
                 for m in ("run", "smoke", "storm")},
       "override": region.RegionSpec("storm", {"epochs": 4,
                                               "replicas": 3}).as_dict(),
       "fields": list(region.RegionSpec.FIELDS), "schedules": {}}
for m in ("smoke", "storm"):
    out["schedules"][m] = [
        [e.at_s, e.action, e.target, e.arg, e.label]
        for e in res.parse_fault_schedule(region.RegionSpec(m).schedule)]
assert not [k for k in sys.modules
            if k.split(".")[0] in ("jax", "torch")
            and sys.modules[k] is not None]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_region():
    """The JAX package's specs and parsed schedules, from a process where
    jax (and torch) never load."""
    proc = subprocess.run([sys.executable, "-c", _JAX_SPEC_SCRIPT,
                           JAX_REGION], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout)


@pytest.mark.parametrize("mode", MODES)
def test_region_spec_matches_jax(jax_region, mode):
    got = region_main.RegionSpec(mode).as_dict()
    assert got == jax_region["specs"][mode]
    assert list(region_main.RegionSpec.FIELDS) == jax_region["fields"]


def test_spec_overrides_match_jax(jax_region, tmp_path):
    got = region_main.RegionSpec("storm", {"epochs": 4, "replicas": 3})
    assert got.as_dict() == jax_region["override"]
    path = tmp_path / "spec.json"
    path.write_text(json.dumps({"epochs": 4, "replicas": 3}))
    assert region_main.RegionSpec.for_mode("storm", str(path)).as_dict() \
        == jax_region["override"]
    with pytest.raises(SystemExit, match="unknown region spec field"):
        region_main.RegionSpec("run", {"epoch": 3})


@pytest.mark.parametrize("mode", ("smoke", "storm"))
def test_schedules_parse_alike(jax_region, mode):
    events = tres.parse_fault_schedule(region_main.RegionSpec(mode).schedule)
    got = [[e.at_s, e.action, e.target, e.arg, e.label] for e in events]
    assert got == jax_region["schedules"][mode]
    assert region_main.STORM_SCHEDULE == _jax_module().STORM_SCHEDULE


def _jax_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location("jax_tools_region",
                                                  JAX_REGION)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# checks() and stats_payload() on synthetic states
# ---------------------------------------------------------------------------

class _Sup(object):
    def __init__(self, state, pid=None, restarts=0, last_rc=None):
        self.state = state
        self._snap = {"role": None, "state": state, "pid": pid,
                      "restarts": restarts, "last_rc": last_rc}

    def snapshot(self):
        return dict(self._snap)


def _ckpt(directory, epochs):
    """Verified whole-blob publishes of a tiny net, written by the port."""
    sym = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=2,
                                 name="fc")
    mgr = tres.CheckpointManager(directory, keep_last=None)
    for e in epochs:
        w = {"fc_weight": tmx.nd.array(np.full((2, 3), e, "f"),
                                       ctx=tmx.cpu()),
             "fc_bias": tmx.nd.array(np.zeros(2, "f"), ctx=tmx.cpu())}
        mgr.save(e, symbol=sym, arg_params=w, aux_params={}, blocking=True)


def _state(name):
    """(events, clients, fleet stats, first served, fired, trainer state,
    trainer status) of one synthetic region."""
    replicas = {"0": {"epochs": {"mlp": 16}, "pid": 11, "restarts": 0},
                "1": {"epochs": {"mlp": 16}, "pid": 12, "restarts": 1}}
    fleet = {"replicas": replicas,
             "rollout": {"polls": 40, "rollouts": 24, "rejected": 1,
                         "halted": 0},
             "fleet": {"replicas_healthy": 2, "freshness_ms": 150.0}}
    events = {"kill:data#0": 1, "resize:trainer": 1,
              "arm:trainer:rot_checkpoint": 1, "rot:trainer:shard#1": 1,
              "kill:replica#1": 1, "publish_rejected": 1}
    clients = {"requests": 100, "ok": 100, "retried": 0, "dropped": 0,
               "retries": 0}
    first, fired, trainer = 1, 5, "done"
    status = {"epoch": 16, "world": 4, "batches": 90, "pid": 9,
              "reconnects": 1}
    if name == "dropped":
        clients["dropped"] = 1
    elif name == "leak502":
        events["client_retry:502"] = 2
    elif name == "missed":
        del events["arm:trainer:rot_checkpoint"]
        fired = 4
    elif name == "unserved":
        fleet["replicas"] = {}
    elif name == "no_advance":
        first = 16
    elif name == "trainer_failed":
        trainer = "failed"
    elif name == "stale_epoch":
        for entry in replicas.values():
            entry["epochs"]["mlp"] = 17
    elif name == "no_rot":
        del events["publish_rejected"]
    return events, clients, fleet, first, fired, trainer, status


def _synthetic(pkg_region, res, tmp_path, name, mode):
    spec = pkg_region.RegionSpec(mode)
    run_dir = str(tmp_path)
    region = pkg_region.Region(spec, run_dir, res)
    events, clients, fleet, first, fired, trainer, status = _state(name)
    region._events = dict(events)
    region._clients = dict(clients)
    region._fleet_stats = json.loads(json.dumps(fleet))
    region._first_served = first
    region._storm_fired = fired if mode == "storm" else \
        len(region.schedule)
    region.sups = {"trainer": _Sup(trainer, restarts=1, last_rc=0),
                   "fleet": _Sup("running", pid=5)}
    with open(region.status_file, "w") as f:
        json.dump(status, f)
    return region


@pytest.mark.parametrize("name", ["good", "dropped", "leak502", "missed",
                                  "unserved", "no_advance",
                                  "trainer_failed", "stale_epoch",
                                  "no_rot"])
@pytest.mark.parametrize("mode", ["smoke", "storm"])
def test_checks_match_jax_on_synthetic_states(tmp_path, name, mode):
    import mxnet_tpu.resilience as jres
    jreg = _jax_module()
    ckpt = tmp_path / "port" / "ckpt"
    _ckpt(str(ckpt), (1, 16))
    (tmp_path / "jax").mkdir()
    os.symlink(str(ckpt), str(tmp_path / "jax" / "ckpt"))
    port = _synthetic(region_main, tres, tmp_path / "port", name, mode)
    ref = _synthetic(jreg, jres, tmp_path / "jax", name, mode)
    got, want = port.checks(), ref.checks()
    assert got == want
    if name == "good":
        assert all(got.values()), got
        assert got["rot_publish_rejected"]
    else:
        assert not all(got.values()), (name, got)
    assert port.stats_payload() == ref.stats_payload()


def test_reconnects_accumulate_across_trainer_generations(tmp_path):
    region = region_main.Region(region_main.RegionSpec("storm"),
                                str(tmp_path), tres)
    for pid, cur in ((1, 0), (1, 2), (2, 1), (2, 3), (3, 0)):
        total = region._reconnect_total({"pid": pid, "reconnects": cur})
    assert total == 5
    assert region._events["data_reconnect"] == 5


# ---------------------------------------------------------------------------
# the Supervisor copy
# ---------------------------------------------------------------------------

def test_relaunch_decision_matches_tools_supervise():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import supervise as jsup
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    assert supervisor.PREEMPT_EXIT_CODE == jsup.PREEMPT_EXIT_CODE == \
        tres.PREEMPT_EXIT_CODE
    assert supervisor.WATCHDOG_EXIT_CODE == jsup.WATCHDOG_EXIT_CODE == \
        tres.WATCHDOG_EXIT_CODE
    assert supervisor.RESUME_ENV == jsup.RESUME_ENV
    for rc in (0, 1, 85, 87, -9, 137):
        for restarts in (0, 2, 3):
            for retry_any in (False, True):
                assert supervisor.relaunch_decision(
                    rc, restarts, 3, retry_any) == \
                    jsup.relaunch_decision(rc, restarts, 3, retry_any)


def _wait(pred, seconds, what):
    end = time.monotonic() + seconds
    while not pred():
        assert time.monotonic() < end, "timed out: " + what
        time.sleep(0.02)


def test_supervisor_respawns_with_resume(tmp_path):
    """Exit 85, then a respawn that sees MXTPU_RESUME=1 and exits 0."""
    log = tmp_path / "runs"
    code = ("import os, sys\n"
            "open(%r, 'a').write(os.environ.get('MXTPU_RESUME', '-') "
            "+ '\\n')\n"
            "sys.exit(0 if os.environ.get('MXTPU_RESUME') == '1' "
            "else 85)\n" % str(log))
    exits = []
    env = dict(os.environ)
    env.pop("MXTPU_RESUME", None)
    sup = supervisor.Supervisor(
        "t", [sys.executable, "-c", code], env=env, backoff=0.05,
        on_exit=lambda role, rc, again: exits.append((role, rc, again)),
        log=lambda m: None).start()
    _wait(lambda: sup.state in ("done", "failed"), 60, "the respawn")
    assert sup.state == "done" and sup.restarts == 1 and sup.last_rc == 0
    assert log.read_text().split() == ["-", "1"]
    assert exits == [("t", 85, True), ("t", 0, False)]
    assert sup.snapshot() == {"role": "t", "state": "done", "pid": None,
                              "restarts": 1, "last_rc": 0}


def test_supervisor_kill_respawns_and_drain_stops(tmp_path):
    spawns = []

    def command(restarts):
        spawns.append(restarts)
        return [sys.executable, "-c", "import time; time.sleep(60)"]

    def env(restarts):
        e = dict(os.environ)
        e.pop("MXTPU_RESUME", None)
        e["ROLE_SPAWN"] = str(restarts)
        return e
    sup = supervisor.Supervisor("data#0", command, env=env,
                                retry_any=True, max_restarts=2,
                                backoff=0.05, log=lambda m: None).start()
    pid = sup.pid
    assert pid is not None and sup.state == "running"
    assert sup.kill() == pid
    _wait(lambda: sup.restarts == 1 and sup.pid not in (None, pid), 30,
          "the respawn after kill")
    assert spawns == [0, 1] and sup.state == "running"
    assert sup.drain(timeout=10) == -15
    assert sup.state == "stopped" and sup.pid is None
    assert sup.kill() is None
    # without retry_any a SIGKILL is not a preempt/watchdog code: failed
    sup = supervisor.Supervisor("fleet", command, env=env, max_restarts=2,
                                backoff=0.05, log=lambda m: None).start()
    sup.kill()
    _wait(lambda: sup.state == "failed", 30, "the propagated death")
    assert sup.restarts == 0 and sup.last_rc == -9


# ---------------------------------------------------------------------------
# the trainer in process against the JAX zero3 trainer
# ---------------------------------------------------------------------------

def _cfg(tmp_path, world):
    env = {"REGION_WORLD": str(world), "REGION_CONTEXT": "cpu",
           "REGION_BATCH": str(BATCH), "REGION_EPOCHS": "3",
           "REGION_EPOCH_GAP_S": "0", "REGION_STATUS_FILE":
           str(tmp_path / "status.json"),
           "REGION_CMD_FILE": str(tmp_path / "cmd"),
           "REGION_CKPT_DIR": str(tmp_path / "ckpt"),
           "REGION_DATA_SERVERS": "", "REGION_REC": "", "REGION_IDX": ""}
    return trainer_main.Config(env)


def _weights():
    rs = np.random.RandomState(21)
    return {"fc1_weight": rs.uniform(-0.2, 0.2, (32, 192)).astype("f"),
            "fc1_bias": rs.uniform(-0.1, 0.1, 32).astype("f"),
            "fc2_weight": rs.uniform(-0.2, 0.2, (7, 32)).astype("f"),
            "fc2_bias": rs.uniform(-0.1, 0.1, 7).astype("f")}


def _batches(n=3):
    rs = np.random.RandomState(4)
    return [(rs.uniform(0, 1, (BATCH, 192)).astype("f"),
             rs.randint(0, 7, BATCH).astype("f")) for _ in range(n)]


def _port_trainer(tmp_path, world, weights=None):
    tr = trainer_main.build(_cfg(tmp_path, world))
    if weights is not None:
        tr.set_params({k: tmx.nd.array(v, ctx=tmx.cpu())
                       for k, v in weights.items()}, {})
    return tr


def _jax_trainer(world, weights):
    data = jmx.sym.Variable("data")
    net = jmx.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = jmx.sym.Activation(net, act_type="relu")
    net = jmx.sym.FullyConnected(net, num_hidden=7, name="fc2")
    sym = jmx.sym.SoftmaxOutput(net, name="softmax")
    tr = jmx.parallel.SPMDTrainer(
        sym, "sgd", {"learning_rate": 0.05, "momentum": 0.9,
                     "rescale_grad": 1.0 / BATCH},
        mesh=jmx.parallel.local_mesh("dp", jax.devices()[:world]),
        grad_sync="zero3")
    tr.bind([("data", (BATCH, 192))], [("softmax_label", (BATCH,))])
    tr.init_params(None, arg_params={k: jmx.nd.array(v)
                                     for k, v in weights.items()})
    return tr


def _params(tr):
    arg, _aux = tr.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}


@pytest.mark.parametrize("world", [1, 2])
def test_drill_trainer_matches_jax_zero3(tmp_path, world):
    weights = _weights()
    tr = _port_trainer(tmp_path, world, weights)
    assert tr.grad_sync == "zero3" and tr._dp == world
    if world > 1:
        assert tr.zero3_tier == "manual"
    jtr = _jax_trainer(world, weights)
    for x, y in _batches():
        tr.step(x, y)
        jtr.step(x, y)
    got, want = _params(tr), _params(jtr)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    tr.close()
    jtr.close()


def test_publishes_restore_elastically_and_serve_bit_equal(tmp_path,
                                                           monkeypatch):
    """World 1 publishes epoch 1 whole-blob; world 2 (sharded-native)
    publishes epoch 2 as two shard blobs, which a world-4 trainer
    restores bit-equal; a CheckpointWatcher serves epoch 1, then
    promotes epoch 2, each bit-equal to a Predictor on the publisher's
    params."""
    monkeypatch.setenv("MXTPU_CKPT_SHARDED", "1")
    mgr = tres.CheckpointManager(str(tmp_path / "ckpt"), keep_last=None)
    batches = _batches()
    one = _port_trainer(tmp_path, 1)
    one.step(*batches[0])
    one.save_checkpoint(mgr, 1, blocking=True)
    assert not (mgr.entry(1) or {}).get("shard_set")
    two = _port_trainer(tmp_path, 2)
    assert two.restore(mgr) == 1
    np.testing.assert_array_equal(_params(two)["fc1_weight"],
                                  _params(one)["fc1_weight"])
    for x, y in batches[1:]:
        two.step(x, y)
    two.save_checkpoint(mgr, 2, blocking=True)
    names = sorted(os.listdir(str(tmp_path / "ckpt")))
    assert any(n.endswith(".params.s000-of-002") for n in names), names
    assert any(n.endswith(".params.s001-of-002") for n in names), names
    assert tres.verify_promotion(str(tmp_path / "ckpt")) == (2, [])
    four = _port_trainer(tmp_path, 4)
    assert four.restore(mgr) == 2
    want, got = _params(two), _params(four)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    s_two = pickle.loads(two.get_states())
    s_four = pickle.loads(four.get_states())
    assert s_four["num_update"] == s_two["num_update"] == 3
    assert sorted(s_four["states"]) == sorted(s_two["states"])
    for k, st in s_two["states"].items():
        for a, b in zip(s_four["states"][k], st):
            np.testing.assert_array_equal(a, b, err_msg=k)
    # the watcher: epoch 1 (whole blob) first, then epoch 2 (sharded)
    sym = tmx.sym.load_json(one.symbol.tojson())
    x = np.random.RandomState(6).rand(4, 192).astype("f")
    pool = ModelPool(ctx=tmx.cpu())
    entry = pool.load_dir("mlp", str(tmp_path / "ckpt"),
                          sample_shapes={"data": (192,)}, epoch=1)
    watcher = CheckpointWatcher(pool, "mlp")
    assert entry.loaded_epoch == 1
    ref = ref_predictor(sym, _params(one), {}, (4, 192))
    assert np.array_equal(entry.forward({"data": x})[0],
                          ref.forward(data=x).get_output(0))
    out = watcher.check_once()
    assert out["ok"] and out["action"] == "promoted", out
    assert entry.loaded_epoch == 2
    ref = ref_predictor(sym, want, {}, (4, 192))
    assert np.array_equal(entry.forward({"data": x})[0],
                          ref.forward(data=x).get_output(0))
    for tr in (one, two, four):
        tr.close()


def test_trainer_commands_apply_once_and_go_opens(tmp_path):
    cmds = trainer_main.Commands(str(tmp_path / "cmd"))
    cmds.poll()                 # no file yet
    assert not cmds.go
    (tmp_path / "cmd").write_text("arm rot_shard:1@1\n\n")
    tres.faults.disarm()
    try:
        cmds.poll()
        assert tres.faults.is_armed("rot_shard")
        tres.faults.disarm()
        cmds.poll()             # applied once
        assert not tres.faults.is_armed("rot_shard")
        with open(str(tmp_path / "cmd"), "a") as f:
            f.write("go\n")
        cmds.wait_go()
        assert cmds.go
    finally:
        tres.faults.disarm()
    assert trainer_main.parse_context("gpu(0)") == tmx.gpu(0)
    assert trainer_main.parse_context("cpu") == tmx.cpu()
    with pytest.raises(SystemExit):
        trainer_main.parse_context("tpu(0)")


class _FakeIter(object):
    """Batches of the drill's shape, and the reconnects a test sets."""

    def __init__(self, n=4):
        self.n = n
        self.recon = 0

    def stats(self):
        return {"servers": {0: {"reconnects": self.recon},
                            1: {"reconnects": 0}}}

    def __iter__(self):
        rs = np.random.RandomState(0)
        for _ in range(self.n):
            yield tmx.io.DataBatch(
                [rs.uniform(0, 1, (BATCH, 3, 8, 8)).astype("f")],
                [rs.randint(0, 7, BATCH).astype("f")])


class _FakeTrainer(object):
    def __init__(self):
        self.steps = 0

    def step(self, x, y):
        assert x.shape == (BATCH, 192) and y.shape == (BATCH,)
        self.steps += 1


def _read(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def test_a_reconnect_is_reported_before_the_next_batch(tmp_path):
    """The storm's resize can kill the trainer while a reconnect's first
    batch is still on its way: the status watcher writes the reconnect
    at once, with the last published epoch and the batches so far."""
    cfg = _cfg(tmp_path, 2)
    it = _FakeIter()
    status = trainer_main.Status(cfg, it, time.time(), period=0.02)
    status.start(4)
    try:
        t = _FakeTrainer()
        assert trainer_main.train_epoch(cfg, t, it, status)[0] == 4
        assert t.steps == 4 and status.batches == 4
        time.sleep(0.2)
        assert _read(cfg.status) is None      # nothing new to report
        it.recon = 1                          # inside a blocked next()
        _wait(lambda: _read(cfg.status) is not None, 10, "the report")
        doc = _read(cfg.status)
        assert (doc["reconnects"], doc["epoch"], doc["world"],
                doc["batches"]) == (1, 4, 2, 4), doc
        status.write(5)                       # the publish
        assert _read(cfg.status)["epoch"] == 5
        assert status.reported == 1
    finally:
        status.stop()
    assert not status._thread.is_alive()


@pytest.mark.parametrize("point,world", [("rot_checkpoint", 1),
                                         ("rot_checkpoint", 2),
                                         ("rot_shard", 2)])
def test_a_rotted_publish_is_never_seen_intact(tmp_path, monkeypatch,
                                               point, world):
    """The promote-path faults damage a file before the manifest entry
    vouching for its intact bytes is published: a rollout polling
    between the two would otherwise verify intact bytes and leave the
    rot to its replicas (a halt, not the rejection the smoke's check
    counts)."""
    monkeypatch.setenv("MXTPU_CKPT_SHARDED", "1")
    mgr = tres.CheckpointManager(str(tmp_path / "ckpt"), keep_last=None)
    seen = []
    publish = tres.CheckpointManager._update_manifest

    def checked(self, entry):
        seen.append(any(
            tuple(tres.checksum_file(os.path.join(self.directory, name),
                                     entry["checksum"]))
            != (rec["size"], rec["digest"])
            for name, rec in entry["files"].items()))
        return publish(self, entry)
    monkeypatch.setattr(tres.CheckpointManager, "_update_manifest", checked)
    tr = _port_trainer(tmp_path, world)
    tres.faults.disarm()
    try:
        tres.faults.arm(point, times=1, after=int(point == "rot_shard"))
        tr.save_checkpoint(mgr, 1, blocking=True)
    finally:
        tres.faults.disarm()
    tr.close()
    assert seen == [True], seen       # already damaged when published
    assert bool(mgr.entry(1).get("shard_set")) == (world > 1)
    assert tres.verify_promotion(str(tmp_path / "ckpt"))[1]


# ---------------------------------------------------------------------------
# the drill end to end
# ---------------------------------------------------------------------------

def _run_region(mode, tmp_path, timeout):
    """Run ``region_main.py <mode> --context cpu`` with jax unimportable,
    poll /region/stats while it is live, return (report, one mid-run
    stats payload)."""
    poison = tmp_path / "poison" / "jax"
    poison.mkdir(parents=True)
    (poison / "__init__.py").write_text(
        "raise ImportError('a region process imported jax')\n")
    env = dict(os.environ)
    for k in ("MXTPU_FAULTS", "MXTPU_RESUME", "CUDA_VISIBLE_DEVICES"):
        env.pop(k, None)
    env["PYTHONPATH"] = str(tmp_path / "poison")
    run_dir = str(tmp_path / "region")
    report = str(tmp_path / "report.json")
    proc = subprocess.Popen(
        [sys.executable, REGION_MAIN, mode, "--context", "cpu",
         "--run-dir", run_dir, "--report", report],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(tmp_path), start_new_session=True)
    deadline = time.monotonic() + timeout
    try:
        port_file = os.path.join(run_dir, "region.port")
        addr = None
        while time.monotonic() < deadline and proc.poll() is None:
            if os.path.exists(port_file):
                addr = open(port_file).read().strip()
                if addr:
                    break
            time.sleep(0.2)
        live = None
        if addr and proc.poll() is None:
            host, port = addr.rsplit(":", 1)
            while time.monotonic() < deadline and proc.poll() is None:
                try:
                    conn = http.client.HTTPConnection(host, int(port),
                                                      timeout=5)
                    conn.request("GET", "/region/stats")
                    resp = conn.getresponse()
                    body = resp.read()
                    conn.close()
                    if resp.status == 200:
                        live = json.loads(body.decode())
                        break
                except OSError:
                    time.sleep(0.2)
        out, err = proc.communicate(
            timeout=max(5.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError("region %s hung:\n%s" % (mode, err[-4000:]))
    finally:
        # the region's process group: its supervisors' children with it
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(timeout=30)
    assert proc.returncode == 0, \
        "region %s failed rc=%s:\n%s" % (mode, proc.returncode,
                                         err[-4000:])
    assert "REGION_REPORT " in out, out[-2000:]
    assert live is not None, "stats endpoint never answered mid-run"
    assert "events" in live and "roles" in live and "clients" in live
    with open(report) as f:
        doc = json.load(f)
    line = [ln for ln in out.splitlines() if ln.startswith("REGION_REPORT ")]
    assert json.loads(line[-1][len("REGION_REPORT "):]) == doc
    with open(os.path.join(run_dir, "trainer.log")) as f:
        doc["trainer_log"] = f.read()
    with open(os.path.join(run_dir, "trainer-status.json")) as f:
        doc["trainer_status"] = json.load(f)
    return doc, live


@pytest.mark.chaos
def test_region_smoke_drill(tmp_path):
    """1 data server -> supervised trainer -> 1-replica fleet -> clients,
    one rot-injected publish, on the port: zero dropped requests, the
    rot rejected at the rollout gate (every run: the storm window opens
    only after the trainer's ``go``), the served epoch advances
    bit-verified."""
    doc, live = _run_region("smoke", tmp_path, timeout=300)
    assert doc["ok"], doc["checks"]
    assert doc["checks"]["rot_publish_rejected"] is True
    assert len(doc["checks"]) == 8
    stats = doc["stats"]
    assert stats["clients"]["dropped"] == 0
    assert stats["clients"]["requests"] - stats["clients"]["ok"] \
        <= doc["spec"]["clients"]
    assert stats["events"].get("publish_rejected", 0) >= 1
    assert stats["events"].get("exit:trainer:rc=0") == 1
    assert stats["served_epochs"] == {"0": doc["spec"]["epochs"]}
    assert stats["first_served_epoch"] == 1
    assert stats["freshness_ms"] is not None
    assert "REGION_TRAINER armed rot_checkpoint:1" in doc["trainer_log"]
    assert set(live["trainer"]) == {"epoch", "world", "batches"}
    rollout = stats["fleet"]["rollout"]
    assert rollout["rejected"] >= 1
    assert rollout["halted"] == stats["events"].get("rollout_halted", 0)
    status = doc["trainer_status"]
    assert status["epoch"] == doc["spec"]["epochs"]
    assert status["world"] == 1 and status["batches"] > 0
    assert 0 < status["uptime_s"] and status["time"] <= time.time()


@pytest.mark.slow
@pytest.mark.chaos
def test_region_storm_drill(tmp_path):
    """The full STORM on the port: data-server SIGKILL, a resize from
    world 2 to 4, a rot-injected publish and a rotted shard blob, a
    replica SIGKILL, all in one window."""
    doc, live = _run_region("storm", tmp_path, timeout=480)
    assert doc["ok"], doc["checks"]
    events = doc["stats"]["events"]
    for label in ("kill:data#0", "resize:trainer",
                  "arm:trainer:rot_checkpoint", "kill:replica#1"):
        assert events.get(label) == 1, events
    assert doc["stats"]["clients"]["dropped"] == 0
    assert events.get("client_retry:502", 0) == 0, events
    assert doc["checks"]["no_502_leak"], events
    epochs = doc["spec"]["epochs"]
    assert doc["stats"]["served_epochs"] == {"0": epochs, "1": epochs}
    assert doc["stats"]["trainer"]["world"] == 4
    assert events.get("data_reconnect", 0) >= 1
    assert events.get("publish_rejected", 0) >= 1
    assert doc["stats"]["freshness_ms"] is not None
    assert "REGION_TRAINER resumed epoch=" in doc["trainer_log"]
