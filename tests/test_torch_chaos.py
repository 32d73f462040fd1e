"""The port's preemption-and-hang survival layer on the CPU: the exit codes
against ``tools/supervise.py``, ``StepWatchdog`` (calibration, floor,
firing with a stack and ``torch.cuda`` state dump), ``PreemptionHandler``,
graceful SIGTERM preemption with a mid-epoch checkpoint and a
bit-identical resume (a Dropout net, so the random stream must come back
through the JSON manifest), ``PreemptionCheckpoint`` in a custom loop, the
staging fault points, and the drills as subprocesses of the port with
JAX made unimportable: SIGTERM mid-epoch under ``supervise.py`` (exit 85,
relaunch, resume), a hung step (exit 87 with a dump, relaunch, resume), a
SIGKILL in the middle of an async save (the previous epoch resumes), and
a decode worker hung or failing by fault point mid-epoch (respawned, the
stream byte-identical).  Tolerance: exact (the CPU path is
deterministic)."""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import (PREEMPT_EXIT_CODE,
                                        WATCHDOG_EXIT_CODE,
                                        CheckpointManager, FaultInjector,
                                        PreemptionHandler, StepWatchdog,
                                        TransientError, faults)

pytestmark = pytest.mark.resilience

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPERVISE = os.path.join(REPO, "tools", "supervise.py")


@pytest.fixture
def port_faults():
    """Disarm the port's fault points around the test (the JAX package's
    ``clean_faults`` disarms only its own injector)."""
    faults.disarm()
    yield faults
    faults.disarm()


def make_blobs(n, d, c, seed=4):
    rs = np.random.RandomState(seed)
    centers = rs.randn(c, d) * 3
    X = np.concatenate([centers[i] + rs.randn(n // c, d)
                        for i in range(c)]).astype("f")
    y = np.concatenate([np.full(n // c, i) for i in range(c)]).astype("f")
    perm = rs.permutation(len(X))
    return X[perm], y[perm]


def mlp_sym(dropout=0.25):
    with tmx.name.NameManager():
        data = tmx.sym.Variable("data")
        net = tmx.sym.FullyConnected(data, num_hidden=16, name="fc1")
        net = tmx.sym.Activation(net, act_type="relu")
        if dropout:
            net = tmx.sym.Dropout(net, p=dropout)
        net = tmx.sym.FullyConnected(net, num_hidden=3, name="fc2")
        return tmx.sym.SoftmaxOutput(net, name="softmax")


def _load_supervise():
    import importlib.util
    spec = importlib.util.spec_from_file_location("supervise_t", SUPERVISE)
    sup = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sup)
    return sup


def test_exit_codes_match_supervisor():
    """supervise.py hardcodes the codes (it stays stdlib-only); the port's
    must equal them, and its resume knob is the one supervise sets."""
    sup = _load_supervise()
    assert sup.PREEMPT_EXIT_CODE == PREEMPT_EXIT_CODE == 85
    assert sup.WATCHDOG_EXIT_CODE == WATCHDOG_EXIT_CODE == 87
    assert sup.RESUME_ENV == tmx.resilience.ENV_RESUME
    assert sup.relaunch_decision(PREEMPT_EXIT_CODE, 0, 1)[0] == "relaunch"
    assert sup.relaunch_decision(WATCHDOG_EXIT_CODE, 0, 1)[0] == "relaunch"


# ---------------------------------------------------------------------------
# fault points: delayed firing, hangs, trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flavor", ["after", "hang", "trip"])
def test_fault_point_flavors(port_faults, flavor):
    if flavor == "after":
        fi = FaultInjector()
        fi.arm("preempt", times=1, after=3)
        assert [fi.consume("preempt") for _ in range(5)] == \
            [False, False, False, True, False]
    elif flavor == "hang":
        port_faults.arm_hang("hang_step", seconds=0.2)
        t0 = time.monotonic()
        faults.maybe_hang("hang_step")
        assert time.monotonic() - t0 >= 0.2
        t0 = time.monotonic()
        faults.maybe_hang("hang_step")    # disarmed after firing
        assert time.monotonic() - t0 < 0.1
    else:
        port_faults.arm("ckpt_write")
        with pytest.raises(TransientError):
            faults.maybe_trip("ckpt_write")
        port_faults.arm_hang("ckpt_write", seconds=0.15)
        t0 = time.monotonic()
        faults.maybe_trip("ckpt_write")
        assert time.monotonic() - t0 >= 0.15


# ---------------------------------------------------------------------------
# StepWatchdog (fake clock and injected abort: the whole fire path)
# ---------------------------------------------------------------------------

def _fake_watchdog(**kw):
    now = {"t": 0.0}
    fired = []
    wd = StepWatchdog(clock=lambda: now["t"], abort=fired.append,
                      debug_dir=kw.pop("debug_dir", None), **kw)
    return wd, now, fired


@pytest.mark.parametrize("case", ["median", "floor", "env", "zero"])
def test_watchdog_budget(monkeypatch, case):
    """The budget: the median (not the mean) of the first steps times the
    multiplier, never below the floor; a fixed MXTPU_STEP_TIMEOUT; and
    0, negative or garbage meaning off."""
    from mxnet_tpu_torch.resilience import step_timeout_configured
    if case == "median":
        wd, now, _ = _fake_watchdog(calibrate_steps=3, multiplier=10.0,
                                    min_timeout=0.5)
        assert wd.calibrated_timeout is None
        for dur in (5.0, 0.1, 0.2):     # the first step loads kernels
            with wd.armed("step"):
                now["t"] += dur
        assert wd.calibrated_timeout == pytest.approx(2.0)
    elif case == "floor":
        wd, now, _ = _fake_watchdog(calibrate_steps=2, multiplier=10.0,
                                    min_timeout=60.0)
        for _ in range(2):
            with wd.armed("step"):
                now["t"] += 0.001
        assert wd.calibrated_timeout == 60.0
    elif case == "env":
        monkeypatch.setenv("MXTPU_STEP_TIMEOUT", "7.5")
        assert StepWatchdog(clock=lambda: 0.0, abort=lambda c: None) \
            .calibrated_timeout == 7.5
        monkeypatch.setenv("MXTPU_STEP_TIMEOUT", "auto")
        assert StepWatchdog(clock=lambda: 0.0, abort=lambda c: None) \
            .calibrated_timeout is None
    else:
        for value, expect in (("0", False), ("-1", False), ("", False),
                              ("nonsense", False), ("auto", True),
                              ("2.5", True)):
            monkeypatch.setenv("MXTPU_STEP_TIMEOUT", value)
            assert step_timeout_configured() is expect, value
        monkeypatch.delenv("MXTPU_STEP_TIMEOUT")
        assert step_timeout_configured() is False
        monkeypatch.setenv("MXTPU_STEP_TIMEOUT", "0")
        assert StepWatchdog(clock=lambda: 0.0, abort=lambda c: None) \
            .calibrated_timeout is None


def test_watchdog_fires_on_overrun_and_dumps(tmp_path, capsys):
    import torch
    tr = tmx.parallel.SPMDTrainer(mlp_sym(0), "sgd", {"learning_rate": 0.1},
                                  ctx=tmx.cpu())
    wd, now, fired = _fake_watchdog(timeout=1.0, debug_dir=str(tmp_path))
    tr.install_watchdog(wd)
    with wd.armed("epoch 0 batch 3"):
        now["t"] += 0.5
        assert not wd.poll()
        now["t"] += 1.0
        assert wd.poll()
    assert fired == [WATCHDOG_EXIT_CODE]
    err = capsys.readouterr().err
    assert "epoch 0 batch 3" in err and "trainer: step 0" in err
    assert "MainThread" in err
    dumps = list(tmp_path.iterdir())
    assert len(dumps) == 1 and dumps[0].name.startswith("watchdog-")
    report = dumps[0].read_text()
    assert "exceeded its 1.0s budget" in report and "--- thread" in report
    assert "torch %s" % torch.__version__ in report
    assert "torch.cuda" in report
    tr.install_watchdog(None)
    assert wd.info is None and tr.watchdog is None


@pytest.mark.parametrize("case", ["disarmed", "reentrant", "thread"])
def test_watchdog_arming(case):
    if case == "disarmed":
        wd, now, fired = _fake_watchdog(timeout=1.0)
        now["t"] += 100.0
        assert not wd.poll()
        with wd.armed("step"):
            now["t"] += 0.9
            assert not wd.poll()
        assert fired == []
    elif case == "reentrant":
        wd, now, fired = _fake_watchdog(timeout=1.0)
        with wd.armed("outer"):
            now["t"] += 0.8
            with wd.armed("inner"):     # fit wraps the trainer's own arm
                now["t"] += 0.4
                assert wd.poll()
        assert fired == [WATCHDOG_EXIT_CODE]
    else:
        fired = []
        wd = StepWatchdog(timeout=0.2, check_interval=0.05,
                          abort=fired.append)
        wd.start()
        try:
            with wd.armed("stalled step"):
                deadline = time.monotonic() + 5.0
                while not fired and time.monotonic() < deadline:
                    time.sleep(0.05)
        finally:
            wd.stop()
        assert fired == [WATCHDOG_EXIT_CODE]


# ---------------------------------------------------------------------------
# preemption in-process: handler, mid-epoch checkpoint, resume
# ---------------------------------------------------------------------------

def test_preemption_handler_flag_and_uninstall():
    before = signal.getsignal(signal.SIGTERM)
    h = PreemptionHandler().install()
    try:
        assert not h.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if h.triggered:
                break
            time.sleep(0.01)
        assert h.triggered
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before


def _run_fit(ckpt_dir, epochs, preempt_after=None, resume=False, seed=21,
             kvstore="tpu"):
    """One fit of the Dropout MLP; host params, or None when the run left
    through graceful preemption."""
    X, y = make_blobs(256, 10, 3)
    mod = tmx.mod.Module(mlp_sym(), context=tmx.cpu())
    tmx.random.seed(seed)
    if preempt_after is not None:
        faults.arm("preempt", times=1, after=preempt_after)
    try:
        mod.fit(tmx.io.NDArrayIter(X, y, batch_size=64), num_epoch=epochs,
                kvstore=kvstore, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=tmx.initializer.Xavier(), checkpoint=ckpt_dir,
                resume=resume, preemption_safe=preempt_after is not None)
    except SystemExit as e:
        assert e.code == PREEMPT_EXIT_CODE
        return None
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("kvstore,ckpt_async", [("tpu", "0"), ("local", "0"),
                                                ("tpu", "1")])
def test_preemption_saves_mid_epoch_and_resume_is_bit_identical(
        tmp_path, port_faults, monkeypatch, kvstore, ckpt_async):
    """A real SIGTERM (delivered in-band at the 6th step boundary of a
    4-steps-an-epoch run) saves a mid-epoch checkpoint whose random state
    is JSON in the manifest; fit(resume=True) after another seed
    fast-forwards and ends bit-identical to the uninterrupted run, on both
    routes, and under MXTPU_CKPT_ASYNC=1 the preemption save still lands
    blocking.  The epoch-end saves then replace the partial entry."""
    monkeypatch.setenv("MXTPU_CKPT_ASYNC", ckpt_async)
    full = _run_fit(str(tmp_path / "full"), 3, kvstore=kvstore)
    cut_dir = str(tmp_path / "cut")
    assert _run_fit(cut_dir, 3, preempt_after=5, kvstore=kvstore) is None
    with open(os.path.join(cut_dir, "manifest.json")) as f:
        entry = json.load(f)["checkpoints"][-1]
    assert entry["step_state"]["epoch"] == 1
    assert entry["step_state"]["step"] == 2
    assert entry["step_state"]["rng"]["format"] == \
        tmx.random.STATE_FORMAT and entry["files"]
    resumed = _run_fit(cut_dir, 3, resume=True, seed=77, kvstore=kvstore)
    for name in full:
        assert np.array_equal(full[name], resumed[name]), name
    man = CheckpointManager(cut_dir)
    assert man.latest() == 3
    for e in man._read_manifest()["checkpoints"]:
        assert "step_state" not in e


def test_resume_env_var_forces_resume(tmp_path, port_faults, monkeypatch):
    cut_dir = str(tmp_path / "cut")
    full = _run_fit(str(tmp_path / "full"), 2)
    assert _run_fit(cut_dir, 2, preempt_after=1) is None
    monkeypatch.setenv("MXTPU_RESUME", "1")
    resumed = _run_fit(cut_dir, 2)
    for name in full:
        assert np.array_equal(full[name], resumed[name]), name


def test_preemption_checkpoint_callback_for_custom_loops(tmp_path):
    from mxnet_tpu_torch.model import BatchEndParam
    X, y = make_blobs(128, 10, 3)
    it = tmx.io.NDArrayIter(X, y, batch_size=32)
    mod = tmx.mod.Module(mlp_sym(), context=tmx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    tmx.random.seed(7)
    mod.init_params(tmx.initializer.Xavier())
    mod.init_optimizer(kvstore="tpu", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    man = CheckpointManager(str(tmp_path))
    before = signal.getsignal(signal.SIGTERM)
    with tmx.callback.PreemptionCheckpoint(mod, man) as cb:
        with pytest.raises(SystemExit) as exc:
            for nbatch, batch in enumerate(it):
                mod.forward_backward(batch)
                mod.update()
                if nbatch == 1:
                    cb.handler.trigger()
                cb(BatchEndParam(epoch=0, nbatch=nbatch, eval_metric=None,
                                 locals=None))
        assert exc.value.code == PREEMPT_EXIT_CODE
    assert signal.getsignal(signal.SIGTERM) is before
    entry = man.latest_entry()
    assert entry["step_state"] == {"epoch": 0, "step": 2,
                                   "rng": entry["step_state"]["rng"]}
    with pytest.raises(MXNetError, match="needs checkpoint"):
        tmx.mod.Module(mlp_sym(), context=tmx.cpu()).fit(
            it, num_epoch=1, preemption_safe=True)


@pytest.mark.parametrize("point", ["stage_batch", "hang_stage"])
def test_stage_fault_points(port_faults, point):
    """stage_batch raises on the consumer's thread; a short hang_stage
    delays but loses no batch (the long one is what the watchdog kills)."""
    from mxnet_tpu_torch.dataflow import DevicePrefetchIter
    X = np.arange(64, dtype="f").reshape(16, 4)
    base = tmx.io.NDArrayIter(X, np.zeros(16, "f"), batch_size=4)
    if point == "stage_batch":
        port_faults.arm("stage_batch")
    else:
        port_faults.arm_hang("hang_stage", seconds=0.3)
    # the constructor starts the worker, which may enter the hang before
    # it returns: the clock starts before it, so the whole hang is timed
    t0 = time.monotonic()
    it = DevicePrefetchIter(base, stage=None, depth=2)
    try:
        if point == "stage_batch":
            with pytest.raises(TransientError, match="stage_batch"):
                for _ in it:
                    pass
        else:
            seen = [b.data[0].asnumpy().copy() for b in it]
            assert time.monotonic() - t0 >= 0.3
            assert len(seen) == 4
            np.testing.assert_array_equal(seen[0], X[:4])
    finally:
        it.close()


# ---------------------------------------------------------------------------
# the drills: port subprocesses, real signals, real exits
# ---------------------------------------------------------------------------

DRILL_SCRIPT = """
import os, sys
sys.modules["jax"] = None          # the drill runs the port alone
sys.modules["mxnet_tpu"] = None
sys.path.insert(0, %(repo)r)
import logging
logging.basicConfig(level=logging.INFO)
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.resilience import faults

rs = np.random.RandomState(4)     # make_blobs(256, 10, 3): 4 batches
centers = rs.randn(3, 10) * 3
X = np.concatenate([centers[i] + rs.randn(85, 10) for i in range(3)])
y = np.concatenate([np.full(85, i) for i in range(3)])
perm = rs.permutation(len(X))
X, y = X[perm].astype("f"), y[perm].astype("f")

dropout = float(os.environ.get("CHAOS_DROPOUT", "0"))
with mx.name.NameManager():
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=16,
                                name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    if dropout:
        net = mx.sym.Dropout(net, p=dropout)
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    net = mx.sym.SoftmaxOutput(net, name="softmax")

mod = mx.mod.Module(net, context=mx.cpu())
mx.random.seed(21)
resuming = os.environ.get("MXTPU_RESUME") == "1"
if resuming:
    # the drill's own strip of its one-shot hang around the relaunch
    faults.disarm("hang_step")
preempt_at = os.environ.get("CHAOS_PREEMPT_AT")
if preempt_at and not resuming:
    # in-band preemption: a real SIGTERM to ourselves at step boundary N
    faults.arm("preempt", times=1, after=int(preempt_at))
if os.environ.get("CHAOS_CKPT_HANG") and not resuming:
    # wedge the async writer mid-save of epoch 2 (files on disk, manifest
    # not): the parent SIGKILLs us there
    faults.arm_hang("ckpt_write", seconds=3600, after=1)
mod.fit(mx.io.NDArrayIter(X, y, batch_size=64), num_epoch=3, kvstore="tpu",
        optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
        initializer=mx.initializer.Xavier(),
        checkpoint=os.environ["CHAOS_DIR"], preemption_safe=bool(preempt_at))
mod.save_params(os.environ["CHAOS_OUT"])
"""


def _drill_env(tmp_path, name, dropout="0", **extra):
    env = dict(os.environ)
    for k in ("MXTPU_RESUME", "MXTPU_FAULTS", "MXTPU_STEP_TIMEOUT",
              "MXTPU_CKPT_ASYNC", "CHAOS_PREEMPT_AT", "CHAOS_CKPT_HANG"):
        env.pop(k, None)
    env.update(CHAOS_DIR=str(tmp_path / name),
               CHAOS_OUT=str(tmp_path / (name + ".params")),
               CHAOS_DROPOUT=dropout)
    env.update(extra)
    return env


def _load_params(path):
    return {k: v.asnumpy() for k, v in tmx.nd.load(str(path)).items()}


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The drill script and its two uninterrupted baselines (with and
    without Dropout), run in parallel."""
    root = tmp_path_factory.mktemp("drill")
    script = root / "train.py"
    script.write_text(DRILL_SCRIPT % {"repo": REPO})
    procs = [subprocess.Popen([sys.executable, str(script)],
                              env=_drill_env(root, name, dropout),
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for name, dropout in (("full", "0"), ("full_do", "0.25"))]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
    return script, {"0": _load_params(root / "full.params"),
                    "0.25": _load_params(root / "full_do.params")}


def _supervised(script, env, restarts=2):
    return subprocess.run(
        [sys.executable, SUPERVISE, "--max-restarts", str(restarts),
         "--backoff", "0", "--", sys.executable, str(script)],
        env=env, capture_output=True, text=True, timeout=600)


def _assert_same(full, path):
    cut = _load_params(path)
    assert set(full) == set(cut)
    for name in full:
        assert np.array_equal(full[name], cut[name]), name


def test_drill_sigterm_mid_epoch_supervised_resume(drill, tmp_path):
    """SIGTERM at the 6th step boundary (mid epoch 1 of 3 x 4 steps) under
    supervise.py: exit 85, relaunch with MXTPU_RESUME=1, fast-forward, and
    the Dropout net's final params are bit-identical to the uninterrupted
    run's."""
    script, full = drill
    res = _supervised(script, _drill_env(tmp_path, "cut", "0.25",
                                         CHAOS_PREEMPT_AT="5"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "graceful preemption — relaunch 1/2" in res.stderr
    assert "saved mid-epoch checkpoint (epoch 1, step 2)" in res.stderr
    assert "fast-forwarded 2 batches of epoch 1" in res.stderr
    man = CheckpointManager(str(tmp_path / "cut"))
    assert man.latest() == 3 and "step_state" not in man.latest_entry()
    _assert_same(full["0.25"], tmp_path / "cut.params")


def test_drill_hung_step_watchdog_supervised_resume(drill, tmp_path):
    """MXTPU_FAULTS=hang_step:1@5 stalls the 6th fused step against a 3 s
    MXTPU_STEP_TIMEOUT: the watchdog dumps stacks and the torch state to
    MXTPU_DEBUG_DIR and exits 87; supervise.py relaunches, the relaunch
    resumes from the last epoch-end checkpoint and ends bit-identical."""
    script, full = drill
    debug = tmp_path / "debug"
    t0 = time.monotonic()
    res = _supervised(script, _drill_env(
        tmp_path, "hang", MXTPU_FAULTS="hang_step:1@5",
        MXTPU_STEP_TIMEOUT="3", MXTPU_DEBUG_DIR=str(debug)))
    assert res.returncode == 0, res.stderr[-3000:]
    assert time.monotonic() - t0 < 240
    assert "watchdog abort (hung step) — relaunch 1/2" in res.stderr
    assert "exceeded its 3.0s budget" in res.stderr
    assert "restored checkpoint epoch 1" in res.stderr
    dumps = list(debug.iterdir())
    assert len(dumps) == 1
    report = dumps[0].read_text()
    assert "--- thread" in report and "maybe_hang" in report
    assert "torch " in report and "epoch 1 batch 1" in report
    assert "trainer: step 5" in report
    _assert_same(full["0"], tmp_path / "hang.params")


def test_drill_sigkill_mid_async_save_resumes_previous_epoch(drill,
                                                             tmp_path):
    """SIGKILL while the async writer is wedged mid-save of epoch 2 (its
    files on disk, the manifest not): epoch 2 is never restorable, the
    relaunch resumes epoch 1 and ends bit-identical."""
    script, full = drill
    cut_dir = tmp_path / "cut"
    proc = subprocess.Popen([sys.executable, str(script)],
                            env=_drill_env(tmp_path, "cut",
                                           MXTPU_CKPT_ASYNC="1",
                                           CHAOS_CKPT_HANG="1"),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120
        params2 = cut_dir / "checkpoint-0002.states"
        while time.monotonic() < deadline and not params2.exists():
            assert proc.poll() is None, "drill process died early"
            time.sleep(0.05)
        assert params2.exists(), "epoch-2 save never started"
        time.sleep(0.5)       # let the writer reach the armed hang
        proc.kill()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    man = CheckpointManager(str(cut_dir))
    assert man.latest() == 1 and man.latest_entry()["files"]
    res = subprocess.run([sys.executable, str(script)],
                         env=_drill_env(tmp_path, "cut", MXTPU_CKPT_ASYNC="1",
                                        MXTPU_RESUME="1"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert man.latest() == 3
    _assert_same(full["0"], tmp_path / "cut.params")


# ---------------------------------------------------------------------------
# data-service drills by fault point (a hung and a failing decode worker)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ds_rec(tmp_path_factory):
    sys.path.insert(0, REPO)
    import chip_smoke
    prefix = str(tmp_path_factory.mktemp("dsrec") / "d")
    rs = np.random.RandomState(0)
    w = tmx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(29):
        img = chip_smoke.seeded_image(rs, 48, 48 + 4 * (i % 3))
        w.write_idx(i, tmx.recordio.pack_img((0, float(i % 5), i, 0), img,
                                             quality=90))
    w.close()
    return prefix + ".rec", prefix + ".idx"


def _ds_stream(rec, epochs=2):
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(
            path_imgrec=rec[0], path_imgidx=rec[1], data_shape=(3, 32, 32),
            batch_size=8, shuffle=True, seed=5, rand_crop=True,
            rand_mirror=True, dtype="float32", host_batches=True,
            data_service=True, preprocess_threads=2)
        out = []
        try:
            for e in range(epochs):
                if e:
                    it.reset()
                out += [(np.array(b.data[0]).copy(),
                         np.array(b.label[0]).copy(), b.pad) for b in it]
            return out, it.stats()
        finally:
            it.close()


@pytest.mark.parametrize("point", ["hang_data_worker", "data_worker"])
def test_data_service_worker_fault_drill(ds_rec, monkeypatch, point):
    """MXTPU_FAULTS arms every decode worker at its first batch: a hang
    ages its heartbeat out (MXTPU_DATA_HEARTBEAT_S=2) and a failure exits
    it; the coordinator respawns each with the fault stripped, and both
    epochs equal an undisturbed run byte for byte."""
    ref, _ = _ds_stream(ds_rec)
    monkeypatch.setenv("MXTPU_FAULTS", point + ":1")
    monkeypatch.setenv("MXTPU_DATA_HEARTBEAT_S", "2")
    t0 = time.monotonic()
    got, st = _ds_stream(ds_rec)
    assert time.monotonic() - t0 < 120
    assert sum(w["respawns"] for w in st["workers"].values()) >= 1, st
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert a[2] == b[2], ("pad", i)
        np.testing.assert_array_equal(a[1], b[1], err_msg="labels %d" % i)
        np.testing.assert_array_equal(a[0], b[0], err_msg="data %d" % i)
