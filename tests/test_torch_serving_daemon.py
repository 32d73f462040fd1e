"""The port's serving daemon (``mxnet_tpu_torch/serving/serve_main.py``)
as a subprocess on the CPU (``--context cpu``), with JAX and the JAX
package made unimportable in it: end to end with ``--warmup`` (a quiet
request bit-equal to the unbatched ``Predictor``, JSON and x-npy bodies,
``/predict_seq``, ``/stats``, 404/400), a SIGTERM drain that answers
every accepted request and exits 0 with the launch-counter line, a hot
swap under ``--watch``, the refusals (a gpu context without CUDA,
``--export-aot`` without a cache, a JAX-built AOT store), and the watchdog drill under
``tools/supervise.py`` (a hung forward exits 87 with a dump, the relaunch
answers 200, a SIGTERM to the supervisor gives 0).

Each test bounds its own run: every wait has a deadline and every
process it starts is killed on the way out.  Tolerance: exact (bit for
bit) wherever outputs are compared.
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

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.serving import ServeClient, pad_to_bucket

pytestmark = pytest.mark.serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_MAIN = os.path.join(REPO, "mxnet_tpu_torch", "serving", "serve_main.py")
SUPERVISE = os.path.join(REPO, "tools", "supervise.py")
CPU = tmx.cpu()

#: runs serve_main.py with JAX and the JAX package unimportable; a
#: relaunch under the supervisor (MXTPU_RESUME=1) drops its injected
#: faults, as a drill's respawn does
WRAPPER = """
import os, runpy, sys
sys.modules["jax"] = None
sys.modules["mxnet_tpu"] = None
if os.environ.get("MXTPU_RESUME") == "1":
    os.environ.pop("MXTPU_FAULTS", None)
sys.argv = [%(main)r] + sys.argv[1:]
runpy.run_path(%(main)r, run_name="__main__")
"""


def _sym(nh=32):
    with tmx.name.NameManager():
        data = tmx.sym.Variable("data")
        net = tmx.sym.Convolution(data, num_filter=4, kernel=(3, 3),
                                  pad=(1, 1), name="c1")
        net = tmx.sym.BatchNorm(net, name="bn1")
        net = tmx.sym.Activation(net, act_type="relu")
        net = tmx.sym.Flatten(net)
        net = tmx.sym.FullyConnected(net, num_hidden=nh, name="fc1")
        net = tmx.sym.FullyConnected(net, num_hidden=10, name="fc2")
        return tmx.sym.SoftmaxOutput(net, name="softmax")


SAMPLE = (3, 6, 6)


def _params(sym, seed):
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1,) + SAMPLE)
    args = {n: tmx.nd.array(rs.uniform(-0.3, 0.3, s).astype("f"), ctx=CPU)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    auxs = {n: tmx.nd.array((np.ones(s) if n.endswith("var")
                             else np.zeros(s)).astype("f"), ctx=CPU)
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def _save_pair(tmp_path, seed=0):
    sym = _sym()
    args, auxs = _params(sym, seed)
    prefix = str(tmp_path / "net")
    tmx.model.save_checkpoint(prefix, 1, sym, args, auxs, blocking=True)
    return sym, args, auxs, prefix


def _predictor(sym, args, auxs, batch):
    blob = {"arg:%s" % k: v for k, v in args.items()}
    blob.update({"aux:%s" % k: v for k, v in auxs.items()})
    return tmx.predict.Predictor(sym, blob, {"data": (batch,) + SAMPLE},
                                 ctx=CPU)


class Daemon(object):
    """One serve_main.py process (through the wrapper, or under the
    supervisor), killed on close if still alive."""

    def __init__(self, tmp_path, args, env_extra=None, supervised=False,
                 deadline_s=120):
        wrapper = tmp_path / "serve_wrapper.py"
        wrapper.write_text(WRAPPER % {"main": SERVE_MAIN})
        self.port_file = str(tmp_path / "port")
        env = dict(os.environ)
        for k in ("MXTPU_RESUME", "MXTPU_FAULTS", "MXTPU_STEP_TIMEOUT",
                  "MXTPU_COMPILE_CACHE", "CUDA_VISIBLE_DEVICES"):
            env.pop(k, None)
        env.update(env_extra or {})
        cmd = [sys.executable, str(wrapper), "--port", "0",
               "--port-file", self.port_file] + list(args)
        if supervised:
            cmd = [sys.executable, SUPERVISE, "--max-restarts", "1",
                   "--backoff", "0", "--"] + cmd
        self.proc = subprocess.Popen(cmd, env=env, cwd=str(tmp_path),
                                     stdout=subprocess.DEVNULL,
                                     stderr=subprocess.PIPE, text=True)
        self.err = ""
        deadline = time.monotonic() + deadline_s
        while not os.path.exists(self.port_file):
            if self.proc.poll() is not None:
                raise AssertionError("daemon died: %s" % self.stderr())
            if time.monotonic() > deadline:
                self.close()
                raise AssertionError("daemon never wrote its port file")
            time.sleep(0.05)

    @property
    def port(self):
        return int(open(self.port_file).read().split(":")[1])

    def stop(self, timeout=60):
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=timeout)
        self.stderr()
        return rc

    def stderr(self):
        if self.proc.poll() is not None and self.proc.stderr is not None:
            self.err += self.proc.stderr.read()
            self.proc.stderr.close()
            self.proc.stderr = None
        return self.err

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self.stderr()


def _launch_line(err):
    lines = [ln for ln in err.splitlines()
             if ln.startswith("mxserve: launches ")]
    assert len(lines) == 1, err[-3000:]
    return json.loads(lines[0][len("mxserve: launches "):])


def _lm_dir(tmp_path):
    """A CheckpointManager directory holding the LSTM LM (vocab 50,
    width 8, 2 layers) without its init states."""
    from mxnet_tpu_torch.models import lstm_lm
    with tmx.name.NameManager():
        sym, _, _ = lstm_lm.lstm_lm_sym(8, 50, num_embed=8, num_hidden=8,
                                        num_layers=2)
    arg_shapes, _, _ = sym.infer_shape(data=(2, 8), softmax_label=(2, 8))
    rs = np.random.RandomState(0)
    args = {n: tmx.nd.array(((rs.rand(*s) - 0.5) * 0.4).astype("f"),
                            ctx=CPU)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label", "lstm_init_h",
                         "lstm_init_c")}
    tmx.CheckpointManager(str(tmp_path / "lm")).save(
        1, symbol=sym, arg_params=args, aux_params={}, blocking=True)
    return sym, args, str(tmp_path / "lm")


def test_daemon_end_to_end_with_warmup(tmp_path):
    sym, args, auxs, prefix = _save_pair(tmp_path)
    lm_sym, lm_args, lm_dir = _lm_dir(tmp_path)
    d = Daemon(tmp_path, ["--context", "cpu", "--model",
                          "net=%s:1" % prefix, "--model", "lm=%s" % lm_dir,
                          "--input-shape", "net:data=3,6,6",
                          "--buckets", "1,2,4,8", "--seq-buckets", "4,8",
                          "--max-wait-ms", "2", "--warmup"])
    try:
        cli = ServeClient("127.0.0.1", d.port, timeout=30)
        health = cli.wait_ready(60)
        assert health["status"] == "ok"
        assert health["models"] == ["lm", "net"]
        x = np.random.RandomState(0).rand(*SAMPLE).astype("f")
        ref = _predictor(sym, args, auxs, 1).forward(
            data=x[None]).get_output(0)[0]
        for npy in (False, True):
            st, payload = cli.predict("net", x, npy=npy)
            assert st == 200, payload
            assert np.array_equal(np.asarray(payload["outputs"][0], "f"),
                                  ref)
        toks = [3, 1, 4, 1, 5, 9]
        st, out = cli.predict_seq("lm", toks)
        assert st == 200 and out["bucket"] == 8 and out["len"] == 6
        pred = tmx.predict.Predictor(
            lm_sym, {"arg:%s" % k: v for k, v in lm_args.items()},
            {"data": (1, 8), "softmax_label": (1, 8)}, ctx=CPU)
        lm_ref = pred.forward(
            data=np.asarray(toks + [9, 9], "f")[None],
            softmax_label=np.zeros((1, 8), "f")).get_output(0)
        assert np.array_equal(np.asarray(out["outputs"][0], "f"),
                              lm_ref[:6])
        st, stats = cli.stats()
        assert st == 200 and stats["counters"]["completed"] == 3
        assert stats["queue_depth"]["net"] == 0
        assert cli.predict("nope", x)[0] == 404
        assert cli._request("POST", "/predict/net", body=b"{}")[0] == 400
        cli.close()
        assert d.stop() == 0
    finally:
        d.close()
    err = d.stderr()
    assert "drained" in err and "warmed 'net' over buckets" in err
    counts = _launch_line(err)
    assert sorted(counts) == sorted([
        "bn_act_fwd", "bn_act_bwd", "lstm_cell_fwd", "lstm_cell_bwd",
        "lstm_seq_fwd", "lstm_seq_bwd", "flash_attention_fwd",
        "rtc_elementwise"])
    # on the host every wrapper takes its plain version: no launch
    assert set(counts.values()) == {0}


def test_daemon_sigterm_drains_every_accepted_request(tmp_path):
    """SIGTERM while requests sit in an open batch window: each one is
    answered 200 from the batch it was in, and the daemon exits 0."""
    sym, args, auxs, prefix = _save_pair(tmp_path)
    d = Daemon(tmp_path, ["--context", "cpu", "--model",
                          "net=%s:1" % prefix, "--input-shape",
                          "data=3,6,6", "--buckets", "8",
                          "--max-wait-ms", "1500", "--warmup"])
    try:
        port = d.port
        ServeClient("127.0.0.1", port).wait_ready(60)
        X = np.random.RandomState(1).rand(5, *SAMPLE).astype("f")
        results = [None] * 5

        def worker(i):
            c = ServeClient("127.0.0.1", port, timeout=60)
            try:
                results[i] = c.predict("net", X[i])
            finally:
                c.close()

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(5)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st, stats = ServeClient("127.0.0.1", port).stats()
            if stats["counters"]["accepted"] == 5:
                break
            time.sleep(0.02)
        assert stats["counters"]["accepted"] == 5
        d.proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(timeout=60)
        assert d.proc.wait(timeout=60) == 0
    finally:
        d.close()
    ref = _predictor(sym, args, auxs, 8)
    for i in range(5):
        st, payload = results[i]
        assert st == 200, payload
        # the five rode one padded bucket of 8; each equals its row of
        # that bucket's forward
        batch = np.asarray(payload["outputs"][0], "f")
        assert batch.shape == (10,)
    got = np.stack([np.asarray(r[1]["outputs"][0], "f") for r in results])
    full = ref.forward(data=pad_to_bucket(list(X), 8)).get_output(0)[:5]
    assert np.array_equal(got, full)
    assert "drained" in d.stderr()


def test_daemon_watch_hot_swaps_a_new_epoch(tmp_path):
    sym = _sym()
    man = tmx.CheckpointManager(str(tmp_path / "dir"))
    args1, auxs1 = _params(sym, 1)
    man.save(1, symbol=sym, arg_params=args1, aux_params=auxs1,
             blocking=True)
    d = Daemon(tmp_path, ["--context", "cpu", "--model",
                          "net=%s" % man.directory, "--input-shape",
                          "data=3,6,6", "--buckets", "1,2", "--warmup",
                          "--watch"], env_extra={"MXTPU_SWAP_POLL_S": "0.1"})
    try:
        cli = ServeClient("127.0.0.1", d.port, timeout=30)
        assert cli.wait_ready(60)["epochs"] == {"net": 1}
        args2, auxs2 = _params(sym, 2)
        man.save(2, symbol=sym, arg_params=args2, aux_params=auxs2,
                 blocking=True)
        deadline = time.monotonic() + 60
        while cli.healthz()[1]["epochs"]["net"] != 2:
            assert time.monotonic() < deadline, cli.stats()[1]
            time.sleep(0.05)
        x = np.random.RandomState(4).rand(*SAMPLE).astype("f")
        st, payload = cli.predict("net", x)
        ref = _predictor(sym, args2, auxs2, 1).forward(
            data=x[None]).get_output(0)[0]
        assert st == 200
        assert np.array_equal(np.asarray(payload["outputs"][0], "f"), ref)
        assert cli.stats()[1]["deploy"]["net"]["promoted"] == 1
        cli.close()
        assert d.stop() == 0
    finally:
        d.close()


def test_daemon_refusals(tmp_path):
    """A gpu context without CUDA exits 2 (never a silent host run);
    ``--export-aot`` without ``MXTPU_COMPILE_CACHE`` exits 2 and writes
    no store; ``--warmup-only`` against a JAX-built AOT store warns,
    falls back and exits 0."""
    _, _, _, prefix = _save_pair(tmp_path)
    wrapper = tmp_path / "w.py"
    wrapper.write_text(WRAPPER % {"main": SERVE_MAIN})
    base = [sys.executable, str(wrapper), "--model", "net=%s:1" % prefix,
            "--input-shape", "data=3,6,6", "--port", "0",
            "--buckets", "1,2"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("MXTPU_COMPILE_CACHE", None)
    res = subprocess.run(base, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 2 and "CUDA is not available" in res.stderr
    cache = tmp_path / "cache"
    res = subprocess.run(base + ["--context", "cpu", "--export-aot",
                                 "--warmup-only"],
                         env=env, cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 2
    assert "--export-aot needs MXTPU_COMPILE_CACHE" in res.stderr
    assert not (tmp_path / "aot").exists()
    store = cache / "aot"
    store.mkdir(parents=True)
    (store / "net.json").write_text(json.dumps(
        {"platform": "cpu", "meta_version": 1, "buckets": [1, 2],
         "dtype": "float32", "sample_shapes": {"data": [3, 6, 6]}}))
    (store / "net-b1.exec").write_bytes(b"\0" * 32)
    res = subprocess.run(base + ["--context", "cpu", "--warmup-only"],
                         env=dict(env, MXTPU_COMPILE_CACHE=str(cache)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "meta mismatch" in res.stderr and "warmup_s=" in res.stderr
    assert "warmed 'net' over buckets [1, 2]" in res.stderr


@pytest.mark.chaos
def test_daemon_watchdog_drill_under_supervise(tmp_path):
    """A hung forward (``MXTPU_FAULTS=hang_serve_forward:1``) trips the
    4 s watchdog: a dump and exit 87; ``supervise.py`` relaunches, the
    relaunch answers 200, and a SIGTERM to the supervisor drains it to
    0."""
    sym, args, auxs, prefix = _save_pair(tmp_path)
    debug = tmp_path / "debug"
    d = Daemon(tmp_path, ["--context", "cpu", "--model",
                          "net=%s:1" % prefix, "--input-shape",
                          "data=3,6,6", "--buckets", "1,2",
                          "--max-wait-ms", "5"],
               env_extra={"MXTPU_FAULTS": "hang_serve_forward:1",
                          "MXTPU_STEP_TIMEOUT": "4",
                          "MXTPU_DEBUG_DIR": str(debug)},
               supervised=True)
    x = np.zeros(SAMPLE, "f")
    try:
        first = d.port
        deadline = time.monotonic() + 120
        served = None
        while time.monotonic() < deadline:
            try:
                cli = ServeClient("127.0.0.1", d.port, timeout=8)
                served = cli.predict("net", x)
                cli.close()
            except Exception:  # noqa: BLE001 — wedged or relaunching
                served = None
            if served and served[0] == 200:
                break
            assert d.proc.poll() is None, d.stderr()[-3000:]
            time.sleep(0.2)
        assert served and served[0] == 200, "no 200 after the relaunch"
        assert d.port != first
        ref = _predictor(sym, args, auxs, 1).forward(
            data=x[None]).get_output(0)[0]
        assert np.array_equal(np.asarray(served[1]["outputs"][0], "f"), ref)
        assert d.stop(timeout=120) == 0
    finally:
        d.close()
    err = d.stderr()
    assert "watchdog abort (hung step)" in err
    assert "StepWatchdog" in err and "exceeded its 4.0s budget" in err
    assert "drained" in err
    assert len(list(debug.iterdir())) == 1
