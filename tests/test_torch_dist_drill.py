"""Kill-and-resume drills of the port across processes under
``tools/launch.py --platform cpu`` (this file run as a script is the
worker: ``python tests/test_torch_dist_drill.py --worker <phase>``).

- ZeRO-3 (tests/dist/dist_zero3.py's drill): zero3 params bit-identical
  to allreduce's after 6 steps; a sharded-native save at step 3 (one
  blob a rank), then every rank SIGKILLs itself in step 4 (the launcher
  reports the failure); a resume whose digest equals the undisturbed
  run's.
- Preemption agreement: under ``fit(preemption_safe=True)`` SIGTERM
  reaches rank 1 alone (the ``preempt`` fault point, a real signal);
  both ranks agree at the next step boundary, save there and exit 85;
  the resumed run (``MXTPU_RESUME=1``) ends bit-identical to an
  uninterrupted one.
- Sharded-native checkpoints cross the packages: the JAX package writes
  one at a two-device mesh, the port's two ranks and a one-device port
  trainer restore it bit for bit; the port's ranks write one, the JAX
  package restores it at two devices and at one.

Every subprocess carries a timeout.
"""
import hashlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LAUNCH = os.path.join(REPO, "tools", "launch.py")
TIMEOUT = 240
BATCH = 32
STEPS, SAVE_AT = 6, 3


def launch(n, phase, env=None, timeout=TIMEOUT):
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("MXTPU_")}
    base.pop("XLA_FLAGS", None)
    base["OMP_NUM_THREADS"] = "1"
    base["PYTHONPATH"] = REPO + os.pathsep + base.get("PYTHONPATH", "")
    base.update(env or {})
    return subprocess.run(
        [sys.executable, LAUNCH, "-n", str(n), "--platform", "cpu",
         sys.executable, os.path.abspath(__file__), "--worker", phase],
        env=base, capture_output=True, text=True, timeout=timeout)


def mlp(mx, hidden=64):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=hidden, name="fc1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def stream(n=STEPS):
    rs = np.random.RandomState(0)
    return [(rs.randn(BATCH, 10).astype("f"),
             rs.randint(0, 4, BATCH).astype("f")) for _ in range(n)]


def digest(arg, aux=None):
    h = hashlib.sha256()
    for d in (arg, aux or {}):
        for k in sorted(d):
            v = d[k]
            h.update(np.ascontiguousarray(
                v.asnumpy() if hasattr(v, "asnumpy") else v).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def _trainer(mx, sync, mesh, world):
    tr = mx.parallel.SPMDTrainer(
        mlp(mx), "sgd", {"learning_rate": 0.3, "momentum": 0.9,
                         "rescale_grad": 1.0 / BATCH},
        mesh=mesh, grad_sync=sync, ctx=mx.cpu())
    tr.bind([("data", (BATCH // world, 10))],
            [("softmax_label", (BATCH // world,))])
    mx.random.seed(33)
    tr.init_params(mx.initializer.Xavier())
    return tr


def _zero3(mx, phase, rank, world):
    import signal
    mesh = mx.parallel.local_mesh()
    data = [(x[rank::world], y[rank::world]) for x, y in stream()]
    ckpt = os.environ["DRILL_DIR"]
    if phase == "zero3_baseline":
        finals = {}
        for sync in ("allreduce", "zero3"):
            t = _trainer(mx, sync, mesh, world)
            for x, y in data:
                t.step(x, y)
            finals[sync] = t.get_params()
            t.close()
        a, z = finals["allreduce"][0], finals["zero3"][0]
        assert all(np.array_equal(a[k].asnumpy(), z[k].asnumpy()) for k in a)
        print("dist_zero3 rank %d/%d: OK baseline zero3==allreduce bitwise "
              "digest=%s" % (rank, world, digest(*finals["zero3"])),
              flush=True)
        return
    mgr = mx.resilience.CheckpointManager(ckpt)
    t = _trainer(mx, "zero3", mesh, world)
    if phase == "zero3_kill":
        for x, y in data[:SAVE_AT]:
            t.step(x, y)
        t.save_checkpoint(mgr, SAVE_AT)        # MXTPU_CKPT_SHARDED=1
        print("dist_zero3 rank %d/%d: SAVED at step %d"
              % (rank, world, SAVE_AT), flush=True)
        t.step(*data[SAVE_AT])
        os.kill(os.getpid(), signal.SIGKILL)
    mx.random.seed(99)          # the resume must not lean on ambient state
    assert t.restore(mgr) == SAVE_AT
    for x, y in data[SAVE_AT:]:
        t.step(x, y)
    print("dist_zero3 rank %d/%d: OK resume digest=%s"
          % (rank, world, digest(*t.get_params())), flush=True)


def _preempt(mx, phase, rank, world):
    rs = np.random.RandomState(4)
    X = rs.randn(BATCH * 8, 10).astype("f")
    y = rs.randint(0, 4, BATCH * 8).astype("f")
    it = mx.io.NDArrayIter(X[rank::world], y[rank::world],
                           batch_size=BATCH // world)
    if phase == "preempt_kill" and rank == 1:
        # SIGTERM to rank 1 alone, at its fourth step boundary of the
        # second epoch
        mx.resilience.faults.arm("preempt", times=1, after=8 + 3)
    mod = mx.mod.Module(mlp(mx))
    mx.random.seed(21)
    mod.fit(it, num_epoch=2, kvstore="tpu", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.initializer.Xavier(),
            checkpoint=os.environ["DRILL_DIR"], preemption_safe=True)
    assert mod._fused is not None
    print("dist_preempt rank %d/%d: OK %s digest=%s"
          % (rank, world, phase, digest(*mod.get_params())), flush=True)


def _xpkg(mx, phase, rank, world):
    """Restore the JAX package's sharded blobs (or write the port's)."""
    mesh = mx.parallel.local_mesh()
    d = os.environ["DRILL_DIR"]
    t = _trainer(mx, "zero3", mesh, world)
    mgr = mx.resilience.CheckpointManager(d)
    if phase == "xpkg_read":
        t.restore(mgr)
    else:
        for x, y in stream():
            t.step(x[rank::world], y[rank::world])
        t.save_checkpoint(mgr, STEPS)          # MXTPU_CKPT_SHARDED=1
    arg, aux = t.get_params()
    if rank == 0:
        np.savez(os.path.join(d, "port_%s.npz" % phase),
                 **{k: v.asnumpy() for k, v in arg.items()})
    print("dist_xpkg rank %d/%d: OK %s digest=%s"
          % (rank, world, phase, digest(arg, aux)), flush=True)


def worker(phase):
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import distributed
    rank, world = distributed.rank(), distributed.num_workers()
    if phase.startswith("zero3"):
        _zero3(mx, phase, rank, world)
    elif phase.startswith("preempt"):
        _preempt(mx, phase, rank, world)
    elif phase.startswith("xpkg"):
        _xpkg(mx, phase, rank, world)
    else:
        raise SystemExit("unknown phase %r" % phase)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _digests(pattern, out, n=2):
    got = set()
    for r in range(n):
        m = re.search(pattern % (r, n), out)
        assert m, out[-4000:]
        got.add(m.group(1))
    assert len(got) == 1, got
    return got.pop()


def test_zero3_bitwise_sigkill_resume(tmp_path):
    env = {"DRILL_DIR": str(tmp_path / "ckpt"), "MXTPU_CKPT_SHARDED": "1"}
    res = launch(2, "zero3_baseline", env)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    base = _digests(r"rank %d/%d: OK baseline zero3==allreduce bitwise "
                    r"digest=(\w+)", res.stdout)
    res = launch(2, "zero3_kill", env)
    assert res.returncode != 0                  # SIGKILL propagated
    for r in range(2):
        assert "rank %d/2: SAVED at step 3" % r in res.stdout, \
            res.stdout[-4000:]
    names = os.listdir(env["DRILL_DIR"])
    assert "checkpoint-0003.params.s001-of-002" in names, names
    res = launch(2, "zero3_resume", env)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    assert _digests(r"rank %d/%d: OK resume digest=(\w+)",
                    res.stdout) == base


def test_preemption_agreement(tmp_path):
    res = launch(2, "preempt_baseline",
                 {"DRILL_DIR": str(tmp_path / "base")})
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    base = _digests(r"rank %d/%d: OK preempt_baseline digest=(\w+)",
                    res.stdout)
    env = {"DRILL_DIR": str(tmp_path / "ckpt")}
    res = launch(2, "preempt_kill", env)
    assert res.returncode != 0
    saved = re.findall(r"\[worker (\d)\].*preemption: saved mid-epoch "
                       r"checkpoint \(epoch (\d+), step (\d+)\)", res.stdout)
    # both ranks saved, at the same boundary (rank 1 alone was signaled)
    assert sorted(w for w, _, _ in saved) == ["0", "1"], res.stdout[-4000:]
    assert len({(e, s) for _, e, s in saved}) == 1
    assert saved[0][1:] == ("1", "4")
    env["MXTPU_RESUME"] = "1"
    res = launch(2, "preempt_resume", env)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    assert _digests(r"rank %d/%d: OK preempt_resume digest=(\w+)",
                    res.stdout) == base


def _jax_zero3(world):
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import SPMDTrainer, build_mesh
    mesh = build_mesh({"dp": world}, jax.devices()[:world]) \
        if world > 1 else None
    tr = SPMDTrainer(mlp(jmx), "sgd", {"learning_rate": 0.3,
                                       "momentum": 0.9,
                                       "rescale_grad": 1.0 / BATCH},
                     mesh=mesh, grad_sync="zero3")
    tr.bind([("data", (BATCH, 10))], [("softmax_label", (BATCH,))])
    jmx.random.seed(33)
    tr.init_params(jmx.initializer.Xavier())
    return tr


def _host(arg):
    return {k: v.asnumpy() for k, v in arg.items()}


def test_sharded_checkpoints_cross_the_packages(tmp_path, monkeypatch):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    monkeypatch.setenv("MXTPU_CKPT_SHARDED", "1")
    # the JAX package writes at two devices ...
    jdir = str(tmp_path / "from_jax")
    tr = _jax_zero3(2)
    for x, y in stream():
        tr.step(x, y)
    tr.save_checkpoint(jmx.resilience.CheckpointManager(jdir), STEPS)
    want = _host(tr.get_params()[0])
    tr.close()
    assert "checkpoint-0006.params.s001-of-002" in os.listdir(jdir)
    # ... the port's two ranks restore it
    res = launch(2, "xpkg_read", {"DRILL_DIR": jdir,
                                  "MXTPU_CKPT_SHARDED": "1"})
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    got = dict(np.load(os.path.join(jdir, "port_xpkg_read.npz")))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # ... and so does one port device
    one = tmx.parallel.SPMDTrainer(mlp(tmx), "sgd", {}, ctx=tmx.cpu())
    one.bind([("data", (BATCH, 10))], [("softmax_label", (BATCH,))])
    one.init_params(tmx.initializer.Xavier())
    assert one.restore(tmx.resilience.CheckpointManager(jdir)) == STEPS
    for k, v in _host(one.get_params()[0]).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    # the port's ranks write; the JAX package restores at 2 and at 1
    pdir = str(tmp_path / "from_port")
    res = launch(2, "xpkg_write", {"DRILL_DIR": pdir,
                                   "MXTPU_CKPT_SHARDED": "1"})
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    assert "checkpoint-0006.params.s001-of-002" in os.listdir(pdir)
    port = dict(np.load(os.path.join(pdir, "port_xpkg_write.npz")))
    for world in (2, 1):
        tr = _jax_zero3(world)
        assert tr.restore(jmx.resilience.CheckpointManager(pdir)) == STEPS
        for k, v in _host(tr.get_params()[0]).items():
            np.testing.assert_array_equal(v, port[k], err_msg=k)
        tr.close()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(sys.argv[2])
