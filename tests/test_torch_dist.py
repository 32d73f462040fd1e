"""Multi-process drills of the port under ``tools/launch.py --platform
cpu`` (the counterparts of tests/test_dist.py and tests/dist/*.py): this
file run as a script is the worker (``python tests/test_torch_dist.py
--worker <phase>``), so pytest collects no worker.

- the dist_sync kvstore at 2 and 3 ranks: the closed form of the
  reference's nightly test (rank-dependent pushes summed, a big key,
  string and list keys, multi-copy pushes, rank 0's init broadcast);
- ``Module.fit`` with ``kvstore='tpu'`` (the fused step over the ``dp``
  mesh) and ``'dist_sync'`` (the executor route with the collective
  store): identical weights on every rank and a separable problem
  learned;
- the launcher propagating a failing worker;
- dead-node detection: a rank that stops its heartbeat is counted dead
  by ``get_num_dead_node``; ages are observer-side (a unit test with a
  fake store client, as tests/test_dist.py's);
- in one process, ``Module`` over two contexts (the executor group
  slices the batch and sums the gradients through the local store)
  against the JAX package's over two devices.

Every subprocess carries a timeout.
"""
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LAUNCH = os.path.join(REPO, "tools", "launch.py")
TIMEOUT = 240


def launch(n, phase, env=None, timeout=TIMEOUT):
    """``tools/launch.py -n n --platform cpu python this_file --worker
    phase`` with a clean environment; returns the CompletedProcess."""
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


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def _kvstore(mx, rank, nworker):
    keys, rate, shape, big = [3, 5, 7], 2, (2, 2), (1200, 1200)
    kv = mx.kv.create("dist_sync")
    assert (kv.rank, kv.num_workers) == (rank, nworker)
    kv.init(keys, [mx.nd.ones(shape)] * len(keys))
    kv.init(99, mx.nd.ones(big))
    kv.init("str_key", mx.nd.ones(shape))

    def updater(key, g, w):
        w += rate * g      # the reference's 'test' optimizer

    kv._set_updater(updater)
    nrepeat = 3
    for _ in range(nrepeat):
        kv.push(3, mx.nd.ones(shape) * (rank + 1))
        kv.push(99, mx.nd.ones(big) * (rank + 1))
        kv.push("str_key", mx.nd.ones(shape) * (rank + 1))
        kv.push(5, [mx.nd.ones(shape) * (rank + 1) * 0.5] * 2)
    num = (nworker + 1) * nworker * rate / 2 * nrepeat + 1
    for key, shp in ((3, shape), (99, big), ("str_key", shape), (5, shape)):
        val = mx.nd.zeros(shp)
        kv.pull(key, out=val)
        np.testing.assert_array_equal(val.asnumpy(),
                                      np.full(shp, num, "f"))
    kv.init(11, mx.nd.ones(shape) * (rank + 41))
    val = mx.nd.zeros(shape)
    kv.pull(11, out=val)
    np.testing.assert_array_equal(val.asnumpy(), np.full(shape, 41, "f"))
    kv.barrier()
    print("dist_sync_kvstore rank %d/%d: OK" % (rank, nworker), flush=True)


def _fit(mx, rank, nworker, kind):
    from mxnet_tpu_torch import distributed
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    rs = np.random.RandomState(0)
    X = rs.randn(512, 20).astype("f")
    y = X.dot(rs.randn(20, 3).astype("f")).argmax(axis=1).astype("f")
    it = mx.io.NDArrayIter(X[rank::nworker], y[rank::nworker],
                           batch_size=32)
    mod = mx.mod.Module(net)
    mx.random.seed(5)
    mod.fit(it, num_epoch=6, kvstore=kind, optimizer="sgd",
            optimizer_params={"learning_rate": 0.2, "momentum": 0.9})
    assert (mod._fused is not None) == (kind == "tpu"), kind
    arg, _ = mod.get_params()
    coll = distributed.Collective()
    for name in sorted(arg):
        mine = arg[name]._data
        theirs = coll.broadcast(mine.clone(), root=0)
        assert bool((mine == theirs).all()), name
    acc = dict(mod.score(mx.io.NDArrayIter(X, y, batch_size=64), "acc"))
    assert acc["accuracy"] > 0.9, acc
    print("dist_module_fit %s rank %d/%d: OK acc=%.3f"
          % (kind, rank, nworker, acc["accuracy"]), flush=True)


def _dead_node(mx, rank, nworker):
    from mxnet_tpu_torch import distributed
    distributed.HEARTBEAT_INTERVAL = 0.3
    kv = mx.kv.create("tpu")
    assert nworker == 3 and distributed.heartbeat_supported()
    time.sleep(0.6)
    distributed.barrier("hb_started")
    if rank == 2:
        distributed.stop_heartbeat()
        time.sleep(6.0)
        print("dist_dead_node rank 2/3: OK (went silent)", flush=True)
        return
    assert kv.get_num_dead_node(timeout=60) == 0
    if rank == 0:
        deadline = time.time() + 20
        dead = 0
        while time.time() < deadline:
            dead = kv.get_num_dead_node(timeout=2)
            if dead == 1:
                break
            time.sleep(0.5)
        assert dead == 1, "dead=%d" % dead
        ages = distributed.heartbeat_ages()
        assert ages[2] is None or ages[2] > 2, ages
        assert ages[0] is not None and ages[0] < 2, ages
    time.sleep(1.0)
    print("dist_dead_node rank %d/3: OK" % rank, flush=True)


def worker(phase):
    sys.path.insert(0, REPO)
    if phase == "fail":
        sys.exit(3)
    import torch
    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import distributed
    rank, nworker = distributed.rank(), distributed.num_workers()
    assert distributed.backend() == "gloo"
    assert mx.current_context() == mx.cpu()
    if phase == "kvstore":
        _kvstore(mx, rank, nworker)
    elif phase in ("fit_tpu", "fit_dist_sync"):
        _fit(mx, rank, nworker, phase[4:])
    elif phase == "dead_node":
        _dead_node(mx, rank, nworker)
    else:
        raise SystemExit("unknown phase %r" % phase)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nworkers", [2, 3])
def test_dist_sync_kvstore(nworkers):
    res = launch(nworkers, "kvstore")
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    for r in range(nworkers):
        assert "dist_sync_kvstore rank %d/%d: OK" % (r, nworkers) \
            in res.stdout


@pytest.mark.parametrize("kind", ["tpu", "dist_sync"])
def test_dist_module_fit(kind):
    res = launch(2, "fit_" + kind)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    for r in range(2):
        assert "dist_module_fit %s rank %d/2: OK" % (kind, r) in res.stdout
    # each rank joined over gloo on the host and said so
    assert len(re.findall(r"rank \d/2 on cpu over gloo", res.stdout)) == 2


def test_launcher_propagates_failure():
    res = launch(2, "fail", timeout=120)
    assert res.returncode != 0
    assert "workers failed" in res.stderr


def test_dist_dead_node_detection():
    res = launch(3, "dead_node")
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    assert "dist_dead_node rank 0/3: OK" in res.stdout
    assert "rank 2/3: OK (went silent)" in res.stdout


def test_heartbeat_ages_observer_side(monkeypatch):
    """Liveness is measured on the observer's monotonic clock from the
    moment a stamp last changed, never from a remote wall clock."""
    from mxnet_tpu_torch import distributed as dist

    stamps = {0: "1.0"}

    class FakeClient:
        def key_value_try_get(self, key):
            r = int(key.rsplit("/", 1)[-1])
            if r not in stamps:
                raise KeyError(key)
            return stamps[r]

    client = FakeClient()
    monkeypatch.setattr(dist, "_kv_client", lambda: client)
    monkeypatch.setattr(dist, "num_workers", lambda: 2)
    monkeypatch.setattr(dist, "_HB_OBSERVED", {})
    monkeypatch.setattr(dist, "_HB_CLIENT", None)
    ages = dist.heartbeat_ages()
    assert ages[0] is None and ages[1] is None
    assert dist.num_dead_nodes(timeout=60) == 0
    time.sleep(0.05)
    assert dist.heartbeat_ages()[0] is None
    assert dist.num_dead_nodes(timeout=0.04) == 1
    assert dist.num_dead_nodes(timeout=60) == 0
    stamps[0] = "2.0"
    assert dist.heartbeat_ages()[0] < 0.05
    time.sleep(0.05)
    assert 0.05 <= dist.heartbeat_ages()[0] < 5.0
    assert dist.num_dead_nodes(timeout=0.04) == 1
    client2 = FakeClient()
    monkeypatch.setattr(dist, "_kv_client", lambda: client2)
    assert dist.heartbeat_ages()[0] is None
    assert dist.num_dead_nodes(timeout=60) == 0


def test_module_over_two_contexts_matches_jax():
    """One process, two contexts, kvstore 'local': the executor group
    binds one executor a context over half the batch and the Module sums
    their gradients through the store — the JAX package's executor group
    over two devices.  rtol 1e-5, atol 1e-6 (float32, the halves' sums
    in another order)."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    rs = np.random.RandomState(1)
    X = rs.randn(64, 10).astype("f")
    y = rs.randint(0, 3, 64).astype("f")
    rs = np.random.RandomState(2)
    w = {"fc1_weight": (0.3 * rs.randn(16, 10)).astype("f"),
         "fc1_bias": np.zeros(16, "f"),
         "fc2_weight": (0.3 * rs.randn(3, 16)).astype("f"),
         "fc2_bias": np.zeros(3, "f")}
    got = []
    for mx in (jmx, tmx):
        data = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
        net = mx.sym.SoftmaxOutput(net, name="softmax")
        mod = mx.mod.Module(net, context=[mx.cpu(0), mx.cpu(1)])
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=16), num_epoch=2,
                kvstore="local", arg_params={
                    k: mx.nd.array(v, ctx=mx.cpu()) for k, v in w.items()},
                optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        assert len(mod._exec_group.execs) == 2
        got.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    for k in w:
        np.testing.assert_allclose(got[1][k], got[0][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(sys.argv[2])
