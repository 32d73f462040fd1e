"""The port's resilience layer (``mxnet_tpu_torch/resilience.py`` and its
users) on the CPU, against the JAX package's where both compute the same
thing: atomic writes, ``CheckpointManager`` (manifest, checksums,
retention with tombstones, the corrupt-manifest scan, verified restore
with walk-back, ring replicas, the sharded-native layout), async saves,
the fused step's guard under the ``poison_grad`` fault, ``fit``'s managed
checkpoints and resume, deferred on-device metrics, the input path's
fault points, ``verify_promotion`` and ``tools/ckpt_fsck.py``.

Cross-package checks: the same numpy values written by each package's
manager give equal ``.params`` and states bytes and manifest entries with
the same keys and digests; an epoch-end checkpoint restores in the other
package; both ``verify_promotion``s and ``ckpt_fsck`` agree on damaged
directories; the fault grammars parse alike; crc32c agrees; ``Accuracy``
deferred equals blocking and the JAX package's.  Tolerances: exact
everywhere (integer counts, copied bytes, the same float32 arithmetic
on the same path).
"""
import json
import os
import pickle
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import (CheckpointManager, FaultInjector,
                                        TransientError, atomic_write,
                                        verify_promotion)

pytestmark = pytest.mark.resilience

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FSCK = os.path.join(REPO, "tools", "ckpt_fsck.py")


@pytest.fixture
def port_faults():
    """Disarm every fault point of the port's injector around the test
    (the JAX package's ``clean_faults`` disarms only its own)."""
    from mxnet_tpu_torch.resilience import faults
    faults.disarm()
    yield faults
    faults.disarm()


def make_blobs(n, d, c, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(c, d) * 3
    X = np.concatenate([centers[i] + rs.randn(n // c, d)
                        for i in range(c)]).astype("f")
    y = np.concatenate([np.full(n // c, i) for i in range(c)]).astype("f")
    perm = rs.permutation(len(X))
    return X[perm], y[perm]


def mlp_sym(mx=tmx, num_classes=3, nh=16, dropout=0.0):
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(data, num_hidden=nh, name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        if dropout:
            net = mx.sym.Dropout(net, p=dropout)
        net = mx.sym.FullyConnected(net, num_hidden=num_classes, name="fc2")
        return mx.sym.SoftmaxOutput(net, name="softmax")


def P(x):
    """A host NDArray of the port."""
    return tmx.nd.array(np.asarray(x, dtype="f"), ctx=tmx.cpu())


def J(x):
    return jmx.nd.array(np.asarray(x, dtype="f"))


def _flip_payload_byte(path, value):
    """Flip one mantissa bit of the float32 payload ``value``: the file
    still parses (only the checksum catches it)."""
    pat = struct.pack("<f", float(value)) * 2
    blob = bytearray(open(path, "rb").read())
    i = bytes(blob).find(pat)
    assert i >= 0, "float payload %r not found in %s" % (value, path)
    blob[i] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(blob))


def _run_fsck(directory, *args):
    return subprocess.run([sys.executable, FSCK, str(directory), *args],
                          capture_output=True, text=True, timeout=120)


# ---------------------------------------------------------------------------
# fault grammars and checksums: parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env", ["iter_next:2, checkpoint_write",
                                 "hang_step:1@2, iter_next:3",
                                 "preempt:1@5,data_worker", "", "a:0"])
def test_fault_env_grammar_matches_jax(monkeypatch, env):
    monkeypatch.setenv("MXTPU_FAULTS", env)
    j, t = jmx.resilience.FaultInjector(), FaultInjector()
    assert t._armed == j._armed
    points = sorted({p.split("/")[0] for p in j._armed}) or ["x"]
    for point in points:
        assert [t.consume(point) for _ in range(5)] == \
            [j.consume(point) for _ in range(5)], point
    assert tmx.resilience.strip_faults_env(env, ["iter_next"]) == \
        jmx.resilience.strip_faults_env(env, ["iter_next"])
    env2 = {"MXTPU_FAULTS": env, "OTHER": "1"}
    assert tmx.resilience.region_faults_env(env2, ["a:1"]) == \
        jmx.resilience.region_faults_env(env2, ["a:1"])


@pytest.mark.parametrize("text", [
    "9 rot trainer shard#1\n", "1 kill data#0, 2 resize trainer 4",
    "0.5 arm trainer rot_checkpoint:1@2  # comment\n3 kill replica#1",
    "9 rot trainer", "9 rot trainer shard1", "9 rot trainer shard#",
    "9 rot trainer shard#1 extra", "x kill a", "1 nuke a", "1 resize t 0",
    "1 arm t :1", "1 kill a b"])
def test_parse_fault_schedule_matches_jax(text):
    def parse(mod):
        try:
            return [(e.at_s, e.action, e.target, e.arg, e.label)
                    for e in mod.parse_fault_schedule(text)]
        except Exception as e:  # noqa: BLE001 — compared across packages
            return type(e).__name__
    got, want = parse(tmx.resilience), parse(jmx.resilience)
    assert got == want
    if isinstance(want, str):
        assert want == "MXNetError"


def test_checksums_match_jax_and_fsck(tmp_path, monkeypatch):
    """crc32c/crc32/sha256 of fixed bytes equal the JAX package's and
    ckpt_fsck's (both duplicate the code), and known vectors hold."""
    import importlib.util
    from mxnet_tpu_torch.resilience import checksum_bytes, checksum_file
    assert checksum_bytes(b"hello", "crc32c") == (5, "9a71bb4c")
    assert checksum_bytes(b"hello", "crc32") == (5, "3610a686")
    assert checksum_bytes(b"hello", "off") == (5, None)
    sample = tmp_path / "sample.bin"
    sample.write_bytes(bytes(range(256)) * 41)
    spec = importlib.util.spec_from_file_location("ckpt_fsck_t", FSCK)
    fsck = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fsck)
    for algo in ("sha256", "crc32", "crc32c", "off"):
        data = bytes(range(256)) * 3 + b"mxnet"
        assert checksum_bytes(data, algo) == \
            jmx.resilience.checksum_bytes(data, algo), algo
        if algo != "off":
            assert checksum_file(str(sample), algo) == \
                fsck.checksum_file(str(sample), algo), algo
    # the selector routes through the manifest; a typo degrades to sha256
    monkeypatch.setenv("MXTPU_CKPT_CHECKSUM", "crc32c")
    man = CheckpointManager(str(tmp_path / "c"))
    man.save(1, None, {"w": P(np.ones(2))}, {})
    entry = man.latest_entry()
    assert entry["checksum"] == "crc32c"
    assert len(entry["files"]["checkpoint-0001.params"]["digest"]) == 8
    man.restore()
    monkeypatch.setenv("MXTPU_CKPT_CHECKSUM", "md5oops")
    man.save(2, None, {"w": P(np.ones(2))}, {})
    assert man.latest_entry()["checksum"] == "sha256"


# ---------------------------------------------------------------------------
# atomic writes and the CheckpointManager
# ---------------------------------------------------------------------------

def test_atomic_write_and_kvstore_states_never_tear(tmp_path, port_faults):
    target = tmp_path / "f.json"
    atomic_write(str(target), "old")
    port_faults.arm("checkpoint_write")
    with pytest.raises(TransientError):
        atomic_write(str(target), "new")
    assert target.read_text() == "old"
    assert list(tmp_path.iterdir()) == [target]  # temp cleaned up
    kv = tmx.kv.create("local")
    kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1,
                                          momentum=0.9))
    kv.init(0, P(np.ones((4, 3))))
    kv.push(0, [P(np.full((4, 3), 0.5))])
    fname = str(tmp_path / "opt.states")
    kv.save_optimizer_states(fname)
    old_bytes = (tmp_path / "opt.states").read_bytes()
    kv.push(0, [P(np.full((4, 3), 0.25))])
    port_faults.arm("checkpoint_write")
    with pytest.raises(TransientError):
        kv.save_optimizer_states(fname)
    assert (tmp_path / "opt.states").read_bytes() == old_bytes
    kv.load_optimizer_states(fname)


def test_checkpoint_crash_mid_write_keeps_previous(tmp_path, port_faults):
    man = CheckpointManager(str(tmp_path), keep_last=3)
    man.save(1, mlp_sym(), {"w": P(np.ones((3, 2)))}, {})
    old_bytes = (tmp_path / "checkpoint-0001.params").read_bytes()
    port_faults.arm("checkpoint_write")
    with pytest.raises(TransientError):
        man.save(2, None, {"w": P(np.full((3, 2), 7))}, {})
    assert (tmp_path / "checkpoint-0001.params").read_bytes() == old_bytes
    assert not (tmp_path / "checkpoint-0002.params").exists()
    assert man.latest() == 1
    sym, args, _, states, epoch = man.restore()
    assert epoch == 1 and sym is not None and states is None
    assert args["w"].context == tmx.cpu()
    assert np.allclose(args["w"].asnumpy(), 1.0)
    man.save(2, None, {"w": P(np.full((3, 2), 7))}, {})
    assert man.latest() == 2
    assert np.allclose(man.restore()[1]["w"].asnumpy(), 7.0)


def test_retention_scan_and_step_state(tmp_path):
    """keep_last retention, the corrupt-manifest directory scan (repaired
    in place), step_state riding an entry until the epoch-end save of the
    same number replaces it, and do_checkpoint over a manager."""
    man = CheckpointManager(str(tmp_path / "r"), keep_last=2)
    for epoch in range(1, 5):
        man.save(epoch, mlp_sym(), {"w": P(np.full((2,), epoch))}, {},
                 optimizer_states=b"state-%d" % epoch)
    assert man.checkpoints() == [3, 4]
    assert not (tmp_path / "r" / "checkpoint-0001.params").exists()
    assert not (tmp_path / "r" / "checkpoint-0002.states").exists()
    mpath = tmp_path / "r" / "manifest.json"
    mpath.write_bytes(mpath.read_bytes()[: len(mpath.read_bytes()) // 2])
    man2 = CheckpointManager(str(tmp_path / "r"))
    assert man2.checkpoints() == [3, 4]
    assert [e["epoch"] for e in
            json.loads(mpath.read_text())["checkpoints"]] == [3, 4]
    _, args, _, states, epoch = man2.restore()
    assert epoch == 4 and states == b"state-4"
    assert np.allclose(args["w"].asnumpy(), 4.0)

    man = CheckpointManager(str(tmp_path / "s"))
    st = {"epoch": 1, "step": 3, "rng": tmx.random.get_state()}
    man.save(2, None, {"w": P(np.ones(2))}, {}, step_state=st)
    entry = man.latest_entry()
    assert entry["epoch"] == 2 and entry["step_state"] == \
        json.loads(json.dumps(st))
    man.save(2, None, {"w": P(np.full((2,), 5))}, {})
    assert "step_state" not in man.latest_entry()

    man = CheckpointManager(str(tmp_path / "cb"), keep_last=2)
    cb = tmx.callback.do_checkpoint(man, period=2)
    for iter_no in range(4):
        cb(iter_no, mlp_sym(), {"w": P(np.full((2,), iter_no))}, {})
    assert man.checkpoints() == [2, 4]


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "all", "symbol",
                                    "deleted"])
def test_restore_walks_back_past_damage(tmp_path, damage):
    man = CheckpointManager(str(tmp_path))
    for epoch in (1, 2, 3):
        man.save(epoch, mlp_sym() if damage == "symbol" else None,
                 {"w": P(np.full((2,), epoch))}, {})
    p3 = tmp_path / "checkpoint-0003.params"
    if damage == "truncate":
        p3.write_bytes(p3.read_bytes()[: len(p3.read_bytes()) // 2])
    elif damage == "bitflip":
        _flip_payload_byte(str(p3), 3)
        assert tmx.nd.load(str(p3))  # still parses: only the digest knows
    elif damage == "all":
        for e in (1, 2, 3):
            (tmp_path / ("checkpoint-%04d.params" % e)).write_bytes(
                b"\x00" * 16)
        with pytest.raises(MXNetError, match="unreadable"):
            man.restore()
        return
    elif damage == "symbol":
        path = tmp_path / "checkpoint-symbol.json"
        path.write_bytes(path.read_bytes().replace(b"fc1", b"fc9", 1))
        json.loads(path.read_text())
        # the shared symbol is verified against the newest record for
        # every epoch: the walk-back must not reach an unverified one
        for epoch in (None, 1):
            with pytest.raises(MXNetError, match="verification"):
                man.restore(epoch)
        return
    elif damage == "deleted":
        os.remove(str(p3))
        assert CheckpointManager(str(tmp_path)).checkpoints() == [1, 2]
        assert man.entry(3) is not None
    _, args, _, _, epoch = man.restore()
    assert epoch == 2 and np.allclose(args["w"].asnumpy(), 2.0)
    if damage != "deleted":
        assert man.latest() == 3
        with pytest.raises(Exception):
            man.restore(3)
        _, problems = verify_promotion(str(tmp_path))
        assert problems


def test_manifest_records_file_checksums(tmp_path):
    man = CheckpointManager(str(tmp_path))
    man.save(1, mlp_sym(), {"w": P(np.ones((3, 2)))}, {},
             optimizer_states=b"state-1")
    entry = man.latest_entry()
    assert entry["checksum"] == "sha256"
    assert set(entry["files"]) == {"checkpoint-0001.params",
                                   "checkpoint-0001.states",
                                   "checkpoint-symbol.json"}
    for name, rec in entry["files"].items():
        assert tmx.resilience.checksum_file(str(tmp_path / name)) == \
            (rec["size"], rec["digest"]), name


# ---------------------------------------------------------------------------
# cross-package checkpoints
# ---------------------------------------------------------------------------

def _same_values(seed=3):
    rs = np.random.RandomState(seed)
    args = {"fc1_weight": rs.randn(16, 10).astype("f"),
            "fc1_bias": rs.randn(16).astype("f"),
            "fc2_weight": rs.randn(3, 16).astype("f"),
            "fc2_bias": rs.randn(3).astype("f")}
    aux = {"bn_moving_mean": rs.randn(4).astype("f")}
    states = pickle.dumps({"num_update": 7, "states": {
        k: (rs.randn(*v.shape).astype("f"),) for k, v in args.items()}})
    return args, aux, states


@pytest.mark.parametrize("algo", ["sha256", "crc32c"])
def test_manager_bytes_and_manifest_equal_across_packages(tmp_path,
                                                          monkeypatch, algo):
    monkeypatch.setenv("MXTPU_CKPT_CHECKSUM", algo)
    args, aux, states = _same_values()
    dirs = {}
    for name, mx, arr in (("jax", jmx, J), ("port", tmx, P)):
        d = tmp_path / name
        man = mx.resilience.CheckpointManager(str(d), keep_last=2)
        for epoch in (1, 2, 3):
            man.save(epoch, mlp_sym(mx), {k: arr(v) for k, v in
                                          args.items()},
                     {k: arr(v) for k, v in aux.items()},
                     optimizer_states=states,
                     step_state={"epoch": epoch - 1, "step": 2,
                                 "rng": {"x": 1}} if epoch == 3 else None)
        dirs[name] = d
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"]))
    for n in names:
        if n != "manifest.json":
            assert (dirs["jax"] / n).read_bytes() == \
                (dirs["port"] / n).read_bytes(), n
    mj, mt = (json.loads((dirs[k] / "manifest.json").read_text())
              for k in ("jax", "port"))
    assert mj["prefix"] == mt["prefix"]
    assert len(mj["checkpoints"]) == len(mt["checkpoints"]) == 2
    for ej, et in zip(mj["checkpoints"], mt["checkpoints"]):
        assert set(ej) == set(et)
        for k in ej:
            if k not in ("time",):
                assert ej[k] == et[k], k
    # the states layout is the trainers' shared pickle
    got = pickle.loads((dirs["port"] / "checkpoint-0003.states")
                       .read_bytes())
    assert got["num_update"] == 7 and set(got["states"]) == set(args)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_epoch_end_checkpoint_crosses_packages(tmp_path, direction):
    """An epoch-end checkpoint written by fit(checkpoint=) in one package
    restores in the other's manager and SPMDTrainer to the same arrays,
    epoch and optimizer state."""
    X, y = make_blobs(128, 10, 3, seed=4)
    src, dst = (jmx, tmx) if direction == "jax_to_port" else (tmx, jmx)
    d = str(tmp_path / "ck")
    kw = {} if src is jmx else {"context": tmx.cpu()}
    mod = src.mod.Module(mlp_sym(src), **kw)
    src.random.seed(5)
    mod.fit(src.io.NDArrayIter(X, y, batch_size=32), num_epoch=2,
            kvstore="tpu", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=src.initializer.Xavier(), checkpoint=d)
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    man = dst.resilience.CheckpointManager(d)
    assert man.latest() == 2
    _, got, _, states, epoch = man.restore()
    assert epoch == 2
    for k in want:
        assert np.array_equal(got[k].asnumpy(), want[k]), k
    kw = {} if dst is jmx else {"ctx": tmx.cpu()}
    tr = dst.parallel.SPMDTrainer(mlp_sym(dst), "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9},
                                  **kw)
    tr.bind([("data", (32, 10))], [("softmax_label", (32,))])
    tr.init_params(dst.initializer.Xavier())
    assert tr.restore(man) == 2
    assert tr._num_update == 8
    params = tr.get_params()[0]
    for k in want:
        assert np.array_equal(params[k].asnumpy(), want[k]), k
    assert set(pickle.loads(states)["states"]) == set(want)


def _damaged_dir(mx, root, case):
    """One damaged checkpoint directory, the same damage for both
    packages' writers: rot or truncate the newest params, drop one shard
    blob, or tear the manifest (the scan rebuild)."""
    d = root / case
    man = mx.resilience.CheckpointManager(str(d))
    arr = J if mx is jmx else P
    if case == "drop_shard":
        payloads = _sharded_payloads
        man.save_sharded(1, mlp_sym(mx), payloads(1, 3), world=3)
        man.save_sharded(2, None, payloads(2, 3, base=5.0), world=3)
        os.remove(str(d / man.shard_blob_name(2, 1, 3)))
        return d
    for epoch in (1, 2):
        man.save(epoch, mlp_sym(mx), {"w": arr(np.full((4,), epoch))}, {},
                 optimizer_states=b"opt")
    p2 = d / "checkpoint-0002.params"
    if case == "rot":
        _flip_payload_byte(str(p2), 2)
    elif case == "truncate":
        p2.write_bytes(p2.read_bytes()[: len(p2.read_bytes()) // 2])
    elif case == "scan_rebuild":
        (d / "manifest.json").write_text("{ torn")
    return d


@pytest.mark.parametrize("case", ["clean", "rot", "truncate", "drop_shard",
                                  "scan_rebuild"])
def test_damaged_directory_verdicts_agree(tmp_path, case):
    """verify_promotion of both packages and ckpt_fsck's promote gate give
    the same verdict on the same damage, and ckpt_fsck's audit fails it."""
    for name, mx in (("jax", jmx), ("port", tmx)):
        d = _damaged_dir(mx, tmp_path / name, case)
        verdicts = [m.resilience.verify_promotion(str(d))
                    for m in (jmx, tmx)]
        assert verdicts[0] == verdicts[1], (name, verdicts)
        epoch, problems = verdicts[1]
        assert epoch == 2
        assert bool(problems) == (case != "clean")
        gate = _run_fsck(d, "--promote-gate")
        doc = json.loads(gate.stdout)
        assert gate.returncode == (0 if case == "clean" else 1)
        assert doc["problems"] == problems and doc["epoch"] == epoch
        audit = _run_fsck(d, "-q")
        assert audit.returncode == (1 if case in ("rot", "truncate",
                                                  "drop_shard") else 0), \
            audit.stdout + audit.stderr
        # restore walks back to the last complete verified epoch
        assert tmx.resilience.CheckpointManager(str(d)).restore()[4] == \
            (1 if case in ("rot", "truncate", "drop_shard") else 2)


# ---------------------------------------------------------------------------
# async saves
# ---------------------------------------------------------------------------

def test_async_save_parity_and_wait(tmp_path):
    w = np.random.RandomState(0).randn(8, 4).astype("f")
    mb = CheckpointManager(str(tmp_path / "block"))
    ma = CheckpointManager(str(tmp_path / "async"))
    mb.save(1, mlp_sym(), {"w": P(w)}, {}, optimizer_states=b"st")
    ma.save(1, mlp_sym(), {"w": P(w)}, {}, optimizer_states=b"st",
            blocking=False)
    res = ma.wait()
    assert res["error"] is None and res["label"] == "epoch 1"
    assert ma.last_result()["error"] is None
    assert (tmp_path / "block" / "checkpoint-0001.params").read_bytes() \
        == (tmp_path / "async" / "checkpoint-0001.params").read_bytes()
    _, args, _, states, epoch = ma.restore()
    assert epoch == 1 and states == b"st"
    assert np.array_equal(args["w"].asnumpy(), w)


def test_async_snapshot_isolated_from_mutation(tmp_path, port_faults):
    """The values handed to an async save are frozen at the call: an
    in-place write into the NDArray's storage, a handle swap and a new
    trainer tensor after it must not reach the file."""
    import torch
    w = P(np.zeros((4, 4)))
    v = P(np.zeros((4, 4)))
    t = torch.zeros(3)
    man = CheckpointManager(str(tmp_path))
    port_faults.arm_hang("ckpt_write", seconds=0.2)  # hold the writer
    man.save(1, None, {"w": w, "v": v, "t": t}, {}, blocking=False)
    w[:] = 7.0          # in place, into the storage
    v += 5.0            # a handle swap
    t.add_(3.0)
    man.wait()
    _, args, _, _, _ = man.restore()
    for k in ("w", "v", "t"):
        assert not args[k].asnumpy().any(), k


def test_async_save_failure_surfaces_at_next_call(tmp_path, port_faults):
    man = CheckpointManager(str(tmp_path))
    man.save(1, None, {"w": P(np.ones(2))}, {})
    port_faults.arm("ckpt_write")
    man.save(2, None, {"w": P(np.full((2,), 2))}, {}, blocking=False)
    with pytest.raises(MXNetError, match="background write"):
        man.wait()
    assert man.latest() == 1
    assert man.last_result()["error"] is not None
    man.save(3, None, {"w": P(np.full((2,), 3))}, {}, blocking=False)
    man.wait()
    assert man.latest() == 3


def test_blocking_save_drains_inflight_async_write(tmp_path):
    man = CheckpointManager(str(tmp_path))
    man.save(1, None, {"w": P(np.ones(2))}, {}, blocking=False)
    man.wait()
    done = []

    def slow():
        time.sleep(0.3)
        done.append(1)

    man._writer.submit(slow, "in-flight")
    man.save(2, None, {"w": P(np.full((2,), 2))}, {}, blocking=True)
    assert done, "blocking save did not wait for the in-flight write"
    assert man.checkpoints() == [1, 2]


def _fused_module(X, y, batch=32, seed=11, dropout=0.0):
    it = tmx.io.NDArrayIter(X, y, batch_size=batch)
    mod = tmx.mod.Module(mlp_sym(dropout=dropout), context=tmx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    tmx.random.seed(seed)
    mod.init_params(tmx.initializer.Xavier())
    mod.init_optimizer(kvstore="tpu", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    assert mod._fused is not None, "fused path did not engage"
    return mod, it


def test_module_async_prefix_save_one_job(tmp_path, monkeypatch):
    """Module.save_checkpoint under MXTPU_CKPT_ASYNC=1 goes through the
    shared default writer in ONE job (params and states), and the files
    load back equal."""
    monkeypatch.setenv("MXTPU_CKPT_ASYNC", "1")
    calls = []
    real = tmx.resilience.submit_checkpoint

    def counting(fn, label="checkpoint"):
        calls.append(label)
        return real(fn, label)

    monkeypatch.setattr(tmx.resilience, "submit_checkpoint", counting)
    X, y = make_blobs(64, 10, 3)
    mod, it = _fused_module(X, y)
    batch = next(iter(it))
    mod.forward_backward(batch)
    mod.update()
    want = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    prefix = str(tmp_path / "mod")
    mod.save_checkpoint(prefix, 3, save_optimizer_states=True)
    tmx.resilience.wait_checkpoints()
    assert len(calls) == 1, calls
    _, args, _ = tmx.model.load_checkpoint(prefix, 3)
    assert os.path.exists(prefix + "-0003.states")
    for name in want:
        assert np.array_equal(want[name], args[name].asnumpy()), name


def test_preempt_drain_is_bounded(tmp_path, monkeypatch):
    monkeypatch.setattr(CheckpointManager, "DRAIN_TIMEOUT", 0.4)
    X, y = make_blobs(64, 10, 3)
    mod, it = _fused_module(X, y)
    batch = next(iter(it))
    mod.forward_backward(batch)
    mod.update()
    tmx.resilience.submit_checkpoint(lambda: time.sleep(1.2), "wedged")
    man = CheckpointManager(str(tmp_path))
    t0 = time.monotonic()
    mod._save_preemption_checkpoint(man, 0, 4)
    assert time.monotonic() - t0 < 1.0
    entry = man.latest_entry()
    assert entry["epoch"] == 1 and entry["step_state"]["step"] == 4
    json.dumps(entry)
    tmx.resilience.wait_checkpoints()


def test_fit_drains_default_writer_for_prefix_callbacks(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("MXTPU_CKPT_ASYNC", "1")
    real = tmx.resilience.submit_checkpoint

    def slow_submit(fn, label="checkpoint"):
        def slow():
            time.sleep(0.3)
            fn()
        return real(slow, label)

    monkeypatch.setattr(tmx.resilience, "submit_checkpoint", slow_submit)
    X, y = make_blobs(64, 10, 3)
    prefix = str(tmp_path / "mod")
    mod = tmx.mod.Module(mlp_sym(), context=tmx.cpu())
    tmx.random.seed(11)
    mod.fit(tmx.io.NDArrayIter(X, y, batch_size=32), num_epoch=2,
            kvstore="tpu", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            initializer=tmx.initializer.Xavier(),
            epoch_end_callback=tmx.callback.do_checkpoint(prefix))
    assert os.path.exists(prefix + "-0002.params")


# ---------------------------------------------------------------------------
# retention hardening, ring replicas, the sharded-native layout
# ---------------------------------------------------------------------------

def test_prune_crash_cannot_resurrect_pruned_epoch(tmp_path, port_faults):
    man = CheckpointManager(str(tmp_path), keep_last=2)
    for epoch in (1, 2):
        man.save(epoch, None, {"w": P(np.full((2,), epoch))}, {})
    port_faults.arm("ckpt_prune")
    with pytest.raises(TransientError):
        man.save(3, None, {"w": P(np.full((2,), 3))}, {})
    assert (tmp_path / "checkpoint-0001.params").exists()
    assert (tmp_path / "checkpoint-0001.pruning").exists()
    assert man.checkpoints() == [2, 3]
    (tmp_path / "manifest.json").write_text("{torn")
    assert CheckpointManager(str(tmp_path)).checkpoints() == [2, 3]
    man2 = CheckpointManager(str(tmp_path), keep_last=2)
    man2.save(4, None, {"w": P(np.full((2,), 4))}, {})
    assert not (tmp_path / "checkpoint-0001.params").exists()
    assert not any(p.name.endswith(".pruning") for p in tmp_path.iterdir())
    assert man2.checkpoints() == [3, 4]


def _simulated_ring_save(tmp_path, world=3, epoch=1):
    args = {"w%d" % i: P(np.full((4, 3), i + 1)) for i in range(5)}
    man = CheckpointManager(str(tmp_path))
    for r in range(world):
        man.save(epoch, None, args, {}, optimizer_states=b"ABCDEFGHIJKL",
                 rank=r, world=world)
    return man, args


def test_replication_ring_shards_and_recovery(tmp_path, monkeypatch):
    """Ring replicas: every shard and its offset-1 replica on disk with
    rank 0's digests; a limited build byte-equal to the full one and to
    the JAX package's; restore rebuilds from a peer replica when the
    primary params file and one shard primary rot; every copy dead walks
    back; a typo'd replica count degrades."""
    monkeypatch.setenv("MXTPU_CKPT_REPLICAS", "1")
    man, args = _simulated_ring_save(tmp_path)
    names = {p.name for p in tmp_path.iterdir()}
    for p in range(3):
        assert "checkpoint-0001.shard%03d" % p in names
        assert "checkpoint-0001.shard%03d.rep1" % p in names
    meta = man.latest_entry()["shards"]
    assert meta["world"] == 3 and meta["replicas"] == 1
    for part in meta["parts"]:
        assert tmx.resilience.checksum_file(str(tmp_path / part["file"])) \
            == (part["size"], part["digest"])
    full = man._shard_parts(1, args, {}, b"ABCDEFGHIJKL", 3)
    subset = man._shard_parts(1, args, {}, b"ABCDEFGHIJKL", 3, need={1, 2})
    jman = jmx.resilience.CheckpointManager(str(tmp_path / "j"))
    jfull = jman._shard_parts(1, {k: J(v.asnumpy()) for k, v in
                                  args.items()}, {}, b"ABCDEFGHIJKL", 3)
    assert sorted(subset) == [1, 2]
    for p in full:
        assert full[p] == jfull[p]
        if p in subset:
            assert subset[p] == full[p]
    _flip_payload_byte(str(tmp_path / "checkpoint-0001.params"), 3)
    _flip_payload_byte(str(tmp_path / "checkpoint-0001.shard001"), 2)
    _, restored, _, states, epoch = man.restore()
    assert epoch == 1 and states == b"ABCDEFGHIJKL"
    for name in args:
        assert np.array_equal(args[name].asnumpy(),
                              restored[name].asnumpy()), name
    _simulated_ring_save(tmp_path, epoch=2)
    for name in ("checkpoint-0002.params", "checkpoint-0002.shard001",
                 "checkpoint-0002.shard001.rep1"):
        _flip_payload_byte(str(tmp_path / name), 2)
    assert man.restore()[4] == 1
    with pytest.raises(MXNetError, match="no intact copy"):
        man.restore(2)
    monkeypatch.setenv("MXTPU_CKPT_REPLICAS", "one")
    man3 = CheckpointManager(str(tmp_path / "typo"))
    man3.save(1, None, {"w": P(np.ones(2))}, {}, rank=0, world=3)
    assert "shards" not in man3.latest_entry()


def test_replication_checksums_off_and_rank_pruning(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_CKPT_REPLICAS", "1")
    monkeypatch.setenv("MXTPU_CKPT_CHECKSUM", "off")
    man, args = _simulated_ring_save(tmp_path / "off")
    (tmp_path / "off" / "checkpoint-0001.params").write_bytes(b"torn")
    shard = tmp_path / "off" / "checkpoint-0001.shard001"
    shard.write_bytes(shard.read_bytes()[:len(shard.read_bytes()) // 2])
    _, restored, _, states, epoch = man.restore()
    assert epoch == 1 and states == b"ABCDEFGHIJKL"
    for name in args:
        assert np.array_equal(args[name].asnumpy(),
                              restored[name].asnumpy()), name
    monkeypatch.delenv("MXTPU_CKPT_CHECKSUM")
    man = CheckpointManager(str(tmp_path / "rank1"), keep_last=2)
    for epoch in (1, 2, 3):
        man.save(epoch, None, {"w": P(np.ones((2, 2)))}, {}, rank=1,
                 world=3)
    names = {p.name for p in (tmp_path / "rank1").iterdir()}
    assert "checkpoint-0003.shard001" in names
    assert not any(n.startswith("checkpoint-0001.shard") for n in names)
    man = CheckpointManager(str(tmp_path / "prune"), keep_last=1)
    for epoch in (1, 2):
        for r in range(2):
            man.save(epoch, None, {"w": P(np.ones(2))}, {}, rank=r,
                     world=2)
    names = {p.name for p in (tmp_path / "prune").iterdir()}
    assert "checkpoint-0002.shard000" in names
    assert not any(n.startswith("checkpoint-0001.shard") for n in names)


@pytest.mark.parametrize("case", ["degraded_replica", "dead_primary"])
def test_fsck_replica_audit(tmp_path, monkeypatch, case):
    monkeypatch.setenv("MXTPU_CKPT_REPLICAS", "1")
    _simulated_ring_save(tmp_path)
    if case == "degraded_replica":
        os.remove(str(tmp_path / "checkpoint-0001.shard001.rep1"))
    else:
        _flip_payload_byte(str(tmp_path / "checkpoint-0001.shard001"), 2)
    res = _run_fsck(tmp_path)
    entry = json.loads(res.stdout)["checkpoints"][0]
    if case == "degraded_replica":
        assert res.returncode == 0 and entry["ok"] and entry["degraded"]
    else:
        assert res.returncode == 1 and not entry["ok"]
        assert any("primary dead" in p for p in entry["problems"])


def _sharded_payloads(epoch, world, base=1.0, rows=2):
    """Shard payloads in the trainer's blob contract: shard k carries its
    slice of "w" (dim 0) and one momentum slot; shard 0 also the
    replicated "bias", aux state and the update counter."""
    def payload(k):
        w = np.full((rows, 3), base + k, "f")
        out = {"epoch": int(epoch), "shard": k, "world": int(world),
               "args": {"w": w}, "opt": {"w": (w * 0.5,)},
               "dims": {"w": 0}}
        if k == 0:
            out["args"]["bias"] = np.full((3,), base, "f")
            out["dims"]["bias"] = None
            out["aux"] = {"mov": np.full((2,), base, "f")}
            out["num_update"] = int(epoch) * 10
        return pickle.dumps(out, protocol=4)
    return payload


def _expected_w(world, base=1.0, rows=2):
    return np.concatenate(
        [np.full((rows, 3), base + k, "f") for k in range(world)], axis=0)


def test_save_sharded_roundtrip_scan_and_prune(tmp_path):
    man = CheckpointManager(str(tmp_path / "a"))
    world = 4
    man.save_sharded(1, mlp_sym(), _sharded_payloads(1, world), world=world)
    entry = man.entry(1)
    assert entry["format"] == CheckpointManager.SHARDED_FORMAT
    assert entry["params"] is None and entry["states"] is None
    assert [r["shard"] for r in entry["shard_set"]["files"]] == \
        list(range(world))
    assert verify_promotion(str(tmp_path / "a")) == (1, [])
    st = man.last_save_stats
    assert st["peak_blob_bytes"] < st["total_blob_bytes"]
    symbol, args, auxs, states, epoch = man.restore()
    assert epoch == 1 and symbol is not None
    assert np.array_equal(args["w"].asnumpy(), _expected_w(world))
    assert np.array_equal(auxs["mov"].asnumpy(), np.full((2,), 1.0, "f"))
    st = pickle.loads(states)
    assert st["num_update"] == 10
    assert np.array_equal(st["states"]["w"][0], _expected_w(world) * 0.5)
    # scan rebuild: a complete set restores, an incomplete one is skipped,
    # neither is promotable
    man = CheckpointManager(str(tmp_path / "b"))
    man.save_sharded(1, mlp_sym(), _sharded_payloads(1, 2), world=2)
    atomic_write(str(tmp_path / "b" / man.shard_blob_name(3, 0, 2)),
                 _sharded_payloads(3, 2, base=9.0)(0))
    (tmp_path / "b" / "manifest.json").write_text("{ torn")
    man2 = CheckpointManager(str(tmp_path / "b"))
    assert man2.checkpoints() == [1]
    assert np.array_equal(man2.restore()[1]["w"].asnumpy(), _expected_w(2))
    epoch, problems = verify_promotion(str(tmp_path / "b"))
    assert epoch == 1 and "no integrity record" in problems[0]
    # a blob spliced from another epoch is refused as a mixed assembly
    man = CheckpointManager(str(tmp_path / "c"))
    man.save_sharded(1, mlp_sym(), _sharded_payloads(1, 2), world=2)
    man.save_sharded(2, None, _sharded_payloads(2, 2, base=5.0), world=2)
    (tmp_path / "c" / "manifest.json").write_text("{ torn")
    import shutil
    shutil.copyfile(str(tmp_path / "c" / man.shard_blob_name(1, 1, 2)),
                    str(tmp_path / "c" / man.shard_blob_name(2, 1, 2)))
    assert CheckpointManager(str(tmp_path / "c")).restore()[4] == 1
    # retention deletes every blob of a pruned epoch
    man = CheckpointManager(str(tmp_path / "d"), keep_last=1)
    for epoch in (1, 2):
        man.save_sharded(epoch, mlp_sym(), _sharded_payloads(epoch, 2),
                         world=2)
    assert man.checkpoints() == [2]
    assert not (tmp_path / "d" / man.shard_blob_name(1, 0, 2)).exists()


@pytest.mark.parametrize("point", ["rot_shard", "truncate_shard",
                                   "drop_shard"])
def test_shard_loss_matrix(tmp_path, port_faults, point):
    world = 3
    for k in range(world):
        d = tmp_path / ("%s_%d" % (point, k))
        man = CheckpointManager(str(d))
        man.save_sharded(1, mlp_sym(), _sharded_payloads(1, world),
                         world=world)
        port_faults.arm(point, times=1, after=k)
        man.save_sharded(2, None, _sharded_payloads(2, world, base=5.0),
                         world=world)
        assert man.latest() == 2
        assert (d / man.shard_blob_name(2, k, world)).exists() == \
            (point != "drop_shard")
        epoch, problems = verify_promotion(str(d))
        assert epoch == 2 and problems, (point, k)
        _, args, _, _, epoch = man.restore()
        assert epoch == 1 and np.array_equal(args["w"].asnumpy(),
                                             _expected_w(world))


def test_rot_and_truncate_points_fire_after_manifest(tmp_path, port_faults):
    man = CheckpointManager(str(tmp_path))
    man.save(1, None, {"w": P(np.ones(4))}, {})
    port_faults.arm("rot_checkpoint")
    man.save(2, None, {"w": P(np.full((4,), 2.0))}, {})
    assert man.latest() == 2
    rec = man.entry(2)["files"]["checkpoint-0002.params"]
    assert os.path.getsize(str(tmp_path / "checkpoint-0002.params")) == \
        rec["size"]
    _, problems = verify_promotion(str(tmp_path))
    assert problems and "fails verification" in problems[0]
    port_faults.arm("truncate_checkpoint")
    man.save(3, None, {"w": P(np.full((4,), 3.0))}, {})
    assert os.path.getsize(str(tmp_path / "checkpoint-0003.params")) < \
        man.entry(3)["files"]["checkpoint-0003.params"]["size"]
    assert man.restore()[4] == 1
    assert tmx.resilience.publish_mark(str(tmp_path), 3) == \
        jmx.resilience.publish_mark(str(tmp_path), 3)


# ---------------------------------------------------------------------------
# the fused step's guard under poison_grad
# ---------------------------------------------------------------------------

def test_step_guard_skips_poisoned_batch(port_faults):
    """A poisoned step changes no parameter, aux value or optimizer
    state; SkippedSteps and the Monitor rows read 1; the next clean step
    trains; the metric never sees the NaN outputs."""
    X, y = make_blobs(128, 10, 3)
    mod, it = _fused_module(X, y)
    batch = next(iter(it))
    before = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    states = pickle.loads(mod.get_optimizer_states())
    skipped = tmx.metric.SkippedSteps(mod)
    assert skipped.get() == ("skipped_steps", 0.0)
    metric = tmx.metric.CrossEntropy()
    port_faults.arm("poison_grad")
    mod.forward_backward(batch)
    mod.update()
    mod.update_metric(metric, batch.label)
    assert metric.num_inst == 0
    after = mod.get_params()[0]
    for name, old in before.items():
        assert np.array_equal(old, after[name].asnumpy()), name
    states_after = pickle.loads(mod.get_optimizer_states())
    for k, s in states["states"].items():
        for a, b in zip(s, states_after["states"][k]):
            assert np.array_equal(a, b), k
    assert skipped.get() == ("skipped_steps", 1.0)
    assert mod._fused.consecutive_bad_steps == 1
    mon = tmx.mon.Monitor(1)
    mon.install_step_guard(mod)
    mon.tic()
    rows = {k: v for _, k, v in mon.toc()}
    assert rows["step_guard_skipped"] == str(1.0)
    mod.forward_backward(batch)
    mod.update()
    mod.update_metric(metric, batch.label)
    assert metric.num_inst > 0 and np.isfinite(metric.get()[1])
    assert any(not np.array_equal(before[k], v.asnumpy())
               for k, v in mod.get_params()[0].items())
    assert mod.skipped_update_count == 1
    assert mod._fused.consecutive_bad_steps == 0


def test_step_guard_aborts_after_max_consecutive_bad_steps(port_faults):
    tr = tmx.parallel.SPMDTrainer(mlp_sym(), "sgd",
                                  {"learning_rate": 0.1,
                                   "rescale_grad": 1.0 / 16},
                                  max_consecutive_bad_steps=2,
                                  ctx=tmx.cpu())
    tr.bind([("data", (16, 10))], [("softmax_label", (16,))])
    tmx.random.seed(3)
    tr.init_params(tmx.initializer.Xavier())
    X = np.random.RandomState(0).randn(16, 10).astype("f")
    y = np.zeros((16,), "f")
    port_faults.arm("poison_grad", times=2)
    tr.step(X, y)
    assert tr.skipped_steps == 1
    tr.step(X, y)
    with pytest.raises(MXNetError, match="consecutive"):
        tr.flush_step_guard()
    assert tr._skipped_steps == 2


# ---------------------------------------------------------------------------
# fit: managed checkpoints, resume, deferred metrics
# ---------------------------------------------------------------------------

def _fit_params(tmp_dir, kvstore, epochs, resume=False, seed=21,
                dropout=0.0, **kw):
    X, y = make_blobs(256, 10, 3, seed=4)
    mod = tmx.mod.Module(mlp_sym(dropout=dropout), context=tmx.cpu())
    tmx.random.seed(seed)
    mod.fit(tmx.io.NDArrayIter(X, y, batch_size=64), num_epoch=epochs,
            kvstore=kvstore, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=tmx.initializer.Xavier(), checkpoint=tmp_dir,
            resume=resume, **kw)
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("kvstore,ckpt_async",
                         [("tpu", "0"), ("local", "0"), ("tpu", "1")])
def test_fit_resume_matches_uninterrupted_run(tmp_path, monkeypatch,
                                              kvstore, ckpt_async):
    """Two epochs, then a fresh module (another seed) resumes to four:
    bit-identical to four uninterrupted epochs, on both routes and through
    async saves.  (An epoch-end checkpoint carries no random state, as in
    the JAX package: the mid-epoch drills in test_torch_chaos.py cover a
    Dropout net.)"""
    monkeypatch.setenv("MXTPU_CKPT_ASYNC", ckpt_async)
    full = _fit_params(str(tmp_path / "full"), kvstore, epochs=4)
    _fit_params(str(tmp_path / "cut"), kvstore, epochs=2)
    man = CheckpointManager(str(tmp_path / "cut"))
    assert man.latest() == 2 and man.latest_entry()["files"]
    assert os.path.exists(str(tmp_path / "cut" / "checkpoint-0002.states"))
    resumed = _fit_params(str(tmp_path / "cut"), kvstore, epochs=4,
                          resume=True, seed=99)
    for name in full:
        assert np.array_equal(resumed[name], full[name]), name
    assert man.latest() == 4
    # an empty directory with resume=True trains from scratch
    assert _fit_params(str(tmp_path / "fresh"), kvstore, epochs=1,
                       resume=True)


def test_spmd_trainer_checkpoint_roundtrip(tmp_path):
    X = np.random.RandomState(1).randn(16, 10).astype("f")
    y = np.zeros((16,), "f")

    def make(net):
        t = tmx.parallel.SPMDTrainer(net, "sgd",
                                     {"learning_rate": 0.1, "momentum": 0.9,
                                      "rescale_grad": 1.0 / 16},
                                     ctx=tmx.cpu())
        t.bind([("data", (16, 10))], [("softmax_label", (16,))])
        tmx.random.seed(5)
        t.init_params(tmx.initializer.Xavier())
        return t

    man = CheckpointManager(str(tmp_path))
    a = make(mlp_sym())
    for _ in range(3):
        a.step(X, y)
    a.save_checkpoint(man, 3)
    b = make(mlp_sym())
    assert b.restore(man) == 3 and b._num_update == a._num_update
    a.step(X, y)
    b.step(X, y)
    for name, v in a.get_params()[0].items():
        assert np.array_equal(b.get_params()[0][name].asnumpy(),
                              v.asnumpy()), name
    snap = a.snapshot_params()[0]
    assert all(type(v).__name__ == "_HostSnapshot" for v in snap.values())
    a.save_checkpoint(man, 4, blocking=False)
    man.wait()
    assert man.latest() == 4
    with pytest.raises(MXNetError, match="parameter set"):
        _other_model(tmp_path)
    from mxnet_tpu.parallel.planner import diff_param_sets as jdiff
    from mxnet_tpu_torch.parallel.trainer import diff_param_sets as tdiff
    assert tdiff(["a", "b"], ["b", "c"], kind="aux state") == \
        jdiff({"a": {}, "b": {}}, {"b", "c"}, kind="aux state")


def _other_model(tmp_path):
    """A model with another parameter set restoring the checkpoint."""
    with tmx.name.NameManager():
        data = tmx.sym.Variable("data")
        net = tmx.sym.FullyConnected(data, num_hidden=3, name="fc9")
        net = tmx.sym.SoftmaxOutput(net, name="softmax")
    t = tmx.parallel.SPMDTrainer(net, "sgd", {"learning_rate": 0.1},
                                 ctx=tmx.cpu())
    t.bind([("data", (16, 10))], [("softmax_label", (16,))])
    t.init_params(tmx.initializer.Xavier())
    return t.restore(CheckpointManager(str(tmp_path)))


def test_deferred_accuracy_equals_blocking_and_jax(monkeypatch):
    """Accuracy accumulated on the device equals the blocking host path
    exactly (values and trained params), copies nothing between folds,
    folds every MXTPU_METRIC_INTERVAL updates, and equals the JAX
    package's blocking value on the same weights and batches."""
    X, y = make_blobs(256, 10, 3, seed=4)
    rs = np.random.RandomState(2)
    y = np.where(rs.rand(len(y)) < 0.3, (y + 1) % 3, y).astype("f")

    def fit(blocking, interval="0"):
        monkeypatch.setenv("MXTPU_METRIC_BLOCKING", blocking)
        monkeypatch.setenv("MXTPU_METRIC_INTERVAL", interval)
        mod = tmx.mod.Module(mlp_sym(), context=tmx.cpu())
        tmx.random.seed(21)
        metric = tmx.metric.Accuracy()
        values = []
        mod.fit(tmx.io.NDArrayIter(X, y, batch_size=64), num_epoch=2,
                kvstore="tpu", optimizer="sgd", eval_metric=metric,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=tmx.initializer.Xavier(),
                batch_end_callback=lambda p: values.append(
                    (p.eval_metric.sum_metric, p.eval_metric.num_inst)),
                epoch_end_callback=lambda e, s, a, x: values.append(
                    metric.get()))
        return mod, metric, values

    mod_d, met_d, vals_d = fit("0")
    mod_b, met_b, vals_b = fit("1")
    assert mod_d._deferred_metric is met_d and mod_b._deferred_metric is None
    assert vals_d[4] == vals_b[4] and vals_d[-1] == vals_b[-1]
    assert vals_d[0] == (0.0, 0)       # nothing folded between reads
    assert met_d.get() == met_b.get()
    for k, v in mod_d.get_params()[0].items():
        assert np.array_equal(v.asnumpy(), mod_b.get_params()[0][k]
                              .asnumpy()), k
    _, _, vals_i = fit("0", interval="2")
    assert vals_i[1] == vals_b[1] and vals_i[0] == (0.0, 0)
    # the JAX package's Accuracy on the port's outputs and labels
    out = mod_d.predict(tmx.io.NDArrayIter(X, y, batch_size=64))
    jm, tm = jmx.metric.Accuracy(), tmx.metric.Accuracy()
    jm.update([J(y)], [J(out.asnumpy())])
    tm.update([P(y)], [P(out.asnumpy())])
    assert jm.get() == tm.get()


def test_foreign_rng_record_refused_on_resume(tmp_path):
    """A mid-epoch checkpoint whose rng record is the JAX package's key
    chain cannot continue the port's stream: fit(resume=True) raises
    instead of resuming on other dropout masks."""
    d = tmp_path / "ck"
    _fit_params(str(d), "tpu", epochs=1, dropout=0.2)
    man = CheckpointManager(str(d))
    _, args, aux, states, _ = man.restore()
    man.save(1, mlp_sym(dropout=0.2), args, aux, optimizer_states=states,
             step_state={"epoch": 0, "step": 2,
                         "rng": jmx.random.get_state()})
    with pytest.raises(MXNetError, match="cannot be continued"):
        _fit_params(str(d), "tpu", epochs=1, resume=True, dropout=0.2)


# ---------------------------------------------------------------------------
# the input path's fault points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("times,retries", [(2, "3"), (2, "2")])
def test_iter_next_fault_through_the_retry_ladder(monkeypatch, port_faults,
                                                  times, retries):
    monkeypatch.setenv("MXTPU_DATA_RETRY_BACKOFF", "0")
    monkeypatch.setenv("MXTPU_DATA_RETRIES", retries)
    X = np.arange(64, dtype="f").reshape(16, 4)
    base = tmx.io.NDArrayIter(X, np.zeros(16, "f"), batch_size=4)
    port_faults.arm("iter_next", times=times)
    it = tmx.io.PrefetchingIter(base)
    if int(retries) > times:
        seen = [b.data[0].asnumpy().copy() for b in it]
        assert len(seen) == 4
        np.testing.assert_array_equal(seen[0], X[:4])
        np.testing.assert_array_equal(seen[-1], X[12:])
    else:
        with pytest.raises(MXNetError, match="all 2 attempts"):
            next(it)
        assert next(it) is not None
