"""The port's ZeRO-3 against the JAX package's on the CPU.

- The gather groups are pure functions of the graph
  (``zero3.first_consumer_order``, ``plan_gather_groups``,
  ``planner.derive_gather_groups``): they must equal the JAX package's
  exactly, for ResNet-50, Inception-BN, the LSTM LM and an MLP, at
  several worlds, layer counts and buckets.
- Two gloo ranks (this file as a script, a file store under
  ``tmp_path``): bench.py's MLP (cut to 256 -> 128 -> 128 -> 10) under
  zero3 is bit-identical to allreduce after 6 steps (two ranks: every
  element of a reduce-scatter and of an all-reduce is the same sum of
  two); a gather-on-save checkpoint restores bit-identical into a fresh
  zero3 trainer; a sharded-native checkpoint (``MXTPU_CKPT_SHARDED=1``,
  one blob a rank) restores at world 2 and, in this process, at world 1;
  ``MXTPU_ZERO3_GATHER_GROUP=1`` gives the JAX package's per-layer
  groups; ``SPMDModule(grad_sync='zero3')`` drives ``fit``.
"""
import hashlib
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from test_torch_parallel import launch_workers  # noqa: E402

BATCH = 16
DIM = 256


def bench_mlp(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=128, name="fc2")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc3")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def data_stream(n):
    rs = np.random.RandomState(3)
    return [(rs.standard_normal((BATCH, DIM)).astype(np.float32),
             rs.randint(0, 10, BATCH).astype(np.float32)) for _ in range(n)]


def _symbols(mx):
    with mx.name.NameManager():
        yield "mlp", bench_mlp(mx), {"data": (BATCH, DIM)}
    with mx.name.NameManager():
        yield ("resnet50", mx.models.get_symbol(
            "resnet", num_layers=50, num_classes=1000,
            image_shape=(3, 224, 224)), {"data": (8, 3, 224, 224)})
    with mx.name.NameManager():
        yield ("inception_bn", mx.models.get_symbol(
            "inception-bn", num_classes=1000, image_shape=(3, 224, 224)),
            {"data": (8, 3, 224, 224)})
    with mx.name.NameManager():
        lm = mx.models.lstm_lm.lstm_lm_sym(8, 100, 16, 32, 2)[0]
        yield "lstm_lm", lm, {"data": (4, 8), "softmax_label": (4, 8)}


def _groups(mx, world, layers, bucket):
    from importlib import import_module
    z3 = import_module(mx.__name__ + ".parallel.zero3")
    planner = import_module(mx.__name__ + ".parallel.planner")
    out = {}
    for name, sym, shapes in _symbols(mx):
        arg_shapes, _, _ = sym.infer_shape(**shapes)
        shp = {n: tuple(s) for n, s in zip(sym.list_arguments(), arg_shapes)
               if n not in shapes}
        names = sorted(n for n, s in shp.items()
                       if any(d % world == 0 and d >= world for d in s))
        out[name] = (z3.first_consumer_order(sym, names),
                     z3.plan_gather_groups(sym, names, layers),
                     planner.derive_gather_groups(sym, names, shp,
                                                  bucket_bytes=bucket))
    return out


@pytest.mark.parametrize("world,layers,bucket", [(2, 1, None), (4, 3, 1 << 16),
                                                 (8, 2, 1 << 22)])
def test_gather_groups_equal_jax(world, layers, bucket):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    want = _groups(jmx, world, layers, bucket)
    got = _groups(tmx, world, layers, bucket)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

def _trainer(tmx, sync, mesh, world):
    tr = tmx.parallel.SPMDTrainer(
        bench_mlp(tmx), "sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                "rescale_grad": 1.0 / BATCH},
        mesh=mesh, grad_sync=sync, ctx=tmx.cpu())
    tr.bind([("data", (BATCH // world, DIM))],
            [("softmax_label", (BATCH // world,))])
    tmx.random.seed(33)
    tr.init_params(tmx.initializer.Xavier())
    return tr


def _digest(tr):
    arg, aux = tr.get_params()
    h = hashlib.sha256()
    for d in (arg, aux):
        for k in sorted(d):
            h.update(d[k].asnumpy().tobytes())
    return h.hexdigest()


def worker(out, rank, world, init):
    import torch
    torch.set_num_threads(1)
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import distributed
    distributed.initialize(init_method="file://" + init,
                           num_processes=world, process_id=rank,
                           platform="cpu")
    mesh = tmx.parallel.local_mesh()
    data = [(x[rank::world], y[rank::world]) for x, y in data_stream(6)]
    res = {}
    finals = {}
    for sync in ("allreduce", "zero3"):
        tr = _trainer(tmx, sync, mesh, world)
        for x, y in data:
            tr.step(x, y)
        finals[sync] = {k: v.asnumpy() for k, v in tr.get_params()[0].items()}
        if sync == "zero3":
            res["local_fc1"] = np.array(tr.params["fc1_weight"].shape)
            res["digest6"] = np.array(_digest(tr))
        tr.close()
    res["bitwise"] = np.array(all(
        np.array_equal(finals["allreduce"][k], finals["zero3"][k])
        for k in finals["zero3"]))
    # gather-on-save, then a fresh zero3 trainer restores it
    mgr = tmx.resilience.CheckpointManager(os.path.join(out, "gathered"))
    tr = _trainer(tmx, "zero3", mesh, world)
    for x, y in data[:3]:
        tr.step(x, y)
    tr.save_checkpoint(mgr, 3, blocking=True)
    saved = _digest(tr)
    distributed.barrier()
    tr2 = _trainer(tmx, "zero3", mesh, world)
    assert tr2.restore(mgr) == 3
    res["gathered_roundtrip"] = np.array(_digest(tr2) == saved)
    for x, y in data[3:]:
        tr.step(x, y)
        tr2.step(x, y)
    res["gathered_resume"] = np.array(_digest(tr2) == _digest(tr))
    # sharded-native: one blob a rank, restored at world 2 here
    os.environ["MXTPU_CKPT_SHARDED"] = "1"
    smgr = tmx.resilience.CheckpointManager(os.path.join(out, "sharded"))
    tr.save_checkpoint(smgr, 6)
    del os.environ["MXTPU_CKPT_SHARDED"]
    res["sharded_digest"] = np.array(_digest(tr))
    tr3 = _trainer(tmx, "zero3", mesh, world)
    assert tr3.restore(smgr) == 6
    res["sharded_roundtrip"] = np.array(_digest(tr3) == _digest(tr))
    # the manual per-layer override
    os.environ["MXTPU_ZERO3_GATHER_GROUP"] = "1"
    tr4 = _trainer(tmx, "zero3", mesh, world)
    res["layer_groups"] = np.array(["|".join(g) for g in tr4._zero3_groups])
    del os.environ["MXTPU_ZERO3_GATHER_GROUP"]
    # a plan written for world 4 adopted at world 2: its policy holds,
    # its groups are re-derived for this world
    doc = tmx.parallel.planner.plan(
        bench_mlp(tmx), [("data", (BATCH, DIM))], [("softmax_label",
                                                     (BATCH,))],
        world=4, grad_sync="zero3").to_doc()
    tr5 = tmx.parallel.SPMDTrainer(bench_mlp(tmx), "sgd", {}, mesh=mesh,
                                   plan=doc, ctx=tmx.cpu())
    tr5.bind([("data", (BATCH // world, DIM))],
             [("softmax_label", (BATCH // world,))])
    res["replan"] = np.array([tr5.grad_sync, str(tr5.sharding_plan.world),
                              str(tr5.sharding_plan.batch_size)])
    # SPMDModule drives BaseModule.fit unchanged
    X = np.concatenate([x for x, _ in data_stream(4)])
    y = np.concatenate([y for _, y in data_stream(4)])
    it = tmx.io.NDArrayIter(X[rank::world], y[rank::world],
                            batch_size=BATCH // world)
    mod = tmx.parallel.SPMDModule(bench_mlp(tmx), mesh=mesh,
                                  grad_sync="zero3")
    with tmx.cpu():
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05})
    res["module_plan"] = np.array(mod.sharding_plan.to_json())
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)
    distributed.barrier()


def analysis_worker(out, rank, world, init):
    """One step window of each data-parallel trainer linted by
    ``SPMDTrainer.analyze`` (tests/test_torch_analysis.py reads it)."""
    import json
    import torch
    torch.set_num_threads(1)
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import distributed
    distributed.initialize(init_method="file://" + init,
                           num_processes=world, process_id=rank,
                           platform="cpu")
    mesh = tmx.parallel.local_mesh()

    class LeftOut(tmx.parallel.SPMDTrainer):
        """A broken sharding: fc1_weight stays replicated under zero3."""

        def _param_spec(self, name, shape):
            if name == "fc1_weight":
                return ()
            return super()._param_spec(name, shape)

    x, y = data_stream(1)[0]
    x, y = x[rank::world], y[rank::world]
    res = {}
    for label, sync, cls in (("zero3", "zero3", tmx.parallel.SPMDTrainer),
                             ("zero", "zero", tmx.parallel.SPMDTrainer),
                             ("allreduce", "allreduce",
                              tmx.parallel.SPMDTrainer),
                             ("left_out", "zero3", LeftOut)):
        tr = cls(bench_mlp(tmx), "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9},
                 mesh=mesh, grad_sync=sync, ctx=tmx.cpu())
        tr.bind([("data", (BATCH // world, DIM))],
                [("softmax_label", (BATCH // world,))])
        tr.init_params(tmx.initializer.Xavier())
        tr.step(x, y)
        before = {k: v.clone() for k, v in tr.params.items()}
        rep = tr.analyze(x, y)
        same = all(torch.equal(before[k], tr.params[k]) for k in before)
        res[label] = np.array(json.dumps({
            "ok": rep.ok, "rules": sorted({f.rule for f in rep.findings}),
            "text": rep.format_text(), "unchanged": same,
            "collectives": rep.stats["collectives"],
            "groups": len(tr._zero3_groups),
            "expect": tr._zero3_expected_gather_bytes()}))
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)
    distributed.barrier()


_RUN = {}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    if "r" not in _RUN:
        tmp = tmp_path_factory.mktemp("zero3")
        _RUN["r"] = (tmp, launch_workers(os.path.abspath(__file__), 2, tmp))
    return _RUN["r"]


def test_zero3_bitwise_equal_to_allreduce(two_ranks):
    _, ranks = two_ranks
    for r in ranks:
        assert bool(r["bitwise"])
        assert tuple(r["local_fc1"]) == (64, DIM)   # 128 rows over 2 ranks
    assert str(ranks[0]["digest6"]) == str(ranks[1]["digest6"])


def test_zero3_checkpoints_round_trip(two_ranks):
    _, ranks = two_ranks
    for r in ranks:
        assert bool(r["gathered_roundtrip"]) and bool(r["gathered_resume"])
        assert bool(r["sharded_roundtrip"])


def test_sharded_native_blobs_restore_at_world_one(two_ranks):
    import mxnet_tpu_torch as tmx
    tmp, ranks = two_ranks
    sdir = os.path.join(str(tmp), "sharded")
    names = sorted(os.listdir(sdir))
    assert "checkpoint-0006.params.s000-of-002" in names
    assert "checkpoint-0006.params.s001-of-002" in names
    tr = _trainer(tmx, "allreduce", None, 1)
    assert tr.restore(tmx.resilience.CheckpointManager(sdir)) == 6
    assert _digest(tr) == str(ranks[0]["sharded_digest"])


def test_manual_group_override_equals_jax(two_ranks):
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import SPMDTrainer, build_mesh
    _, ranks = two_ranks
    os.environ["MXTPU_ZERO3_GATHER_GROUP"] = "1"
    try:
        tr = SPMDTrainer(bench_mlp(jmx), "sgd", {"learning_rate": 0.1},
                         mesh=build_mesh({"dp": 2}, jax.devices()[:2]),
                         grad_sync="zero3")
        tr.bind([("data", (BATCH, DIM))], [("softmax_label", (BATCH,))])
    finally:
        del os.environ["MXTPU_ZERO3_GATHER_GROUP"]
    assert ["|".join(g) for g in tr._zero3_groups] == \
        list(ranks[0]["layer_groups"])
    assert len(tr._zero3_groups) == 3


def test_spmd_module_records_its_plan(two_ranks):
    """The descriptive plan of a two-rank SPMDModule equals the JAX
    package's at a two-device mesh byte for byte (the global batch)."""
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import SPMDModule, build_mesh
    _, ranks = two_ranks
    X = np.concatenate([x for x, _ in data_stream(4)])
    y = np.concatenate([y for _, y in data_stream(4)])
    mod = SPMDModule(bench_mlp(jmx), mesh=build_mesh(
        {"dp": 2}, jax.devices()[:2]), grad_sync="zero3")
    mod.fit(jmx.io.NDArrayIter(X, y, batch_size=BATCH), num_epoch=1,
            optimizer="sgd", optimizer_params={"learning_rate": 0.05})
    assert str(ranks[0]["module_plan"]) == mod.sharding_plan.to_json()
    assert str(ranks[1]["module_plan"]) == mod.sharding_plan.to_json()


def test_plan_adopted_at_another_world_replans(two_ranks):
    _, ranks = two_ranks
    for r in ranks:
        assert list(r["replan"]) == ["zero3", "2", str(BATCH)]


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, REPO)
    (analysis_worker if sys.argv[6:7] == ["analysis"] else worker)(
        sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
