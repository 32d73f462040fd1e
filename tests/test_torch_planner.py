"""The port's sharding planner against the JAX package's.

``planner.plan`` is host arithmetic over the graph: given the same
symbol, inventory, budget and options, the port's ``ShardingPlan`` JSON
must equal the JAX package's byte for byte (and so its digest, its
``explain()`` text and its ``check_inventory`` verdicts).  Cases: an
MLP, ResNet-50 and the LSTM LM at worlds 1, 2, 4 and 8 and budgets from
unconstrained to "nothing fits"; sgd and adam; a bfloat16 compute dtype;
a pinned grad_sync.  A plan that needs ``tp`` raises, naming the item
that brings it; the descriptive plan of a one-device trainer matches
too.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.parallel import planner as jplan
from mxnet_tpu_torch.parallel import planner as tplan


def _sym(mx, name):
    with mx.name.NameManager():
        if name == "mlp":
            data = mx.sym.Variable("data")
            net = mx.sym.FullyConnected(data, num_hidden=1024, name="fc1")
            net = mx.sym.Activation(net, act_type="relu")
            net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
            return (mx.sym.SoftmaxOutput(net, name="softmax"),
                    [("data", (64, 256))], [("softmax_label", (64,))])
        if name == "resnet50":
            return (mx.models.get_symbol("resnet", num_layers=50,
                                         num_classes=1000,
                                         image_shape=(3, 224, 224)),
                    [("data", (32, 3, 224, 224))],
                    [("softmax_label", (32,))])
        lm = mx.models.lstm_lm.lstm_lm_sym(32, 10000, 200, 200, 2)[0]
        return lm, [("data", (32, 32))], [("softmax_label", (32, 32))]


def _both(name, **kw):
    out = []
    for mx, pl in ((jmx, jplan), (tmx, tplan)):
        sym, data, label = _sym(mx, name)
        try:
            out.append(pl.plan(sym, data, label, **kw))
        except Exception as e:  # noqa: BLE001 — the message is compared
            out.append(e)
    return out


CASES = [
    ("mlp", dict(world=1)),
    ("mlp", dict(world=2, hbm_budget=0)),
    ("mlp", dict(world=4, hbm_budget=2_000_000)),
    ("mlp", dict(world=4, hbm_budget=1_000_000)),
    ("mlp", dict(world=8, hbm_budget=1_500_000, optimizer="adam")),
    ("mlp", dict(world=8, hbm_budget=10)),
    ("mlp", dict(world=3, hbm_budget=0)),
    ("mlp", dict(world=4, grad_sync="zero3", compute_dtype="bfloat16",
                 gather_bucket=1 << 20)),
    ("resnet50", dict(world=2, hbm_budget=300_000_000,
                      optimizer_params={"momentum": 0.9})),
    ("resnet50", dict(world=8, hbm_budget=60_000_000,
                      optimizer_params={"momentum": 0.9})),
    ("resnet50", dict(world=4, grad_sync="zero3")),
    ("lstm_lm", dict(world=2, hbm_budget=30_000_000, optimizer="rmsprop")),
    ("lstm_lm", dict(world=8, grad_sync="zero")),
]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_plan_json_equals_jax(name, kw):
    j, t = _both(name, **kw)
    if isinstance(j, Exception):
        assert isinstance(t, tmx.MXNetError), t
        assert str(t) == str(j)
        return
    assert t.to_json() == j.to_json()
    assert t.digest() == j.digest()
    assert t.explain() == j.explain()
    for n in (1, 2, 3, 4, 16):
        for budget in (None, 1_000_000, 10 ** 10):
            assert t.check_inventory(n, budget) == \
                j.check_inventory(n, budget), (n, budget)
    assert tplan.check_inventory(t.to_doc(), 4) == \
        jplan.check_inventory(j.to_doc(), 4)


def test_plan_round_trips_through_a_file(tmp_path):
    t = tplan.plan(*_sym(tmx, "mlp"), world=4, hbm_budget=3_000_000,
                   optimizer_params={"momentum": 0.9})
    path = t.save(str(tmp_path / "plan.json"))
    back = tplan.ShardingPlan.load(path)
    assert back.to_json() == t.to_json() and back.digest() == t.digest()
    j = jplan.ShardingPlan.load(path)       # the JAX package reads it
    assert j.to_json() == t.to_json()
    assert tplan.ShardingPlan.from_doc(t.to_doc()).grad_sync == \
        back.grad_sync == "zero"
    bad = dict(t.to_doc(), version=99)
    with pytest.raises(tmx.MXNetError, match="unsupported plan version"):
        tplan.ShardingPlan(bad)
    assert tplan.check_inventory(bad, 4)[0]


def test_diff_param_sets_equals_jax():
    saved = {"a": {"shape": [2, 3]}, "b": {"shape": [4]}}
    for current in (["a", "b"], ["a", "c"], {"a": (2, 3), "b": (5,)},
                    {"a": (2, 3)}):
        assert tplan.diff_param_sets(saved, current) == \
            jplan.diff_param_sets(saved, current)


def test_plan_needing_tp_raises_naming_the_next_item():
    """A plan with tp rules equals the JAX package's, over a context list
    (an in-process mesh) and over a world of ranks alike (the inventory is
    ranks x contexts; tests/test_torch_hybrid_mesh.py plans over a real
    process group)."""
    sym, data, label = _sym(tmx, "mlp")
    rules = {"fc1_weight": ("tp", None)}
    over_ranks = tplan.plan(sym, data, label, world=4,
                            param_shardings=rules).to_doc()
    got = tplan.plan(sym, data, label, devices=[tmx.cpu()] * 4,
                     param_shardings=rules).to_doc()
    assert over_ranks == got
    jsym, jdata, jlabel = _sym(jmx, "mlp")
    want = jplan.plan(jsym, jdata, jlabel, world=4,
                      param_shardings=rules).to_doc()
    assert got == want
    with pytest.raises(tmx.MXNetError,
                       match="multiply to 4 but 1 devices"):
        tmx.parallel.build_mesh({"dp": 4})


def test_trainer_plan_equals_jax_on_one_device():
    docs = []
    for mx in (jmx, tmx):
        sym, data, label = _sym(mx, "mlp")
        kw = {"ctx": tmx.cpu()} if mx is tmx else {}
        tr = mx.parallel.SPMDTrainer(sym, "sgd", {"momentum": 0.9},
                                     mesh=None, **kw)
        tr.bind(data, label)
        docs.append(tr.sharding_plan.to_json())
    assert docs[0] == docs[1]
    doc = json.loads(docs[1])
    assert doc["world"] == 1 and doc["grad_sync"] == "allreduce"


def test_trainer_adopts_a_plan():
    sym, data, label = _sym(tmx, "mlp")
    p = tplan.plan(sym, data, label, world=4, hbm_budget=3_000_000,
                   optimizer_params={"momentum": 0.9})
    assert p.grad_sync == "zero"
    tr = tmx.parallel.SPMDTrainer(sym, "sgd", {}, plan=p.to_doc(),
                                  ctx=tmx.cpu())
    assert tr.grad_sync == p.grad_sync
    tr.bind(data, label)
    tr.init_params(tmx.initializer.Xavier())
    # one device: the policy is kept, nothing shards (world 1)
    assert tr.sharding_plan.world == 1 and not tr._zero3_dims
    x = np.random.RandomState(0).standard_normal((64, 256)).astype("f")
    tr.step(x, np.zeros(64, "f"))


def test_plan_explain_reads_the_ports_mesh_plans(tmp_path, monkeypatch):
    """The unedited ``tools/plan_explain.py --check --devices N`` on what
    the port's zero3 trainer over an in-process dp 4 mesh writes: its
    plan JSON, a gather-on-save checkpoint directory and a
    sharded-native one (``MXTPU_CKPT_SHARDED=1``).  Each explains the
    manual tier and its gather group, fits 4 devices (exit 0) and not 3
    (exit 1: batch 64 does not split three ways)."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = tmx.sym.Variable("data")
    net = tmx.sym.FullyConnected(data, num_hidden=64, name="fc1")
    net = tmx.sym.Activation(net, act_type="relu")
    net = tmx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    net = tmx.sym.SoftmaxOutput(net, name="softmax")
    mesh = tmx.parallel.build_mesh({"dp": 4}, [tmx.cpu()] * 4)
    tr = tmx.parallel.SPMDTrainer(net, "sgd", {"momentum": 0.9}, mesh=mesh,
                                  grad_sync="zero3", ctx=tmx.cpu())
    tr.bind([("data", (64, 10))], [("softmax_label", (64,))])
    tr.init_params(tmx.initializer.Xavier())
    rs = np.random.RandomState(0)
    tr.step(rs.rand(64, 10).astype("f"), rs.randint(0, 4, 64).astype("f"))
    targets = [str(tmp_path / "plan.json"), str(tmp_path / "gathered"),
               str(tmp_path / "sharded")]
    tr.sharding_plan.save(targets[0])
    tr.save_checkpoint(tmx.resilience.CheckpointManager(targets[1]), 1)
    monkeypatch.setenv("MXTPU_CKPT_SHARDED", "1")
    tr.save_checkpoint(tmx.resilience.CheckpointManager(targets[2]), 1)
    entry = tmx.resilience.CheckpointManager(targets[2]).entry(1)
    assert entry["format"] == 2 and entry["shard_set"]["world"] == 4
    group = ", ".join(tr._zero3_groups[0])
    for target in targets:
        for n, rc, verdict in ((4, 0, "FITS"), (3, 1, "DOES NOT FIT")):
            res = subprocess.run(
                [sys.executable, os.path.join(repo, "tools",
                                              "plan_explain.py"),
                 target, "--check", "--devices", str(n)],
                capture_output=True, text=True, timeout=120, cwd=repo)
            assert res.returncode == rc, (target, n, res.stdout, res.stderr)
            assert "grad_sync='zero3' tier=manual" in res.stdout
            assert "gather groups (1," in res.stdout
            assert "[0] %s (" % group in res.stdout
            assert "%s on %d device(s)" % (verdict, n) in res.stdout
    tr.close()
