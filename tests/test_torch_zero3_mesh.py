"""``zero`` and ``zero3`` on the port's mesh inside one process, against
the JAX package's trainer on its 8 virtual CPU devices and against the
port's own ``allreduce`` step.

The port's meshes run over ``[cpu()] * n`` (one thread a position,
``parallel/collectives.py``); the JAX package's over the conftest's 8
devices.  Both start from the same numpy weights (or the same seeded
initializer where only the port runs) and take the same numpy batches.

- zero and zero3 on a pure-dp mesh (the manual tier) against the port's
  allreduce: bit-equal (every element of a reduce-scatter is the same
  sum, in the same position order, as the all-reduce's); against the
  JAX package's same ``grad_sync``: rtol 1e-4 / atol 1e-5 after 4 steps
  (float32 sums in other orders);
- zero3 composed with a ``tp`` rule (the gspmd tier), the kept rule
  spec and its plan decision, the guard, gather-on-save and
  sharded-native checkpoints (elastic onto dp 2, 4, 8, one device and
  dp 2 x tp 2, bit-identical), ``SPMDModule.fit``, the remat mode on a
  BatchNorm net at dp 2 x tp 2 (bit-equal to the step without it),
  ``analyze`` and ``MXTPU_ANALYZE=strict`` on the mesh;
- a narrow ResNet at dp 2 x tp 2 under zero3 against the JAX gspmd
  trainer (rtol 1e-3 / atol 1e-4 after 2 steps);
- two runs of the long-context LM's dp 2 x sp 4 step update bit-equal;
  the launch counters lose no count when eight positions add at once.
"""
import pickle
import sys

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.parallel import collectives as C

SGD = {"learning_rate": 0.3, "rescale_grad": 1.0 / 64, "momentum": 0.9}
#: the port's step against the JAX package's after a few steps
JAX_TOL = dict(rtol=1e-4, atol=1e-5)


def mlp_sym(mx, num_classes=4, nh=64):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=nh, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=num_classes, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def make_blobs(n, d, c, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(c, d) * 3
    X = np.concatenate([centers[i] + rs.randn(n // c, d)
                        for i in range(c)]).astype("f")
    y = np.concatenate([np.full(n // c, i) for i in range(c)]).astype("f")
    perm = rs.permutation(len(X))
    return X[perm], y[perm]


def _mesh(mx, axes):
    n = int(np.prod(list(axes.values())))
    if mx is tmx:
        return tmx.parallel.build_mesh(axes, [tmx.cpu()] * n)
    return jmx.parallel.build_mesh(axes, jax.devices()[:n])


def _weights(sym, shape, seed):
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    args = {n: rs.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (rs.uniform(0.8, 1.2, s) if n.endswith("_var")
               else 0.1 * rs.standard_normal(s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _trainer(mx, axes, sync, sym=None, shape=(64, 10), opt=None, rules=None,
             seed=None, weights=None, cls=None, **kw):
    """A bound, initialised trainer: from ``weights`` (numpy ``(args,
    aux)``) or from Xavier after ``mx.random.seed(seed)``."""
    sym = sym if sym is not None else mlp_sym(mx)
    cls = cls or mx.parallel.SPMDTrainer
    mesh = _mesh(mx, axes) if axes else None
    extra = {"ctx": tmx.cpu()} if mx is tmx else {}
    tr = cls(sym, "sgd", dict(opt or SGD), mesh=mesh, grad_sync=sync,
             param_shardings=rules, **extra, **kw)
    tr.bind([("data", shape)], [("softmax_label", (shape[0],))])
    if weights is not None:
        args, aux = weights
        if mx is jmx:
            args = {k: jmx.nd.array(v) for k, v in args.items()}
            aux = {k: jmx.nd.array(v) for k, v in aux.items()}
        tr.init_params(None, arg_params=args, aux_params=aux)
    else:
        mx.random.seed(seed)
        tr.init_params(mx.initializer.Xavier())
    return tr


def _params(tr):
    arg, aux = tr.get_params()
    return {k: v.asnumpy() for k, v in list(arg.items()) + list(aux.items())}


def _run(tr, X, y, batch=64):
    for i in range(0, len(X), batch):
        tr.step(X[i:i + batch], y[i:i + batch])
    return _params(tr)


def _close(got, want, tol, what=""):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=what + k, **tol)


def _equal(got, want, what=""):
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=what + k)


# ---------------------------------------------------------------------------
# the manual tier (pure dp) against allreduce and the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sync", ["zero", "zero3"])
def test_sharded_step_matches_allreduce_and_jax(sync):
    """zero (JAX ``test_spmd_trainer_zero_matches_allreduce``, rtol 2e-5
    there) and zero3 (``..._zero3_matches_allreduce_bitwise``) at dp 8:
    the master params and momentum live 1/8 a position, the update is
    bit-equal to the port's allreduce and within JAX_TOL of the JAX
    package's same grad_sync."""
    X, y = make_blobs(256, 10, 4)
    weights = _weights(mlp_sym(tmx), (64, 10), 33)
    got = {}
    for s in ("allreduce", sync):
        tr = _trainer(tmx, {"dp": 8}, s, weights=weights)
        if s == sync:
            assert tr.zero3_tier == ("manual" if sync == "zero3" else None)
            w = tr.params["fc1_weight"]
            assert tuple(w.sharding.spec) == ("dp", None)
            assert w.parts[0].shape == (8, 10)
            assert tr.opt_state["fc1_weight"][0].parts[3].shape == (8, 10)
        got[s] = _run(tr, X, y)
        tr.close()
    _equal(got[sync], got["allreduce"], sync + ":")
    jtr = _trainer(jmx, {"dp": 8}, sync, weights=weights)
    _close(got[sync], _run(jtr, X, y), JAX_TOL, "jax:")
    jtr.close()


def test_zero3_param_residency_is_one_over_world():
    tr = _trainer(tmx, {"dp": 8}, "zero3", seed=1)
    whole = sum(int(np.prod(v.shape)) * 4 for v in tr.params.values())
    for pos in (0, 5):
        held = tr.resident_bytes(position=pos)
        assert held["params"] / whole <= 1.0 / 8 + 0.05, (held, whole)
        assert held["opt_state"] == held["params"]
    # the indivisible residue (fc2_bias, 4 over 8) stays whole
    assert "fc2_bias" not in tr._zero3_dims
    assert tr.params["fc2_bias"].parts[0].shape == (4,)
    tr.close()


@pytest.mark.parametrize("group", ["1", "2", None])
def test_zero3_gather_groups_follow_plan_order(monkeypatch, group):
    """The groups equal the JAX trainer's for MXTPU_ZERO3_GATHER_GROUP=1,
    2 and the planner's default, in plan order (fc1's before fc2's)."""
    if group is None:
        monkeypatch.delenv("MXTPU_ZERO3_GATHER_GROUP", raising=False)
    else:
        monkeypatch.setenv("MXTPU_ZERO3_GATHER_GROUP", group)
    t = _trainer(tmx, {"dp": 8}, "zero3", seed=1)
    j = _trainer(jmx, {"dp": 8}, "zero3", seed=1)
    assert t._zero3_groups == j._zero3_groups
    assert t._zero3_dims == j._zero3_dims
    groups = t._zero3_groups
    ix1 = next(i for i, g in enumerate(groups) if "fc1_weight" in g)
    ix2 = next(i for i, g in enumerate(groups) if "fc2_weight" in g)
    assert ix1 <= ix2
    assert sorted(n for g in groups for n in g) == sorted(t._zero3_dims)
    # one layout (one bucketed all-gather) a group
    assert [lay.names for lay in t._layouts] == groups
    t.close()
    j.close()


# ---------------------------------------------------------------------------
# the gspmd tier: dp x tp
# ---------------------------------------------------------------------------

def test_zero3_composes_with_tp():
    """JAX ``test_zero3_composes_with_tp`` (dp 4 x tp 2): the gspmd tier,
    fc1_weight keeps ('tp', None), fc1_bias is dp-sharded, accuracy above
    0.9 after 12 epochs; and the params after four steps against the
    JAX gspmd trainer's from the same weights (JAX_TOL)."""
    X, y = make_blobs(256, 16, 4, seed=2)
    rules = {r"fc1_weight": ("tp", None)}
    opt = {"learning_rate": 0.5, "rescale_grad": 1.0 / 64}
    tr = _trainer(tmx, {"dp": 4, "tp": 2}, "zero3", shape=(64, 16), opt=opt,
                  rules=rules, seed=4)
    assert tr.zero3_tier == "gspmd"
    assert tuple(tr.params["fc1_weight"].sharding.spec) == ("tp", None)
    assert tr.params["fc1_weight"].parts[0].shape == (32, 16)
    assert "fc1_bias" in tr._zero3_dims and "fc1_weight" not in \
        tr._zero3_dims
    for _ in range(12):
        _run(tr, X, y)
    outs = tr.eval_step(X[:64], y[:64])
    acc = (outs[0].numpy().argmax(1) == y[:64]).mean()
    assert acc > 0.9, acc
    tr.close()
    weights = _weights(mlp_sym(tmx), (64, 16), 12)
    got = []
    for mx in (tmx, jmx):
        t = _trainer(mx, {"dp": 4, "tp": 2}, "zero3", shape=(64, 16),
                     opt=opt, rules=rules, weights=weights)
        assert t.zero3_tier == "gspmd"
        got.append(_run(t, X, y))
        t.close()
    _close(got[0], got[1], JAX_TOL, "jax:")


def test_zero_keeps_explicit_rule_spec_and_records_decision():
    """JAX ``test_zero_keeps_explicit_rule_spec_and_records_decision``:
    under zero the tp rule keeps its spec through the steps, the plan
    records the kept spec, and the update equals allreduce's (rtol 2e-6
    / atol 1e-7 in the JAX test; bit-equal here)."""
    X, y = make_blobs(256, 16, 4, seed=2)
    weights = _weights(mlp_sym(tmx), (64, 16), 11)
    rules = {r"fc1_weight": ("tp", None)}
    got = {}
    for sync in ("allreduce", "zero"):
        tr = _trainer(tmx, {"dp": 4, "tp": 2}, sync, shape=(64, 16),
                      rules=rules, weights=weights)
        got[sync] = _run(tr, X, y)
        assert tr.params["fc1_weight"].sharding.spec[0] == "tp"
        if sync == "zero":
            decs = tr.sharding_plan.decisions
            assert any("fc1_weight: explicit shard spec" in d and "kept" in d
                       and "'zero'" in d for d in decs), decs
            assert tuple(tr.params["fc2_weight"].spec) == ("dp", None)
        tr.close()
    _equal(got["zero"], got["allreduce"])


@pytest.mark.parametrize("sync,axes", [("zero3", {"dp": 8}),
                                       ("zero", {"dp": 4, "tp": 2})])
def test_plan_json_equals_jax(sync, axes):
    """The trainer's plan under zero/zero3 (tier, groups, kept-rule
    decisions) and the planner's plan for the same inventory equal the
    JAX package's."""
    rules = {r"fc1_weight": ("tp", None)} if "tp" in axes else None
    docs = []
    for mx in (jmx, tmx):
        tr = _trainer(mx, axes, sync, rules=rules, seed=1)
        doc = tr.sharding_plan.to_doc()
        doc.pop("gather_bucket", None)
        doc["decisions"] = [d for d in doc["decisions"] if "tp form" not in d]
        docs.append(doc)
        tr.close()
    assert docs[0]["grad_sync"] == sync and docs[0]["gather_groups"] == \
        docs[1]["gather_groups"]
    assert docs[0] == docs[1]
    n = int(np.prod(list(axes.values())))
    pdocs = []
    for mx, devices in ((jmx, jax.devices()[:n]), (tmx, [tmx.cpu()] * n)):
        p = mx.parallel.planner.plan(mlp_sym(mx), [("data", (64, 10))],
                                     [("softmax_label", (64,))],
                                     devices=devices, grad_sync=sync)
        pdocs.append(p.to_doc())
    assert pdocs[0] == pdocs[1] and pdocs[1]["gather_groups"]


# ---------------------------------------------------------------------------
# guard, checkpoints, batch checks, Module
# ---------------------------------------------------------------------------

def test_zero3_guard_skips_poisoned_step():
    from mxnet_tpu_torch.resilience import faults
    X, y = make_blobs(128, 10, 4)
    tr = _trainer(tmx, {"dp": 8}, "zero3", seed=2,
                  opt={"learning_rate": 0.3, "momentum": 0.9})
    tr.step(X[:64], y[:64])
    before = _params(tr)
    ptr = tr.params["fc1_weight"].parts[3].data_ptr()
    faults.disarm()
    try:
        faults.arm("poison_grad", times=1)
        tr.step(X[64:128], y[64:128])
    finally:
        faults.disarm()
    assert tr.skipped_steps == 1
    _equal(_params(tr), before)
    tr.step(X[64:128], y[64:128])
    assert tr.skipped_steps == 1
    assert tr.params["fc1_weight"].parts[3].data_ptr() == ptr
    tr.close()


def test_zero3_checkpoint_roundtrip_bit_identical(tmp_path):
    """Gather-on-save under zero3 on the mesh: restore re-shards and the
    continued step is bit-identical to the uninterrupted run."""
    X, y = make_blobs(192, 10, 4)
    opt = {"learning_rate": 0.3, "momentum": 0.9}
    mgr = tmx.resilience.CheckpointManager(str(tmp_path))
    a = _trainer(tmx, {"dp": 8}, "zero3", seed=6, opt=opt)
    a.step(X[:64], y[:64])
    a.step(X[64:128], y[64:128])
    a.save_checkpoint(mgr, 1)
    a.step(X[128:], y[128:])
    want = _params(a)
    a.close()
    b = _trainer(tmx, {"dp": 8}, "zero3", seed=99, opt=opt)
    assert b.restore(mgr) == 1
    assert tuple(b.params["fc1_weight"].sharding.spec) == ("dp", None)
    b.step(X[128:], y[128:])
    _equal(_params(b), want)
    b.close()


def test_zero3_indivisible_batch_raises():
    tr = _trainer(tmx, {"dp": 8}, "zero3", seed=1)
    X, y = make_blobs(60, 10, 4)
    with pytest.raises(tmx.MXNetError, match="zero3"):
        tr.step(X[:60], y[:60])
    tr.close()


def test_spmd_module_fit_zero3():
    """SPMDModule(grad_sync='zero3') over a context list drives
    BaseModule.fit unchanged (JAX ``test_spmd_module_fit_zero3``)."""
    X, y = make_blobs(512, 10, 3, seed=1)
    mod = tmx.parallel.SPMDModule(mlp_sym(tmx, num_classes=3, nh=32),
                                  mesh=_mesh(tmx, {"dp": 8}),
                                  grad_sync="zero3")
    tmx.random.seed(3)
    with tmx.cpu():
        mod.fit(tmx.io.NDArrayIter(X, y, batch_size=64, shuffle=True),
                num_epoch=5, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5},
                initializer=tmx.initializer.Xavier(), kvstore="tpu")
        score = mod.score(tmx.io.NDArrayIter(X, y, batch_size=64), "acc")
    assert mod._trainer.zero3_tier == "manual"
    assert score[0][1] > 0.95, score


def test_zero3_sharded_native_checkpoint_roundtrip_and_elastic(
        tmp_path, monkeypatch):
    """MXTPU_CKPT_SHARDED=1 on the mesh: one blob a dp shard (world 4, a
    format-2 entry), the same-world restore continues bit-identically,
    and the four blobs restore bit-identically (params, momentum,
    num_update) onto dp 2, dp 8, one device and dp 2 x tp 2."""
    import os
    monkeypatch.setenv("MXTPU_CKPT_SHARDED", "1")
    X, y = make_blobs(192, 10, 4)
    opt = {"learning_rate": 0.3, "momentum": 0.9}
    mgr = tmx.resilience.CheckpointManager(str(tmp_path))
    a = _trainer(tmx, {"dp": 4}, "zero3", seed=6, opt=opt)
    a.step(X[:64], y[:64])
    a.step(X[64:128], y[64:128])
    a.save_checkpoint(mgr, 1)
    entry = mgr.entry(1)
    assert entry["format"] == 2 and entry["params"] is None
    assert entry["shard_set"]["world"] == 4
    assert len(entry["shard_set"]["files"]) == 4
    for rec in entry["shard_set"]["files"]:
        assert os.path.exists(os.path.join(str(tmp_path), rec["file"]))
    saved = _params(a)
    states = pickle.loads(a.get_states())
    a.step(X[128:], y[128:])
    after = _params(a)
    a.close()
    b = _trainer(tmx, {"dp": 4}, "zero3", seed=99, opt=opt)
    assert b.restore(mgr) == 1
    assert tuple(b.params["fc1_weight"].sharding.spec) == ("dp", None)
    b.step(X[128:], y[128:])
    _equal(_params(b), after)
    b.close()
    for axes, sync, rules in (({"dp": 2}, "zero3", None),
                              ({"dp": 8}, "zero3", None),
                              (None, "allreduce", None),
                              ({"dp": 2, "tp": 2}, "zero3",
                               {r"fc1_weight": ("tp", None)})):
        c = _trainer(tmx, axes, sync, seed=99, opt=opt, rules=rules)
        assert c.restore(mgr) == 1
        what = "%s:" % (axes,)
        _equal(_params(c), saved, what)
        got = pickle.loads(c.get_states())
        assert got["num_update"] == states["num_update"]
        assert set(got["states"]) == set(states["states"])
        for name, slots in states["states"].items():
            for i, s in enumerate(slots):
                np.testing.assert_array_equal(
                    np.asarray(got["states"][name][i]), np.asarray(s),
                    err_msg="%s%s[%d]" % (what, name, i))
        c.close()


# ---------------------------------------------------------------------------
# remat with collectives inside the recomputed segments
# ---------------------------------------------------------------------------

def conv_sym(mx, nf=8):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, num_filter=nf, kernel=(3, 3), pad=(1, 1),
                             no_bias=True, name="conv1")
    net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.Convolution(net, num_filter=nf, kernel=(3, 3), pad=(1, 1),
                             name="conv2")
    net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn2")
    net = mx.sym.Activation(net, act_type="relu", name="relu2")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = mx.sym.Flatten(net)
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc1")
    return mx.sym.SoftmaxOutput(net, name="softmax")


CONV_RULES = {r"conv\d_weight": ("tp", None, None, None),
              r"fc1_weight": (None, "tp")}


def _conv_batches(n, seed=6, shape=(8, 3, 8, 8)):
    rs = np.random.RandomState(seed)
    return [(rs.standard_normal(shape).astype(np.float32),
             rs.randint(0, 4, shape[0]).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("dp", [4, 8])
def test_zero3_manual_tier_batchnorm_matches_jax(dp):
    """The manual tier on a BatchNorm net at dp 4 and dp 8 over ``[cpu()]
    * dp``: each position normalises its own rows and the moving
    statistics are averaged over ``dp`` (the JAX tier's ``shard_map``
    body and ``pmean``).  Params and moving statistics after three steps
    against the JAX manual-tier trainer's from the same weights and
    batches (JAX_TOL: float32 sums in other orders); the moving variance
    is not the allreduce step's (global statistics), so the test sees
    which statistics were averaged."""
    shape = (16, 3, 8, 8)
    weights = _weights(conv_sym(tmx), shape, 9)
    batches = _conv_batches(3, seed=10, shape=shape)
    opt = dict(SGD, learning_rate=0.1, rescale_grad=1.0 / shape[0])
    got = {}
    for mx, sync in ((tmx, "zero3"), (jmx, "zero3"), (tmx, "allreduce")):
        tr = _trainer(mx, {"dp": dp}, sync, sym=conv_sym(mx), shape=shape,
                      opt=opt, weights=weights)
        assert tr.zero3_tier == ("manual" if sync == "zero3" else None)
        if mx is tmx and sync == "zero3":
            assert "bn1_gamma" in tr._zero3_dims
        for xb, yb in batches:
            tr.step(xb, yb)
        got[mx.__name__, sync] = _params(tr)
        tr.close()
    port = got["mxnet_tpu_torch", "zero3"]
    _close(port, got["mxnet_tpu", "zero3"], JAX_TOL, "jax:")
    for k in ("bn1_moving_var", "bn2_moving_var"):
        assert not np.allclose(port[k], got["mxnet_tpu_torch",
                                            "allreduce"][k], **JAX_TOL), k


@pytest.mark.parametrize("sync", ["allreduce", "zero3"])
def test_spmd_trainer_remat_matches_on_a_mesh(sync):
    """JAX ``test_spmd_trainer_remat_matches`` (rtol 1e-6 there) on a dp 2
    x tp 2 mesh with a BatchNorm net: the recomputed segments hold
    BatchNorm's global-statistics psum and the tp forms' collectives,
    which the recompute replays from the first run (no position waits at
    a rendezvous in the backward); under zero3 the recompute re-gathers
    the dropped groups.  Params, moving statistics and outputs after
    three steps are bit-equal to the step without remat."""
    sym = conv_sym(tmx)
    shape = (8, 3, 8, 8)
    weights = _weights(sym, shape, 5)
    got = []
    for remat in (False, True):
        tr = _trainer(tmx, {"dp": 2, "tp": 2}, sync, sym=sym, shape=shape,
                      opt=dict(SGD, rescale_grad=1.0 / 8), rules=CONV_RULES,
                      weights=weights, remat=remat)
        assert bool(tr._eval.segments) == remat
        outs = [tr.step(xb, yb)[0].numpy() for xb, yb in _conv_batches(3)]
        got.append((_params(tr), outs))
        if sync == "zero3":
            assert tr.zero3_tier == "gspmd" and "bn1_gamma" in \
                tr._zero3_dims
        tr.close()
    _equal(got[1][0], got[0][0])
    np.testing.assert_array_equal(got[1][1][-1], got[0][1][-1])
    assert not np.array_equal(got[0][0]["bn1_moving_mean"],
                              weights[1]["bn1_moving_mean"])


def test_segment_tape_replays_the_first_run():
    """A checkpointed segment run by a mesh position keeps its
    collectives' outputs; the recompute on the caller's thread replays
    them, and a recompute that calls another collective raises."""
    mesh = _mesh(tmx, {"dp": 2})
    leaves = [torch.tensor([1.0, 2.0], requires_grad=True),
              torch.tensor([3.0, 5.0], requires_grad=True)]
    calls = []

    def seg(x, tape):
        with tape.scope():
            calls.append(C.current() is not None)
            return C.psum(x * x, "dp") * x

    def position(x):
        tape = C.segment_tape()
        return torch.utils.checkpoint.checkpoint(seg, x, tape,
                                                 use_reentrant=False)
    outs = C.run(mesh, position, [(x,) for x in leaves])
    grads = torch.autograd.grad(outs, leaves, [torch.ones(2)] * 2)
    # y_i = s * x_i with s = x_0^2 + x_1^2: dy/dx_i = s + 2 x_i (x_0 + x_1)
    s = torch.tensor([10.0, 29.0])
    total = leaves[0].detach() + leaves[1].detach()
    for x, g in zip(leaves, grads):
        torch.testing.assert_close(g, s + 2 * x.detach() * total)
    assert len(calls) == 4 and calls.count(True) == 4
    assert C.segment_tape() is None     # outside a position
    tape = C.SegmentTape(None)
    tape.items = [(("_PSum", ("dp",), ()), torch.ones(1), False)]
    with tape.scope(), pytest.raises(tmx.MXNetError, match="recompute"):
        C.all_gather(torch.ones(1), "dp")


# ---------------------------------------------------------------------------
# analyze and MXTPU_ANALYZE on the mesh
# ---------------------------------------------------------------------------

class LeftOut(tmx.parallel.SPMDTrainer):
    """A broken sharding: fc1_weight stays replicated under zero3."""

    def _param_spec(self, name, shape):
        if name == "fc1_weight":
            return ()
        return super()._param_spec(name, shape)


TIERS = {"manual": ({"dp": 8}, None, (64, 10)),
         "gspmd": ({"dp": 4, "tp": 2}, {r"fc2_weight": (None, "tp")},
                   (64, 16))}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_analyze_holds_zero3_on_the_mesh(tier):
    """``analyze`` on both tiers (JAX ``test_zero3_schedule_proven_by_
    analyze``, whose JAX call fails under jax 0.9.0 at
    graph_lint.py:168): ok, the declared schedule, all-gather bytes
    within 0.75-2.25x of the expected (a forward gather and the backward
    re-gather), one reduce-scatter a group, the all-reduce beyond the
    plan's own below half the expected; the carries as they were."""
    axes, rules, shape = TIERS[tier]
    X, y = make_blobs(64, shape[1], 4)
    tr = _trainer(tmx, axes, "zero3", shape=shape, rules=rules, seed=1)
    tr.step(X, y)
    before = _params(tr)
    ptrs = [p.data_ptr() for p in tr.params["fc1_weight"].parts]
    rep = tr.analyze(X, y)
    assert rep.ok, rep.format_text()
    assert rep.stats["schedule"]["declared"] == "zero3-" + tier
    coll = rep.stats["data_axis_collectives"]
    expect, owed = tr._zero3_schedule_bytes()
    assert expect == tr._zero3_expected_gather_bytes() > 0
    assert 0.75 * expect <= coll["all-gather"]["bytes"] <= 2.25 * expect, \
        coll
    assert coll["reduce-scatter"]["count"] == len(tr._zero3_groups), coll
    assert coll["all-reduce"]["bytes"] - owed < 0.5 * expect, (coll, owed)
    assert rep.stats["collectives"]["all-gather"]["count"] >= \
        coll["all-gather"]["count"]
    _equal(_params(tr), before)
    assert [p.data_ptr() for p in tr.params["fc1_weight"].parts] == ptrs
    tr.close()


def test_analyze_flags_unsharded_zero3_on_the_mesh():
    X, y = make_blobs(64, 10, 4)
    tr = _trainer(tmx, {"dp": 8}, "zero3", seed=1, cls=LeftOut)
    rep = tr.analyze(X, y)
    assert not rep.ok
    assert "graph-collective-schedule" in {f.rule for f in rep.findings}
    tr.close()


def test_env_analyze_strict_on_the_mesh(monkeypatch):
    """JAX ``test_env_analyze_strict_{refuses_unsharded,accepts_real}_
    zero3`` on an in-process mesh: strict refuses the left-out sharding
    before its first step trains, and lints and trains a real one."""
    monkeypatch.setenv("MXTPU_ANALYZE", "strict")
    X, y = make_blobs(64, 10, 4)
    bad = _trainer(tmx, {"dp": 8}, "zero3", seed=1, cls=LeftOut)
    before = _params(bad)
    with pytest.raises(tmx.MXNetError, match="graph-collective-schedule"):
        bad.step(X, y)
    _equal(_params(bad), before)
    bad.close()
    good = _trainer(tmx, {"dp": 8}, "zero3", seed=1)
    good.step(X, y)
    assert good._analyzed_keys and good._num_update == 1
    assert not np.array_equal(_params(good)["fc1_weight"],
                              before["fc1_weight"])
    good.close()


# ---------------------------------------------------------------------------
# the slice as a whole: a narrow ResNet at dp 2 x tp 2 under zero3
# ---------------------------------------------------------------------------

RESNET_RULES = {r"fc1_weight": ("tp", None),
                r"stage3_unit\d+_conv\d_weight": ("tp", None, None, None)}


def test_resnet_zero3_dp2_tp2_matches_jax():
    """A ResNet-8 (widths 16-64) at global batch 8 on dp 2 x tp 2 with
    its last stage's convs and the classifier tp-ruled, zero3 (the
    gspmd tier, global BatchNorm statistics): the first two steps'
    params and moving statistics against the JAX gspmd trainer's from
    the same weights (rtol 1e-3 / atol 1e-4: float32 sums of a
    BatchNorm net in other orders)."""
    shape = (8, 3, 16, 16)
    got = []
    for mx in (tmx, jmx):
        with mx.name.NameManager():
            sym = mx.models.get_symbol("resnet", num_layers=8, num_classes=8,
                                       image_shape=shape[1:])
        if not got:
            weights = _weights(sym, shape, 21)
        tr = _trainer(mx, {"dp": 2, "tp": 2}, "zero3", sym=sym, shape=shape,
                      opt={"learning_rate": 0.1, "momentum": 0.9,
                           "wd": 1e-4, "rescale_grad": 1.0 / 8},
                      rules=RESNET_RULES, weights=weights)
        assert tr.zero3_tier == "gspmd"
        rs = np.random.RandomState(22)
        for _ in range(2):
            tr.step(rs.standard_normal(shape).astype(np.float32),
                    rs.randint(0, 8, shape[0]).astype(np.float32))
        if mx is tmx:
            assert tr.tp_forms and set(tr.tp_forms.values()) == {"column"}
            assert len(tr._zero3_dims) > 10
        got.append(_params(tr))
        tr.close()
    _close(got[0], got[1], dict(rtol=1e-3, atol=1e-4), "jax:")


# ---------------------------------------------------------------------------
# ROADMAP queue 3: reproducible mesh steps, counters under COUNT_LOCK
# ---------------------------------------------------------------------------

def test_lm_dp2_sp4_step_is_bit_reproducible():
    """Two runs of the long-context LM's dp 2 x sp 4 step from the same
    params and batch update bit-equal: the replicated params enter the
    graph through one node whose backward adds the positions' gradients
    in position order, and position 0 makes every collective's node."""
    from mxnet_tpu_torch.models import long_context_lm as tlm
    rs = np.random.RandomState(40)
    D, V, L, T, B = 16, 32, 2, 32, 4
    s = 1.0 / np.sqrt(D)
    params = {"embed": (rs.randn(V, D) * 0.02).astype("f"),
              "pos": (rs.randn(1, 64, D) * 0.02).astype("f")}
    for i in range(L):
        params["l%d" % i] = {
            "qkv": (rs.randn(D, 3 * D) * s).astype("f"),
            "proj": (rs.randn(D, D) * s).astype("f"),
            "ff1": (rs.randn(D, 4 * D) * s).astype("f"),
            "ff2": (rs.randn(4 * D, D) / np.sqrt(4 * D)).astype("f")}
    x = rs.randint(0, V, (B, T))
    y = rs.randint(0, V, (B, T))
    runs = []
    for _ in range(2):
        mesh = _mesh(tmx, {"dp": 2, "sp": 4})
        p = tlm.params_from_numpy(params, tmx.cpu())
        _, loss = tlm.make_step(mesh, 2, L, 0.3)(p, x, y)
        flat = tlm.params_to_numpy(p)
        runs.append((float(loss), {"%s/%s" % (k, kk): vv
                                   for k, v in flat.items()
                                   for kk, vv in (v.items()
                                                  if isinstance(v, dict)
                                                  else [("", v)])}))
    assert runs[0][0] == runs[1][0]
    _equal(runs[1][1], runs[0][1])
    assert not np.array_equal(runs[0][1]["embed/"], params["embed"])


def test_counters_lose_no_count_from_eight_positions():
    """``kernels/concat_fuse.MERGED_BODIES``, ``kernels/flash_attention.
    ALIGN_COPIES`` and ``operator.HOST_COUNTS`` add under
    ``kernels.COUNT_LOCK``: eight mesh positions counting at once lose
    nothing (``rtc.LAUNCHES`` counts a CUDA launch only: its concurrent
    check is the card test below)."""
    from mxnet_tpu_torch import operator as top
    from mxnet_tpu_torch.kernels import concat_fuse as CF
    from mxnet_tpu_torch.kernels import flash_attention as TFA
    sym = tmx.sym
    data = sym.Variable("data")
    towers = []
    for i, nf in enumerate((4, 6)):
        t = sym.Convolution(data, kernel=(1, 1), num_filter=nf,
                            name="t%d_conv" % i)
        t = sym.BatchNorm(t, fix_gamma=False, name="t%d_bn" % i)
        towers.append(sym.Activation(t, act_type="relu",
                                     name="t%d_relu" % i))
    net = sym.MakeLoss(sym.sum(sym.Concat(*towers, name="cat")))
    mesh = _mesh(tmx, {"dp": 8})
    reps, forwards = 400, 20
    base = torch.zeros(4 * 24 * 16 + 1)
    view = base[1:].view(4, 24, 1, 16)          # 4 bytes off 16: copied
    route = TFA.flash_route(torch.float32, 16)

    def position(i):
        ex = net.simple_bind(tmx.cpu(), data=(2, 5, 4, 4), grad_req="null")
        for _ in range(forwards):
            ex.forward(is_train=False)
        for _ in range(reps):
            TFA._staged(view, route)
            top._to_device(np.zeros(3, np.float32), torch.device("cpu"),
                           torch.float32)
            top._to_host([torch.zeros(5)])
    before = (CF.MERGED_BODIES, TFA.ALIGN_COPIES,
              dict(top.HOST_COUNTS))
    # switch threads often, so that an unlocked read-modify-write loses
    # counts
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        C.run(mesh, position, [(i,) for i in range(8)])
    finally:
        sys.setswitchinterval(interval)
    n = 8 * reps
    assert CF.MERGED_BODIES - before[0] == 8 * forwards
    assert TFA.ALIGN_COPIES - before[1] == n
    assert top.HOST_COUNTS["bytes_to_device"] - \
        before[2]["bytes_to_device"] == 12 * n
    assert top.HOST_COUNTS["bytes_to_host"] - \
        before[2]["bytes_to_host"] == 20 * n


@pytest.mark.cuda
def test_rtc_launches_lose_no_count_from_eight_positions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kern = tmx.rtc.elementwise_cuda_kernel("out = 2.0f * in;",
                                           plain=lambda t: t * 2)
    x = torch.ones(1024, device="cuda")
    mesh = tmx.parallel.build_mesh({"dp": 8}, [tmx.gpu(0)] * 8)
    before = tmx.rtc.LAUNCHES
    C.run(mesh, lambda i: [kern(x) for _ in range(50)],
          [(i,) for i in range(8)])
    torch.cuda.synchronize()
    assert tmx.rtc.LAUNCHES - before == 400
