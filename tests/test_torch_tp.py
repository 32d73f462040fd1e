"""The port's meshes inside one process, its collectives and the ``tp``
axis of ``SPMDTrainer`` against numpy and the JAX package on the CPU.

The port's meshes run over ``[cpu()] * n`` (every position a thread,
``parallel/collectives.py``); the JAX package's over the conftest's 8
virtual CPU devices.  Both start from the same numpy weights and take
the same numpy batches.

- the collectives and their transposes against numpy (float64, exact up
  to summation order: rtol 1e-12);
- the JAX ``test_spmd_trainer_dp_tp`` MLP (dp 4 x tp 2, ``fc1_weight``
  column-parallel, ``fc2_weight`` row-parallel) and a conv + BatchNorm
  net with its convs ``tp``-ruled (dp 2 x tp 2), after 1 step at rtol
  1e-4 / atol 1e-5, after 12 at rtol 1e-3 / atol 1e-4 (float32 sums in
  other orders, compounded by momentum SGD);
- the column-parallel FC's local product has the sharded shapes (a
  dispatch record), a ruled param's storage a position is 1/tp;
- the plan JSON of a ``tp``-ruled trainer and planner equals the JAX
  package's; ``Module.fit(kvstore='tpu')`` over two contexts against
  the JAX package's; a ``tp`` checkpoint crosses the packages both ways.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.parallel import collectives as C

SGD = {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-4}
ONE = dict(rtol=1e-4, atol=1e-5)
LONG = dict(rtol=1e-3, atol=1e-4)
EXACT = dict(rtol=1e-12, atol=1e-12)


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return tmx.parallel.build_mesh(axes, [tmx.cpu()] * n)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [{"dp": 4, "tp": 2}, {"dp": 2, "sp": 4},
                                  {"pp": 4}, {"ep": 8}, {"dp": 2, "ep": 4}])
def test_mesh_over_a_context_list(axes):
    mesh = _mesh(axes)
    assert mesh.in_process and dict(mesh.shape) == axes
    jmesh = jmx.parallel.build_mesh(axes, jax.devices()[:mesh.size])
    assert dict(mesh.shape) == dict(jmesh.shape)
    # groups along each axis: row-major positions, as jax's device array
    ids = np.vectorize(lambda d: d.id)(jmesh.devices) - jax.devices()[0].id
    for a in axes:
        k = list(axes).index(a)
        want = sorted(sorted(map(int, r)) for r in
                      np.moveaxis(ids, k, -1).reshape(-1, axes[a]))
        assert sorted(sorted(g) for g in mesh.groups(a)) == want


def test_mesh_refusals_and_defaults():
    assert dict(tmx.parallel.default_mesh(
        tensor_parallel=2, devices=[tmx.cpu()] * 8).shape) == \
        {"dp": 4, "tp": 2}
    assert dict(tmx.parallel.local_mesh(devices=[tmx.cpu(0),
                                                 tmx.cpu(1)]).shape) == \
        {"dp": 2}
    with pytest.raises(tmx.MXNetError, match="multiply to 4 but 3"):
        tmx.parallel.build_mesh({"dp": 4}, [tmx.cpu()] * 3)
    # a mesh over ranks needs the process group (tests/test_torch_rank_
    # mesh.py runs one under tools/launch.py)
    with pytest.raises(tmx.MXNetError, match="needs the process group"):
        tmx.parallel.build_mesh({"dp": 1, "tp": 2}, devices=[0, 1])


# ---------------------------------------------------------------------------
# collectives against numpy
# ---------------------------------------------------------------------------

def _rs(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape)


def _positions(mesh, fn, xs, cots):
    """Every position's output and its input's gradient for the
    positions' own cotangents (one backward over all of them)."""
    leaves = [torch.tensor(x, requires_grad=True) for x in xs]
    outs = C.run(mesh, fn, [(leaf,) for leaf in leaves])
    grads = torch.autograd.grad(outs, leaves,
                                [torch.tensor(c) for c in cots])
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


#: op -> (fn, input shape, output shape, forward(xs), backward(cots))
#: over a dp 2 x tp 2 mesh, the collectives along tp: groups (0, 1) and
#: (2, 3), coordinate k within a group
OPS = {
    "psum": (lambda a: C.psum(a, "tp"), (4, 6), (4, 6),
             lambda xs: [xs[m[0]] + xs[m[1]] for m in [[0, 1]] * 2 +
                         [[2, 3]] * 2],
             lambda cs: [cs[m[0]] + cs[m[1]] for m in [[0, 1]] * 2 +
                         [[2, 3]] * 2]),
    "all_gather": (lambda a: C.all_gather(a, "tp", dim=1), (4, 3), (4, 6),
                   lambda xs: [np.concatenate([xs[g], xs[g + 1]], 1)
                               for g in (0, 0, 2, 2)],
                   lambda cs: [(cs[g] + cs[g + 1])[:, 3 * k:3 * k + 3]
                               for g, k in ((0, 0), (0, 1), (2, 0),
                                            (2, 1))]),
    "all_gather_stacked": (
        lambda a: C.all_gather(a, "tp", dim=0, tiled=False), (4, 3),
        (2, 4, 3),
        lambda xs: [np.stack([xs[g], xs[g + 1]]) for g in (0, 0, 2, 2)],
        lambda cs: [(cs[g] + cs[g + 1])[k] for g, k in
                    ((0, 0), (0, 1), (2, 0), (2, 1))]),
    "psum_scatter": (lambda a: C.psum_scatter(a, "tp", dim=0), (4, 3),
                     (2, 3),
                     lambda xs: [(xs[g] + xs[g + 1])[2 * k:2 * k + 2]
                                 for g, k in ((0, 0), (0, 1), (2, 0),
                                              (2, 1))],
                     lambda cs: [np.concatenate([cs[g], cs[g + 1]], 0)
                                 for g in (0, 0, 2, 2)]),
    "ppermute": (lambda a: C.ppermute(a, "tp", [(0, 1)]), (4, 3), (4, 3),
                 lambda xs: [0 * xs[0], xs[0], 0 * xs[2], xs[2]],
                 lambda cs: [cs[1], 0 * cs[0], cs[3], 0 * cs[2]]),
    "all_to_all": (lambda a: C.all_to_all(a, "tp", 0, 1), (4, 3), (2, 6),
                   lambda xs: [np.concatenate([xs[g][2 * k:2 * k + 2],
                                               xs[g + 1][2 * k:2 * k + 2]],
                                              1)
                               for g, k in ((0, 0), (0, 1), (2, 0),
                                            (2, 1))],
                   lambda cs: [np.concatenate([cs[g][:, 3 * k:3 * k + 3],
                                               cs[g + 1][:, 3 * k:3 * k + 3]],
                                              0)
                               for g, k in ((0, 0), (0, 1), (2, 0),
                                            (2, 1))]),
    # the tensor-parallel forms: their backwards count a cotangent that
    # every position holds alike once
    "copy_to": (lambda a: C.copy_to(a, "tp"), (4, 6), (4, 6),
                lambda xs: list(xs),
                lambda cs: [cs[m[0]] + cs[m[1]] for m in [[0, 1]] * 2 +
                            [[2, 3]] * 2]),
    "reduce_from": (lambda a: C.reduce_from(a, "tp"), (4, 6), (4, 6),
                    lambda xs: [xs[m[0]] + xs[m[1]] for m in [[0, 1]] * 2 +
                                [[2, 3]] * 2],
                    lambda cs: list(cs)),
    "gather_from": (lambda a: C.gather_from(a, "tp", 1), (4, 3), (4, 6),
                    lambda xs: [np.concatenate([xs[g], xs[g + 1]], 1)
                                for g in (0, 0, 2, 2)],
                    lambda cs: [cs[i][:, 3 * (i % 2):3 * (i % 2) + 3]
                                for i in range(4)]),
    "scatter_to": (lambda a: C.scatter_to(a, "tp", 1), (4, 6), (4, 3),
                   lambda xs: [xs[i][:, 3 * (i % 2):3 * (i % 2) + 3]
                               for i in range(4)],
                   lambda cs: [np.concatenate([cs[g], cs[g + 1]], 1)
                               for g in (0, 0, 2, 2)]),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_collective_and_its_transpose(op):
    fn, shape_in, shape_out, fwd, bwd = OPS[op]
    mesh = _mesh({"dp": 2, "tp": 2})
    xs = [_rs(i, *shape_in) for i in range(4)]
    cots = [_rs(10 + i, *shape_out) for i in range(4)]
    outs, grads = _positions(mesh, fn, xs, cots)
    for got, want in zip(outs, fwd(xs)):
        np.testing.assert_allclose(got, want, **EXACT)
    for got, want in zip(grads, bwd(cots)):
        np.testing.assert_allclose(got, want, **EXACT)
    # every output in storage of its own (the contexts repeat)
    assert len({id(o) for o in outs}) == 4


def test_axis_index_and_shard_map_specs():
    from mxnet_tpu_torch.parallel.compat import HAS_SHARD_MAP, shard_map
    assert HAS_SHARD_MAP
    mesh = _mesh({"dp": 2, "tp": 2})
    x = torch.arange(16.).reshape(4, 4)

    def f(a):
        k = C.axis_index("tp") + 10 * C.axis_index("dp")
        return a + k, C.psum(a.sum(), ("dp", "tp"))
    y, total = shard_map(f, mesh, (C.P("dp", "tp"),),
                         (C.P("dp", "tp"), C.P()))(x)
    want = x.clone()
    want[:, 2:] += 1
    want[2:] += 10
    assert torch.equal(y, want) and float(total) == float(x.sum())
    with pytest.raises(tmx.MXNetError, match="collective runs inside"):
        C.psum(x, "dp")


def test_shards_hold_their_own_storage():
    mesh = _mesh({"dp": 2, "tp": 2})
    t = torch.arange(24.).reshape(4, 6)
    for spec in (C.P(), C.P("tp"), C.P(None, "tp"), C.P("dp", "tp"),
                 C.P(("dp", "tp"))):
        s = C.shard(t, mesh, spec)
        ptrs = {p.untyped_storage().data_ptr() for p in s.parts}
        assert len(ptrs) == 4
        assert torch.equal(s.full(), t)
        assert s.sharding.spec == spec
    with pytest.raises(tmx.MXNetError, match="does not divide"):
        C.shard(torch.zeros(3, 2), mesh, C.P("tp"))
    arrays = {"w": _rs(11, 4, 6).astype(np.float32),
              "b": _rs(12, 6).astype(np.float32)}
    placed = tmx.convert.shards_from_numpy(arrays, mesh, {"w": ("tp",)})
    assert placed["w"].parts[0].shape == (2, 6)
    assert placed["b"].parts[0].shape == (6,)
    back = tmx.convert.shards_to_numpy(placed)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])


def test_a_failing_position_fails_the_run():
    mesh = _mesh({"dp": 4})

    def fn(i):
        if i == 2:
            raise ValueError("position 2 broke")
        return C.psum(torch.ones(1), "dp")
    with pytest.raises(ValueError, match="position 2 broke"):
        C.run(mesh, fn, [(i,) for i in range(4)])


# ---------------------------------------------------------------------------
# SPMDTrainer with tp rules against the JAX package's
# ---------------------------------------------------------------------------

def mlp_sym(mx, num_classes=4, nh=64):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=nh, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=num_classes, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def conv_sym(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                             no_bias=True, name="conv1")
    net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.Convolution(net, num_filter=8, kernel=(3, 3), pad=(1, 1),
                             name="conv2")
    net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn2")
    net = mx.sym.Activation(net, act_type="relu", name="relu2")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = mx.sym.Flatten(net)
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc1")
    return mx.sym.SoftmaxOutput(net, name="softmax")


MLP_RULES = {r"fc1_weight": ("tp", None), r"fc2_weight": (None, "tp")}
CONV_RULES = {r"conv\d_weight": ("tp", None, None, None),
              r"fc1_weight": (None, "tp")}
#: case -> (symbol, mesh axes, rules, batch shape, classes, forms)
CASES = {
    "mlp_dp4_tp2": (mlp_sym, {"dp": 4, "tp": 2}, MLP_RULES, (64, 16), 4,
                    {"fc1_weight": "column", "fc2_weight": "row"}),
    "conv_dp2_tp2": (conv_sym, {"dp": 2, "tp": 2}, CONV_RULES,
                     (8, 3, 8, 8), 4,
                     {"conv1_weight": "column", "conv2_weight": "column",
                      "fc1_weight": "row"}),
    "conv_gather": (conv_sym, {"dp": 2, "tp": 2},
                    {r"bn1_gamma": ("tp",), r"conv2_weight":
                     (None, None, None, None)}, (8, 3, 8, 8), 4,
                    {"bn1_gamma": "gather"}),
}


def _init(sym, shape, seed):
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    args = {n: rs.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (rs.uniform(0.8, 1.2, s) if n.endswith("_var")
               else 0.1 * rs.standard_normal(s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _batches(shape, classes, n, seed):
    rs = np.random.RandomState(seed)
    return [(rs.standard_normal(shape).astype(np.float32),
             rs.randint(0, classes, shape[0]).astype(np.float32))
            for _ in range(n)]


def _train(mx, case, steps, port):
    make, axes, rules, shape, classes, _ = CASES[case]
    sym = make(mx)
    args, aux = _init(sym, shape, 5)
    if port:
        mesh = _mesh(axes)
        kw = {"ctx": tmx.cpu()}
        a, x = args, aux
    else:
        n = int(np.prod(list(axes.values())))
        mesh = jmx.parallel.build_mesh(axes, jax.devices()[:n])
        kw = {}
        a = {k: jmx.nd.array(v) for k, v in args.items()}
        x = {k: jmx.nd.array(v) for k, v in aux.items()}
    tr = mx.parallel.SPMDTrainer(sym, "sgd", dict(SGD, rescale_grad=1.0 /
                                                  shape[0]),
                                 mesh=mesh, param_shardings=rules, **kw)
    tr.bind([("data", shape)], [("softmax_label", (shape[0],))])
    tr.init_params(None, arg_params=a, aux_params=x)
    outs = []
    for xb, yb in _batches(shape, classes, steps, 6):
        outs.append(np.asarray(tr.step(xb, yb)[0]))
    arg, aux = tr.get_params()
    return tr, ({k: v.asnumpy() for k, v in arg.items()},
                {k: v.asnumpy() for k, v in aux.items()}, outs)


@pytest.mark.parametrize("steps,tol", [(1, ONE), (12, LONG)],
                         ids=["1step", "12steps"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_tp_matches_jax(case, steps, tol):
    ttr, (t_args, t_aux, t_outs) = _train(tmx, case, steps, True)
    jtr, (j_args, j_aux, j_outs) = _train(jmx, case, steps, False)
    assert ttr.tp_forms == CASES[case][5]
    for k in j_args:
        np.testing.assert_allclose(t_args[k], j_args[k], err_msg=k, **tol)
    for k in j_aux:
        np.testing.assert_allclose(t_aux[k], j_aux[k], err_msg=k, **tol)
    np.testing.assert_allclose(t_outs[-1], j_outs[-1], **tol)
    # the ruled params report their spec, as the JAX arrays' shardings do
    def stripped(spec):
        spec = list(spec)
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)
    for name in CASES[case][5]:
        assert stripped(ttr.params[name].sharding.spec) == \
            stripped(jtr.params[name].sharding.spec)
    ttr.close()
    jtr.close()


def test_column_parallel_product_has_sharded_shapes():
    """A dispatch record of one step: the column-parallel fc1's product
    is (B/dp, in) x (in, out/tp), the row-parallel fc2's (B/dp, in/tp) x
    (in/tp, out); a ruled param's storage a position is 1/tp."""
    class Rec(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                mats = [a for a in args if isinstance(a, torch.Tensor)]
                self.mm.append(tuple(tuple(m.shape) for m in mats[-2:]))
            return func(*args, **(kwargs or {}))

    sym = mlp_sym(tmx)
    tr = tmx.parallel.SPMDTrainer(sym, "sgd", SGD, mesh=_mesh({"dp": 4,
                                                             "tp": 2}),
                                  param_shardings=MLP_RULES, ctx=tmx.cpu())
    tr.bind([("data", (64, 16))], [("softmax_label", (64,))])
    tr.init_params(tmx.initializer.Xavier())
    assert tr.params["fc1_weight"].parts[0].shape == (32, 16)
    held = tr.resident_bytes(names=["fc1_weight", "fc2_weight"])
    assert held["params"] * 2 == (64 * 16 + 4 * 64) * 4
    (xb, yb), = _batches((64, 16), 4, 1, 7)
    rec = Rec()
    with rec:
        tr.step(xb, yb)
    # forward products of every position: 8 positions x 2 layers
    fwd = [m for m in rec.mm if m in (((16, 16), (16, 32)),
                                      ((16, 32), (32, 4)))]
    assert fwd.count(((16, 16), (16, 32))) == 8, rec.mm
    assert fwd.count(((16, 32), (32, 4))) == 8, rec.mm
    assert not [m for m in rec.mm if (16, 64) in m or (64, 16) in m]


def test_in_process_refusals():
    sym = mlp_sym(tmx)
    mesh = _mesh({"dp": 4, "tp": 2})
    # zero, zero3 and remat are accepted on the mesh now
    # (tests/test_torch_zero3_mesh.py holds their steps)
    for kw, tier in ((dict(grad_sync="zero"), None),
                     (dict(grad_sync="zero3"), "gspmd"),
                     (dict(remat=True), None)):
        tr = tmx.parallel.SPMDTrainer(sym, mesh=mesh, ctx=tmx.cpu(), **kw)
        tr.bind([("data", (64, 16))], [("softmax_label", (64,))])
        assert tr.zero3_tier == tier
        assert bool(tr._eval.segments) == bool(kw.get("remat"))
    with pytest.raises(tmx.MXNetError, match="rules name the 'tp' axis"):
        tmx.parallel.SPMDTrainer(
            sym, mesh=mesh, ctx=tmx.cpu(),
            param_shardings={"fc1_weight": ("dp", None)}).bind(
                [("data", (64, 16))], [("softmax_label", (64,))])
    with pytest.raises(tmx.MXNetError, match="no role"):
        tmx.parallel.SPMDTrainer(sym, mesh=_mesh({"dp": 2, "sp": 2}),
                                 ctx=tmx.cpu())
    tr = tmx.parallel.SPMDTrainer(sym, "sgd", SGD, mesh=mesh,
                                  param_shardings=MLP_RULES, ctx=tmx.cpu())
    tr.bind([("data", (64, 16))], [("softmax_label", (64,))])
    tr.init_params(tmx.initializer.Xavier())
    rep = tr.analyze(np.zeros((64, 16), np.float32),
                     np.zeros(64, np.float32))
    assert rep.ok, rep.format_text()
    with pytest.raises(tmx.MXNetError, match="does not split"):
        tmx.parallel.SPMDTrainer(sym, mesh=mesh, ctx=tmx.cpu()).bind(
            [("data", (6, 16))], [("softmax_label", (6,))])


def test_plan_json_equals_jax():
    docs = []
    for mx in (jmx, tmx):
        sym = mlp_sym(mx)
        if mx is tmx:
            mesh, kw = _mesh({"dp": 4, "tp": 2}), {"ctx": tmx.cpu()}
        else:
            mesh, kw = jmx.parallel.default_mesh(tensor_parallel=2), {}
        tr = mx.parallel.SPMDTrainer(sym, "sgd", {"momentum": 0.9},
                                     mesh=mesh, param_shardings=MLP_RULES,
                                     **kw)
        tr.bind([("data", (64, 16))], [("softmax_label", (64,))])
        doc = tr.sharding_plan.to_doc()
        doc.pop("gather_bucket", None)
        forms = doc["decisions"][1:]
        doc["decisions"] = doc["decisions"][:1]
        docs.append(doc)
    assert docs[0]["mesh_axes"] == {"dp": 4, "tp": 2}
    assert docs[0] == docs[1]
    # the port's plan also records the form each rule took
    assert forms == ["fc1_weight: tp form column (ops.nn.tp_layer)",
                     "fc2_weight: tp form row (ops.nn.tp_layer)"]
    pdocs = []
    for mx, devices in ((jmx, jax.devices()[:8]), (tmx, [tmx.cpu()] * 8)):
        p = mx.parallel.planner.plan(mlp_sym(mx), [("data", (64, 16))],
                                     [("softmax_label", (64,))],
                                     devices=devices,
                                     param_shardings=MLP_RULES)
        pdocs.append(p.to_doc())
    assert pdocs[0] == pdocs[1]


def test_module_fit_over_two_contexts_matches_jax():
    """kvstore='tpu' over [cpu(0), cpu(1)]: one fused step over an
    in-process dp mesh, as the JAX package runs it."""
    rs = np.random.RandomState(0)
    X = rs.randn(64, 6).astype("f")
    y = rs.randint(0, 3, 64).astype("f")
    sym_args = {}
    got = []
    for mx in (jmx, tmx):
        sym = mlp_sym(mx, num_classes=3, nh=8)
        if not sym_args:
            sym_args.update(_init(sym, (32, 6), 3)[0])
        it = mx.io.NDArrayIter(X, y, batch_size=32)
        mod = mx.mod.Module(sym, context=[mx.cpu(0), mx.cpu(1)])
        mod.fit(it, num_epoch=2, kvstore="tpu",
                optimizer_params={"learning_rate": 0.1},
                arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                            for k, v in sym_args.items()},
                aux_params={}, initializer=None)
        assert mod._fused is not None
        got.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    for k in got[0]:
        np.testing.assert_allclose(got[1][k], got[0][k], err_msg=k, **ONE)


def test_tp_checkpoint_crosses_the_packages(tmp_path):
    """A tp-trained gathered checkpoint: the port's read by the JAX
    package and the JAX package's by the port, each resuming exactly."""
    case = "mlp_dp4_tp2"
    ttr, (t_args, _, _) = _train(tmx, case, 2, True)
    jtr, (j_args, _, _) = _train(jmx, case, 2, False)
    for mx, tr, name in ((tmx, ttr, "t"), (jmx, jtr, "j")):
        tr.save_checkpoint(mx.resilience.CheckpointManager(
            str(tmp_path / name)), 1)
    # each package restores the other's into a tp trainer
    for mx, src, want in ((jmx, "t", t_args), (tmx, "j", j_args)):
        make, axes, rules, shape, _, _ = CASES[case]
        if mx is tmx:
            mesh, kw = _mesh(axes), {"ctx": tmx.cpu()}
        else:
            mesh, kw = jmx.parallel.build_mesh(axes, jax.devices()[:8]), {}
        tr = mx.parallel.SPMDTrainer(make(mx), "sgd", dict(SGD),
                                     mesh=mesh, param_shardings=rules, **kw)
        tr.bind([("data", shape)], [("softmax_label", (shape[0],))])
        tr.init_params(mx.initializer.Xavier())
        assert tr.restore(mx.resilience.CheckpointManager(
            str(tmp_path / src))) == 1
        arg, _ = tr.get_params()
        for k in want:
            np.testing.assert_array_equal(arg[k].asnumpy(), want[k])
        if mx is tmx:
            assert tuple(tr.params["fc1_weight"].sharding.spec) == \
                ("tp", None)
            assert tr.params["fc1_weight"].parts[0].shape == (32, 16)


def dropout_sym(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=24, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Dropout(net, p=0.3, name="drop")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


@pytest.mark.parametrize("axes,rules", [
    ({"dp": 4}, {}), ({"dp": 2, "tp": 2}, {r"fc1_weight": ("tp", None)})],
    ids=["dp4", "dp2_tp2"])
def test_mesh_step_equals_one_device_with_dropout(axes, rules):
    """The mesh's step equals the one-device step at the global batch,
    Dropout included (each position keeps its rows of the global draw),
    with a deferred metric summed over the global batch; rtol 1e-5 /
    atol 1e-6 (the psum adds the positions' partial sums)."""
    sym = dropout_sym(tmx)
    args, _ = _init(sym, (16, 10), 8)
    got = []
    for mesh in (None, _mesh(axes)):
        tr = tmx.parallel.SPMDTrainer(sym, "sgd", dict(SGD, rescale_grad=1 /
                                                       16.0),
                                      mesh=mesh, param_shardings=rules,
                                      ctx=tmx.cpu())
        tr.bind([("data", (16, 10))], [("softmax_label", (16,))])
        tr.init_params(None, arg_params=args)
        tr.install_metric(lambda outs, data: (
            (outs[0].argmax(1).float() == data["softmax_label"]).sum(),
            torch.tensor(float(outs[0].shape[0]))), flush_interval=5)
        for i, (xb, yb) in enumerate(_batches((16, 10), 4, 3, 9)):
            tr.step(xb, yb, key=100 + i)
        s, c = tr.fetch_metric()
        arg, _ = tr.get_params()
        got.append(({k: v.asnumpy() for k, v in arg.items()}, s, c))
    for k in got[0][0]:
        np.testing.assert_allclose(got[1][0][k], got[0][0][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert got[1][1:] == got[0][1:] and got[0][2] == 48.0


def test_guard_skips_a_poisoned_step_on_every_position():
    from mxnet_tpu_torch.resilience import faults
    tr = tmx.parallel.SPMDTrainer(mlp_sym(tmx), "sgd", SGD,
                                  mesh=_mesh({"dp": 2, "tp": 2}),
                                  param_shardings=MLP_RULES, ctx=tmx.cpu())
    tr.bind([("data", (8, 16))], [("softmax_label", (8,))])
    tr.init_params(tmx.initializer.Xavier())
    before = {k: v.asnumpy() for k, v in tr.get_params()[0].items()}
    (xb, yb), = _batches((8, 16), 4, 1, 10)
    faults.disarm()
    try:
        faults.arm("poison_grad", times=1)
        tr.step(xb, yb)
    finally:
        faults.disarm()
    assert tr.skipped_steps == 1
    after = tr.get_params()[0]
    for k, v in before.items():
        np.testing.assert_array_equal(after[k].asnumpy(), v)
    # every position's parts kept their values and their storage
    ptr = tr.params["fc1_weight"].parts[1].data_ptr()
    tr.step(xb, yb)
    assert tr.skipped_steps == 1
    assert tr.params["fc1_weight"].parts[1].data_ptr() == ptr


def test_spmd_module_passes_rules_through():
    """SPMDModule on an in-process dp 2 x tp 2 mesh takes the tp rules to
    its trainer; a one-epoch fit equals the one-device module's (rtol
    1e-5 / atol 1e-6)."""
    rs = np.random.RandomState(11)
    X = rs.randn(64, 16).astype("f")
    y = rs.randint(0, 4, 64).astype("f")
    args, _ = _init(mlp_sym(tmx), (16, 16), 12)
    got = []
    for mesh, rules in ((None, None), (_mesh({"dp": 2, "tp": 2}),
                                       MLP_RULES)):
        mod = tmx.parallel.SPMDModule(mlp_sym(tmx), mesh=mesh,
                                      param_shardings=rules)
        with tmx.cpu():
            mod.fit(tmx.io.NDArrayIter(X, y, batch_size=16), num_epoch=1,
                    optimizer="sgd", optimizer_params={"learning_rate": 0.1},
                    arg_params={k: tmx.nd.array(v) for k, v in
                                args.items()}, aux_params={},
                    initializer=None)
        if mesh is not None:
            assert mod._trainer.tp_forms == {"fc1_weight": "column",
                                             "fc2_weight": "row"}
        got.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    for k in got[0]:
        np.testing.assert_allclose(got[1][k], got[0][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
