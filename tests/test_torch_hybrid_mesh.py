"""SPMDTrainer, the planner, checkpoints and Module on meshes across the
process group's ranks on the CPU: two ranks under ``tools/launch.py -n 2
--platform cpu`` (this file run as a script is the worker: ``python
tests/test_torch_hybrid_mesh.py --worker <dir>``), each saving its
results to ``<dir>/rank<r>.npz`` for the pytest process.

- ``SPMDTrainer`` with ``tp`` rules over ranks (one position a rank), on
  hybrid meshes (``tp`` across the ranks with ``dp`` in process, ``dp``
  across with ``tp`` in process, three positions on one rank and one on
  the other) and on pure-``dp`` meshes of ``(rank, Context)`` pairs,
  under ``allreduce``, ``zero`` and ``zero3`` (the ``gspmd`` tier with a
  tp axis, the ``manual`` tier without), and with remat: after three
  steps every param, aux state and output row bit-equal to the port's
  in-process mesh of the same shape from the same weights and batches
  (rank 1 is handed other initial values: rank 0's win), and within
  rtol 1e-4 / atol 1e-5 of the JAX trainer on the same mesh shape;
- ``analyze()`` on a rank-spanning zero3 step is clean;
- sharded-native checkpoints cross both ways: one written on the rank
  mesh restores bit-equal onto the in-process mesh, and one written on
  the in-process mesh onto the rank mesh;
- ``plan()`` with tp rules over the process group equals the JAX
  package's plan at the same world;
- ``Module(context=[cpu(0), cpu(1)], kvstore='tpu')`` in each of two
  ranks takes the fused route over ONE dp mesh of ranks x contexts, and
  matches the JAX ``Module`` over four devices at
  tests/test_torch_dist.py's tolerances (rtol 1e-5, atol 1e-6).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LAUNCH = os.path.join(REPO, "tools", "launch.py")
TIMEOUT = 300
SGD = {"learning_rate": 0.3, "momentum": 0.9}
JAX_TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 3


def mlp_sym(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
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
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="avg")
    net = mx.sym.Flatten(net)
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc1")
    return mx.sym.SoftmaxOutput(net, name="softmax")


MLP_RULES = {r"fc1_weight": ("tp", None), r"fc2_weight": (None, "tp")}
CONV_RULES = {r"conv\d_weight": ("tp", None, None, None),
              r"fc1_weight": (None, "tp")}
SYMS = {"mlp": (mlp_sym, (16, 10), MLP_RULES),
        "conv": (conv_sym, (8, 3, 8, 8), CONV_RULES)}
#: layout -> (mesh axes, the rank of each position; ints: one position
#: a rank given as ranks, else (rank, cpu()) pairs)
LAYOUTS = {
    "ranks": ({"dp": 1, "tp": 2}, [0, 1]),
    "tp_across": ({"dp": 2, "tp": 2}, [(0,), (1,), (0,), (1,)]),
    "dp_across": ({"dp": 2, "tp": 2}, [(0,), (0,), (1,), (1,)]),
    "uneven": ({"dp": 2, "tp": 2}, [(0,), (0,), (0,), (1,)]),
    "dp2": ({"dp": 2}, [(0,), (1,)]),
    "dp4": ({"dp": 4}, [(0,), (0,), (1,), (1,)]),
}
#: case -> (symbol, layout, grad_sync, remat)
CASES = {
    "ranks_mlp_allreduce": ("mlp", "ranks", "allreduce", False),
    "ranks_conv_allreduce": ("conv", "ranks", "allreduce", False),
    "tp_across_mlp_allreduce": ("mlp", "tp_across", "allreduce", False),
    "tp_across_mlp_zero": ("mlp", "tp_across", "zero", False),
    "tp_across_mlp_zero3": ("mlp", "tp_across", "zero3", False),
    "tp_across_conv_zero3": ("conv", "tp_across", "zero3", False),
    "tp_across_conv_zero3_remat": ("conv", "tp_across", "zero3", True),
    "dp_across_conv_allreduce": ("conv", "dp_across", "allreduce", False),
    "dp_across_mlp_zero3": ("mlp", "dp_across", "zero3", False),
    "uneven_mlp_zero": ("mlp", "uneven", "zero", False),
    "dp2_conv_zero3": ("conv", "dp2", "zero3", False),
    "dp4_conv_zero3_remat": ("conv", "dp4", "zero3", True),
    "dp4_mlp_allreduce": ("mlp", "dp4", "allreduce", False),
}


def launch(out, env=None, timeout=TIMEOUT):
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("MXTPU_")}
    base.pop("XLA_FLAGS", None)
    base["OMP_NUM_THREADS"] = "1"
    base["PYTHONPATH"] = REPO + os.pathsep + base.get("PYTHONPATH", "")
    base.update(env or {})
    return subprocess.run(
        [sys.executable, LAUNCH, "-n", "2", "--platform", "cpu",
         sys.executable, os.path.abspath(__file__), "--worker", str(out)],
        env=base, capture_output=True, text=True, timeout=timeout)


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


def _batches(shape, n, seed=6):
    rs = np.random.RandomState(seed)
    return [(rs.standard_normal(shape).astype(np.float32),
             rs.randint(0, 4, shape[0]).astype(np.float32))
            for _ in range(n)]


def _mesh(mx, layout, ranks):
    axes, owners = LAYOUTS[layout]
    if not ranks:
        return mx.parallel.build_mesh(axes, [mx.cpu()] * len(owners))
    if isinstance(owners[0], int):
        return mx.parallel.build_mesh(axes, owners)
    return mx.parallel.build_mesh(axes, [(o[0], mx.cpu()) for o in owners])


def _local_rows(mesh, batch):
    """This process's rows of a global batch: its dp coordinates' blocks
    in order (the whole batch on a mesh inside one process)."""
    dp = mesh.shape["dp"]
    held = sorted({mesh.coords(i)["dp"] for i in mesh.local})
    per = batch // dp
    return np.concatenate([np.arange(d * per, (d + 1) * per)
                           for d in held])


def _train(mx, case, ranks, rank=0):
    """The case's trainer after STEPS steps: ``(trainer, params + aux,
    outputs a step)``."""
    sym_kind, layout, sync, remat = CASES[case]
    make, shape, rules = SYMS[sym_kind]
    sym = make(mx)
    args, aux = _weights(sym, shape, 5)
    if rank:
        # rank 0's initial values win
        args = {k: v + 1.0 for k, v in args.items()}
    mesh = _mesh(mx, layout, ranks)
    axes = LAYOUTS[layout][0]
    rows = _local_rows(mesh, shape[0])
    tr = mx.parallel.SPMDTrainer(
        sym, "sgd", dict(SGD, rescale_grad=1.0 / shape[0]), mesh=mesh,
        param_shardings=rules if "tp" in axes else None, grad_sync=sync,
        remat=remat, ctx=mx.cpu())
    tr.bind([("data", (len(rows),) + shape[1:])],
            [("softmax_label", (len(rows),))])
    tr.init_params(None, arg_params=args, aux_params=aux)
    outs = []
    for x, y in _batches(shape, STEPS):
        outs.append(tr.step(x[rows], y[rows])[0].detach().numpy().copy())
    arg, aux = tr.get_params()
    got = {k: v.asnumpy() for k, v in list(arg.items()) + list(aux.items())}
    return tr, got, outs, rows


def _jax_train(case):
    import jax
    import mxnet_tpu as jmx
    sym_kind, layout, sync, remat = CASES[case]
    make, shape, rules = SYMS[sym_kind]
    sym = make(jmx)
    args, aux = _weights(sym, shape, 5)
    axes = LAYOUTS[layout][0]
    n = int(np.prod(list(axes.values())))
    mesh = jmx.parallel.build_mesh(axes, jax.devices()[:n])
    tr = jmx.parallel.SPMDTrainer(
        sym, "sgd", dict(SGD, rescale_grad=1.0 / shape[0]), mesh=mesh,
        param_shardings=rules if "tp" in axes else None, grad_sync=sync,
        remat=remat)
    tr.bind([("data", shape)], [("softmax_label", (shape[0],))])
    tr.init_params(None, arg_params={k: jmx.nd.array(v)
                                     for k, v in args.items()},
                   aux_params={k: jmx.nd.array(v) for k, v in aux.items()})
    for x, y in _batches(shape, STEPS):
        tr.step(x, y)
    arg, aux = tr.get_params()
    return {k: v.asnumpy() for k, v in list(arg.items()) + list(aux.items())}


# -- checkpoints ------------------------------------------------------------

CKPT_CASE = "tp_across_mlp_zero3"


def _ckpt_trainer(mx, ranks, weights=None):
    _, layout, sync, _ = CASES[CKPT_CASE]
    make, shape, rules = SYMS["mlp"]
    sym = make(mx)
    args, aux = weights or _weights(sym, shape, 9)
    mesh = _mesh(mx, layout, ranks)
    rows = _local_rows(mesh, shape[0])
    tr = mx.parallel.SPMDTrainer(
        sym, "sgd", dict(SGD, rescale_grad=1.0 / shape[0]), mesh=mesh,
        param_shardings=rules, grad_sync=sync, ctx=mx.cpu())
    tr.bind([("data", (len(rows),) + shape[1:])],
            [("softmax_label", (len(rows),))])
    tr.init_params(None, arg_params=args, aux_params=aux)
    return tr, rows


def _host(tr):
    arg, aux = tr.get_params()
    out = {k: v.asnumpy() for k, v in list(arg.items()) + list(aux.items())}
    states = __import__("pickle").loads(tr.get_states())["states"]
    for k, s in states.items():
        for j, v in enumerate(s):
            out["opt/%s/%d" % (k, j)] = np.asarray(v)
    return out


def write_inproc_checkpoint(mx, path):
    """Two steps on the in-process mesh, saved sharded-native at epoch 2;
    returns the params and optimizer state saved."""
    os.environ["MXTPU_CKPT_SHARDED"] = "1"
    try:
        tr, rows = _ckpt_trainer(mx, False)
        for x, y in _batches(SYMS["mlp"][1], 2, seed=11):
            tr.step(x[rows], y[rows])
        tr.save_checkpoint(mx.resilience.CheckpointManager(path), 2)
        return _host(tr)
    finally:
        del os.environ["MXTPU_CKPT_SHARDED"]


# -- the worker -------------------------------------------------------------

def worker(out):
    import torch
    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import distributed
    rank = distributed.rank()
    save = {}
    meta = {"cases": {}}
    with mx.cpu():
        for case in sorted(CASES):
            tr, got, outs, rows = _train(mx, case, True, rank)
            for k, v in got.items():
                save["%s/p/%s" % (case, k)] = v
            for j, o in enumerate(outs):
                save["%s/out/%d" % (case, j)] = o
            save["%s/rows" % case] = rows
            info = {"tier": tr.zero3_tier, "forms": tr.tp_forms,
                    "spans": tr.mesh.spans_ranks,
                    "resident": tr.resident_bytes(),
                    "whole": sum(int(np.prod(tr.arg_shapes[n])) * 4
                                 for n in tr.param_names)}
            if case == "tp_across_mlp_zero3":
                shape = SYMS["mlp"][1]
                x, y = _batches(shape, 1, seed=8)[0]
                rep = tr.analyze(x[rows], y[rows])
                info["analyze_ok"] = rep.ok
                info["analyze_text"] = rep.format_text()
                info["data_axis"] = rep.stats.get("data_axis_collectives")
            meta["cases"][case] = info
            tr.close()
        # checkpoints, both ways
        os.environ["MXTPU_CKPT_SHARDED"] = "1"
        tr, rows = _ckpt_trainer(mx, True)
        for x, y in _batches(SYMS["mlp"][1], 2, seed=11):
            tr.step(x[rows], y[rows])
        tr.save_checkpoint(mx.resilience.CheckpointManager(
            os.path.join(out, "ckpt_ranks")), 2)
        for k, v in _host(tr).items():
            save["ckpt/saved/" + k] = v
        tr.close()
        tr, _ = _ckpt_trainer(mx, True)
        epoch = tr.restore(mx.resilience.CheckpointManager(
            os.path.join(out, "ckpt_inproc")))
        meta["ckpt_epoch"] = epoch
        for k, v in _host(tr).items():
            save["ckpt/restored/" + k] = v
        tr.close()
        del os.environ["MXTPU_CKPT_SHARDED"]
        # the planner over the process group
        make, shape, rules = SYMS["mlp"]
        meta["plan"] = mx.parallel.planner.plan(
            make(mx), [("data", shape)], [("softmax_label", (shape[0],))],
            param_shardings=rules).to_doc()
        meta["plan_devices"] = mx.parallel.planner.plan(
            make(mx), [("data", shape)], [("softmax_label", (shape[0],))],
            devices=distributed.global_devices([mx.cpu(0), mx.cpu(1)]),
            param_shardings=rules).to_doc()
        # Module over two contexts in each of two ranks
        X, y, w = module_data()
        rows = np.concatenate([np.arange(b * 32 + rank * 16,
                                         b * 32 + rank * 16 + 16)
                               for b in range(len(X) // 32)])
        sym = module_sym(mx)
        mod = mx.mod.Module(sym, context=[mx.cpu(0), mx.cpu(1)])
        mod.fit(mx.io.NDArrayIter(X[rows], y[rows], batch_size=16),
                num_epoch=2, kvstore="tpu",
                optimizer_params={"learning_rate": 0.1},
                arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                            for k, v in w.items()},
                aux_params={}, initializer=None)
        fused = mod._fused
        meta["module"] = {"fused": fused is not None,
                          "mesh": None if fused is None else
                          [dict(fused.mesh.shape), fused.mesh.rank_of]}
        for k, v in mod.get_params()[0].items():
            save["module/" + k] = v.asnumpy()
    np.savez(os.path.join(out, "rank%d.npz" % rank), **save)
    with open(os.path.join(out, "rank%d.json" % rank), "w") as f:
        json.dump(meta, f, default=str)
    distributed.barrier()
    print("rank %d: OK" % rank, flush=True)


def module_sym(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def module_data():
    rs = np.random.RandomState(0)
    X = rs.randn(64, 6).astype("f")
    y = rs.randint(0, 3, 64).astype("f")
    rs = np.random.RandomState(3)
    w = {"fc1_weight": rs.uniform(-0.3, 0.3, (8, 6)).astype("f"),
         "fc1_bias": np.zeros(8, "f"),
         "fc2_weight": rs.uniform(-0.3, 0.3, (3, 8)).astype("f"),
         "fc2_bias": np.zeros(3, "f")}
    return X, y, w


# -- the tests ----------------------------------------------------------------

@pytest.fixture
def one_thread():
    """The workers' torch thread count for the in-process references: a
    CPU convolution's reductions split by thread, so another count sums
    in another order."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def hybrid_run(tmp_path_factory):
    import torch
    import mxnet_tpu_torch as tmx
    out = tmp_path_factory.mktemp("hybrid_mesh")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with tmx.cpu():
            inproc = write_inproc_checkpoint(tmx, str(out / "ckpt_inproc"))
    finally:
        torch.set_num_threads(before)
    proc = launch(out)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-6000:]
    ranks = []
    for r in range(2):
        with np.load(str(out / ("rank%d.npz" % r))) as z:
            arrays = {k: z[k] for k in z.files}
        with open(str(out / ("rank%d.json" % r))) as f:
            ranks.append((arrays, json.load(f)))
    return ranks, inproc, str(out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_across_ranks(hybrid_run, case, one_thread):
    """Three steps on the rank mesh: params, aux and each rank's output
    rows bit-equal to the in-process mesh of the same shape (and equal
    on both ranks), within JAX_TOL of the JAX trainer."""
    import mxnet_tpu_torch as tmx
    ranks, _, _ = hybrid_run
    with tmx.cpu():
        tr, ref, outs, _ = _train(tmx, case, False)
    sync = CASES[case][2]
    for arrays, meta in ranks:
        info = meta["cases"][case]
        assert info["spans"]
        assert info["tier"] == tr.zero3_tier
        assert info["forms"] == {k: v for k, v in tr.tp_forms.items()}
        for k, v in ref.items():
            assert np.array_equal(arrays["%s/p/%s" % (case, k)], v), k
        rows = arrays["%s/rows" % case]
        for j, o in enumerate(outs):
            assert np.array_equal(arrays["%s/out/%d" % (case, j)], o[rows])
    if sync == "zero3" and tr.zero3_tier:
        assert tr.zero3_tier == ("gspmd" if "tp" in tr.mesh.shape
                                 else "manual")
    _close(ref, _jax_train(case), JAX_TOL)
    tr.close()


def _close(got, want, tol):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_zero3_across_ranks_is_sharded_and_analyze_is_clean(hybrid_run):
    ranks, _, _ = hybrid_run
    for _, meta in ranks:
        zero3 = meta["cases"]["tp_across_mlp_zero3"]
        assert zero3["analyze_ok"], zero3["analyze_text"]
        assert zero3["data_axis"]["all-gather"]["count"] > 0
        # every param is split over tp (its rule) or dp (zero3): each
        # position holds half of the params and of the momentum
        whole = zero3["whole"]
        assert zero3["resident"]["params"] * 2 == whole
        assert zero3["resident"]["opt_state"] * 2 == whole


def test_sharded_checkpoints_cross_rank_and_in_process_meshes(hybrid_run,
                                                            one_thread):
    """A sharded-native checkpoint written on the rank mesh restores
    bit-equal onto the in-process mesh, and the other way round."""
    import mxnet_tpu_torch as tmx
    ranks, inproc, out = hybrid_run
    os.environ["MXTPU_CKPT_SHARDED"] = "1"
    try:
        with tmx.cpu():
            tr, _ = _ckpt_trainer(tmx, False)
            epoch = tr.restore(tmx.resilience.CheckpointManager(
                os.path.join(out, "ckpt_ranks")))
            restored = _host(tr)
            tr.close()
    finally:
        del os.environ["MXTPU_CKPT_SHARDED"]
    assert epoch == 2
    blobs = sorted(n for n in os.listdir(os.path.join(out, "ckpt_ranks"))
                   if ".params.s" in n)
    assert len(blobs) == 2, blobs
    for arrays, meta in ranks:
        assert meta["ckpt_epoch"] == 2
        for k, v in restored.items():
            assert np.array_equal(arrays["ckpt/saved/" + k], v), k
        for k, v in inproc.items():
            assert np.array_equal(arrays["ckpt/restored/" + k], v), k


def test_plan_with_tp_rules_over_ranks_equals_jax(hybrid_run):
    import mxnet_tpu as jmx
    ranks, _, _ = hybrid_run
    make, shape, rules = SYMS["mlp"]
    for world, key in ((2, "plan"), (4, "plan_devices")):
        want = jmx.parallel.planner.plan(
            make(jmx), [("data", shape)], [("softmax_label", (shape[0],))],
            world=world, param_shardings=rules).to_doc()
        for _, meta in ranks:
            got = dict(meta[key])
            got["decisions"] = [d for d in got["decisions"]
                                if not d.startswith("inventory from")]
            assert json.loads(json.dumps(got)) == \
                json.loads(json.dumps(want)), key


def test_module_over_contexts_in_each_rank_matches_jax(hybrid_run):
    import mxnet_tpu as jmx
    ranks, _, _ = hybrid_run
    X, y, w = module_data()
    mod = jmx.mod.Module(module_sym(jmx),
                         context=[jmx.cpu(i) for i in range(4)])
    mod.fit(jmx.io.NDArrayIter(X, y, batch_size=32), num_epoch=2,
            kvstore="tpu", optimizer_params={"learning_rate": 0.1},
            arg_params={k: jmx.nd.array(v) for k, v in w.items()},
            aux_params={}, initializer=None)
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for arrays, meta in ranks:
        assert meta["module"]["fused"]
        assert meta["module"]["mesh"] == [{"dp": 4}, [0, 0, 1, 1]]
        for k, v in want.items():
            np.testing.assert_allclose(arrays["module/" + k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(sys.argv[2])
