"""The port's data-parallel ``SPMDTrainer`` against the JAX package's on
the CPU.

The JAX side runs in this process on ``build_mesh({"dp": N},
jax.devices()[:N])`` over the conftest's virtual CPUs and is fed the
global batch; the port's side runs N gloo processes (this file run as a
script, joined through a file store under ``tmp_path``, one torch thread
each), every rank fed its rows.  Both start from the same numpy weights.

Cases, at N = 2 and 3: an MLP (10 -> 24 -> 4; at N = 3 ``fc2_bias``
stays replicated and ``fc2_weight`` shards on dim 1) under allreduce,
zero and zero3 for 3 steps; a ResNet-8 (3x16x16, batch 6) under
allreduce (BatchNorm over the global batch) and zero3 (per-rank
statistics, averaged moving statistics) for 2 steps; the port's N-rank
step against its own 1-rank step at the global batch, with a Dropout
MLP among them; the guard skipping a poisoned step on every rank;
zero3 residency of 1/world; an uneven batch raising.

Tolerances: the MLP rtol 1e-5, atol 1e-6 (float32, sums in other
orders); the ResNet rtol 1e-4, atol 1e-5 as tests/test_torch_trainer.py
holds the one-device step; the port against itself at N ranks vs 1
rtol 1e-5, atol 1e-6 (the all-reduce adds the ranks' partial sums)."""
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MLP_BATCH = 12
RES_BATCH = 6
IMAGE = (3, 16, 16)
MLP_STEPS = 3
RES_STEPS = 2
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
TIMEOUT = 240


# ---------------------------------------------------------------------------
# shared inputs (the same numpy values on both sides)
# ---------------------------------------------------------------------------

def mlp_sym(mx, dropout=False):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=24, name="fc1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    if dropout:
        net = mx.sym.Dropout(net, p=0.3, name="drop")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def res_sym(mx):
    return mx.models.get_symbol("resnet", num_layers=8, num_classes=10,
                                image_shape=IMAGE)


def weights(sym, data_shape, seed):
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=data_shape)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight"):
            std = np.sqrt(2.0 / np.prod(s[1:]))
            args[n] = (std * rs.standard_normal(s)).astype(np.float32)
        elif n.endswith("_gamma"):
            args[n] = rs.uniform(0.8, 1.2, s).astype(np.float32)
        else:
            args[n] = (0.1 * rs.standard_normal(s)).astype(np.float32)
    aux = {n: (rs.uniform(0.8, 1.2, s) if n.endswith("_var")
               else 0.1 * rs.standard_normal(s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def batches(kind, n, seed):
    rs = np.random.RandomState(seed)
    if kind == "mlp":
        return [(rs.standard_normal((MLP_BATCH, 10)).astype(np.float32),
                 rs.randint(0, 4, MLP_BATCH).astype(np.float32))
                for _ in range(n)]
    return [(rs.standard_normal((RES_BATCH,) + IMAGE).astype(np.float32),
             rs.randint(0, 10, RES_BATCH).astype(np.float32))
            for _ in range(n)]


#: case -> (model, grad_sync, steps)
CASES = {"mlp_allreduce": ("mlp", "allreduce", MLP_STEPS),
         "mlp_zero": ("mlp", "zero", MLP_STEPS),
         "mlp_zero3": ("mlp", "zero3", MLP_STEPS),
         "res_allreduce": ("res", "allreduce", RES_STEPS),
         "res_zero3": ("res", "zero3", RES_STEPS)}


def case_setup(mx, kind):
    if kind == "mlp":
        sym = mlp_sym(mx)
        shape, seed = (MLP_BATCH, 10), 60
    else:
        sym = res_sym(mx)
        shape, seed = (RES_BATCH,) + IMAGE, 61
    args, aux = weights(sym, shape, seed)
    return sym, shape, args, aux, batches(kind, 3, seed + 1)


# ---------------------------------------------------------------------------
# the port's side: this file as a script, one process a rank
# ---------------------------------------------------------------------------

def _rows(x, rank, world):
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def _port_trainer(tmx, sym, shape, args, aux, grad_sync, world, mesh):
    opt = dict(SGD, rescale_grad=1.0 / shape[0])
    tr = tmx.parallel.SPMDTrainer(sym, "sgd", opt, mesh=mesh,
                                  grad_sync=grad_sync, ctx=tmx.cpu())
    local = (shape[0] // world,) + tuple(shape[1:])
    tr.bind([("data", local)], [("softmax_label", (local[0],))])
    tr.init_params(None, arg_params=args, aux_params=aux)
    return tr


def _host(d):
    return {k: v.asnumpy() for k, v in d.items()}


def worker(out, rank, world, init):
    import torch
    torch.set_num_threads(1)
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import distributed
    distributed.initialize(init_method="file://" + init,
                           num_processes=world, process_id=rank,
                           platform="cpu")
    mesh = tmx.parallel.local_mesh()
    res = {}
    for case, (kind, sync, steps) in CASES.items():
        sym, shape, args, aux, data = case_setup(tmx, kind)
        tr = _port_trainer(tmx, sym, shape, args, aux, sync, world, mesh)
        tmx.random.seed(7)
        for x, y in data[:steps]:
            outs = tr.step(_rows(x, rank, world), _rows(y, rank, world))
        res[case + "/out"] = outs[0].numpy()
        arg, auxp = tr.get_params()
        for k, v in _host(arg).items():
            res[case + "/arg/" + k] = v
        for k, v in _host(auxp).items():
            res[case + "/aux/" + k] = v
        rb = tr.resident_bytes()
        res[case + "/resident"] = np.array([rb["params"], rb["opt_state"]])
        if sync == "zero3":
            res[case + "/groups"] = np.array(
                ["|".join(g) for g in tr._zero3_groups])
            res[case + "/tier"] = np.array(tr.zero3_tier)
        tr.close()
    # the port's N-rank step equals its 1-rank step at the global batch
    for name, dropout in (("mlp", False), ("drop", True)):
        sym = mlp_sym(tmx, dropout=dropout)
        shape = (MLP_BATCH, 10)
        args, aux = weights(sym, shape, 62)
        data = batches("mlp", 2, 63)
        for label, w, m in (("n", world, mesh), ("one", 1, None)):
            if label == "one" and rank != 0:
                continue
            tr = _port_trainer(tmx, sym, shape, args, aux, "allreduce", w, m)
            tmx.random.seed(11)
            for x, y in data:
                outs = tr.step(_rows(x, rank, w) if w > 1 else x,
                               _rows(y, rank, w) if w > 1 else y)
            res["self_%s/%s/out" % (name, label)] = outs[0].numpy()
            arg, _ = tr.get_params()
            for k, v in _host(arg).items():
                res["self_%s/%s/arg/%s" % (name, label, k)] = v
            tr.close()
    # the guard skips a poisoned step on every rank (rank 0's batch only)
    sym, shape, args, aux, data = case_setup(tmx, "mlp")
    for sync in ("allreduce", "zero3"):
        tr = _port_trainer(tmx, sym, shape, args, aux, sync, world, mesh)
        x, y = data[0]
        tr.step(_rows(x, rank, world), _rows(y, rank, world))
        before = _host(tr.get_params()[0])
        if rank == 0:
            tmx.resilience.faults.arm("poison_grad", times=1)
        tr.step(_rows(x, rank, world), _rows(y, rank, world))
        after = _host(tr.get_params()[0])
        same = all(np.array_equal(before[k], after[k]) for k in before)
        res["guard_%s" % sync] = np.array([tr.skipped_steps, int(same)])
        tr.close()
    # an uneven global batch raises under zero3, on every rank
    tr = _port_trainer(tmx, sym, shape, args, aux, "zero3", world, mesh)
    x, y = data[0]
    n = MLP_BATCH // world - (1 if rank == 0 else 0)
    try:
        tr.step(x[:n], y[:n])
        res["uneven"] = np.array("no error")
    except tmx.MXNetError as e:
        res["uneven"] = np.array(str(e))
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)
    distributed.barrier()


def launch_workers(script, world, tmp, extra=()):
    """Run ``script --worker out rank world init`` once a rank; returns
    the list of per-rank result dicts."""
    out = str(tmp)
    init = os.path.join(out, "init")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MXTPU_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, script, "--worker", out, str(r), str(world), init]
        + list(extra), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, "rank %d failed:\n%s" % (r, logs[r][-4000:])
    return [dict(np.load(os.path.join(out, "rank%d.npz" % r)))
            for r in range(world)]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

_RESULTS = {}


@pytest.fixture(scope="module", params=[2, 3])
def port_run(request, tmp_path_factory):
    world = request.param
    if world not in _RESULTS:
        _RESULTS[world] = launch_workers(
            os.path.abspath(__file__), world,
            tmp_path_factory.mktemp("parallel%d" % world))
    return world, _RESULTS[world]


def _jax_run(case, world):
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import SPMDTrainer, build_mesh
    kind, sync, steps = CASES[case]
    sym, shape, args, aux, data = case_setup(jmx, kind)
    mesh = build_mesh({"dp": world}, jax.devices()[:world])
    tr = SPMDTrainer(sym, "sgd", dict(SGD, rescale_grad=1.0 / shape[0]),
                     mesh=mesh, grad_sync=sync)
    tr.bind([("data", shape)], [("softmax_label", (shape[0],))])
    tr.init_params(None, arg_params=args, aux_params=aux)
    for x, y in data[:steps]:
        outs = tr.step(x, y)
    arg, auxp = tr.get_params()
    groups = [list(g) for g in tr._zero3_groups]
    res = (np.asarray(outs[0]), _host(arg), _host(auxp), groups,
           tr.zero3_tier)
    tr.close()
    return res


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_jax(port_run, case):
    world, ranks = port_run
    kind = CASES[case][0]
    rtol, atol = (1e-5, 1e-6) if kind == "mlp" else (1e-4, 1e-5)
    out, arg, aux, groups, tier = _jax_run(case, world)
    got = np.concatenate([r[case + "/out"] for r in ranks])
    np.testing.assert_allclose(got, out, rtol=rtol, atol=atol)
    for k, v in arg.items():
        for r in ranks:
            np.testing.assert_allclose(r[case + "/arg/" + k], v, rtol=rtol,
                                       atol=atol, err_msg=k)
    for k, v in aux.items():
        for r in ranks:
            np.testing.assert_allclose(r[case + "/aux/" + k], v, rtol=rtol,
                                       atol=atol, err_msg=k)
    if CASES[case][1] == "zero3":
        # the gather groups are a pure function of the graph: equal
        assert ["|".join(g) for g in groups] == \
            list(ranks[0][case + "/groups"])
        assert str(ranks[0][case + "/tier"]) == tier == "manual"


@pytest.mark.parametrize("name", ["mlp", "drop"])
def test_n_ranks_equal_one_rank_at_global_batch(port_run, name):
    world, ranks = port_run
    pre = "self_%s/" % name
    one = np.asarray(ranks[0][pre + "one/out"])
    got = np.concatenate([r[pre + "n/out"] for r in ranks])
    np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-6)
    for key in ranks[0]:
        if key.startswith(pre + "one/arg/"):
            k = key.split("/")[-1]
            for r in ranks:
                np.testing.assert_allclose(r[pre + "n/arg/" + k],
                                           ranks[0][key], rtol=1e-5,
                                           atol=1e-6, err_msg=k)


def test_zero3_residency_is_one_over_world(port_run):
    world, ranks = port_run
    for kind in ("mlp", "res"):
        full = ranks[0][kind + "_allreduce/resident"].astype(float)
        for r in ranks:
            z3 = r[kind + "_zero3/resident"].astype(float)
            # params and momentum: 1/world of the sharded ones, plus the
            # indivisible params kept whole
            assert np.all(z3 <= full / world * 1.15 + 512), (kind, z3, full)
            assert np.all(z3 >= full / world * 0.99), (kind, z3, full)


@pytest.mark.parametrize("sync", ["allreduce", "zero3"])
def test_guard_skips_a_poisoned_step_on_every_rank(port_run, sync):
    world, ranks = port_run
    for r in ranks:
        skipped, unchanged = r["guard_%s" % sync]
        assert skipped == 1 and unchanged == 1


def test_uneven_batch_raises_under_zero3(port_run):
    world, ranks = port_run
    for r in ranks:
        msg = str(r["uneven"])
        assert "grad_sync='zero3': batch dim" in msg, msg
        assert "pad the final batch" in msg


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, REPO)
    worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
