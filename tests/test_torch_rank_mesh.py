"""The mesh across the process group's ranks on the CPU: two ranks under
``tools/launch.py -n 2 --platform cpu`` (this file run as a script is
the worker: ``python tests/test_torch_rank_mesh.py --worker <phase>
<dir>``), each saving its positions' results to ``<dir>/rank<r>.npz``,
which the pytest process compares.

- every collective and its transpose (``psum``, ``all_gather`` tiled and
  stacked, ``psum_scatter``, ``ppermute``, ``all_to_all``, the four tp
  forms, a psum over two axes, ``axis_index``) on four layouts of two
  ranks: one position a rank, ``tp`` groups across the ranks, ``dp``
  across the ranks, and three positions on one rank with one on the
  other; bit-equal to the in-process mesh of the same shape and equal
  to numpy;
- ``shard_map``, ``ring_attention`` with ``sp`` across the ranks,
  ``pipeline_apply`` over ``pp`` and ``moe_ffn`` over ``ep`` (placed by
  ``moe_init(mesh=)``), forward and gradients: bit-equal to the
  in-process mesh and within the JAX package's tolerances of its
  functions on its virtual CPU devices (``tests/test_pp_ep.py``'s
  settings: pipeline rtol 1e-5 / atol 1e-6, MoE rtol 1e-4 / atol 1e-5,
  ring rtol 2e-4 / atol 2e-5);
- the long-context LM's step at dp 2 x sp 4 with every ring across both
  ranks: bit-equal to the in-process mesh;
- ranks that issue different collectives fail with an error that names
  both sides.

Every subprocess carries a timeout.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LAUNCH = os.path.join(REPO, "tools", "launch.py")
TIMEOUT = 240


def launch(n, phase, out, env=None, timeout=TIMEOUT):
    """``tools/launch.py -n n --platform cpu python this_file --worker
    phase out`` with a clean environment; returns the CompletedProcess."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("MXTPU_")}
    base.pop("XLA_FLAGS", None)
    base["OMP_NUM_THREADS"] = "1"
    base["PYTHONPATH"] = REPO + os.pathsep + base.get("PYTHONPATH", "")
    base.update(env or {})
    return subprocess.run(
        [sys.executable, LAUNCH, "-n", str(n), "--platform", "cpu",
         sys.executable, os.path.abspath(__file__), "--worker", phase,
         str(out)],
        env=base, capture_output=True, text=True, timeout=timeout)


def load_ranks(out, n=2):
    """``{key: array}`` over every rank's npz (keys carry positions)."""
    merged = {}
    for r in range(n):
        with np.load(os.path.join(str(out), "rank%d.npz" % r)) as z:
            for k in z.files:
                merged[k] = z[k]
    return merged


# ---------------------------------------------------------------------------
# the layouts and the collectives
# ---------------------------------------------------------------------------

#: layout -> (mesh axes, the rank of each position); every position of
#: a rank is on that rank's cpu()
LAYOUTS = {
    "ranks": ({"dp": 1, "tp": 2}, [0, 1]),
    "tp_across": ({"dp": 2, "tp": 2}, [0, 1, 0, 1]),
    "dp_across": ({"dp": 2, "tp": 2}, [0, 0, 1, 1]),
    "uneven": ({"dp": 2, "tp": 2}, [0, 0, 0, 1]),
}


def _coll_ops(C):
    """op -> (fn over a position's tensor, input shape, output shape)."""
    return {
        "psum": (lambda a: C.psum(a, "tp"), (4, 6)),
        "psum_dp_tp": (lambda a: C.psum(a, ("dp", "tp")), (4, 6)),
        "all_gather": (lambda a: C.all_gather(a, "tp", dim=1), (4, 3)),
        "all_gather_stacked": (
            lambda a: C.all_gather(a, "tp", dim=0, tiled=False), (4, 3)),
        "psum_scatter": (lambda a: C.psum_scatter(a, "tp", dim=0), (4, 3)),
        "ppermute": (lambda a: C.ppermute(a, "tp", [(0, 1)]), (4, 3)),
        "all_to_all": (lambda a: C.all_to_all(a, "tp", 0, 1), (4, 3)),
        "copy_to": (lambda a: C.copy_to(a, "tp"), (4, 6)),
        "reduce_from": (lambda a: C.reduce_from(a, "tp"), (4, 6)),
        "gather_from": (lambda a: C.gather_from(a, "tp", 1), (4, 3)),
        "scatter_to": (lambda a: C.scatter_to(a, "tp", 1), (4, 6)),
        "axis_index": (lambda a: a * (1 + C.axis_index("tp")
                                      + 2 * C.axis_index("dp")), (4, 3)),
    }


def _rs(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype("f")


def _run_positions(mx, C, mesh, fn, shape_in, seed):
    """This process's positions' outputs and input gradients for
    cotangents made from the positions' indices (one backward)."""
    import torch
    n = mesh.size
    leaves = [torch.tensor(_rs(seed + i, *shape_in), requires_grad=True)
              for i in range(n)]
    outs = C.run(mesh, fn, [(leaf,) for leaf in leaves])
    local = mesh.local
    cots = [torch.from_numpy(_rs(100 + seed + i, *outs[i].shape))
            for i in local]
    grads = torch.autograd.grad([outs[i] for i in local],
                                [leaves[i] for i in local], cots)
    return ({i: outs[i].detach().numpy() for i in local},
            {i: g.numpy() for i, g in zip(local, grads)})


def _mesh(mx, layout, ranks=True):
    axes, owners = LAYOUTS[layout]
    if not ranks:
        return mx.parallel.build_mesh(axes, [mx.cpu()] * len(owners))
    if layout == "ranks":
        return mx.parallel.build_mesh(axes, owners)
    return mx.parallel.build_mesh(axes, [(r, mx.cpu()) for r in owners])


def _w_collectives(mx, save):
    from mxnet_tpu_torch.parallel import collectives as C
    for layout in sorted(LAYOUTS):
        mesh = _mesh(mx, layout)
        for op, (fn, shape) in sorted(_coll_ops(C).items()):
            outs, grads = _run_positions(mx, C, mesh, fn, shape, 7)
            for i in outs:
                save["coll/%s/%s/out/%d" % (layout, op, i)] = outs[i]
                save["coll/%s/%s/grad/%d" % (layout, op, i)] = grads[i]


def _numpy_collective(op, groups, coords, xs, cs):
    """Every position's output and input gradient by numpy."""
    n = len(xs)
    out, grad = [None] * n, [None] * n
    group_of = {m: g for g in groups for m in g}
    for i in range(n):
        g = group_of[i]
        k = g.index(i)
        xg, cg = [xs[m] for m in g], [cs[m] for m in g]
        if op in ("psum", "copy_to", "reduce_from"):
            out[i] = xs[i] if op == "copy_to" else sum(xg)
            grad[i] = cs[i] if op == "reduce_from" else sum(cg)
        elif op == "all_gather":
            out[i] = np.concatenate(xg, 1)
            grad[i] = np.split(sum(cg), len(g), 1)[k]
        elif op == "all_gather_stacked":
            out[i] = np.stack(xg)
            grad[i] = sum(cg)[k]
        elif op == "psum_scatter":
            out[i] = np.split(sum(xg), len(g), 0)[k]
            grad[i] = np.concatenate(cg, 0)
        elif op == "ppermute":
            out[i] = xg[0] if k == 1 else 0 * xs[i]
            grad[i] = cg[1] if k == 0 else 0 * cs[i]
        elif op == "all_to_all":
            out[i] = np.concatenate([np.split(x, len(g), 0)[k] for x in xg],
                                    1)
            grad[i] = np.concatenate([np.split(c, len(g), 1)[k]
                                      for c in cg], 0)
        elif op == "gather_from":
            out[i] = np.concatenate(xg, 1)
            grad[i] = np.split(cs[i], len(g), 1)[k]
        elif op == "scatter_to":
            out[i] = np.split(xs[i], len(g), 1)[k]
            grad[i] = np.concatenate(cg, 1)
        elif op == "axis_index":
            f = 1 + coords[i]["tp"] + 2 * coords[i]["dp"]
            out[i], grad[i] = xs[i] * f, cs[i] * f
    return out, grad


@pytest.fixture(scope="module")
def parallel_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("rank_mesh")
    proc = launch(2, "parallel", out)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-6000:]
    return load_ranks(out), str(out)


@pytest.mark.parametrize("op", sorted(
    ["psum", "psum_dp_tp", "all_gather", "all_gather_stacked",
     "psum_scatter", "ppermute", "all_to_all", "copy_to", "reduce_from",
     "gather_from", "scatter_to", "axis_index"]))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_collective_across_ranks(parallel_run, layout, op):
    """Forward and backward of one collective on one layout: every
    position's output and gradient bit-equal to the in-process mesh of
    the same shape, and equal to numpy (float32 sums of two or four
    terms: rtol 1e-6)."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.parallel import collectives as C
    got, _ = parallel_run
    mesh = _mesh(tmx, layout, ranks=False)
    fn, shape = _coll_ops(C)[op]
    outs, grads = _run_positions(tmx, C, mesh, fn, shape, 7)
    n = mesh.size
    for i in range(n):
        assert np.array_equal(got["coll/%s/%s/out/%d" % (layout, op, i)],
                              outs[i]), (layout, op, i)
        assert np.array_equal(got["coll/%s/%s/grad/%d" % (layout, op, i)],
                              grads[i]), (layout, op, i)
    axes = ("dp", "tp") if op == "psum_dp_tp" else ("tp",)
    xs = [_rs(7 + i, *shape) for i in range(n)]
    cs = [_rs(107 + i, *outs[i].shape) for i in range(n)]
    want, wgrad = _numpy_collective(
        "psum" if op == "psum_dp_tp" else op, mesh.groups(axes),
        [mesh.coords(i) for i in range(n)], xs, cs)
    for i in range(n):
        np.testing.assert_allclose(outs[i], want[i], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(grads[i], wgrad[i], rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# shard_map, ring attention, the pipeline and MoE across the ranks
# ---------------------------------------------------------------------------

#: ring case -> (mesh axes, the rank of each position, causal)
RING_CASES = {
    "sp2_ranks_causal": ({"sp": 2}, [0, 1], True),
    "sp4_across_plain": ({"sp": 4}, [0, 1, 0, 1], False),
    "dp2_sp2_causal": ({"dp": 2, "sp": 2}, [0, 1, 0, 1], True),
}
#: pipeline case -> (stages, microbatches, batch, the rank of each stage)
PP_CASES = {"pp2_ranks": (2, 3, 12, [0, 1]),
            "pp4_across": (4, 4, 8, [0, 1, 0, 1])}
#: MoE case -> (experts, mesh axes, ranks, batch axis, capacity factor,
#: x shape)
MOE_CASES = {
    "ep4_replicated": (4, {"ep": 4}, [0, 0, 1, 1], None, 8.0, (2, 8, 8)),
    "ep4_dropping": (4, {"ep": 4}, [0, 1, 0, 1], None, 0.5, (2, 8, 8)),
    "ep4_batch_over_ep": (8, {"ep": 4}, [0, 1, 0, 1], "ep", 1.0,
                          (4, 8, 8)),
    "dp2_ep2_batch_over_dp": (4, {"dp": 2, "ep": 2}, [0, 0, 1, 1], "dp",
                              0.75, (4, 8, 8)),
}
LM = dict(vocab=32, d=16, heads=2, layers=2, seq=32, batch=4, max_len=64)


def _build(mx, axes, owners, ranks):
    if not ranks:
        return mx.parallel.build_mesh(axes, [mx.cpu()] * len(owners))
    return mx.parallel.build_mesh(axes, [(r, mx.cpu()) for r in owners])


def _qkv(seed, B=2, Tn=16, H=2, Dh=8):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, Tn, H, Dh).astype("f") for _ in range(3)]


def _ring(mx, case, ranks):
    import torch
    from mxnet_tpu_torch.parallel import ring_attention as TRA
    axes, owners, causal = RING_CASES[case]
    mesh = _build(mx, axes, owners, ranks)
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(len(case)))
    out = TRA.ring_attention(q, k, v, mesh=mesh, causal=causal)
    cot = torch.from_numpy(_rs(5, *out.shape))
    g = torch.autograd.grad((out * cot).sum(), (q, k, v))
    return [out.detach().numpy()] + [t.numpy() for t in g]


def _stages(S, d, seed):
    rs = np.random.RandomState(seed)
    return [{"w": (rs.randn(d, d) * 0.3).astype("f"),
             "b": (rs.randn(d) * 0.1).astype("f")} for _ in range(S)]


def _pipeline(mx, case, ranks):
    import torch
    S, M, B, owners = PP_CASES[case]
    d = 16
    per = [{k: torch.from_numpy(v).requires_grad_(True) for k, v in
            p.items()} for p in _stages(S, d, S + M)]
    x = torch.from_numpy(np.random.RandomState(B).randn(B, d).astype("f"))
    x.requires_grad_(True)
    out = mx.parallel.pipeline_apply(
        lambda p, a: torch.tanh(a @ p["w"] + p["b"]),
        mx.parallel.stack_stage_params(per), x,
        _build(mx, {"pp": S}, owners, ranks), n_microbatch=M)
    leaves = [x] + [p[k] for p in per for k in ("w", "b")]
    g = torch.autograd.grad((out * torch.from_numpy(_rs(3, *out.shape)))
                            .sum(), leaves)
    return [out.detach().numpy()] + [t.numpy() for t in g]


def _moe_params(E, d, h, seed):
    rs = np.random.RandomState(seed)
    return {"gate": (rs.randn(d, E) / np.sqrt(d)).astype("f"),
            "w1": (rs.randn(E, d, h) / np.sqrt(d)).astype("f"),
            "b1": (rs.randn(E, h) * 0.1).astype("f"),
            "w2": (rs.randn(E, h, d) / np.sqrt(h)).astype("f"),
            "b2": (rs.randn(E, d) * 0.1).astype("f")}


def _moe(mx, case, ranks):
    import torch
    from mxnet_tpu_torch.parallel import collectives as C
    from mxnet_tpu_torch.parallel import moe as TM
    E, axes, owners, batch_axis, cf, shape = MOE_CASES[case]
    mesh = _build(mx, axes, owners, ranks)
    params = _moe_params(E, shape[-1], 16, E + len(case))
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in params.items()}
    placed = C.shard_tree(leaves, mesh, TM.moe_shardings("ep"))
    x = torch.from_numpy(np.random.RandomState(len(case)).randn(*shape)
                         .astype("f"))
    out = TM.moe_ffn(placed, x, capacity_factor=cf, batch_axis=batch_axis)
    g = torch.autograd.grad(
        (out * torch.from_numpy(_rs(4, *out.shape))).sum(),
        [leaves[k] for k in sorted(leaves)])
    # moe_init(mesh=) places each expert on its owning position
    gen = torch.Generator().manual_seed(3)
    init = TM.moe_init(gen, shape[-1], 16, E, ctx=mx.cpu(), mesh=mesh)
    owned = [init["w1"].parts[i].shape[0] if init["w1"].parts[i] is not
             None else -1 for i in range(mesh.size)]
    return [out.detach().numpy()] + [t.numpy() for t in g] + \
        [np.asarray(owned)]


def _lm_numpy_params(seed=40):
    rs = np.random.RandomState(seed)
    d, s = LM["d"], 1.0 / np.sqrt(LM["d"])

    def f(std, *shape):
        return (rs.randn(*shape) * std).astype(np.float32)
    params = {"embed": f(0.02, LM["vocab"], d),
              "pos": f(0.02, 1, LM["max_len"], d)}
    for i in range(LM["layers"]):
        params["l%d" % i] = {"qkv": f(s, d, 3 * d), "proj": f(s, d, d),
                             "ff1": f(s, d, 4 * d),
                             "ff2": f(1 / np.sqrt(4 * d), 4 * d, d)}
    return params


def _lm(mx, ranks):
    """Two steps of the long-context LM at dp 2 x sp 4, each sp ring over
    both ranks: the losses and the params after."""
    from mxnet_tpu_torch.models import long_context_lm as tlm
    mesh = _build(mx, {"dp": 2, "sp": 4}, [0, 1] * 4, ranks)
    rs = np.random.RandomState(41)
    succ = rs.randint(1, LM["vocab"], size=(LM["vocab"], 3))
    params = tlm.params_from_numpy(_lm_numpy_params(), mx.cpu())
    step = tlm.make_step(mesh, LM["heads"], LM["layers"], 0.3)
    losses = []
    for _ in range(2):
        x, y = tlm.markov_batch(rs, succ, LM["batch"], LM["seq"],
                                LM["vocab"])
        params, loss = step(params, x, y)
        losses.append(float(loss))
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = v.detach().numpy().copy()
    walk(params)
    return np.asarray(losses), flat


def _w_mapped(mx, save):
    import torch
    from mxnet_tpu_torch.parallel import collectives as C
    from mxnet_tpu_torch.parallel.compat import shard_map
    mesh = _mesh(mx, "tp_across")
    x = torch.arange(48.).reshape(4, 12).requires_grad_(True)
    f = shard_map(lambda a: C.psum(a * a, "tp") + C.axis_index("dp"), mesh,
                  (C.P("dp", "tp"),), C.P("dp", "tp"))
    y = f(x)
    (g,) = torch.autograd.grad((y * y).sum(), (x,))
    save["shard_map/out"] = y.detach().numpy()
    save["shard_map/grad"] = g.numpy()
    for case in sorted(RING_CASES):
        for j, a in enumerate(_ring(mx, case, True)):
            save["ring/%s/%d" % (case, j)] = a
    for case in sorted(PP_CASES):
        for j, a in enumerate(_pipeline(mx, case, True)):
            save["pp/%s/%d" % (case, j)] = a
    for case in sorted(MOE_CASES):
        for j, a in enumerate(_moe(mx, case, True)):
            save["moe/%s/%d" % (case, j)] = a
    losses, flat = _lm(mx, True)
    save["lm/losses"] = losses
    for k, v in flat.items():
        save["lm/" + k] = v


def _w_mismatch(mx, save):
    """Rank 0 issues a psum where rank 1 issues an all-gather of the same
    bytes: both raise, naming both sides."""
    import torch
    from mxnet_tpu_torch import distributed
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import collectives as C
    mesh = mx.parallel.build_mesh({"tp": 2}, [0, 1])

    def body(a):
        if distributed.rank() == 0:
            return C.psum(a, "tp")
        return C.all_gather(a, "tp", dim=0, tiled=False)
    try:
        C.run(mesh, body, [(torch.ones(3),)] * 2)
        msg = "no error"
    except MXNetError as e:
        msg = str(e)
    save["mismatch"] = np.frombuffer(msg.encode(), dtype=np.uint8)
    # the ranks go on after a refused exchange
    out = C.run(mesh, lambda a: C.psum(a, "tp"), [(torch.ones(2),)] * 2)
    save["after_mismatch"] = out[mesh.local[0]].numpy()


def worker(phase, out):
    import torch
    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import distributed
    save = {}
    with mx.cpu():
        if phase == "parallel":
            _w_collectives(mx, save)
            _w_mapped(mx, save)
            _w_mismatch(mx, save)
        else:
            raise SystemExit("unknown phase %r" % phase)
    np.savez(os.path.join(out, "rank%d.npz" % distributed.rank()), **save)
    distributed.barrier()
    print("rank %d: %s OK" % (distributed.rank(), phase), flush=True)


def _pick(got, prefix):
    return [got["%s/%d" % (prefix, j)] for j in range(
        len([k for k in got if k.startswith(prefix + "/")]))]


def test_shard_map_across_ranks_equals_in_process(parallel_run):
    import torch
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.parallel import collectives as C
    from mxnet_tpu_torch.parallel.compat import shard_map
    got, _ = parallel_run
    mesh = _mesh(tmx, "tp_across", ranks=False)
    x = torch.arange(48.).reshape(4, 12).requires_grad_(True)
    y = shard_map(lambda a: C.psum(a * a, "tp") + C.axis_index("dp"), mesh,
                  (C.P("dp", "tp"),), C.P("dp", "tp"))(x)
    (g,) = torch.autograd.grad((y * y).sum(), (x,))
    assert np.array_equal(got["shard_map/out"], y.detach().numpy())
    assert np.array_equal(got["shard_map/grad"], g.numpy())
    xn = np.arange(48.).reshape(4, 12)
    blocks = [xn[:, 6 * k:6 * k + 6] ** 2 for k in range(2)]
    want = np.concatenate([blocks[0] + blocks[1]] * 2, 1)
    want[2:] += 1
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_attention_across_ranks(parallel_run, case):
    """sp over the ranks: output and q/k/v gradients bit-equal to the
    in-process ring, the output within the JAX ring's tolerance of its
    ``ring_attention_sharded`` on the virtual devices."""
    import jax
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    from mxnet_tpu.parallel import ring_attention as JRA
    got, _ = parallel_run
    mine = _pick(got, "ring/" + case)
    ref = _ring(tmx, case, False)
    for a, b in zip(mine, ref):
        assert np.array_equal(a, b), case
    axes, _, causal = RING_CASES[case]
    n = int(np.prod(list(axes.values())))
    jmesh = jmx.parallel.build_mesh(axes, jax.devices()[:n])
    q, k, v = _qkv(len(case))
    jref = np.asarray(JRA.ring_attention_sharded(q, k, v, jmesh, "sp",
                                                 causal=causal))
    np.testing.assert_allclose(mine[0], jref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("case", sorted(PP_CASES))
def test_pipeline_across_ranks(parallel_run, case):
    """pp over the ranks: output and every gradient bit-equal to the
    in-process pipeline; the output within rtol 1e-5 / atol 1e-6 of the
    JAX package's ``pipeline_apply``."""
    import jax
    import jax.numpy as jnp
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    got, _ = parallel_run
    mine = _pick(got, "pp/" + case)
    ref = _pipeline(tmx, case, False)
    for a, b in zip(mine, ref):
        assert np.array_equal(a, b), case
    S, M, B, _ = PP_CASES[case]
    per = _stages(S, 16, S + M)
    x = np.random.RandomState(B).randn(B, 16).astype("f")
    jout = jmx.parallel.pipeline_apply(
        lambda p, a: jnp.tanh(a @ p["w"] + p["b"]),
        jmx.parallel.stack_stage_params(
            [{k: jnp.asarray(v) for k, v in p.items()} for p in per]),
        jnp.asarray(x), jmx.parallel.build_mesh({"pp": S},
                                                jax.devices()[:S]),
        n_microbatch=M)
    np.testing.assert_allclose(mine[0], np.asarray(jout), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_across_ranks(parallel_run, case):
    """ep over the ranks: output and every param's gradient bit-equal to
    the in-process mesh, the output within rtol 1e-4 / atol 1e-5 of the
    JAX package's ``moe_ffn`` on an ep mesh, and ``moe_init(mesh=)``
    gives each position its E / ep experts."""
    import jax
    import jax.numpy as jnp
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    from jax.sharding import NamedSharding
    got, _ = parallel_run
    mine = _pick(got, "moe/" + case)
    ref = _moe(tmx, case, False)
    for a, b in zip(mine[:-1], ref[:-1]):
        assert np.array_equal(a, b), case
    E, axes, owners, _, cf, shape = MOE_CASES[case]
    ep = axes["ep"]
    assert sorted(mine[-1].tolist()) == sorted(
        [E // ep] * sum(1 for r in owners if r == 1) +
        [-1] * sum(1 for r in owners if r == 0)), mine[-1]
    assert ref[-1].tolist() == [E // ep] * len(owners)
    params = _moe_params(E, shape[-1], 16, E + len(case))
    x = np.random.RandomState(len(case)).randn(*shape).astype("f")
    jmesh = jmx.parallel.build_mesh({"ep": E}, jax.devices()[:E])
    specs = jmx.parallel.moe_shardings("ep")
    jp = {k: jax.device_put(jnp.asarray(v), NamedSharding(jmesh, specs[k]))
          for k, v in params.items()}
    jref = np.asarray(jax.jit(lambda p, a: jmx.parallel.moe_ffn(
        p, a, capacity_factor=cf))(jp, jnp.asarray(x)))
    np.testing.assert_allclose(mine[0], jref, rtol=1e-4, atol=1e-5)


def test_long_context_lm_across_ranks(parallel_run):
    """The LM's step with every sp ring across both ranks: losses and
    params after two steps bit-equal to the in-process dp 2 x sp 4
    mesh (which tests/test_torch_ring.py holds to the JAX example)."""
    import mxnet_tpu_torch as tmx
    got, _ = parallel_run
    losses, flat = _lm(tmx, False)
    assert np.array_equal(got["lm/losses"], losses)
    assert np.isfinite(losses).all()
    for k, v in flat.items():
        assert np.array_equal(got["lm/" + k], v), k


def test_mismatched_collectives_raise_naming_both_sides(parallel_run):
    got, out = parallel_run
    for r in range(2):
        with np.load(os.path.join(out, "rank%d.npz" % r)) as z:
            msg = bytes(z["mismatch"]).decode()
        assert "mesh ranks diverged" in msg, msg
        assert "rank 0 issued" in msg and "rank 1 issued" in msg, msg
        assert "PSum.fwd" in msg and "AllGather.fwd" in msg, msg
    np.testing.assert_array_equal(got["after_mismatch"], [2.0, 2.0])


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(sys.argv[2], sys.argv[3])
