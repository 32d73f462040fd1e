"""The ``pp`` and ``ep`` axes on the CPU: the port's ``pipeline_apply``
and ``moe_ffn`` over meshes of ``[cpu()] * n`` positions against the JAX
package's on its virtual CPU devices, from the same numpy values.

Tolerances: ``pipeline_apply`` rtol 1e-5 / atol 1e-6 (the JAX test's),
its gradients rtol 1e-5 / atol 1e-6 against the sequential composition;
``moe_ffn`` rtol 1e-4 / atol 1e-5 (the JAX test's), sharded over ``ep``
and dropping tokens at a tight capacity, with tokens replicated and
batch-sharded."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.parallel import collectives as C
from mxnet_tpu_torch.parallel import moe as TM

PP = dict(rtol=1e-5, atol=1e-6)
MOE = dict(rtol=1e-4, atol=1e-5)


def _tmesh(axes):
    return tmx.parallel.build_mesh(
        axes, [tmx.cpu()] * int(np.prod(list(axes.values()))))


def _jmesh(axes):
    return jmx.parallel.build_mesh(
        axes, jax.devices()[:int(np.prod(list(axes.values())))])


def _stages(S, d, seed):
    rs = np.random.RandomState(seed)
    return [{"w": (rs.randn(d, d) * 0.3).astype("f"),
             "b": (rs.randn(d) * 0.1).astype("f")} for _ in range(S)]


@pytest.mark.parametrize("S,M,B", [(4, 4, 8), (2, 2, 12), (2, 3, 12),
                                   (2, 6, 12), (4, 8, 16)])
def test_pipeline_matches_jax_and_sequential(S, M, B):
    d = 16
    per = _stages(S, d, S + M)
    x = np.random.RandomState(B).randn(B, d).astype("f")
    jout = jmx.parallel.pipeline_apply(
        lambda p, a: jnp.tanh(a @ p["w"] + p["b"]),
        jmx.parallel.stack_stage_params(
            [{k: jnp.asarray(v) for k, v in p.items()} for p in per]),
        jnp.asarray(x), _jmesh({"pp": S}), n_microbatch=M)
    tper = [{k: torch.from_numpy(v) for k, v in p.items()} for p in per]

    def stage(p, a):
        return torch.tanh(a @ p["w"] + p["b"])
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tmx.parallel.pipeline_apply(
        stage, tmx.parallel.stack_stage_params(tper), xt,
        _tmesh({"pp": S}), n_microbatch=M)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **PP)
    # the schedule is differentiable: the input's gradient against the
    # sequential composition
    cot = torch.from_numpy(np.random.RandomState(3).randn(B, d)
                           .astype("f"))
    (g,) = torch.autograd.grad((out * cot).sum(), xt)
    xr = torch.from_numpy(x).requires_grad_(True)
    ref = xr
    for p in tper:
        ref = stage(p, ref)
    (gr,) = torch.autograd.grad((ref * cot).sum(), xr)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **PP)
    np.testing.assert_allclose(g.numpy(), gr.numpy(), **PP)


def test_pipeline_stage_params_get_gradients():
    S, d = 4, 8
    per = [{k: torch.from_numpy(v).requires_grad_(True) for k, v in
            p.items()} for p in _stages(S, d, 9)]
    x = torch.from_numpy(np.random.RandomState(4).randn(8, d).astype("f"))

    def stage(p, a):
        return torch.tanh(a @ p["w"] + p["b"])
    stacked = tmx.parallel.stack_stage_params(per)
    out = tmx.parallel.pipeline_apply(stage, stacked, x, _tmesh({"pp": S}),
                                      n_microbatch=4)
    got = torch.autograd.grad(out.sum(), [p["w"] for p in per])
    ref = x
    for p in per:
        ref = stage(p, ref)
    want = torch.autograd.grad(ref.sum(), [p["w"] for p in per])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **PP)


def test_pipeline_errors_are_the_jax_ones():
    per = [{"w": torch.eye(4)} for _ in range(4)]
    with pytest.raises(ValueError, match="4 stages.*2 devices"):
        tmx.parallel.pipeline_apply(
            lambda p, x: x @ p["w"], tmx.parallel.stack_stage_params(per),
            torch.ones(4, 4), _tmesh({"pp": 2}), n_microbatch=2)
    with pytest.raises(ValueError, match="must divide the batch"):
        tmx.parallel.pipeline_apply(
            lambda p, x: x @ p["w"],
            tmx.parallel.stack_stage_params(per[:2]), torch.ones(5, 4),
            _tmesh({"pp": 2}), n_microbatch=2)


def _moe_params(E, d, h, seed):
    """Numpy params in moe_init's structure (biases nonzero, so a
    dropped slot's bias would show)."""
    rs = np.random.RandomState(seed)
    return {"gate": (rs.randn(d, E) / np.sqrt(d)).astype("f"),
            "w1": (rs.randn(E, d, h) / np.sqrt(d)).astype("f"),
            "b1": (rs.randn(E, h) * 0.1).astype("f"),
            "w2": (rs.randn(E, h, d) / np.sqrt(h)).astype("f"),
            "b2": (rs.randn(E, d) * 0.1).astype("f")}


def _jax_moe(params, x, cf, mesh=None):
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    if mesh is not None:
        from jax.sharding import NamedSharding
        specs = jmx.parallel.moe_shardings("ep")
        jp = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
              for k, v in jp.items()}
    return np.asarray(jax.jit(lambda p, a: jmx.parallel.moe_ffn(
        p, a, capacity_factor=cf))(jp, jnp.asarray(x)))


#: case -> (E, mesh axes, batch axis, capacity factor, x shape)
MOE_CASES = {
    "dense_one_device": (4, None, None, 4.0, (2, 6, 8)),
    "ep8_replicated": (8, {"ep": 8}, None, 8.0, (2, 8, 8)),
    "ep8_dropping": (8, {"ep": 8}, None, 0.5, (2, 8, 8)),
    "ep4_batch_over_ep": (8, {"ep": 4}, "ep", 1.0, (4, 8, 8)),
    "dp2_ep4_batch_over_dp": (8, {"dp": 2, "ep": 4}, "dp", 0.75,
                              (4, 8, 8)),
    "one_device_dropping": (2, None, None, 0.25, (1, 16, 4)),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_matches_jax(case):
    E, axes, batch_axis, cf, shape = MOE_CASES[case]
    params = _moe_params(E, shape[-1], 16, E + len(case))
    x = np.random.RandomState(len(case)).randn(*shape).astype("f")
    ref = _jax_moe(params, x, cf, _jmesh({"ep": E}) if axes else None)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    if axes is not None:
        mesh = _tmesh(axes)
        tparams = C.shard_tree(tparams, mesh, TM.moe_shardings("ep"))
        assert tparams["w1"].parts[0].shape[0] == E // axes["ep"]
    got = TM.moe_ffn(tparams, torch.from_numpy(x), capacity_factor=cf,
                     batch_axis=batch_axis)
    np.testing.assert_allclose(got.numpy(), ref, **MOE)
    assert np.isfinite(got.numpy()).all()


def test_moe_gradients_on_the_mesh_match_one_device():
    E, d = 8, 8
    params = _moe_params(E, d, 16, 3)
    x = np.random.RandomState(5).randn(4, 8, d).astype("f")
    one = {k: torch.from_numpy(v).requires_grad_(True)
           for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    ref = TM.moe_ffn(one, xt, capacity_factor=1.0)
    cot = torch.from_numpy(np.random.RandomState(6).randn(*x.shape)
                           .astype("f"))
    want = torch.autograd.grad((ref * cot).sum(), [xt] + list(one.values()))
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in params.items()}
    placed = C.shard_tree(leaves, _tmesh({"ep": 4}), TM.moe_shardings("ep"))
    xm = torch.from_numpy(x).requires_grad_(True)
    got = TM.moe_ffn(placed, xm, capacity_factor=1.0, batch_axis="ep")
    grads = torch.autograd.grad((got * cot).sum(),
                                [xm] + list(leaves.values()))
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **MOE)


def test_moe_init_and_shardings():
    gen = torch.Generator().manual_seed(0)
    p = TM.moe_init(gen, 8, 16, 4, ctx=tmx.cpu())
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "gate": (8, 4), "w1": (4, 8, 16), "b1": (4, 16), "w2": (4, 16, 8),
        "b2": (4, 8)}
    assert float(p["b1"].abs().sum()) == 0.0
    specs = TM.moe_shardings("ep")
    jspecs = jmx.parallel.moe_shardings("ep")
    assert {k: tuple(v) for k, v in specs.items()} == \
        {k: tuple(v) for k, v in jspecs.items()}
    assert tmx.parallel.HAS_SHARD_MAP


def test_moe_init_defaults_to_current_context(monkeypatch):
    """With no ``ctx`` the experts land on ``current_context()``'s device
    (``gpu(0)`` by default), not on the generator's: a stand-in default
    context on the meta device shows where a CPU generator's draws go."""
    gen = torch.Generator().manual_seed(0)
    with tmx.cpu():
        p = TM.moe_init(gen, 8, 16, 4)
    assert {v.device.type for v in p.values()} == {"cpu"}

    class _Meta:
        torch_device = torch.device("meta")
    monkeypatch.setattr(TM, "current_context", lambda: _Meta())
    p = TM.moe_init(gen, 8, 16, 4)
    assert {v.device.type for v in p.values()} == {"meta"}
    assert tuple(p["w1"].shape) == (4, 8, 16)
