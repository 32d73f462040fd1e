"""Gradients of the port's fused BatchNorm+activation (``NormAct`` with
``norm_act_bwd``) against ``jax.vjp`` of the JAX package's Pallas tier,
run in interpret mode on the CPU as the JAX package's own tests run it.

On the CPU the port's backward wrapper takes ``norm_act_bwd_plain``; the
CUDA backward kernel is held against it by the ``cuda``-marked test at the
end (and by ``chip_smoke.py`` on the H100)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.kernels import bn_act as jba
from mxnet_tpu_torch.kernels import bn_act as tba

SHAPES = [(2, 8, 4, 4), (2, 3, 5, 7)]
ACTS = ["relu", "sigmoid", "tanh", None]
EPS, MOMENTUM = 2e-5, 0.9


def _draw(shape, seed):
    rs = np.random.RandomState(seed)
    c = shape[1]
    return dict(
        x=(rs.standard_normal(shape) * 1.5 + 0.2).astype(np.float32),
        gamma=rs.uniform(0.5, 1.5, c).astype(np.float32),
        beta=(0.3 * rs.standard_normal(c)).astype(np.float32),
        mm=(0.3 * rs.standard_normal(c)).astype(np.float32),
        mv=rs.uniform(0.5, 1.5, c).astype(np.float32),
        dy=rs.standard_normal(shape).astype(np.float32))


def _jax_grads(a, jdtype, act_type, fix_gamma):
    def f(x, gamma, beta):
        return jba.fused_bn_act_pallas(
            x, gamma, beta, jnp.asarray(a["mm"]), jnp.asarray(a["mv"]),
            act_type=act_type, eps=EPS, momentum=MOMENTUM,
            fix_gamma=fix_gamma, is_train=True, interpret=True)
    x = jnp.asarray(a["x"]).astype(jdtype)
    (out, mm, mv), vjp = jax.vjp(f, x, jnp.asarray(a["gamma"]),
                                 jnp.asarray(a["beta"]))
    dx, dgamma, dbeta = vjp((jnp.asarray(a["dy"]).astype(jdtype),
                             jnp.zeros_like(mm), jnp.zeros_like(mv)))
    return [np.asarray(t.astype(jnp.float32))
            for t in (out, dx, dgamma, dbeta, mm, mv)]


def _port_grads(a, tdtype, act_type, fix_gamma):
    x = torch.from_numpy(a["x"]).to(tdtype).requires_grad_(True)
    gamma = torch.from_numpy(a["gamma"]).requires_grad_(True)
    beta = torch.from_numpy(a["beta"]).requires_grad_(True)
    out, mm, mv = tba.fused_bn_act(
        x, gamma, beta, torch.from_numpy(a["mm"]), torch.from_numpy(a["mv"]),
        act_type=act_type, eps=EPS, momentum=MOMENTUM, fix_gamma=fix_gamma,
        is_train=True)
    assert not mm.requires_grad and not mv.requires_grad
    grads = torch.autograd.grad(out, (x, gamma, beta),
                                torch.from_numpy(a["dy"]).to(tdtype),
                                allow_unused=True)
    # fix_gamma cuts gamma off the graph: None, where jax.vjp gives zeros
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, (x, gamma, beta))]
    return [t.detach().float().numpy() for t in [out] + grads + [mm, mv]]


NAMES = ("out", "dx", "dgamma", "dbeta", "moving_mean", "moving_var")


@pytest.mark.parametrize("shape", SHAPES, ids=["c8", "odd"])
@pytest.mark.parametrize("act_type", ACTS)
@pytest.mark.parametrize("fix_gamma", [False, True], ids=["gamma", "fixed"])
def test_fused_bn_act_grads_match_pallas_f32(shape, act_type, fix_gamma):
    a = _draw(shape, seed=10)
    before = (tba.LAUNCHES, tba.BWD_LAUNCHES)
    got = _port_grads(a, torch.float32, act_type, fix_gamma)
    want = _jax_grads(a, jnp.float32, act_type, fix_gamma)
    # the same per-element op order as the Pallas kernel pair; the
    # scale/shift gradients and the batch statistics are sums taken in
    # another order: rtol 1e-5, atol 1e-6 on O(1) values
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
    if fix_gamma:
        assert not got[2].any()
    assert (tba.LAUNCHES, tba.BWD_LAUNCHES) == before   # CPU: plain path


@pytest.mark.parametrize("shape", SHAPES, ids=["c8", "odd"])
@pytest.mark.parametrize("act_type", ACTS)
@pytest.mark.parametrize("fix_gamma", [False, True], ids=["gamma", "fixed"])
def test_fused_bn_act_grads_match_pallas_bf16(shape, act_type, fix_gamma):
    a = _draw(shape, seed=11)
    got = _port_grads(a, torch.bfloat16, act_type, fix_gamma)
    want = _jax_grads(a, jnp.bfloat16, act_type, fix_gamma)
    exact = _float64_grads(a, act_type, fix_gamma)
    # bfloat16 keeps 8 mantissa bits.  The port's backward computes and
    # sums in float32 and lands within 1e-2 of each tensor's range of the
    # float64 answer on the same bfloat16 inputs; the Pallas kernel rounds
    # every step and its partial sums to bfloat16 (up to 1.9e-2 of range
    # from that answer at these inputs): the two agree within 2e-2
    for name, g, w, e in zip(NAMES, got, want, exact):
        top = max(float(np.abs(e).max()), 1e-6)
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-2 * top,
                                   err_msg=name + " vs float64")
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-2 * top,
                                   err_msg=name + " vs pallas")


def _float64_grads(a, act_type, fix_gamma):
    """out, dx, dgamma, dbeta in float64 (torch autograd of the plain
    formula) on the bfloat16-rounded x and dy."""
    x = torch.from_numpy(a["x"]).bfloat16().double().requires_grad_(True)
    gamma = torch.from_numpy(a["gamma"]).double().requires_grad_(True)
    beta = torch.from_numpy(a["beta"]).double().requires_grad_(True)
    out, _, _ = tba.fused_bn_act_plain(
        x, gamma, beta, torch.from_numpy(a["mm"]).double(),
        torch.from_numpy(a["mv"]).double(), act_type=act_type, eps=EPS,
        momentum=MOMENTUM, fix_gamma=fix_gamma, is_train=True)
    dy = torch.from_numpy(a["dy"]).bfloat16().double()
    grads = torch.autograd.grad(out, (x, gamma, beta), dy, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, (x, gamma, beta))]
    return [t.detach().numpy() for t in [out] + grads]


@pytest.mark.parametrize("shape", SHAPES, ids=["c8", "odd"])
@pytest.mark.parametrize("act_type", ACTS)
def test_norm_act_bwd_plain_matches_pallas_bwd_call(shape, act_type):
    """The plain backward against the Pallas ``bwd_call`` itself (the
    custom_vjp's backward of the interpret-mode kernel pair)."""
    rs = np.random.RandomState(12)
    n, c = shape[0], shape[1]
    x = rs.standard_normal(shape).astype(np.float32)
    scale = rs.uniform(0.5, 1.5, c).astype(np.float32)
    shift = (0.5 * rs.standard_normal(c)).astype(np.float32)
    dy = rs.standard_normal(shape).astype(np.float32)
    x3 = jnp.asarray(x.reshape(n, c, -1))
    _, vjp = jax.vjp(lambda a, s, b: jba._norm_act(a, s, b, act_type, True),
                     x3, jnp.asarray(scale.reshape(1, c, 1)),
                     jnp.asarray(shift.reshape(1, c, 1)))
    jdx, jds, jdb = vjp(jnp.asarray(dy.reshape(n, c, -1)))
    dx, ds, db = tba.norm_act_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(shift),
        torch.from_numpy(dy), act_type)
    assert dx.shape == x.shape and ds.shape == db.shape == (c,)
    # elementwise: the same float32 ops (1e-6); partial sums in another
    # order (rtol 1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx).reshape(shape),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds).reshape(c),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb).reshape(c),
                               rtol=1e-5, atol=1e-6)


def test_relu_backward_masks_nan_like_jax():
    """relu's act' is (y > 0): a NaN pre-activation gives 0, not NaN,
    wherever dy is finite."""
    x = torch.tensor([[[float("nan"), 1.0, -1.0]]])
    one = torch.ones(1)
    dx, _, _ = tba.norm_act_bwd_plain(x, one, torch.zeros(1),
                                      torch.ones_like(x), "relu")
    assert dx.tolist() == [[[0.0, 1.0, 0.0]]]


@pytest.mark.parametrize("act_type", ACTS)
def test_norm_act_bwd_plain_keeps_float64(act_type):
    """A float64 input (the CPU's exact reference) is differentiated in
    float64, not rounded through float32: torch autograd of the plain
    forward agrees to 1e-12."""
    rs = np.random.RandomState(14)
    shape = (2, 3, 5, 7)
    x, dy = (torch.from_numpy(rs.standard_normal(shape)) for _ in range(2))
    scale = torch.from_numpy(rs.uniform(0.5, 1.5, 3))
    shift = torch.from_numpy(0.5 * rs.standard_normal(3))
    got = tba.norm_act_bwd_plain(x, scale, shift, dy, act_type)
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, shift)]
    want = torch.autograd.grad(tba.norm_act_plain(*leaves, act_type),
                               leaves, dy)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 7, 3), (4, 256, 14, 14),
                                   (2, 64, 112, 112)])
def test_cuda_bwd_kernel_matches_plain(dtype, shape):
    """On a CUDA card: the backward kernel against its plain version,
    every act: dx to 1e-5 absolute in float32 (1e-2 of its range in
    bfloat16), dscale/dshift to 1e-4 of their range in float32 and 1e-2
    in bfloat16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    rs = np.random.RandomState(13)
    c = shape[1]
    x = torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
    scale = torch.from_numpy(rs.uniform(0.5, 1.5, c).astype(np.float32))
    shift = torch.from_numpy((0.5 * rs.standard_normal(c)).astype(np.float32))
    dy = torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
    x, scale, shift, dy = (t.cuda().to(dt) for t in (x, scale, shift, dy))
    rel = 1e-4 if dt == torch.float32 else 1e-2
    for act in ACTS:
        before = tba.BWD_LAUNCHES
        got = tba.norm_act_bwd(x, scale, shift, dy, act)
        ref = tba.norm_act_bwd_plain(x, scale, shift, dy, act)
        torch.cuda.synchronize()
        assert tba.BWD_LAUNCHES == before + 1
        for i, (g, r) in enumerate(zip(got, ref)):
            assert g.shape == r.shape and g.dtype == r.dtype
            err = (g.float() - r.float()).abs().max().item()
            top = r.float().abs().max().item()
            if i == 0 and dt == torch.float32:
                assert err <= 1e-5, (act, err)
            else:
                assert err <= (1e-2 if i == 0 else rel) * top, (act, i, err)
    with pytest.raises(ValueError):
        tba.norm_act_bwd(x, scale, shift, dy.transpose(2, 3), "relu")
    with pytest.raises(ValueError):
        tba.norm_act_bwd(x, scale[:-1], shift, dy, "relu")
