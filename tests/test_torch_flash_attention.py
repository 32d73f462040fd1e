"""Flash attention (``kernels/flash_attention.py``) and ``full_attention``
/ ``ring_attention`` (``parallel/ring_attention.py``) in the port against
the JAX package on the CPU, from the same seeded numpy inputs.

The port's ``flash_attention_plain`` and ``FlashAttentionFn`` (the plain
forward on a CPU tensor, the plain recompute backward) are held against
JAX's ``flash_attention_lax`` and ``flash_attention_pallas(interpret=True)``
(as ``tests/test_kernels.py`` runs them) and against the exact softmax.
Tolerances: float32 rtol/atol 1e-5 forward and 1e-4 for q/k/v gradients
(the streaming softmax reassociates the sums of exponentials, and the two
packages contract in other orders); bfloat16 rtol/atol 5e-2 (the JAX lax
tier rounds its products to bfloat16 where the port and the Pallas kernel
compute in float32: ``tests/test_kernels.py``'s bfloat16 tolerance).  The
roofline accounting is equal.  The route function and the 16-byte
alignment check (and the copies it asks for) are plain Python, tested
here; the CUDA kernel's routes are held against the plain version by the
``cuda``-marked tests, which skip without a card."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.kernels import flash_attention as JFA
from mxnet_tpu.kernels import roofline as jroof
from mxnet_tpu.parallel import ring_attention as JRA
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as TFA
from mxnet_tpu_torch.kernels import roofline as troof
from mxnet_tpu_torch.parallel import ring_attention as TRA

BLOCK = 16
F32 = {"rtol": 1e-5, "atol": 1e-5}
F32_GRAD = {"rtol": 1e-4, "atol": 1e-4}
BF16 = {"rtol": 5e-2, "atol": 5e-2}


def _draw(shape_q, shape_kv, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape_q).astype(np.float32),
            rs.randn(*shape_kv).astype(np.float32),
            rs.randn(*shape_kv).astype(np.float32))


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _torch(arrays, dtype, grad=False):
    return [torch.from_numpy(a).to(getattr(torch, dtype))
            .requires_grad_(grad) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("D", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Tq,Tk", [(16, 16), (37, 37), (16, 37), (37, 16)])
def test_flash_matches_jax(Tq, Tk, causal, dtype, D):
    """Forward of the port's plain version and of FlashAttentionFn against
    JAX's lax tier and Pallas kernel (interpret mode), block 16, Tq < Tk
    and Tq > Tk included; float32 q/k/v gradients of sum(out**2) through
    FlashAttentionFn against jax.grad through the Pallas custom_vjp."""
    arrays = _draw((2, Tq, 3, D), (2, Tk, 3, D), seed=4 + Tq + Tk + D)
    jq, jk, jv = _jax(arrays, dtype)
    lax_out = JFA.flash_attention_lax(jq, jk, jv, causal=causal,
                                      block_k=BLOCK)
    pallas = lambda a, b, c: JFA.flash_attention_pallas(  # noqa: E731
        a, b, c, causal=causal, block=BLOCK, interpret=True)
    pal_out = pallas(jq, jk, jv)
    tq, tk, tv = _torch(arrays, dtype, grad=dtype == "float32")
    plain = TFA.flash_attention_plain(tq, tk, tv, causal=causal,
                                      block_k=BLOCK)
    fn = TFA.flash_attention(tq, tk, tv, causal=causal, block=BLOCK)
    assert plain.dtype == fn.dtype == getattr(torch, dtype)
    assert plain.shape == fn.shape == (2, Tq, 3, D)
    tol = F32 if dtype == "float32" else BF16
    for ref in (lax_out, pal_out):
        np.testing.assert_allclose(_np(plain), _np(ref), **tol)
        np.testing.assert_allclose(_np(fn), _np(ref), **tol)
    if dtype != "float32":
        return
    jgrads = jax.grad(lambda a, b, c: (pallas(a, b, c) ** 2).sum(),
                      argnums=(0, 1, 2))(jq, jk, jv)
    tgrads = torch.autograd.grad((fn ** 2).sum(), (tq, tk, tv))
    for g, r in zip(tgrads, jgrads):
        assert np.isfinite(_np(g)).all()
        np.testing.assert_allclose(_np(g), _np(r), **F32_GRAD)


def test_online_update_matches_jax():
    """One accumulation step from a running state, with a fully masked
    row that must not move the running max, equals JAX's."""
    rs = np.random.RandomState(7)
    B, Tq, Tk, H, D = 2, 5, 6, 3, 8
    q, k, v = (rs.randn(B, T, H, D).astype(np.float32)
               for T in (Tq, Tk, Tk))
    acc = rs.randn(B, Tq, H, D).astype(np.float32)
    m_run = rs.randn(B, H, Tq).astype(np.float32)
    m_run[0, 0, 1] = -np.inf                      # a row with no key yet
    s_run = rs.rand(B, H, Tq).astype(np.float32) + 0.5
    s_run[0, 0, 1] = 0.0
    acc[0, 1, 0] = 0.0
    mask = rs.rand(Tq, Tk) > 0.4
    mask[2] = False                               # fully masked row
    got = TFA.online_update(*(torch.from_numpy(a) for a in
                              (acc, m_run, s_run, q, k, v)), 0.3,
                            torch.from_numpy(mask)[None, None])
    ref = JFA.online_update(*(jnp.asarray(a) for a in
                              (acc, m_run, s_run, q, k, v)), 0.3,
                            jnp.asarray(mask)[None, None])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), **F32)
    np.testing.assert_array_equal(_np(got[1])[:, :, 2], m_run[:, :, 2])


def test_cpu_wrapper_routes_to_plain():
    """On CPU tensors the kernel wrapper is the plain version, bit for
    bit, and counts no launch (strided views included)."""
    arrays = _draw((2, 40, 2, 8), (2, 40, 2, 8), seed=9)
    q, k, v = _torch(arrays, "float32")
    q = torch.cat([q, q], dim=-1)[..., ::2]       # a strided view
    before = TFA.LAUNCHES
    got = TFA.flash_attention_fwd(q, k, v, causal=True, block=BLOCK)
    ref = TFA.flash_attention_plain(q, k, v, causal=True, block_k=BLOCK)
    assert TFA.LAUNCHES == before
    assert torch.equal(got, ref)


@pytest.mark.parametrize("raw,want", [(None, 128), ("32", 32), ("4", 8),
                                      ("abc", 128)])
def test_default_block_matches_jax(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("MXTPU_FLASH_BLOCK", raising=False)
    else:
        monkeypatch.setenv("MXTPU_FLASH_BLOCK", raw)
    assert TFA.default_block() == JFA.default_block() == want


def test_full_attention_exact_route_matches_jax(monkeypatch):
    """MXTPU_FUSED_KERNELS=0 takes the exact softmax in both packages."""
    monkeypatch.setenv("MXTPU_FUSED_KERNELS", "0")
    monkeypatch.setenv("MXTPU_FLASH_BLOCK", str(BLOCK))
    for causal in (True, False):
        arrays = _draw((2, 30, 2, 8), (2, 40, 2, 8), seed=11)
        got = TRA.full_attention(*_torch(arrays, "float32"), causal=causal)
        ref = JRA.full_attention(*_jax(arrays, "float32"), causal=causal)
        np.testing.assert_allclose(_np(got), np.asarray(ref), **F32)


@pytest.mark.parametrize("T,flash", [(16, False), (17, True), (40, True)])
def test_full_attention_routes_by_block(monkeypatch, T, flash):
    """MXTPU_FLASH_BLOCK sets the threshold: Tk at the block takes the
    exact route, Tk above it the flash route; both agree with JAX."""
    monkeypatch.setenv("MXTPU_FLASH_BLOCK", str(BLOCK))
    calls = []
    real = TFA.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(TFA, "flash_attention", spy)
    arrays = _draw((2, T, 2, 8), (2, T, 2, 8), seed=12)
    got = TRA.full_attention(*_torch(arrays, "float32"), causal=True)
    ref = JRA.full_attention(*_jax(arrays, "float32"), causal=True)
    assert bool(calls) == flash
    np.testing.assert_allclose(_np(got), np.asarray(ref), **F32)


def test_masked_rows_zero_on_flash_nan_on_exact(monkeypatch):
    """Causal with Tq > Tk: the first Tq - Tk rows see no key.  The flash
    route gives 0 there and the exact route NaN, in both packages; the
    other rows agree."""
    monkeypatch.setenv("MXTPU_FLASH_BLOCK", str(BLOCK))
    Tq, Tk = 40, 24
    arrays = _draw((2, Tq, 2, 8), (2, Tk, 2, 8), seed=13)
    outs = {}
    for fused in ("1", "0"):
        monkeypatch.setenv("MXTPU_FUSED_KERNELS", fused)
        outs[fused] = (
            _np(TRA.full_attention(*_torch(arrays, "float32"), causal=True)),
            np.asarray(JRA.full_attention(*_jax(arrays, "float32"),
                                          causal=True)))
    dead = Tq - Tk
    for got in outs["1"]:
        assert (got[:, :dead] == 0).all()
        assert np.isfinite(got).all()
    for got in outs["0"]:
        assert np.isnan(got[:, :dead]).all()
        assert np.isfinite(got[:, dead:]).all()
    np.testing.assert_allclose(outs["1"][0], outs["1"][1], **F32)
    np.testing.assert_allclose(outs["1"][0][:, dead:], outs["0"][0][:, dead:],
                               **F32)


def test_ring_attention_without_mesh_is_full_attention(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_BLOCK", str(BLOCK))
    arrays = _draw((2, 40, 2, 8), (2, 40, 2, 8), seed=14)
    q, k, v = _torch(arrays, "float32")
    ref = TRA.full_attention(q, k, v, causal=True)
    one = types.SimpleNamespace(shape={"dp": 1, "sp": 1})
    for mesh in (None, one):
        got = TRA.ring_attention(q, k, v, mesh=mesh, causal=True)
        assert torch.equal(got, ref)
    jgot = JRA.ring_attention(*_jax(arrays, "float32"), mesh=None,
                              causal=True)
    np.testing.assert_allclose(_np(ref), np.asarray(jgot), **F32)
    two = types.SimpleNamespace(shape={"dp": 1, "sp": 2})
    with pytest.raises(MXNetError, match="multi-GPU slice"):
        TRA.ring_attention(q, k, v, mesh=two, causal=True)
    with pytest.raises(MXNetError, match="multi-GPU slice"):
        TRA.ring_attention_sharded(q, k, v, two)


@pytest.mark.parametrize("name,shape", [
    ("bn_act", {"n": 32, "c": 256, "hw": 56 * 56}),
    ("lstm_cell", {"b": 32, "h": 200}),
    ("flash_attention", {"b": 4, "t": 4096, "heads": 4, "d": 16}),
])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_roofline_matches_jax(name, shape, itemsize):
    got = troof.workload(name, itemsize=itemsize, **shape)
    ref = jroof.workload(name, itemsize=itemsize, **shape)
    assert got == ref
    args = (got["flops"], got["fused_bytes"], 67e12, 3.35e12)
    assert troof.roofline_seconds(*args) == jroof.roofline_seconds(*args)
    assert troof.bound_side(*args) == jroof.bound_side(*args)


@pytest.mark.parametrize("dtype,D,want", [
    ("float32", 16, "tiled_f32"), ("bfloat16", 16, "mma_bf16"),
    ("float32", 64, "tiled_f32"), ("bfloat16", 64, "mma_bf16"),
    ("float32", 8, "tiled_f32"), ("bfloat16", 8, "mma_bf16"),
    ("float32", 128, "tiled_f32"), ("bfloat16", 128, "mma_bf16"),
    ("float32", 40, "tiled_f32"), ("bfloat16", 40, "mma_bf16"),
    ("float32", 129, "rowwise"), ("bfloat16", 256, "rowwise"),
    ("float32", 256, "rowwise")])
def test_flash_route(dtype, D, want):
    """The kernel's route from (dtype, D): every head dim of the smoke's
    shapes up to 128 takes a tiled route in both dtypes, above it the
    rowwise kernel."""
    assert TFA.flash_route(getattr(torch, dtype), D) == want
    assert want in TFA.ROUTES


def _qkv_views(dtype, D, offset=0):
    """q, k, v as the model's split gives them: strided views of one
    (B, T, 3, H, D) product, starting ``offset`` elements into a flat
    buffer."""
    B, T, H = 2, 24, 3
    n = B * T * 3 * H * D
    flat = torch.arange(n + offset, dtype=torch.float32).to(dtype)
    qkv = flat[offset:].view(B, T, 3, H, D)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_alignment_check_and_staging_copies(dtype):
    """16-byte alignment for the tiled routes' cp.async: an aligned
    strided qkv view is taken as it is; the same view starting one element
    off is misaligned and copied once per tensor into an aligned
    contiguous tensor of the same values (counted); a head dim whose row
    is not whole 16-byte chunks (D 5, or D 12 in bfloat16) is never
    copied: the kernel stages it with element loads."""
    dt = getattr(torch, dtype)
    route = TFA.flash_route(dt, 16)
    views = _qkv_views(dt, 16)
    for t in views:
        assert t.stride() == (24 * 3 * 3 * 16, 3 * 3 * 16, 16, 1)
        assert TFA.vector_aligned(t)
        before = TFA.ALIGN_COPIES
        assert TFA._staged(t, route) is t
        assert TFA.ALIGN_COPIES == before
    for t in _qkv_views(dt, 16, offset=1):
        assert not TFA.vector_aligned(t)
        before = TFA.ALIGN_COPIES
        got = TFA._staged(t, route)
        assert TFA.ALIGN_COPIES == before + 1
        assert got.is_contiguous() and TFA.vector_aligned(got)
        assert torch.equal(got, t)
        # the rowwise kernel takes any alignment: no copy
        assert TFA._staged(t, "rowwise") is t
    narrow = [5, 12] if dtype == "bfloat16" else [5, 3]
    for D in narrow:
        for t in _qkv_views(dt, D, offset=1) + _qkv_views(dt, D):
            assert not TFA.vector_aligned(t)
            before = TFA.ALIGN_COPIES
            assert TFA._staged(t, TFA.flash_route(dt, D)) is t
            assert TFA.ALIGN_COPIES == before


def test_alignment_ignores_strides_of_length_one_dims():
    """A dim of length 1 contributes no row start, so its stride does not
    count (as in the kernel's ``rows_aligned``)."""
    buf = torch.zeros(1024)
    t = buf.as_strided((1, 8, 1, 16), (3, 16, 5, 1))
    assert TFA.vector_aligned(t)
    u = buf.as_strided((2, 8, 1, 16), (131, 16, 5, 1))
    assert not TFA.vector_aligned(u)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Tq,Tk,H,D,causal", [
    (4, 512, 512, 4, 16, True), (3, 37, 53, 2, 8, True),
    (2, 70, 30, 2, 16, True), (2, 100, 100, 2, 24, False),
    (1, 130, 130, 2, 128, True), (1, 40, 40, 1, 256, False)])
def test_cuda_kernel_matches_plain(dtype, B, Tq, Tk, H, D, causal):
    """On a CUDA card: the kernel against the plain version, from strided
    q/k/v views of one qkv tensor; float32 to 2e-5 absolute, bfloat16 to
    2e-2 of the output's range; one launch; rows that see no key exactly
    0; bad inputs raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn((B, max(Tq, Tk), 3, H, D), generator=gen,
                      device="cuda").to(dt)
    q, k, v = qkv[:, :Tq, 0], qkv[:, :Tk, 1], qkv[:, :Tk, 2]
    before = TFA.LAUNCHES
    route = TFA.flash_route(dt, D)
    route_before = TFA.ROUTE_LAUNCHES[route]
    got = TFA.flash_attention_fwd(q, k, v, causal=causal)
    ref = TFA.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert TFA.LAUNCHES == before + 1
    assert TFA.ROUTE_LAUNCHES[route] == route_before + 1
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = (got.float() - ref.float()).abs().max().item()
    if dt == torch.float32:
        assert err <= 2e-5, err
    else:
        assert err <= 2e-2 * ref.float().abs().max().item(), err
    if causal and Tq > Tk:
        assert (got[:, :Tq - Tk] == 0).all()
    with pytest.raises(ValueError):
        TFA.flash_attention_fwd(q, k[..., :-1], v[..., :-1])
    with pytest.raises(TypeError):
        TFA.flash_attention_fwd(q.half(), k.half(), v.half())
    big = torch.zeros((1, 4, 1, 264), device="cuda", dtype=dt)
    with pytest.raises(ValueError, match="D=264"):
        TFA.flash_attention_fwd(big, big, big)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,offset", [(40, 0), (5, 0), (12, 0), (16, 1),
                                      (64, 0)])
def test_cuda_routes_agree_with_plain(dtype, D, offset):
    """On a CUDA card: the tiled route and the rowwise route against the
    plain version at head dims that are not a multiple of 16 (40), not a
    whole 16-byte row (5, and 12 in bfloat16: element loads), and from a
    misaligned view (copied once per tensor); causal with Tq > Tk, so the
    first rows see no key and are exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    B, Tq, Tk, H = 2, 150, 90, 2
    gen = torch.Generator(device="cuda").manual_seed(6)
    flat = torch.randn(B * Tq * 3 * H * D + offset, generator=gen,
                       device="cuda").to(dt)
    qkv = flat[offset:].view(B, Tq, 3, H, D)
    q, k, v = qkv[:, :, 0], qkv[:, :Tk, 1], qkv[:, :Tk, 2]
    ref = TFA.flash_attention_plain(q, k, v, causal=True)
    top = ref.float().abs().max().item()
    for route in (TFA.flash_route(dt, D), "rowwise"):
        copies = TFA.ALIGN_COPIES
        got = TFA.flash_attention_fwd(q, k, v, causal=True, route=route)
        torch.cuda.synchronize()
        expect = 3 if (offset and route != "rowwise"
                       and D * q.element_size() % 16 == 0) else 0
        assert TFA.ALIGN_COPIES == copies + expect
        err = (got.float() - ref.float()).abs().max().item()
        if dt == torch.float32:
            assert err <= 2e-5, (route, err)
        else:
            assert err <= 1e-2 * top, (route, err)
        assert (got[:, :Tq - Tk] == 0).all()
    with pytest.raises(ValueError, match="route"):
        TFA.flash_attention_fwd(q, k, v, route="mma_bf16" if dt ==
                                torch.float32 else "tiled_f32")
