"""The port's fused BatchNorm+activation (``kernels/bn_act.py``) against
the JAX package's Pallas kernel (run in interpret mode on the CPU, as the
JAX package's own tests run it) and its fused-lax tier.

On the CPU the port's wrapper takes the plain version; the CUDA kernel
itself is held against the plain version by the ``cuda``-marked test at
the end (and by ``chip_smoke.py`` on the H100)."""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.kernels import bn_act as jba
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.kernels import bn_act as tba

SHAPES = [(3, 5, 7, 3), (2, 64, 7, 7)]
ACTS = ["relu", "sigmoid", "tanh", None]


def _draw(shape, seed=0):
    rs = np.random.RandomState(seed)
    c = shape[1]
    return [rs.standard_normal(shape).astype(np.float32) * 1.5 + 0.2,
            rs.uniform(0.5, 1.5, c).astype(np.float32),
            (0.3 * rs.standard_normal(c)).astype(np.float32),
            (0.3 * rs.standard_normal(c)).astype(np.float32),
            rs.uniform(0.5, 1.5, c).astype(np.float32)]


def _jax(fn, arrays, dtype, **kw):
    x = jnp.asarray(arrays[0]).astype(dtype)
    out = fn(x, *[jnp.asarray(a) for a in arrays[1:]], **kw)
    return [np.asarray(o.astype(jnp.float32)) for o in out]


def _port(arrays, dtype, **kw):
    x = torch.from_numpy(arrays[0]).to(dtype)
    out = tba.fused_bn_act_plain(
        x, *[torch.from_numpy(a) for a in arrays[1:]], **kw)
    return [o.float().numpy() for o in out]


@pytest.mark.parametrize("shape", SHAPES, ids=["odd", "c64"])
@pytest.mark.parametrize("act_type", ACTS)
@pytest.mark.parametrize("is_train", [False, True], ids=["eval", "train"])
def test_plain_matches_pallas_interpret_and_lax_f32(shape, act_type,
                                                     is_train):
    arrays = _draw(shape)
    kw = dict(act_type=act_type, eps=2e-5, momentum=0.9, fix_gamma=False,
              is_train=is_train)
    got = _port(arrays, torch.float32, **kw)
    pallas = _jax(jba.fused_bn_act_pallas, arrays, jnp.float32,
                  interpret=True, **kw)
    lax = _jax(jba.fused_bn_act_lax, arrays, jnp.float32, **kw)
    # same op order as the Pallas kernel (x * scale + shift, then act):
    # agreement to 1e-6 absolute, the few-ulp noise of rsqrt and of the
    # batch-statistic sums taken in another order, on O(1) outputs
    for g, p in zip(got, pallas):
        np.testing.assert_allclose(g, p, rtol=0, atol=1e-6)
    # the lax tier computes (x - mean) * inv * gamma + beta: another
    # rounding, so rtol 1e-5 on top of the same atol
    for g, ref in zip(got, lax):
        np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=["odd", "c64"])
@pytest.mark.parametrize("act_type", ACTS)
@pytest.mark.parametrize("is_train", [False, True], ids=["eval", "train"])
def test_plain_matches_pallas_interpret_bf16(shape, act_type, is_train):
    arrays = _draw(shape, seed=1)
    kw = dict(act_type=act_type, eps=2e-5, momentum=0.9, fix_gamma=False,
              is_train=is_train)
    got = _port(arrays, torch.bfloat16, **kw)
    pallas = _jax(jba.fused_bn_act_pallas, arrays, jnp.bfloat16,
                  interpret=True, **kw)
    # bfloat16 keeps 8 bits of mantissa; the two frameworks round the
    # product and the sum at different points: 1e-2 relative and absolute
    for g, p in zip(got, pallas):
        np.testing.assert_allclose(g, p, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("act_type", ["softrelu", "softsign"])
def test_other_acts_take_composed_ops(act_type):
    """Acts outside the kernel's set take BatchNorm then Activation, as
    the JAX package routes them to its lax tier."""
    arrays = _draw((2, 4, 3, 5), seed=2)
    kw = dict(act_type=act_type, eps=1e-3, fix_gamma=True, is_train=False)
    before = tba.LAUNCHES
    got = [o.numpy() for o in tba.fused_bn_act(
        *[torch.from_numpy(a) for a in arrays], **kw)]
    ref = _jax(jba.fused_bn_act_lax, arrays, jnp.float32, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
    assert tba.LAUNCHES == before


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_fold_bn_into_conv(with_bias, fix_gamma):
    rs = np.random.RandomState(3)
    w = rs.standard_normal((6, 3, 3, 3)).astype(np.float32)
    b = rs.standard_normal(6).astype(np.float32) if with_bias else None
    gamma, beta, mm = (rs.standard_normal(6).astype(np.float32)
                       for _ in range(3))
    mv = rs.uniform(0.5, 1.5, 6).astype(np.float32)
    jw, jb = jba.fold_bn_into_conv(
        jnp.asarray(w), None if b is None else jnp.asarray(b),
        jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(mm),
        jnp.asarray(mv), eps=2e-5, fix_gamma=fix_gamma)
    tw, tb = tba.fold_bn_into_conv(
        torch.from_numpy(w), None if b is None else torch.from_numpy(b),
        torch.from_numpy(gamma), torch.from_numpy(beta),
        torch.from_numpy(mm), torch.from_numpy(mv), eps=2e-5,
        fix_gamma=fix_gamma)
    # elementwise products of the same float32 operands: a one-ulp
    # rsqrt difference at most
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)


def test_cpu_tensor_takes_plain_and_leaves_launches():
    arrays = [torch.from_numpy(a) for a in _draw((2, 3, 4, 4), seed=4)]
    before = tba.LAUNCHES
    out = tba.fused_bn_act(*arrays, act_type="relu", is_train=False)
    ref = tba.fused_bn_act_plain(*arrays, act_type="relu", is_train=False)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    y = tba.norm_act(arrays[0], arrays[1], arrays[2], "tanh")
    assert torch.equal(y, tba.norm_act_plain(arrays[0], arrays[1],
                                             arrays[2], "tanh"))
    assert tba.LAUNCHES == before


def test_gpu_context_without_cuda_raises(monkeypatch):
    """No CUDA means an error, never a silent run on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mxt.current_context() == mxt.gpu(0)
    with pytest.raises(mxt.MXNetError, match="CUDA is not available"):
        mxt.gpu(0).torch_device
    with pytest.raises(mxt.MXNetError):
        mxt.nd.zeros((2, 2))
    with pytest.raises(mxt.MXNetError):
        mxt.nd.array(np.ones(3, np.float32), ctx=mxt.gpu(0))
    data = mxt.sym.Variable("data")
    net = mxt.sym.FullyConnected(data, num_hidden=2, name="fc")
    w = {"arg:fc_weight": mxt.nd.zeros((2, 3), ctx=mxt.cpu()),
         "arg:fc_bias": mxt.nd.zeros((2,), ctx=mxt.cpu())}
    with pytest.raises(mxt.MXNetError):
        mxt.predict.Predictor(net, w, {"data": (1, 3)})   # default ctx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 7, 3), (4, 256, 14, 14)])
def test_cuda_kernel_matches_plain(dtype, shape):
    """On a CUDA card: the kernel against its plain version, every act
    (float32 to 1e-5 absolute, bfloat16 to 1e-2 of the output range)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    arrays = _draw(shape, seed=5)
    x = torch.from_numpy(arrays[0]).cuda().to(dt)
    scale = torch.from_numpy(arrays[1]).cuda().to(dt)
    shift = torch.from_numpy(arrays[2]).cuda().to(dt)
    for act in ACTS:
        before = tba.LAUNCHES
        y = tba.norm_act(x, scale, shift, act)
        ref = tba.norm_act_plain(x, scale, shift, act)
        torch.cuda.synchronize()
        assert tba.LAUNCHES == before + 1
        err = (y.float() - ref.float()).abs().max().item()
        if dt == torch.float32:
            assert err <= 1e-5
        else:
            assert err <= 1e-2 * ref.float().abs().max().item()
    with pytest.raises(ValueError):
        tba.norm_act(x.transpose(2, 3), scale, shift, "relu")
    with pytest.raises(ValueError):
        tba.norm_act(x, scale[:-1], shift, "relu")


def test_bf16_numpy_arrays_carry_into_port():
    a = np.arange(6, dtype=np.float32).reshape(2, 3).astype(ml_dtypes.bfloat16)
    t = mxt.nd.array(a, ctx=mxt.cpu(), dtype=a.dtype)
    assert t.dtype == "bfloat16" and t._data.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.asnumpy(), a.astype(np.float32))
