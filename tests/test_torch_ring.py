"""The ``sp`` axis on the CPU: the port's ring attention over a mesh of
``[cpu()] * n`` positions against the JAX package's
``ring_attention_sharded`` on its virtual CPU devices and against
``full_attention``, causal and not (rtol 2e-4 / atol 2e-5, the JAX
package's own test tolerance); and the long-context LM on a dp 2 x sp 4
mesh against the JAX example's ``make_step`` on the same mesh shape (d_model
16, seq 32, three steps: losses rtol 1e-5, params rtol/atol 1e-4, as
tests/test_torch_long_context_lm.py holds the one-device step)."""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.parallel import ring_attention as JRA
from mxnet_tpu_torch.models import long_context_lm as tlm
from mxnet_tpu_torch.parallel import ring_attention as TRA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = dict(rtol=2e-4, atol=2e-5)
VOCAB, D, HEADS, LAYERS, T, BATCH, MAX_LEN = 32, 16, 2, 2, 32, 4, 64


def _qkv(seed, B=2, Tn=16, H=2, Dh=8):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, Tn, H, Dh).astype("f") for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_matches_jax_ring_and_full(sp, causal):
    q, k, v = _qkv(sp)
    jmesh = jmx.parallel.build_mesh({"sp": sp}, jax.devices()[:sp])
    tmesh = tmx.parallel.build_mesh({"sp": sp}, [tmx.cpu()] * sp)
    jref = np.asarray(JRA.ring_attention_sharded(q, k, v, jmesh, "sp",
                                                 causal=causal))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TRA.ring_attention_sharded(tq, tk, tv, tmesh, "sp", causal=causal)
    full = TRA.full_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.numpy(), jref, **RING)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **RING)
    # the entry point dispatches to the ring when sp > 1
    via = TRA.ring_attention(tq, tk, tv, mesh=tmesh, causal=causal)
    assert torch.equal(via, got)


def test_ring_gradients_match_full_attention():
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(7))
    mesh = tmx.parallel.build_mesh({"dp": 2, "sp": 4}, [tmx.cpu()] * 8)
    cot = torch.from_numpy(np.random.RandomState(8).randn(2, 16, 2, 8)
                           .astype("f"))
    got = TRA.ring_attention_sharded(q, k, v, mesh, "sp", causal=True)
    g = torch.autograd.grad((got * cot).sum(), (q, k, v))
    ref = TRA.full_attention(q, k, v, causal=True)
    r = torch.autograd.grad((ref * cot).sum(), (q, k, v))
    # the ring accumulates in float32, as the JAX ring does
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               **RING)
    for a, b in zip(g, r):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **RING)


def _example():
    spec = importlib.util.spec_from_file_location(
        "long_context_train_lm_ring",
        os.path.join(REPO, "example", "long-context", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_params(seed=40):
    rs = np.random.RandomState(seed)
    s = 1.0 / np.sqrt(D)

    def f(std, *shape):
        return (rs.randn(*shape) * std).astype(np.float32)
    params = {"embed": f(0.02, VOCAB, D), "pos": f(0.02, 1, MAX_LEN, D)}
    for i in range(LAYERS):
        params["l%d" % i] = {"qkv": f(s, D, 3 * D), "proj": f(s, D, D),
                             "ff1": f(s, D, 4 * D),
                             "ff2": f(1 / np.sqrt(4 * D), 4 * D, D)}
    return params


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_lm_dp2_sp4_matches_jax_make_step():
    ex = _example()
    params = _numpy_params()
    rs = np.random.RandomState(41)
    succ = rs.randint(1, VOCAB, size=(VOCAB, 3))
    batches = [ex.markov_batch(rs, succ, BATCH, T, VOCAB) for _ in range(3)]
    jmesh = jmx.parallel.build_mesh({"dp": 2, "sp": 4}, jax.devices()[:8])
    jstep, sharding = ex.make_step(jmesh, HEADS, LAYERS, 0.3)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    tmesh = tmx.parallel.build_mesh({"dp": 2, "sp": 4}, [tmx.cpu()] * 8)
    tparams = tlm.params_from_numpy(params, tmx.cpu())
    tstep = tlm.make_step(tmesh, HEADS, LAYERS, 0.3)
    for x, y in batches:
        jparams, jloss = jstep(jparams, jax.device_put(x, sharding),
                               jax.device_put(y, sharding))
        same, tloss = tstep(tparams, x, y)
        assert same is tparams and tloss.ndim == 0
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    got = _flat(tlm.params_to_numpy(tparams))
    ref = _flat(jax.tree_util.tree_map(np.asarray, jparams))
    start = _flat(params)
    for k, r in ref.items():
        assert not np.array_equal(got[k], start[k]), k
        np.testing.assert_allclose(got[k], r, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    # apply_model over the mesh gives the logits of the global batch
    x = batches[0][0]
    logits = tlm.apply_model(tparams, x, tmesh, HEADS, LAYERS)
    one = tlm.apply_model(tparams, torch.from_numpy(x), None, HEADS, LAYERS)
    assert logits.shape == (BATCH, T, VOCAB)
    np.testing.assert_allclose(logits.detach().numpy(),
                               one.detach().numpy(), rtol=1e-5, atol=1e-5)
