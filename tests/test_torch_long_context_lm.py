"""The long-context causal LM (``models/long_context_lm.py``) in the port
against its counterpart, ``example/long-context/train_lm.py`` (loaded by
path), on the CPU from the same numpy parameters: ``markov_batch`` byte
for byte, ``apply_model`` at vocab 32, d_model 32, 4 heads, 2 layers,
T 40, batch 2 with ``MXTPU_FLASH_BLOCK=16`` (so attention takes the flash
route), and three ``make_step`` steps against the example's jitted step
on a 1 x 1 mesh.

Tolerance: logits rtol/atol 1e-5; after three SGD steps at lr 0.3 the
losses at rtol 1e-5 and every parameter at rtol/atol 1e-4 (float32 matmuls
and the streaming softmax summed in other orders, carried through the
updates)."""
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as TFA
from mxnet_tpu_torch.models import long_context_lm as tlm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, D, HEADS, LAYERS, T, BATCH, MAX_LEN = 32, 32, 4, 2, 40, 2, 64


def _example():
    spec = importlib.util.spec_from_file_location(
        "long_context_train_lm",
        os.path.join(REPO, "example", "long-context", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_params(seed=30):
    """The example's structure and scales, drawn with numpy."""
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


def _batches(n, seed=31):
    ex = _example()
    rs = np.random.RandomState(seed)
    succ = rs.randint(1, VOCAB, size=(VOCAB, 3))
    return [ex.markov_batch(rs, succ, BATCH, T, VOCAB) for _ in range(n)]


def test_markov_batch_matches_example():
    ex = _example()
    for seed in (0, 5):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        succ_a = a.randint(1, 128, size=(128, 3))
        succ_b = b.randint(1, 128, size=(128, 3))
        for _ in range(2):
            got = tlm.markov_batch(a, succ_a, 4, 512, 128)
            ref = ex.markov_batch(b, succ_b, 4, 512, 128)
            for g, r in zip(got, ref):
                assert g.dtype == r.dtype and g.tobytes() == r.tobytes()


def _flat(tree, prefix=""):
    """``{"l0/qkv": leaf, ...}`` of a nested params dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def test_build_params_structure_and_scales():
    """The example's tree, shapes and standard deviations, from a
    torch.Generator, on the given context; the same seed, the same
    draw."""
    import jax
    ref = _flat(_example().build_params(jax.random.PRNGKey(0), 128, 64, 4,
                                        2, 256))
    got = _flat(tlm.build_params(torch.Generator().manual_seed(0), 128, 64,
                                 4, 2, 256, ctx=tmx.cpu()))
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        assert tuple(got[k].shape) == tuple(r.shape)
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(float(got[k].std()),
                                   float(np.asarray(r).std()), rtol=0.1)
    again = _flat(tlm.build_params(torch.Generator().manual_seed(0), 128,
                                   64, 4, 2, 256, ctx=tmx.cpu()))
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_apply_model_matches_example(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_BLOCK", "16")
    import jax.numpy as jnp
    params = _numpy_params()
    x, _ = _batches(1)[0]
    calls = []
    real = TFA.flash_attention
    monkeypatch.setattr(TFA, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = tlm.apply_model(tlm.params_from_numpy(params, tmx.cpu()),
                          torch.from_numpy(x), None, HEADS, LAYERS)
    assert len(calls) == LAYERS
    ref = _example().apply_model(
        {k: (jnp.asarray(v) if not isinstance(v, dict) else
             {n: jnp.asarray(a) for n, a in v.items()})
         for k, v in params.items()}, jnp.asarray(x), None, HEADS, LAYERS)
    assert got.shape == (BATCH, T, VOCAB)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_three_steps_match_example(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_BLOCK", "16")
    import jax
    from mxnet_tpu.parallel import build_mesh
    ex = _example()
    params = _numpy_params()
    batches = _batches(3)
    mesh = build_mesh({"dp": 1, "sp": 1}, jax.devices()[:1])
    jstep, sharding = ex.make_step(mesh, HEADS, LAYERS, 0.3)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    tparams = tlm.params_from_numpy(params, tmx.cpu())
    tstep = tlm.make_step(types.SimpleNamespace(shape={"dp": 1, "sp": 1}),
                          HEADS, LAYERS, 0.3)
    for x, y in batches:
        jparams, jloss = jstep(jparams, jax.device_put(x, sharding),
                               jax.device_put(y, sharding))
        same, tloss = tstep(tparams, torch.from_numpy(x), torch.from_numpy(y))
        assert same is tparams and tloss.ndim == 0
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    got = _flat(tlm.params_to_numpy(tparams))
    ref = _flat(jax.tree_util.tree_map(np.asarray, jparams))
    start = _flat(params)
    for k, r in ref.items():
        assert not np.array_equal(got[k], start[k]), k
        np.testing.assert_allclose(got[k], r, rtol=1e-4, atol=1e-4)


def test_mesh_with_sp_raises():
    params = tlm.params_from_numpy(_numpy_params(), tmx.cpu())
    x, _ = _batches(1)[0]
    mesh = types.SimpleNamespace(shape={"dp": 1, "sp": 4})
    with pytest.raises(MXNetError, match="multi-GPU slice"):
        tlm.apply_model(params, torch.from_numpy(x), mesh, HEADS, LAYERS)


def test_params_carry_round_trip():
    params = _numpy_params()
    back = tlm.params_to_numpy(tlm.params_from_numpy(params, tmx.cpu()))
    ref = _flat(params)
    got = _flat(back)
    assert sorted(got) == sorted(ref)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    assert tmx.convert.tree_from_numpy is tlm.params_from_numpy
