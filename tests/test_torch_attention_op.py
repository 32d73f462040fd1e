"""The symbolic attention op ``mx.sym.contrib.Attention`` (``ops/contrib.py``
``_contrib_Attention``) in the port against the JAX package on the CPU:
``simple_bind`` -> ``forward(is_train=True)`` -> ``backward()`` with q/k/v
gradients at T 6 (the exact softmax) and at T 40 with
``MXTPU_FLASH_BLOCK=16`` (the flash route), ``mx.nd.contrib.Attention``,
the symbol JSON, both errors and a ``Predictor`` of the op.

Tolerance: rtol/atol 1e-5 on outputs, 1e-4 on gradients (float32; the
flash route reassociates the softmax sums)."""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.kernels import flash_attention as TFA

HEADS, DMODEL = 2, 16
FWD = {"rtol": 1e-5, "atol": 1e-5}
GRAD = {"rtol": 1e-4, "atol": 1e-4}


def _sym(mx, causal=True, scale=-1.0):
    q, k, v = (mx.sym.Variable(n) for n in ("query", "key", "value"))
    return mx.sym.contrib.Attention(q, k, v, num_heads=HEADS, causal=causal,
                                    scale=scale, name="att")


def _inputs(B, Tq, Tk, seed):
    rs = np.random.RandomState(seed)
    return {"query": rs.randn(B, Tq, DMODEL).astype(np.float32),
            "key": rs.randn(B, Tk, DMODEL).astype(np.float32),
            "value": rs.randn(B, Tk, DMODEL).astype(np.float32)}


def _train_pass(mx, sym, inputs, head, ctx):
    shapes = {k: v.shape for k, v in inputs.items()}
    ex = sym.simple_bind(ctx, grad_req="write", **shapes)
    ex.forward(is_train=True, **inputs)
    out = ex.outputs[0].asnumpy()
    ex.backward(out_grads=[mx.nd.array(head, ctx=ctx)])
    return out, {k: ex.grad_dict[k].asnumpy() for k in inputs}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,flash", [(6, False), (40, True)])
def test_attention_op_train_pass_matches_jax(monkeypatch, T, flash, causal):
    monkeypatch.setenv("MXTPU_FLASH_BLOCK", "16")
    inputs = _inputs(2, T, T, seed=20 + T)
    head = np.random.RandomState(21).randn(2, T, DMODEL).astype(np.float32)
    before = TFA.LAUNCHES
    calls = []
    real = TFA.flash_attention
    monkeypatch.setattr(TFA, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got, tgrads = _train_pass(tmx, _sym(tmx, causal), inputs, head,
                              tmx.cpu())
    assert bool(calls) == flash and TFA.LAUNCHES == before
    ref, jgrads = _train_pass(jmx, _sym(jmx, causal), inputs, head,
                              jmx.cpu())
    assert got.shape == (2, T, DMODEL)
    np.testing.assert_allclose(got, ref, **FWD)
    for k in inputs:
        assert np.abs(tgrads[k]).max() > 0
        np.testing.assert_allclose(tgrads[k], jgrads[k], **GRAD)


def test_attention_op_ndarray_and_scale(monkeypatch):
    """mx.nd.contrib.Attention (imperative), with an explicit scale and
    Tq < Tk, against the JAX package's."""
    monkeypatch.setenv("MXTPU_FLASH_BLOCK", "16")
    inputs = _inputs(2, 20, 33, seed=22)
    got = tmx.nd.contrib.Attention(
        *(tmx.nd.array(inputs[k], ctx=tmx.cpu())
          for k in ("query", "key", "value")),
        num_heads=HEADS, causal=True, scale=0.2)
    ref = jmx.nd.contrib.Attention(
        *(jmx.nd.array(inputs[k]) for k in ("query", "key", "value")),
        num_heads=HEADS, causal=True, scale=0.2)
    assert got.context == tmx.cpu()
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), **FWD)
    assert tmx.contrib.symbol.Attention is tmx.sym.contrib.Attention
    assert tmx.contrib.ndarray.Attention is tmx.nd.contrib.Attention


def test_attention_op_json_matches_jax():
    for causal in (True, False):
        tj = json.loads(_sym(tmx, causal, 0.5).tojson())
        jj = json.loads(_sym(jmx, causal, 0.5).tojson())
        assert tj == jj
        back = tmx.sym.load_json(_sym(jmx, causal, 0.5).tojson())
        assert back.list_arguments() == ["query", "key", "value"]
        _, outs, _ = back.infer_shape(query=(2, 5, 16), key=(2, 7, 16),
                                      value=(2, 7, 16))
        assert outs == [(2, 5, 16)]


@pytest.mark.parametrize("kw,shapes,match", [
    ({"num_heads": 3}, (5, 5), "not divisible"),
    ({"num_heads": 2, "causal": True}, (7, 5), "seq_q"),
])
def test_attention_op_errors_match_jax(kw, shapes, match):
    inputs = _inputs(1, shapes[0], shapes[1], seed=23)
    names = ("query", "key", "value")
    with pytest.raises(tmx.MXNetError, match=match):
        tmx.nd.contrib.Attention(
            *(tmx.nd.array(inputs[k], ctx=tmx.cpu()) for k in names), **kw)
    with pytest.raises(jmx.MXNetError, match=match):
        jmx.nd.contrib.Attention(*(jmx.nd.array(inputs[k]) for k in names),
                                 **kw)


def test_attention_op_predictor_matches_jax(monkeypatch):
    """A Predictor of the op (no parameters) answers like the JAX
    package's, on both routes, and after a reshape."""
    monkeypatch.setenv("MXTPU_FLASH_BLOCK", "16")
    for T in (40, 6):
        inputs = _inputs(2, T, T, seed=24 + T)
        shapes = {k: v.shape for k, v in inputs.items()}
        tpred = tmx.predict.Predictor(_sym(tmx).tojson(), {}, shapes,
                                      ctx=tmx.cpu())
        jpred = jmx.predict.Predictor(_sym(jmx).tojson(), {}, shapes)
        got = tpred.forward(**inputs).get_output(0)
        ref = np.asarray(jpred.forward(**inputs).get_output(0))
        np.testing.assert_allclose(got, ref, **FWD)
    small = _inputs(1, 20, 20, seed=25)
    tpred.reshape({k: v.shape for k, v in small.items()})
    jpred.reshape({k: v.shape for k, v in small.items()})
    np.testing.assert_allclose(tpred.forward(**small).get_output(0),
                               np.asarray(jpred.forward(**small)
                                          .get_output(0)), **FWD)
