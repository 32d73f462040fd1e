"""Training through the port's Executor — ``simple_bind`` ->
``forward(is_train=True)`` -> ``backward()`` — against the JAX package's
Executor on the CPU, on a small conv -> BatchNorm -> relu -> pool -> FC
-> SoftmaxOutput graph, from the same numpy weights.

Tolerance: rtol 1e-5, atol 1e-6 on outputs, gradients and aux updates —
float32 on both sides; the convolution backward and the BatchNorm sums
are taken in other orders (XLA against oneDNN), a few ulps of O(1)
values."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6
SHAPE = (4, 3, 8, 8)


def _features(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                             name="conv0")
    net = mx.sym.BatchNorm(net, fix_gamma=False, eps=2e-5, name="bn0")
    net = mx.sym.Activation(net, act_type="relu", name="relu0")
    return mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                          name="pool0")


def _net(mx):
    net = mx.sym.FullyConnected(_features(mx), num_hidden=5, name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _weights(symbol, seed=40):
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = symbol.infer_shape(data=SHAPE)
    args = {}
    for n, s in zip(symbol.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        args[n] = (0.5 * rs.standard_normal(s)).astype(np.float32)
    aux = {n: (rs.uniform(0.5, 1.5, s) if n.endswith("var")
               else 0.2 * rs.standard_normal(s)).astype(np.float32)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _bind(mx, symbol, weights, grad_req="write"):
    ctx = mx.cpu()
    ex = symbol.simple_bind(ctx, grad_req=grad_req, data=SHAPE)
    args, aux = weights
    for n, v in args.items():
        ex.arg_dict[n][:] = v
    for n, v in aux.items():
        ex.aux_dict[n][:] = v
    return ex


def _batch(seed=41):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal(SHAPE).astype(np.float32),
            rs.randint(0, 5, SHAPE[0]).astype(np.float32))


def _assert_close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg="%s %s" % (what, k))


def _numpy(d):
    return {k: v.asnumpy() for k, v in d.items()}


def test_forward_backward_matches_jax():
    x, y = _batch()
    exes = []
    for mx in (jmx, tmx):
        sym = _net(mx)
        ex = _bind(mx, sym, _weights(_net(jmx)))
        ex.forward(is_train=True, data=x, softmax_label=y)
        ex.backward()
        exes.append(ex)
    j, t = exes
    np.testing.assert_allclose(t.outputs[0].asnumpy(),
                               j.outputs[0].asnumpy(), rtol=RTOL, atol=ATOL)
    # every gradient, the data's too; the label's is zeros
    assert set(t.grad_dict) == set(t.arg_dict)
    _assert_close(_numpy(t.grad_dict), _numpy(j.grad_dict), "grad")
    assert not t.grad_dict["softmax_label"].asnumpy().any()
    # the aux (moving stats) took the batch statistics, detached
    _assert_close(_numpy(t.aux_dict), _numpy(j.aux_dict), "aux")
    assert not any(v._data.requires_grad for v in t.aux_dict.values())
    assert [g is not None for g in t.grad_arrays] == \
        [g is not None for g in j.grad_arrays]


def test_grad_req_add_and_null():
    """'add' accumulates across backward calls (twice gives 2x); 'null'
    allocates no gradient and leaves the argument out of the graph."""
    x, y = _batch(42)
    req = {"conv0_weight": "add", "fc_weight": "write", "bn0_gamma": "add"}
    grads = []
    for mx in (jmx, tmx):
        ex = _bind(mx, _net(mx), _weights(_net(jmx)), grad_req=req)
        assert sorted(ex.grad_dict) == sorted(req)
        ex.forward(is_train=True, data=x, softmax_label=y)
        ex.backward()
        once = _numpy(ex.grad_dict)
        ex.backward()
        grads.append(_numpy(ex.grad_dict))
        for k in req:
            factor = 2.0 if req[k] == "add" else 1.0
            np.testing.assert_allclose(grads[-1][k], factor * once[k],
                                       rtol=1e-6, atol=1e-7)
    _assert_close(grads[1], grads[0], "grad")


def _two_heads(mx, first_is_loss):
    feats = _features(mx)
    fc = mx.sym.FullyConnected(feats, num_hidden=5, name="fc")
    first = mx.sym.SoftmaxOutput(fc, name="softmax") if first_is_loss else fc
    fc2 = mx.sym.FullyConnected(feats, num_hidden=2, name="fc2")
    return mx.sym.Group([first, fc2])


@pytest.mark.parametrize("first_is_loss", [True, False],
                         ids=["loss_head_skipped", "zero_filled"])
def test_backward_out_grads_pads_like_jax(first_is_loss):
    """backward(out_grads) on a two-output group.  With a loss output
    first, the one given head goes to the second output (the loss makes
    its own).  With two plain outputs and one head, the second output's
    head is silently ZERO-FILLED — the JAX package's _pad_out_grads
    (executor.py:578-579), kept for parity."""
    x, y = _batch(43)
    head = np.random.RandomState(44).standard_normal(
        (SHAPE[0], 2 if first_is_loss else 5)).astype(np.float32)
    grads = []
    for mx in (jmx, tmx):
        sym = _two_heads(mx, first_is_loss)
        ex = _bind(mx, sym, _weights(_two_heads(jmx, first_is_loss)))
        kw = dict(softmax_label=y) if first_is_loss else {}
        ex.forward(is_train=True, data=x, **kw)
        ex.backward(out_grads=[mx.nd.array(head, ctx=mx.cpu())])
        grads.append(_numpy(ex.grad_dict))
    _assert_close(grads[1], grads[0], "grad")
    if not first_is_loss:
        # the zero-filled head: fc2 gets no gradient at all
        assert not grads[1]["fc2_weight"].any()
        assert grads[1]["fc_weight"].any()


def test_fused_matches_unfused(monkeypatch):
    """The port's fused plan (BatchNorm+relu through NormAct) against the
    plain BatchNorm and Activation ops (MXTPU_FUSED_KERNELS=0)."""
    x, y = _batch(45)
    weights = _weights(_net(jmx))
    results = []
    for setting in ("1", "0"):
        monkeypatch.setenv("MXTPU_FUSED_KERNELS", setting)
        ex = _bind(tmx, _net(tmx), weights)
        # one fused site (a bn_fold site at inference: its producer is a
        # conv; training runs fused_bn_act there too)
        sites = tmx.mxfuse.bn_sites(ex._eval.plan)
        assert len(sites["bn_act"] + sites["bn_fold"]) == int(setting)
        ex.forward(is_train=True, data=x, softmax_label=y)
        ex.backward()
        results.append((_numpy(ex.grad_dict), _numpy(ex.aux_dict),
                        ex.outputs[0].asnumpy()))
    _assert_close(results[0][0], results[1][0], "grad")
    _assert_close(results[0][1], results[1][1], "aux")
    np.testing.assert_allclose(results[0][2], results[1][2], rtol=RTOL,
                               atol=ATOL)


def test_reshape_copy_params_and_default_context(monkeypatch):
    x, y = _batch(46)
    ex = _bind(tmx, _net(tmx), _weights(_net(jmx)))
    half = ex.reshape(data=(2,) + SHAPE[1:], softmax_label=(2,))
    assert half.arg_dict["fc_weight"] is ex.arg_dict["fc_weight"]
    half.forward(is_train=True, data=x[:2], softmax_label=y[:2])
    half.backward()
    assert half.grad_dict["conv0_weight"].shape == (4, 3, 3, 3)
    other = _bind(tmx, _net(tmx), _weights(_net(jmx), seed=47))
    ex.copy_params_from(other.arg_dict, other.aux_dict)
    np.testing.assert_array_equal(ex.arg_dict["fc_weight"].asnumpy(),
                                  other.arg_dict["fc_weight"].asnumpy())
    with pytest.raises(tmx.MXNetError):
        ex.copy_params_from({"nope": other.arg_dict["fc_weight"]})
    # the default context is gpu(0): without CUDA, binding raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tmx.MXNetError, match="CUDA is not available"):
        _net(tmx).simple_bind(tmx.current_context(), data=SHAPE)
