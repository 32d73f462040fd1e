"""Per-op gradient parity of the PyTorch port against ``jax.vjp`` of the
JAX package's registered ops, on the CPU, float32, small odd shapes.

SoftmaxOutput's backward is a hand ``torch.autograd.Function`` (the JAX
package's ``custom_vjp``); the other ops differentiate through torch
autograd as they are.  Tolerance: rtol 1e-5, atol 1e-6 — both sides
compute in float32 with sums in different orders (XLA's and oneDNN's
convolution and reduction backwards) over O(1) values and at most a few
hundred terms."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch.ops import nn as tnn

RTOL, ATOL = 1e-5, 1e-6


def _vjp_both(jfn, tfn, arrays, diff, cot, **attrs):
    """Gradients of output 0 w.r.t. the inputs at positions ``diff`` for
    the cotangent ``cot``: (jax grads, port grads), as numpy."""
    jargs = [None if a is None else jnp.asarray(a) for a in arrays]

    def f(*d):
        full = list(jargs)
        for i, v in zip(diff, d):
            full[i] = v
        out = jfn(*full, **attrs)
        return out[0] if isinstance(out, tuple) else out

    jout, vjp = jax.vjp(f, *[jargs[i] for i in diff])
    jgrads = vjp(jnp.asarray(cot))
    targs = [None if a is None else torch.from_numpy(a.copy())
             for a in arrays]
    for i in diff:
        targs[i].requires_grad_(True)
    tout = tfn(*targs, **attrs)
    tout = tout[0] if isinstance(tout, tuple) else tout
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    tgrads = torch.autograd.grad(tout, [targs[i] for i in diff],
                                 torch.from_numpy(cot), allow_unused=True)
    tgrads = [torch.zeros_like(targs[i]) if g is None else g
              for g, i in zip(tgrads, diff)]
    return ([np.asarray(g) for g in jgrads],
            [g.detach().numpy() for g in tgrads])


def _assert_grads(jgrads, tgrads):
    for j, t in zip(jgrads, tgrads):
        assert j.shape == t.shape
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
@pytest.mark.parametrize("use_ignore", [False, True], ids=["all", "ignore"])
@pytest.mark.parametrize("multi_output", [False, True], ids=["flat", "multi"])
@pytest.mark.parametrize("out_grad", [False, True], ids=["loss", "outgrad"])
def test_softmax_output_grad(normalization, use_ignore, multi_output,
                             out_grad):
    """(p - onehot(label)) * grad_scale, normalized, masked where the
    label is ignored (labels equal to ignore_label occur in every case:
    without use_ignore their one-hot row is zeros, as jax.nn.one_hot
    gives); the head gradient counts only with out_grad; the label's
    gradient is zeros."""
    rs = np.random.RandomState(20)
    shape = (3, 5, 2, 4) if multi_output else (6, 7)
    classes = shape[1] if multi_output else shape[-1]
    label_shape = (shape[0],) + shape[2:] if multi_output else shape[:-1]
    x = (2 * rs.standard_normal(shape)).astype(np.float32)
    label = rs.randint(0, classes, label_shape).astype(np.float32)
    label.reshape(-1)[::3] = 2.0       # the ignore_label below
    cot = rs.standard_normal(shape).astype(np.float32)
    jg, tg = _vjp_both(jnn.softmax_output, tnn.softmax_output, [x, label],
                       (0, 1), cot, grad_scale=1.5, ignore_label=2.0,
                       use_ignore=use_ignore, multi_output=multi_output,
                       normalization=normalization, out_grad=out_grad)
    _assert_grads(jg, tg)
    assert not tg[1].any()


def test_softmax_output_dense_label_grad():
    """A label of the output's shape gives p - label."""
    rs = np.random.RandomState(21)
    x = rs.standard_normal((4, 6)).astype(np.float32)
    label = rs.dirichlet(np.ones(6), 4).astype(np.float32)
    cot = np.ones((4, 6), np.float32)
    for normalization in ("null", "batch", "valid"):
        jg, tg = _vjp_both(jnn.softmax_output, tnn.softmax_output,
                           [x, label], (0,), cot,
                           normalization=normalization)
        _assert_grads(jg, tg)


@pytest.mark.parametrize("fix_gamma", [False, True], ids=["gamma", "fixed"])
@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_batch_norm_grad(fix_gamma, is_train):
    rs = np.random.RandomState(22)
    x = (rs.standard_normal((3, 4, 5, 3)) * 2 + 0.5).astype(np.float32)
    gamma = rs.uniform(0.5, 1.5, 4).astype(np.float32)
    beta = rs.standard_normal(4).astype(np.float32)
    mm = (0.3 * rs.standard_normal(4)).astype(np.float32)
    mv = rs.uniform(0.5, 2.0, 4).astype(np.float32)
    cot = rs.standard_normal(x.shape).astype(np.float32)
    jg, tg = _vjp_both(jnn.batch_norm, tnn.batch_norm,
                       [x, gamma, beta, mm, mv], (0, 1, 2), cot, eps=2e-5,
                       momentum=0.9, fix_gamma=fix_gamma, is_train=is_train)
    _assert_grads(jg, tg)
    if is_train:
        # the new moving statistics are state, not differentiable outputs
        out = tnn.batch_norm(*(torch.from_numpy(a).requires_grad_(True)
                               for a in (x, gamma, beta, mm, mv)),
                             is_train=True, fix_gamma=fix_gamma)
        assert not out[1].requires_grad and not out[2].requires_grad


@pytest.mark.parametrize("case", [
    dict(data=(2, 3, 7, 9), kernel=(3, 3), num_filter=4, stride=(2, 1),
         pad=(1, 2), no_bias=False),
    dict(data=(2, 4, 9, 7), kernel=(3, 2), num_filter=6, stride=(1, 2),
         pad=(2, 1), no_bias=True, num_group=2, dilate=(2, 1)),
], ids=["stride_pad_bias", "group_dilate"])
def test_convolution_grad(case):
    case = dict(case)
    data = case.pop("data")
    k, nf, g = case["kernel"], case["num_filter"], case.get("num_group", 1)
    rs = np.random.RandomState(23)
    x = rs.standard_normal(data).astype(np.float32)
    w = rs.standard_normal((nf, data[1] // g) + tuple(k)).astype(np.float32)
    b = None if case["no_bias"] else rs.standard_normal(nf).astype(np.float32)
    out_shape = tuple(jnn.convolution(jnp.asarray(x), jnp.asarray(w), None,
                                      **case).shape)
    cot = rs.standard_normal(out_shape).astype(np.float32)
    diff = (0, 1) if b is None else (0, 1, 2)
    jg, tg = _vjp_both(jnn.convolution, tnn.convolution, [x, w, b], diff,
                       cot, **case)
    _assert_grads(jg, tg)


@pytest.mark.parametrize("case", [
    dict(kernel=(3, 3), pool_type="max", stride=(2, 2), pad=(1, 1)),
    dict(kernel=(3, 2), pool_type="avg", stride=(2, 1), pad=(1, 0)),
    dict(kernel=(2, 2), pool_type="max", stride=(2, 2),
         pooling_convention="full"),
    dict(kernel=(1, 1), pool_type="avg", global_pool=True),
], ids=["max_pad", "avg", "max_full", "global_avg"])
def test_pooling_grad(case):
    rs = np.random.RandomState(24)
    x = rs.standard_normal((2, 3, 7, 6)).astype(np.float32)
    out_shape = tuple(jnn.pooling(jnp.asarray(x), **case).shape)
    cot = rs.standard_normal(out_shape).astype(np.float32)
    jg, tg = _vjp_both(jnn.pooling, tnn.pooling, [x], (0,), cot, **case)
    _assert_grads(jg, tg)


@pytest.mark.parametrize("no_bias", [False, True])
def test_fully_connected_grad(no_bias):
    rs = np.random.RandomState(25)
    x = rs.standard_normal((3, 2, 3, 2)).astype(np.float32)
    w = rs.standard_normal((5, 12)).astype(np.float32)
    b = None if no_bias else rs.standard_normal(5).astype(np.float32)
    cot = rs.standard_normal((3, 5)).astype(np.float32)
    diff = (0, 1) if no_bias else (0, 1, 2)
    jg, tg = _vjp_both(jnn.fully_connected, tnn.fully_connected, [x, w, b],
                       diff, cot, num_hidden=5, no_bias=no_bias)
    _assert_grads(jg, tg)
