"""CTC (``mxnet_tpu_torch/ops/ctc.py``: ``ctc_loss`` with its aliases and
``WarpCTC``) against the JAX package's on the CPU, on the same numpy
inputs from a seed, float32; the JAX ops run under ``jax.jit`` as its
executor and imperative calls run them.

Labels hold repeats (a path must pass a blank between them), zero
padding inside and at the end of a row, and a row with no label at all.
Tolerances: losses rtol 1e-5 (log-sum-exp over up to 13 steps, each
side's ``exp``/``log``); gradients rtol 1e-5 / atol 1e-6.  WarpCTC's
forward is a softmax (rtol 1e-6); its backward ignores the head gradient
and gives the label none, whether the label is integer or float."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import ctc as jctc
from mxnet_tpu_torch.ops import ctc as tctc

RTOL, ATOL = 1e-5, 1e-6
T, N, A = 13, 4, 6
LABELS = np.array([[1, 2, 2, 0, 0],       # a repeat: needs a blank between
                   [3, 0, 3, 3, 5],       # padding inside, then repeats
                   [0, 0, 0, 0, 0],       # no label at all
                   [5, 4, 3, 2, 1]], np.float32)


def _logits(seed=0):
    return np.random.RandomState(seed).standard_normal((T, N, A)) \
        .astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.int32],
                         ids=["float_label", "int_label"])
def test_ctc_loss_values_and_gradient(dtype):
    x = _logits()
    lab = LABELS.astype(dtype)
    jloss, vjp = jax.vjp(jax.jit(lambda d: jctc.ctc_loss_op(d, lab)),
                         jnp.asarray(x))
    cot = np.random.RandomState(1).standard_normal(N).astype(np.float32)
    (jg,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    loss = tctc.ctc_loss_op(xt, torch.from_numpy(lab))
    (tg,) = torch.autograd.grad(loss, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=ATOL)
    # the empty row's loss is -log P(all blanks)
    logp = torch.log_softmax(torch.from_numpy(x), -1)
    assert abs(float(loss[2].detach()) + float(logp[:, 2, 0].sum())) < 1e-4


def test_ctc_loss_aliases_through_symbol():
    x = _logits(2)
    want = np.asarray(jctc.ctc_loss_op(jnp.asarray(x), LABELS))
    for name in ("ctc_loss", "_contrib_ctc_loss", "CTCLoss"):
        sym = getattr(tmx.sym, name)(tmx.sym.Variable("data"),
                                     tmx.sym.Variable("label"))
        assert sym.list_arguments() == ["data", "label"]
        ex = sym.simple_bind(tmx.cpu(), data=x.shape, label=LABELS.shape,
                             grad_req={"data": "write", "label": "null"})
        ex.arg_dict["data"][:] = x
        ex.arg_dict["label"][:] = LABELS
        out = ex.forward(is_train=True)[0].asnumpy()
        np.testing.assert_allclose(out, want, rtol=RTOL)
    got = tmx.nd.contrib.ctc_loss(tmx.nd.array(x, ctx=tmx.cpu()),
                                  tmx.nd.array(LABELS, ctx=tmx.cpu()))
    np.testing.assert_allclose(got.asnumpy(), want, rtol=RTOL)


def _warpctc(mx, x, lab, label_dtype, head, label_grad=True):
    """WarpCTC through each package's executor: output, data gradient and
    label gradient (None unless ``label_grad``) for a head gradient."""
    sym = mx.sym.WarpCTC(data=mx.sym.Variable("data"),
                         label=mx.sym.Variable("label"),
                         label_length=lab.shape[1], input_length=T)
    ex = sym.simple_bind(mx.cpu(), data=x.shape, label=lab.shape,
                         type_dict={"label": label_dtype},
                         grad_req={"data": "write",
                                   "label": "write" if label_grad
                                   else "null"})
    ex.arg_dict["data"][:] = x
    ex.arg_dict["label"][:] = lab
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward([mx.nd.array(head, ctx=mx.cpu())])
    return out, ex.grad_dict["data"].asnumpy(), \
        ex.grad_dict["label"].asnumpy() if label_grad else None


@pytest.mark.parametrize("label_dtype", ["float32", "int32"])
def test_warpctc_matches_jax_and_ignores_head(label_dtype):
    x = _logits(3).reshape(T * N, A)
    lab = LABELS.astype(label_dtype)
    rs = np.random.RandomState(4)
    head = rs.standard_normal(x.shape).astype(np.float32)
    # neither executor keeps a gradient array for an integer argument (the
    # JAX package's cotangent is float0, a torch integer tensor cannot
    # require grad), so an integer label binds with grad_req null
    grad = label_dtype == "float32"
    j_out, j_g, j_lg = _warpctc(jmx, x, lab, label_dtype, head, grad)
    t_out, t_g, t_lg = _warpctc(tmx, x, lab, label_dtype, head, grad)
    np.testing.assert_allclose(t_out, j_out, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t_g, j_g, rtol=RTOL, atol=ATOL)
    if grad:
        assert not t_lg.any() and not j_lg.any()
    # another head gradient: the same data gradient
    _, t_g2, _ = _warpctc(tmx, x, lab, label_dtype, 5 * head + 1, grad)
    np.testing.assert_array_equal(t_g2, t_g)
    # softmax minus posteriors: each row's gradient sums to 0
    np.testing.assert_allclose(t_g.sum(1), 0, atol=1e-5)


def test_warpctc_rejects_bad_attrs():
    x = torch.zeros(T * N, A)
    lab = torch.zeros(N, 5)
    with pytest.raises(tmx.MXNetError):
        tctc.warpctc(x, lab, label_length=5, input_length=0)
    with pytest.raises(tmx.MXNetError):
        tctc.warpctc(x.reshape(T, N, A), lab, label_length=5,
                     input_length=T)
    with pytest.raises(tmx.MXNetError):
        tctc.ctc_loss_op(x, lab)
