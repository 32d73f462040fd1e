"""The ops of ``mxnet_tpu/ops/nn.py`` that the PyTorch port added last
(Deconvolution, LeakyReLU, InstanceNorm, L2Normalization, LRN, Pad, Crop,
UpSampling, SoftmaxActivation, SVMOutput, MakeLoss,
IdentityAttachKLSparseReg and the three regression outputs) against the
JAX package's on the CPU, float32: forward values and the gradient for a
random head gradient (``jax.vjp`` against torch autograd), plus their
registration, shape inference and graph JSON through ``mx.sym``.

Tolerance: rtol 1e-5, atol 1e-6 — both sides compute in float32 and sum
in different orders (XLA's and oneDNN's transposed convolutions,
reductions) over O(1) values and at most a few hundred terms.  The loss
layers ignore the head gradient, as the reference's do: their gradient is
compared for a random cotangent, which neither side may read."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6


def _both(jfn, tfn, arrays, diff, attrs, seed=0, kw=None):
    """Forward of both on ``arrays`` and gradients of output 0 w.r.t. the
    inputs at ``diff`` for one random cotangent; asserts agreement."""
    kw = kw or {}
    jargs = [jnp.asarray(a) for a in arrays]

    def f(*d):
        full = list(jargs)
        for i, v in zip(diff, d):
            full[i] = v
        out = jfn(*full, **attrs, **kw)
        return out[0] if isinstance(out, tuple) else out

    jout, vjp = jax.vjp(f, *[jargs[i] for i in diff])
    cot = np.random.RandomState(seed + 1).standard_normal(
        jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    targs = [torch.from_numpy(np.array(a, copy=True)) for a in arrays]
    for i in diff:
        targs[i].requires_grad_(True)
    tout = tfn(*targs, **attrs, **kw)
    tout = tout[0] if isinstance(tout, tuple) else tout
    assert tuple(tout.shape) == tuple(jout.shape)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    if not diff:
        return
    tgrads = torch.autograd.grad(tout, [targs[i] for i in diff],
                                 torch.from_numpy(cot), allow_unused=True)
    for i, g, j in zip(diff, tgrads, jgrads):
        g = torch.zeros_like(targs[i]) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL, err_msg="input %d" % i)


def _rand(rs, *shape, scale=1.0):
    return (scale * rs.standard_normal(shape)).astype(np.float32)


DECONV_CASES = {
    "stride2_pad1": ((2, 4, 5, 6), dict(kernel=(3, 3), stride=(2, 2),
                                        pad=(1, 1), num_filter=3)),
    "adj1": ((2, 4, 5, 5), dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1),
                                adj=(1, 1), num_filter=3)),
    # adj at or above the stride: torch's output_padding refuses it, the
    # port takes the unpadded transposed conv's window
    "adj_ge_stride": ((2, 3, 4, 5), dict(kernel=(3, 3), stride=(1, 1),
                                         pad=(1, 0), adj=(2, 1),
                                         num_filter=2)),
    "group2_bias": ((2, 4, 5, 5), dict(kernel=(3, 3), stride=(2, 2),
                                       num_filter=6, num_group=2,
                                       no_bias=False)),
    "dilate2": ((1, 3, 6, 6), dict(kernel=(3, 3), dilate=(2, 2),
                                   pad=(2, 2), num_filter=4)),
    "target_shape": ((2, 3, 4, 4), dict(kernel=(4, 4), stride=(2, 2),
                                        pad=(1, 1), num_filter=2,
                                        target_shape=(8, 8))),
    "1d": ((2, 3, 7), dict(kernel=(3,), stride=(2,), pad=(1,),
                           num_filter=4)),
}


@pytest.mark.parametrize("case", sorted(DECONV_CASES))
def test_deconvolution(case):
    shape, attrs = DECONV_CASES[case]
    rs = np.random.RandomState(1)
    nd = len(attrs["kernel"])
    w_shape = (shape[1], attrs["num_filter"] // attrs.get("num_group", 1)) \
        + attrs["kernel"]
    arrays = [_rand(rs, *shape), _rand(rs, *w_shape, scale=0.5)]
    diff = (0, 1)
    if not attrs.get("no_bias", True):
        arrays.append(_rand(rs, attrs["num_filter"]))
        diff = (0, 1, 2)
    _both(jnn.deconvolution, tnn.deconvolution, arrays, diff, attrs)
    assert nd == len(shape) - 2


@pytest.mark.parametrize("act_type", ["leaky", "elu", "prelu", "rrelu"])
def test_leaky_relu(act_type):
    rs = np.random.RandomState(2)
    x = _rand(rs, 3, 4, 5)
    arrays, diff = [x], (0,)
    if act_type == "prelu":
        arrays.append(rs.uniform(0.1, 0.5, 4).astype(np.float32))
        diff = (0, 1)
    # rrelu outside training takes the mean slope on both sides
    _both(jnn.leaky_relu, tnn.leaky_relu, arrays, diff,
          dict(act_type=act_type, slope=0.3), kw=dict(is_train=False))


def test_leaky_relu_rrelu_training_draws_from_the_generator():
    """In training rrelu scales each negative entry by a slope drawn
    uniform in [lower_bound, upper_bound) from the node's generator (the
    streams are not the JAX package's): positives pass, the same seed
    draws the same slopes, and the gradient is that slope."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(_rand(rs, 64, 50)).requires_grad_(True)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        outs.append(tnn.leaky_relu(x, act_type="rrelu", lower_bound=0.1,
                                   upper_bound=0.3, is_train=True, rng=gen))
    assert torch.equal(outs[0], outs[1])
    neg = x < 0
    assert torch.equal(outs[0][~neg], x[~neg])
    slope = (outs[0][neg] / x[neg]).detach()
    assert slope.min() >= 0.1 - 1e-6 and slope.max() < 0.3 + 1e-6
    assert slope.std() > 0.04    # drawn, not one constant
    g, = torch.autograd.grad(outs[0].sum(), x)
    np.testing.assert_allclose(g[neg].numpy(), slope.numpy(), rtol=1e-6)


def test_instance_norm():
    rs = np.random.RandomState(4)
    arrays = [_rand(rs, 2, 3, 4, 5, scale=2.0), _rand(rs, 3), _rand(rs, 3)]
    _both(jnn.instance_norm, tnn.instance_norm, arrays, (0, 1, 2),
          dict(eps=1e-3))


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization(mode):
    rs = np.random.RandomState(5)
    _both(jnn.l2_normalization, tnn.l2_normalization,
          [_rand(rs, 2, 3, 4, 5)], (0,), dict(mode=mode))


@pytest.mark.parametrize("nsize", [3, 5])
def test_lrn_window(nsize):
    """MXNet's form: knorm + alpha / nsize * (sum of squares over the
    nsize channels around c, zero-padded at both channel ends)."""
    rs = np.random.RandomState(6)
    _both(jnn.lrn, tnn.lrn, [_rand(rs, 2, 7, 4, 3, scale=3.0)], (0,),
          dict(nsize=nsize, alpha=0.3, beta=0.75, knorm=2.0))


PAD_CASES = {
    "constant": ("constant", (0, 0, 0, 0, 1, 2, 3, 0)),
    "constant_nc": ("constant", (1, 0, 0, 2, 1, 1, 0, 1)),
    "edge": ("edge", (0, 0, 0, 0, 2, 1, 1, 3)),
    "reflect": ("reflect", (0, 0, 0, 0, 1, 2, 2, 1)),
    "reflect_wide": ("reflect", (0, 0, 0, 0, 4, 5, 0, 6)),
}


@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_pad(case):
    mode, width = PAD_CASES[case]
    rs = np.random.RandomState(7)
    _both(jnn.pad_op, tnn.pad_op, [_rand(rs, 2, 3, 3, 4)], (0,),
          dict(pad_width=width, mode=mode, constant_value=0.5))


@pytest.mark.parametrize("attrs", [
    dict(h_w=(3, 4), offset=(1, 2)),
    dict(h_w=(3, 4), center_crop=True),
    dict(h_w=(4, 5), offset=(5, 9)),           # clamped back inside
], ids=["offset", "center", "clamped"])
def test_crop(attrs):
    rs = np.random.RandomState(8)
    _both(jnn.crop, tnn.crop, [_rand(rs, 2, 3, 7, 8)], (0,), attrs)


@pytest.mark.parametrize("center", [False, True])
def test_crop_like(center):
    rs = np.random.RandomState(9)
    x, like = _rand(rs, 2, 3, 7, 8), _rand(rs, 2, 1, 4, 5)
    attrs = dict(num_args=2, offset=(2, 1), center_crop=center)
    _both(lambda d, c, **a: jnn.crop(d, c, **a),
          lambda d, c, **a: tnn.crop(d, c, **a), [x, like], (0,), attrs)


@pytest.mark.parametrize("mode", ["concat", "sum"])
def test_upsampling_nearest(mode):
    rs = np.random.RandomState(10)
    a, b = _rand(rs, 2, 3, 3, 4), _rand(rs, 2, 3, 3, 4)
    attrs = dict(scale=2, sample_type="nearest", num_args=2,
                 multi_input_mode=mode)
    _both(jnn.upsampling, tnn.upsampling, [a, b], (0, 1), attrs)
    _both(jnn.upsampling, tnn.upsampling, [a], (0,),
          dict(scale=3, sample_type="nearest"))


@pytest.mark.parametrize("scale", [2, 3])
def test_upsampling_bilinear(scale):
    rs = np.random.RandomState(11)
    k = 2 * scale - scale % 2
    x, w = _rand(rs, 2, 3, 4, 5), _rand(rs, 3, 1, k, k, scale=0.5)
    _both(jnn.upsampling, tnn.upsampling, [x, w], (0, 1),
          dict(scale=scale, sample_type="bilinear", num_filter=3))


@pytest.mark.parametrize("mode", ["instance", "channel"])
def test_softmax_activation(mode):
    rs = np.random.RandomState(12)
    _both(jnn.softmax_activation, tnn.softmax_activation,
          [_rand(rs, 2, 4, 3, 2)], (0,), dict(mode=mode))


@pytest.mark.parametrize("name,label_shape", [
    ("LinearRegressionOutput", (4,)), ("LinearRegressionOutput", (4, 3)),
    ("LogisticRegressionOutput", (4, 3)), ("MAERegressionOutput", (4, 3)),
])
def test_regression_outputs_ignore_the_head_gradient(name, label_shape):
    """``grad_scale / num_output * d(out, label)``; the random head
    gradient must not count."""
    rs = np.random.RandomState(13)
    data = _rand(rs, 4, 3) if len(label_shape) > 1 else _rand(rs, 4, 1)
    label = _rand(rs, *label_shape)
    if len(label_shape) == 1:
        data = data[:, 0]
    _both(jreg.get_op(name).fn, treg.get_op(name).fn, [data, label], (0, 1),
          dict(grad_scale=1.7))


@pytest.mark.parametrize("use_linear", [False, True],
                         ids=["squared", "linear"])
def test_svm_output(use_linear):
    rs = np.random.RandomState(14)
    data = _rand(rs, 6, 5, scale=1.5)
    label = rs.randint(0, 5, 6).astype(np.float32)
    _both(jnn.svm_output, tnn.svm_output, [data, label], (0, 1),
          dict(margin=0.8, regularization_coefficient=0.6,
               use_linear=use_linear))


@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
def test_make_loss(normalization):
    rs = np.random.RandomState(15)
    _both(jnn.make_loss, tnn.make_loss, [_rand(rs, 3, 4, 2)], (0,),
          dict(grad_scale=2.5, normalization=normalization))


def test_identity_attach_kl_sparse_reg():
    rs = np.random.RandomState(16)
    _both(jnn.identity_attach_kl_sparse_reg,
          tnn.identity_attach_kl_sparse_reg, [_rand(rs, 3, 5)], (0,),
          dict(sparseness_target=0.2, penalty=0.01))


# ---------------------------------------------------------------------------
# registration, shape inference, JSON
# ---------------------------------------------------------------------------

def test_every_nn_op_is_registered_with_the_reference_names():
    """Every name (aliases included) the JAX package registers from
    ops/nn.py is in the port's registry, on an op of the same canonical
    name, aliases, flags, inputs and aux states for default attributes."""
    names = [k for k, v in jreg.OP_REGISTRY.items()
             if v.fn.__module__ == "mxnet_tpu.ops.nn"]
    assert len(names) == 36
    for name in names:
        j, t = jreg.OP_REGISTRY[name], treg.OP_REGISTRY.get(name)
        assert t is not None, name
        assert t.name == j.name, name
        assert t.aliases == j.aliases, name
        assert t.needs_rng == j.needs_rng, name
        assert t.needs_is_train == j.needs_is_train, name
        assert t.get_input_names({}) == j.get_input_names({}), name
        assert t.get_aux_names({}) == j.get_aux_names({}), name


SYMBOL_CASES = {
    "Deconvolution": (("data",), dict(kernel=(4, 4), stride=(2, 2),
                                      pad=(1, 1), adj=(1, 1), num_filter=5,
                                      target_shape=(12, 12)),
                      dict(data=(2, 3, 6, 6))),
    "LeakyReLU": (("data",), dict(act_type="prelu"),
                  dict(data=(2, 3, 6, 6))),
    "InstanceNorm": (("data",), dict(eps=1e-4), dict(data=(2, 3, 6, 6))),
    "L2Normalization": (("data",), dict(mode="channel"),
                        dict(data=(2, 3, 6, 6))),
    "LRN": (("data",), dict(nsize=3), dict(data=(2, 3, 6, 6))),
    "Pad": (("data",), dict(mode="edge", pad_width=(0, 0, 0, 0, 1, 1, 2, 2)),
            dict(data=(2, 3, 6, 6))),
    "Crop": (("data", "like"), dict(num_args=2, center_crop=True),
             dict(data=(2, 3, 6, 6), like=(2, 3, 4, 4))),
    "UpSampling": (("data",), dict(scale=2, sample_type="bilinear",
                                   num_filter=3),
                   dict(data=(2, 3, 6, 6))),
    "SoftmaxActivation": (("data",), dict(mode="channel"),
                          dict(data=(2, 3, 6, 6))),
    "SVMOutput": (("data",), dict(margin=2.0), dict(data=(4, 10))),
    "MakeLoss": (("data",), dict(normalization="batch"),
                 dict(data=(4, 10))),
    "IdentityAttachKLSparseReg": (("data",), dict(penalty=0.1),
                                  dict(data=(4, 10))),
    "LinearRegressionOutput": (("data",), {}, dict(data=(4, 10))),
    "LogisticRegressionOutput": (("data",), {}, dict(data=(4, 10))),
    "MAERegressionOutput": (("data",), {}, dict(data=(4, 10))),
}


@pytest.mark.parametrize("op", sorted(SYMBOL_CASES))
def test_symbol_json_and_infer_shape(op):
    """``mx.sym.<op>`` builds the same graph JSON in both packages and
    infers the same argument, output and aux shapes."""
    inputs, attrs, shapes = SYMBOL_CASES[op]
    got = []
    for mx in (jmx, tmx):
        with mx.name.NameManager():
            args = [mx.sym.Variable(n) for n in inputs]
            net = getattr(mx.sym, op)(*args, name="op", **attrs)
        got.append((net.tojson(), net.list_arguments(),
                    net.infer_shape(**shapes)))
    assert got[0][0] == got[1][0]
    assert got[0][1] == got[1][1]
    assert got[0][2] == got[1][2]
