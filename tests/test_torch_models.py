"""The PyTorch port's image-classification model zoo against the JAX
package's: every ``models.get_symbol`` name builds byte-equal graph JSON,
unknown names raise ``KeyError`` in both, and LeNet, the MLP and
Inception-BN give the same logits through ``Executor.forward`` on the CPU
at batch 2 for the same seeded weights, with every plan pass on
(``MXTPU_FUSED_KERNELS=1``, read by both packages at bind time).

Tolerance: rtol 1e-4, atol 1e-5 on the softmax outputs — the packages sum
convolutions in different orders, and the BN folds and Inception-BN's
merged convolutions reassociate float math, over some seventy layers."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


def _json(mx, name, **kw):
    with mx.name.NameManager():
        return mx.models.get_symbol(name, **kw).tojson()


@pytest.mark.parametrize("name", sorted(jmx.models._BUILDERS))
def test_get_symbol_json_byte_equal(name):
    assert sorted(tmx.models._BUILDERS) == sorted(jmx.models._BUILDERS)
    assert _json(tmx, name) == _json(jmx, name)


@pytest.mark.parametrize("name,kw", [
    ("vgg", dict(num_layers=11, batch_norm=True)),
    ("mobilenet", dict(alpha=0.5)),
    ("resnext", dict(num_layers=101, num_group=16)),
    ("inception-v3", dict(num_classes=7)),
    ("Inception-BN", dict(num_classes=21)),
], ids=["vgg11_bn", "mobilenet_half", "resnext101_g16", "inception_v3_7",
        "inception_bn_upper"])
def test_get_symbol_arguments_byte_equal(name, kw):
    assert _json(tmx, name, **kw) == _json(jmx, name, **kw)


def test_unknown_model_raises_key_error():
    for mx in (jmx, tmx):
        with pytest.raises(KeyError):
            mx.models.get_symbol("no-such-net")


def _bind(mx, name, shape, classes, params):
    with mx.name.NameManager():
        sym = mx.models.get_symbol(name, num_classes=classes)
    ex = sym.simple_bind(mx.cpu(), data=shape)
    for k, v in params.items():
        if k in ex.arg_dict:
            ex.arg_dict[k][:] = v
        else:
            ex.aux_dict[k][:] = v
    return ex


def _params(name, shape, classes, seed):
    """He-normal weights, non-trivial BN parameters and statistics."""
    with jmx.name.NameManager():
        sym = jmx.models.get_symbol(name, num_classes=classes)
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    params = {}
    for n, sh in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight"):
            fan_in = np.prod(sh[1:])
            params[n] = (rs.standard_normal(sh) * np.sqrt(2.0 / fan_in)) \
                .astype(np.float32)
        elif n.endswith("_gamma"):
            params[n] = rs.uniform(0.8, 1.2, sh).astype(np.float32)
        else:
            params[n] = (0.1 * rs.standard_normal(sh)).astype(np.float32)
    for n, sh in zip(sym.list_auxiliary_states(), aux_shapes):
        if n.endswith("_moving_mean"):
            params[n] = (0.1 * rs.standard_normal(sh)).astype(np.float32)
        else:
            params[n] = rs.uniform(0.8, 1.2, sh).astype(np.float32)
    return params


@pytest.mark.parametrize("name,shape,classes", [
    ("lenet", (2, 1, 28, 28), 10),
    ("mlp", (2, 1, 28, 28), 10),
    ("inception-bn", (2, 3, 32, 32), 10),
])
def test_forward_matches_jax(monkeypatch, name, shape, classes):
    monkeypatch.setenv("MXTPU_FUSED_KERNELS", "1")
    params = _params(name, shape, classes, seed=3)
    x = np.random.RandomState(4).uniform(0, 1, shape).astype(np.float32)
    outs = []
    for mx in (jmx, tmx):
        ex = _bind(mx, name, shape, classes, params)
        outs.append(ex.forward(is_train=False, data=x)[0].asnumpy())
    assert outs[1].shape == (shape[0], classes)
    assert np.isfinite(outs[1]).all()
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4, atol=1e-5)
