"""The serving slice end to end: the JAX package writes a checkpoint, the
PyTorch port loads it with its own ``load_checkpoint``, and the two
``Predictor``s answer the same request on the CPU.

ResNet-50 (bottleneck units) and ResNet-18 (basic units), 10 classes, at
2x3x64x64 — above 32, so ``bn0`` and the max-pool are on the path.  The
port runs its plain kernels here (``chip_smoke.py`` runs the CUDA kernel
on the H100).  Tolerance on the softmax: rtol 1e-4, atol 1e-5 — the two
packages sum convolutions in different orders and the BN fold reassociates
float math, over some fifty layers."""
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

SHAPE = (2, 3, 64, 64)


def _weights(symbol, seed):
    """Seeded numpy weights whose logits stay O(1-10): He-normal convs,
    each bottleneck's last conv scaled by 0.3, non-trivial BN params."""
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = symbol.infer_shape(data=SHAPE)
    args, aux = {}, {}
    for n, sh in zip(symbol.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight") and len(sh) == 4:
            std = np.sqrt(2.0 / np.prod(sh[1:]))
            if n.endswith("_conv3_weight"):
                std *= 0.3
            args[n] = (rs.standard_normal(sh) * std).astype(np.float32)
        elif n.endswith("_weight"):
            args[n] = (rs.standard_normal(sh) / np.sqrt(sh[1])) \
                .astype(np.float32)
        elif n.endswith("_gamma"):
            args[n] = rs.uniform(0.8, 1.2, sh).astype(np.float32)
        else:
            args[n] = (0.1 * rs.standard_normal(sh)).astype(np.float32)
    for n, sh in zip(symbol.list_auxiliary_states(), aux_shapes):
        if n.endswith("_moving_mean"):
            aux[n] = (0.1 * rs.standard_normal(sh)).astype(np.float32)
        else:
            aux[n] = rs.uniform(0.8, 1.2, sh).astype(np.float32)
    return args, aux


def _jax_checkpoint(tmp_path, name):
    with mxj.name.NameManager():
        sym = mxj.models.get_symbol(name, num_classes=10,
                                    image_shape=SHAPE[1:])
    args, aux = _weights(sym, seed=7)
    prefix = str(tmp_path / name)
    mxj.model.save_checkpoint(
        prefix, 3, sym, {k: mxj.nd.array(v) for k, v in args.items()},
        {k: mxj.nd.array(v) for k, v in aux.items()})
    return prefix


def _prefixed(arg_params, aux_params):
    params = {"arg:" + k: v for k, v in arg_params.items()}
    params.update({"aux:" + k: v for k, v in aux_params.items()})
    return params


def _jax_bn_sites(symbol):
    """(bn_act, bn_fold) counts of the JAX package's fused plan: a fused
    BatchNorm override with conv extra refs folds, one without them
    calls fused_bn_act."""
    from mxnet_tpu import executor as jex, mxfuse as jfuse
    plan = jfuse.optimize_plan(jex._node_plan(symbol),
                               [(id(n), i) for n, i in symbol._outputs])
    bn = [e for e in plan if e[0].op is not None
          and e[0].op.name == "BatchNorm" and e[5] is not None]
    folds = sum(1 for e in bn if e[5][1])
    return len(bn) - folds, folds


@pytest.mark.parametrize("name,fused,sites", [
    ("resnet-50", None, (17, 33)),
    ("resnet-18", None, (9, 9)),
    ("resnet-18", "0", (0, 0)),
], ids=["resnet50", "resnet18", "resnet18_unfused"])
def test_port_predictor_matches_jax_predictor(tmp_path, monkeypatch, name,
                                              fused, sites):
    if fused is not None:
        # both packages read the knob when a graph is bound
        monkeypatch.setenv("MXTPU_FUSED_KERNELS", fused)
    prefix = _jax_checkpoint(tmp_path, name)
    x = np.random.RandomState(11).standard_normal(SHAPE).astype(np.float32)

    jsym, jargs, jaux = mxj.model.load_checkpoint(prefix, 3)
    jpred = mxj.predict.Predictor(jsym, _prefixed(jargs, jaux),
                                  {"data": SHAPE}, ctx=mxj.cpu())
    want = jpred.forward(data=x).get_output(0)

    tsym, targs, taux = mxt.model.load_checkpoint(prefix, 3)
    assert tsym.tojson() == jsym.tojson()
    tpred = mxt.predict.Predictor(tsym, _prefixed(targs, taux),
                                  {"data": SHAPE}, ctx=mxt.cpu())
    got = tpred.forward(data=x).get_output(0)
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    # the port's fused plan routes the same BatchNorms as the JAX package's
    eval_fn = tpred._exec._eval
    port_sites = mxt.mxfuse.bn_sites(eval_fn.plan)
    assert (len(port_sites["bn_act"]), len(port_sites["bn_fold"])) == sites
    assert _jax_bn_sites(jsym) == sites


def test_predictor_lifecycle(tmp_path):
    """reshape (cached per signature), partial output, set_params, and the
    MXPred errors, on the port alone."""
    prefix = _jax_checkpoint(tmp_path, "resnet-18")
    sym, args, aux = mxt.model.load_checkpoint(prefix, 3)
    with open(prefix + "-0003.params", "rb") as f:
        blob = f.read()
    pred = mxt.predict.create(sym.tojson(), blob, {"data": SHAPE},
                              ctx=mxt.cpu())
    x = np.random.RandomState(12).standard_normal(SHAPE).astype(np.float32)
    out = pred.forward(data=x).get_output(0)
    first = pred._exec
    pred.reshape({"data": (1,) + SHAPE[1:]})
    one = pred.forward(data=x[:1]).get_output(0)
    np.testing.assert_allclose(one[0], out[0], rtol=1e-5, atol=1e-7)
    pred.reshape({"data": SHAPE})
    assert pred._exec is first
    with pytest.raises(mxt.MXNetError):
        pred.forward()                              # inputs were cleared
    with pytest.raises(mxt.MXNetError):
        pred.set_input("data", np.zeros((9, 9), np.float32))
    with pytest.raises(mxt.MXNetError):
        pred.set_input("nope", x)
    with pytest.raises(mxt.MXNetError):
        mxt.predict.Predictor(sym, blob, {"bogus": SHAPE}, ctx=mxt.cpu())

    logits = mxt.predict.Predictor(sym, blob, {"data": SHAPE}, ctx=mxt.cpu(),
                                   output_name="fc1_output")
    assert logits.output_names == ["fc1_output"]
    assert logits.forward(data=x).get_output(0).shape == (2, 10)

    # set_params lands in every cached executor; a shape change is refused
    pred.set_params({"arg:fc1_bias": np.full(10, 50.0, np.float32) *
                     (np.arange(10) == 3)})
    assert (pred.forward(data=x).get_output(0).argmax(1) == 3).all()
    with pytest.raises(mxt.MXNetError):
        pred.set_params({"arg:fc1_bias": np.zeros(11, np.float32)})
    # the serving executor binds no gradients: a train-mode forward runs
    # and backward() has nothing to write, as in the JAX package
    assert not pred._exec.grad_dict
    assert pred._exec.forward(is_train=True)[0].shape == (2, 10)
    pred._exec.backward()
    assert not pred._exec.grad_dict
