"""The six optimizers the reference writes in NDArray arithmetic (NAG,
SGLD, AdaGrad, AdaDelta, DCASGD, Test; ``mxnet_tpu/optimizer.py:147-357``)
in the PyTorch port against the JAX package, on the CPU.

Five updates of each deterministic optimizer, from the same weights and
gradients, with ``wd`` and ``clip_gradient``, agree at rtol 1e-6 (one
float32 elementwise chain each side).  SGLD's noise is not matched across
packages: its update, less the deterministic drift, must have mean 0 and
variance lr, within 5 standard errors.  ``SPMDTrainer`` refuses the six,
and a ``Module.fit`` with NAG on the executor route agrees with the JAX
package's from weights carried over with ``convert.py``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

PKGS = {"jax": jmx, "torch": tmx}
STEPS = 5


@pytest.mark.parametrize("name, params", [
    ("nag", {"momentum": 0.9}),
    ("nag", {"momentum": 0.0}),
    ("adagrad", {"eps": 1e-6}),
    ("adadelta", {"rho": 0.8, "epsilon": 1e-4}),
    ("dcasgd", {"momentum": 0.9, "lamda": 0.1}),
    ("dcasgd", {"momentum": 0.0}),
    ("test", {}),
], ids=["nag_momentum", "nag_plain", "adagrad", "adadelta",
        "dcasgd_momentum", "dcasgd_plain", "test"])
def test_five_updates_match_jax(name, params):
    rs = np.random.RandomState(0)
    w0 = {k: rs.standard_normal((4, 5)).astype(np.float32)
          for k in ("fc_weight", "fc_bias")}
    grads = [{k: (rs.standard_normal((4, 5)) * 2).astype(np.float32)
              for k in w0} for _ in range(STEPS)]
    got = {}
    for key, mx in PKGS.items():
        ctx = mx.cpu()
        opt = mx.optimizer.create(
            name, learning_rate=0.1, wd=0.01, clip_gradient=1.5,
            rescale_grad=0.5, param_idx2name={0: "fc_weight", 1: "fc_bias"},
            **params)
        upd = mx.optimizer.get_updater(opt)
        weights = {k: mx.nd.array(v, ctx=ctx) for k, v in w0.items()}
        for g in grads:
            for i, k in enumerate(("fc_weight", "fc_bias")):
                upd(i, mx.nd.array(g[k], ctx=ctx), weights[k])
        got[key] = {k: v.asnumpy() for k, v in weights.items()}
    for k in w0:
        assert not np.allclose(got["torch"][k], w0[k])
        np.testing.assert_allclose(got["torch"][k], got["jax"][k],
                                   rtol=1e-6, atol=1e-7)


def test_sgld_noise_moments():
    n, lr, wd = 100000, 0.04, 0.01
    rs = np.random.RandomState(1)
    w0 = rs.standard_normal(n).astype(np.float32)
    g = rs.standard_normal(n).astype(np.float32)
    drift = -lr / 2 * (np.clip(g * 0.5, -1.0, 1.0) + wd * w0)
    for mx in PKGS.values():
        ctx = mx.cpu()
        opt = mx.optimizer.create("sgld", learning_rate=lr, wd=wd,
                                  clip_gradient=1.0, rescale_grad=0.5,
                                  param_idx2name={0: "w_weight"})
        w = mx.nd.array(w0, ctx=ctx)
        mx.optimizer.get_updater(opt)(0, mx.nd.array(g, ctx=ctx), w)
        noise = (w.asnumpy() - w0 - drift).astype(np.float64)
        assert abs(noise.mean()) <= 5 * np.sqrt(lr / n)
        assert abs(noise.var() - lr) <= 5 * lr * np.sqrt(2.0 / n)
    # the port's draw is seeded
    draws = []
    for _ in range(2):
        tmx.random.seed(2)
        w = tmx.nd.array(w0, ctx=tmx.cpu())
        tmx.optimizer.get_updater(tmx.optimizer.create(
            "sgld", learning_rate=lr))(0, tmx.nd.array(g, ctx=tmx.cpu()), w)
        draws.append(w.asnumpy())
    np.testing.assert_array_equal(draws[0], draws[1])


@pytest.mark.parametrize("name", ["nag", "sgld", "adagrad", "adadelta",
                                  "dcasgd", "test"])
def test_spmd_trainer_refuses_them(name):
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.var("data"), num_hidden=3, name="fc"), name="softmax")
    with pytest.raises(tmx.base.MXNetError, match="not implemented"):
        tmx.parallel.SPMDTrainer(net, name, {"learning_rate": 0.1},
                                 ctx=tmx.cpu())


def _mlp(mx):
    net = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=16,
                                name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


@pytest.mark.parametrize("kvstore", ["local", "tpu"])
def test_module_fit_with_nag_matches_jax(kvstore):
    rs = np.random.RandomState(3)
    X = rs.standard_normal((64, 10)).astype(np.float32)
    y = rs.randint(0, 3, 64).astype(np.float32)
    shapes = {"fc1_weight": (16, 10), "fc1_bias": (16,),
              "fc2_weight": (3, 16), "fc2_bias": (3,)}
    start = {k: (rs.standard_normal(s) * 0.3).astype(np.float32)
             for k, s in shapes.items()}
    out = {}
    for key, mx in PKGS.items():
        ctx = mx.cpu()
        mod = mx.mod.Module(_mlp(mx), context=ctx)
        if key == "torch":
            # the JAX side's starting arrays, carried over as numpy
            jargs = {k: jmx.nd.array(v) for k, v in start.items()}
            args, _ = tmx.convert.params_from_numpy(
                ({k: v.asnumpy() for k, v in jargs.items()}, {}), ctx=ctx)
        else:
            args = {k: mx.nd.array(v, ctx=ctx) for k, v in start.items()}
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=16), num_epoch=2,
                kvstore=kvstore, optimizer="nag",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 1e-3},
                arg_params=args, aux_params={})
        if key == "torch":
            assert mod._fused is None     # NAG has no in-step rule
        params, _ = mod.get_params()
        out[key] = {k: v.asnumpy() for k, v in params.items()}
    for k in shapes:
        assert not np.allclose(out["torch"][k], start[k])
        np.testing.assert_allclose(out["torch"][k], out["jax"][k],
                                   rtol=1e-5, atol=1e-6)


def test_loaded_optimizer_states_follow_their_weights():
    """States restored into a fresh updater (``Module.load(...,
    load_optimizer_states=True)``) land on their weight's context at its
    first update, not on the default ``gpu(0)``, and continue the run
    exactly."""
    mx = tmx
    host = mx.cpu()
    rs = np.random.RandomState(5)
    w0 = rs.standard_normal((3, 4)).astype(np.float32)
    g = [rs.standard_normal((3, 4)).astype(np.float32) for _ in range(3)]
    runs = []
    for restore in (False, True):
        upd = mx.optimizer.get_updater(mx.optimizer.create(
            "nag", learning_rate=0.1, momentum=0.9))
        w = mx.nd.array(w0, ctx=host)
        upd(0, mx.nd.array(g[0], ctx=host), w)
        if restore:
            blob = upd.get_states()
            upd = mx.optimizer.get_updater(mx.optimizer.create(
                "nag", learning_rate=0.1, momentum=0.9))
            upd.set_states(blob)
        for gi in g[1:]:
            upd(0, mx.nd.array(gi, ctx=host), w)
        assert upd.states[0].context == host
        runs.append(w.asnumpy())
    np.testing.assert_array_equal(runs[1], runs[0])
