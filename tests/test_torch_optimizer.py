"""The port's optimizer stack against the JAX package on the CPU: the
update ops, the per-name lr/wd multipliers, the lr schedulers, the
initializers and the imperative ``Updater``.

Update ops: rtol 1e-6, atol 1e-7 — the same float32 elementwise ops in
the same order, so at most an ulp apart where a Python scalar rounds at
another point.  Random initializers draw from different generators in
the two packages, so only their statistics are compared (std within 5%
at about a million draws, where the sampling error is 0.1%)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import tensor as jtensor
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import tensor as ttensor

RTOL, ATOL = 1e-6, 1e-7


def _arrays(seed, n, shape=(4, 7)):
    rs = np.random.RandomState(seed)
    out = [rs.standard_normal(shape).astype(np.float32) for _ in range(n)]
    return out


UPDATES = {
    "sgd_update": (2, dict(lr=0.1, wd=1e-3, rescale_grad=0.5)),
    "sgd_mom_update": (3, dict(lr=0.1, momentum=0.9, wd=1e-3,
                               rescale_grad=0.5)),
    "adam_update": (4, dict(lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6,
                            wd=1e-3, rescale_grad=0.5)),
    "rmsprop_update": (3, dict(lr=0.01, gamma1=0.9, epsilon=1e-6, wd=1e-3,
                               rescale_grad=0.5, clip_weights=0.8)),
    "rmspropalex_update": (5, dict(lr=0.01, gamma1=0.9, gamma2=0.8,
                                   epsilon=1e-6, wd=1e-3, rescale_grad=0.5,
                                   clip_weights=0.8)),
}


@pytest.mark.parametrize("clip", [-1.0, 0.3], ids=["noclip", "clip"])
@pytest.mark.parametrize("op", sorted(UPDATES))
def test_update_ops_match_jax(op, clip):
    n, attrs = UPDATES[op]
    arrays = _arrays(30, n)
    # second moments are non-negative, and rmspropalex needs n > g^2
    if op in ("adam_update", "rmsprop_update", "rmspropalex_update"):
        arrays[3 if op == "adam_update" else 2] = \
            np.abs(arrays[3 if op == "adam_update" else 2]) + 2.0
    jout = getattr(jtensor, op)(*arrays, clip_gradient=clip, **attrs)
    tout = getattr(ttensor, op)(*[torch.from_numpy(a) for a in arrays],
                                clip_gradient=clip, **attrs)
    jout = jout if isinstance(jout, tuple) else (jout,)
    tout = tout if isinstance(tout, tuple) else (tout,)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)
    assert tmx.ops.registry.get_op(op).fn is getattr(ttensor, op)


NAMES = ["conv0_weight", "bn0_gamma", "bn0_beta", "fc_weight", "fc_bias",
         "stage1_unit1_bn1_gamma", "embed_table"]


def test_wd_mult_seeding_gamma_keeps_decay():
    """Zero weight decay for names ending neither in _weight nor in
    _gamma: biases and betas lose it, gammas keep it — the JAX package's
    rule (mxnet_tpu/optimizer.py:79), whatever its comment says."""
    idx2name = dict(enumerate(NAMES))
    j = jmx.optimizer.create("sgd", param_idx2name=idx2name, wd=1e-4)
    t = tmx.optimizer.create("sgd", param_idx2name=idx2name, wd=1e-4)
    assert t.wd_mult == j.wd_mult
    assert "bn0_gamma" not in t.wd_mult
    assert t._get_wd(1) == 1e-4                   # gamma decays
    assert t.wd_mult["bn0_beta"] == t.wd_mult["fc_bias"] == 0.0
    assert t.wd_mult["embed_table"] == 0.0
    t.set_lr_mult({"fc_weight": 0.1})
    assert t._get_lr(3) == pytest.approx(0.001)


def _small_net(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                             name="conv0")
    net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn0")
    net = mx.sym.Activation(net, act_type="relu", name="relu0")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def test_trainer_bind_seeds_multipliers_like_jax():
    """SPMDTrainer.bind reseeds idx2name and the multipliers from the
    bound parameter names, keeping what the user set."""
    shapes = ([("data", (2, 3, 5, 5))], [("softmax_label", (2,))])
    trainers = []
    for mx, ctx in ((jmx, {}), (tmx, {"ctx": tmx.cpu()})):
        opt = mx.optimizer.create("sgd", learning_rate=0.1, wd=1e-4)
        opt.set_lr_mult({"fc_weight": 0.5})
        tr = mx.parallel.SPMDTrainer(_small_net(mx), opt, **ctx)
        tr.bind(*shapes)
        trainers.append(tr)
    j, t = (tr.optimizer for tr in trainers)
    assert t.idx2name == j.idx2name
    assert t.wd_mult == j.wd_mult
    assert t.lr_mult == j.lr_mult == {"fc_weight": 0.5}
    assert "bn0_gamma" not in t.wd_mult and t.wd_mult["bn0_beta"] == 0.0


def test_schedulers_match_jax():
    pairs = [
        (jmx.lr_scheduler.FactorScheduler(3, 0.5, stop_factor_lr=1e-3),
         tmx.lr_scheduler.FactorScheduler(3, 0.5, stop_factor_lr=1e-3)),
        (jmx.lr_scheduler.MultiFactorScheduler([2, 5, 9], 0.1),
         tmx.lr_scheduler.MultiFactorScheduler([2, 5, 9], 0.1)),
    ]
    for j, t in pairs:
        j.base_lr = t.base_lr = 0.4
        got = [t(n) for n in range(1, 25)]
        assert got == [j(n) for n in range(1, 25)]
    assert got[0] == 0.4 and got[-1] == pytest.approx(4e-4)
    # an optimizer hands its learning rate to its scheduler
    sched = tmx.lr_scheduler.FactorScheduler(2, 0.5)
    opt = tmx.optimizer.create("sgd", learning_rate=0.2, lr_scheduler=sched)
    assert sched.base_lr == 0.2
    with pytest.raises(ValueError):
        tmx.lr_scheduler.FactorScheduler(0)


def _init_both(j_init, t_init, name, shape):
    jarr = jmx.nd.zeros(shape)
    tarr = tmx.nd.zeros(shape, ctx=tmx.cpu())
    j_init(name, jarr)
    t_init(name, tarr)
    return jarr.asnumpy(), tarr.asnumpy()


@pytest.mark.parametrize("name,value", [
    ("fc_bias", 0.0), ("bn_gamma", 1.0), ("bn_beta", 0.0),
    ("bn_moving_mean", 0.0), ("bn_moving_var", 1.0), ("lstm_init_c", 0.0),
    ("bn_moving_inv_var", 0.0), ("bn_moving_avg", 0.0),
    ("upsampling_weight", None)])
def test_initializer_name_dispatch(name, value):
    """Names pick the rule before the initializer does; ``upsampling*``
    takes the deterministic bilinear kernel."""
    j, t = _init_both(jmx.initializer.Xavier(), tmx.initializer.Xavier(),
                      name, (2, 1, 4, 4))
    np.testing.assert_array_equal(t, j)
    if value is not None:
        assert (t == value).all()


def test_deterministic_initializers_and_init_attr():
    for cls, kw in (("Zero", {}), ("One", {}), ("Constant", {"value": 0.25})):
        j, t = _init_both(getattr(jmx.initializer, cls)(**kw),
                          getattr(tmx.initializer, cls)(**kw),
                          "fc_weight", (2, 5))
        np.testing.assert_array_equal(t, j)
    desc = tmx.initializer.InitDesc(
        "fc_bias", attrs={"__init__": tmx.initializer.Constant(3.0).dumps()})
    arr = tmx.nd.zeros((4,), ctx=tmx.cpu())
    tmx.initializer.Zero()(desc, arr)
    assert (arr.asnumpy() == 3.0).all()
    with pytest.raises(ValueError):
        tmx.initializer.Zero()("mystery", arr)
    # a packed RNN vector: Xavier refuses vectors, so the small uniform
    rnn = tmx.nd.zeros((64,), ctx=tmx.cpu())
    tmx.initializer.Xavier()("lstm_parameters", rnn)
    assert np.abs(rnn.asnumpy()).max() <= 0.07 and rnn.asnumpy().any()


@pytest.mark.parametrize("init,shape,std", [
    (("Xavier", dict(rnd_type="gaussian", factor_type="in", magnitude=2)),
     (256, 128, 6, 6), np.sqrt(2.0 / (128 * 36))),
    (("Xavier", {}), (1024, 1024), np.sqrt(3.0 / 1024) / np.sqrt(3.0)),
    (("MSRAPrelu", {}), (256, 128, 6, 6),
     np.sqrt(2.0 / (1 + 0.25 ** 2) / (0.5 * (128 + 256) * 36))),
    (("Uniform", dict(scale=0.2)), (1024, 1024), 0.2 / np.sqrt(3.0)),
    (("Normal", dict(sigma=0.03)), (1024, 1024), 0.03),
], ids=["xavier_gauss_in", "xavier_uniform_avg", "msra", "uniform", "normal"])
def test_random_initializer_statistics(init, shape, std):
    cls, kw = init
    j, t = _init_both(getattr(jmx.initializer, cls)(**kw),
                      getattr(tmx.initializer, cls)(**kw), "w_weight", shape)
    for a in (t, j):
        assert abs(a.std() / std - 1) < 0.05
        assert abs(a.mean()) < 0.05 * std
    assert not np.array_equal(t, j)     # different generators, same law
    # the port's draws repeat after reseeding
    tmx.random.seed(7)
    a = tmx.nd.zeros((64,), ctx=tmx.cpu())
    tmx.initializer.Normal(1.0)("x_weight", a)
    tmx.random.seed(7)
    b = tmx.nd.zeros((64,), ctx=tmx.cpu())
    tmx.initializer.Normal(1.0)("x_weight", b)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_load_and_mixed():
    rs = np.random.RandomState(31)
    w = rs.standard_normal((3, 2)).astype(np.float32)
    loaded = {"arg:fc_weight": w}
    for mx in (jmx, tmx):
        init = mx.initializer.Load(loaded,
                                   default_init=mx.initializer.Constant(0.5))
        mixed = mx.initializer.Mixed(["conv.*", ".*"],
                                     [mx.initializer.One(), init])
        ctx = {} if mx is jmx else {"ctx": tmx.cpu()}
        arr = mx.nd.zeros((3, 2), **ctx)
        mixed("fc_weight", arr)                  # loaded
        np.testing.assert_array_equal(arr.asnumpy(), w)
        other = mx.nd.zeros((2, 2), **ctx)
        mixed("fc2_weight", other)               # Load's default_init
        assert (other.asnumpy() == 0.5).all()
        conv = mx.nd.zeros((3,), **ctx)
        mixed("conv_weight", conv)               # the first pattern
        assert (conv.asnumpy() == 1.0).all()
        with pytest.raises(mx.MXNetError):
            mx.initializer.Load(loaded)("fc_weight", mx.nd.zeros((2, 2),
                                                                 **ctx))


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("adam", dict(learning_rate=0.01, wd=1e-3)),
    ("rmsprop", dict(learning_rate=0.01, centered=True)),
])
def test_updater_steps_match_jax(name, kw):
    """The imperative Updater path: three updates of one weight."""
    rs = np.random.RandomState(32)
    w0 = rs.standard_normal((5, 3)).astype(np.float32)
    grads = [rs.standard_normal((5, 3)).astype(np.float32) for _ in range(3)]
    results = []
    for mx in (jmx, tmx):
        ctx = {} if mx is jmx else {"ctx": tmx.cpu()}
        opt = mx.optimizer.create(name, rescale_grad=0.5,
                                  param_idx2name={0: "fc_weight"}, **kw)
        upd = mx.optimizer.get_updater(opt)
        w = mx.nd.array(w0, **ctx)
        for g in grads:
            upd(0, mx.nd.array(g, **ctx), w)
        results.append(w.asnumpy())
        blob = upd.get_states()
        upd.set_states(blob)
    np.testing.assert_allclose(results[1], results[0], rtol=1e-5, atol=1e-6)
    assert not np.allclose(results[1], w0)
