"""The port's Module stack (``mxnet_tpu_torch/module``, ``io``,
``metric``, ``callback``, ``kvstore``, ``model``) against the JAX
package's, on the CPU.

The single-device cases of ``tests/test_module.py`` run on the port with
``context=cpu()``.  Parity: the reference's fine-tune flow (a checkpoint
cut at ``flatten0``, an rtc op with its vjp, a new ``FullyConnected``
head) trains 3 batches through ``Module.fit`` in both packages from the
same numpy weights and unshuffled ``NDArrayIter`` batches, on the
executor route (``kvstore='local'``) and the fused route (``'tpu'``);
params, aux states and the ``accuracy``/``top_k_accuracy`` values agree at
rtol 1e-4 / atol 1e-5 (float32 on both sides, convolutions and BatchNorm
sums in other orders, carried through the updates).  Iterator batches and
metric values equal the JAX package's exactly."""
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-4, 1e-5


def make_blobs(n, d, c, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(c, d) * 3
    X = np.concatenate([centers[i] + rs.randn(n // c, d)
                        for i in range(c)]).astype("f")
    y = np.concatenate([np.full(n // c, i) for i in range(c)]).astype("f")
    perm = rs.permutation(len(X))
    return X[perm], y[perm]


def mlp_sym(mx=tmx, num_classes=3, nh=32):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=nh, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=num_classes, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _module(net, **kw):
    return tmx.mod.Module(net, context=tmx.cpu(), **kw)


@tmx.optimizer.register
class NoRuleSGD(tmx.optimizer.SGD):
    """An optimizer the fused step has no rule for (the port's registered
    optimizers all have one), to drive the fallback."""


# ---------------------------------------------------------------------------
# the single-device cases of tests/test_module.py
# ---------------------------------------------------------------------------

def test_module_lifecycle():
    mod = _module(mlp_sym())
    mod.bind(data_shapes=[("data", (16, 10))],
             label_shapes=[("softmax_label", (16,))])
    mod.init_params(initializer=tmx.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    X, y = make_blobs(64, 10, 3)
    batch = tmx.io.DataBatch(data=[tmx.nd.array(X[:16], ctx=tmx.cpu())],
                             label=[tmx.nd.array(y[:16], ctx=tmx.cpu())])
    mod.forward_backward(batch)
    mod.update()
    outs = mod.get_outputs()
    assert outs[0].shape == (16, 3)
    arg_params, aux_params = mod.get_params()
    assert "fc1_weight" in arg_params
    assert arg_params["fc1_weight"].context == tmx.cpu()


def test_module_fit_mlp():
    tmx.random.seed(101)
    np.random.seed(101)
    X, y = make_blobs(480, 10, 3)
    train = tmx.io.NDArrayIter(X[:384], y[:384], batch_size=32,
                               shuffle=True)
    val = tmx.io.NDArrayIter(X[384:], y[384:], batch_size=32)
    mod = _module(mlp_sym())
    mod.fit(train, eval_data=val, num_epoch=5,
            optimizer_params={"learning_rate": 0.5},
            initializer=tmx.initializer.Xavier())
    score = mod.score(val, "acc")
    assert score[0][1] > 0.9, score


def test_module_predict_and_checkpoint(tmp_path):
    X, y = make_blobs(96, 6, 3)
    train = tmx.io.NDArrayIter(X, y, batch_size=16)
    mod = _module(mlp_sym(nh=8))
    mod.fit(train, num_epoch=2, initializer=tmx.initializer.Xavier())
    preds = mod.predict(tmx.io.NDArrayIter(X, y, batch_size=16))
    assert preds.shape == (96, 3)
    prefix = str(tmp_path / "model")
    mod.save_checkpoint(prefix, 2, save_optimizer_states=True)
    assert os.path.exists(prefix + "-0002.states")
    mod2 = tmx.mod.Module.load(prefix, 2, context=tmx.cpu())
    mod2.bind(data_shapes=train.provide_data,
              label_shapes=train.provide_label, for_training=False)
    preds2 = mod2.predict(tmx.io.NDArrayIter(X, y, batch_size=16))
    np.testing.assert_allclose(preds.asnumpy(), preds2.asnumpy(), rtol=1e-5)
    # the JAX package reads the port's checkpoint
    jsym, jargs, jaux = jmx.model.load_checkpoint(prefix, 2)
    assert jsym.tojson() == mod.symbol.tojson()
    np.testing.assert_array_equal(jargs["fc1_weight"].asnumpy(),
                                  mod.get_params()[0]["fc1_weight"].asnumpy())


def test_module_kvstore_update_on_kvstore():
    """update_on_kvstore: the optimizer runs in the store (reference
    model.py:_update_params_on_kvstore); lr 0.1 as in the JAX test."""
    X, y = make_blobs(128, 8, 2)
    train = tmx.io.NDArrayIter(X, y, batch_size=16)
    kv = tmx.kvstore.create("local")
    mod = _module(mlp_sym(num_classes=2, nh=8))
    mod.bind(data_shapes=train.provide_data,
             label_shapes=train.provide_label)
    tmx.random.seed(5)
    mod.init_params(initializer=tmx.initializer.Xavier())
    mod.init_optimizer(kvstore=kv, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    assert mod._update_on_kvstore
    for _epoch in range(3):
        train.reset()
        for batch in train:
            mod.forward_backward(batch)
            mod.update()
    score = mod.score(tmx.io.NDArrayIter(X, y, batch_size=16), "acc")
    assert score[0][1] > 0.9


def test_module_input_grads():
    mod = _module(mlp_sym())
    mod.bind(data_shapes=[("data", (4, 6))],
             label_shapes=[("softmax_label", (4,))], inputs_need_grad=True)
    mod.init_params()
    batch = tmx.io.DataBatch(
        data=[tmx.nd.ones((4, 6), ctx=tmx.cpu())],
        label=[tmx.nd.array([0, 1, 2, 0], ctx=tmx.cpu())])
    mod.forward_backward(batch)
    grads = mod.get_input_grads()
    assert grads[0].shape == (4, 6)
    assert np.abs(grads[0].asnumpy()).sum() > 0


def test_module_fused_tpu_kvstore():
    """kvstore='tpu' engages the fused SPMDTrainer step; training
    converges and the param sync / score paths work after fit."""
    tmx.random.seed(106)
    X, y = make_blobs(512, 10, 3)
    it = tmx.io.NDArrayIter(X, y, batch_size=64)
    mod = _module(mlp_sym())
    mod.fit(it, num_epoch=6, kvstore="tpu", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    assert mod._fused is not None, "fused path did not engage"
    acc = dict(mod.score(tmx.io.NDArrayIter(X, y, batch_size=64), "acc"))
    assert acc["accuracy"] > 0.9, acc
    assert mod.skipped_update_count == 0 and mod.consecutive_bad_steps == 0


def test_module_fused_matches_local_path():
    """Fused (kvstore='tpu') and executor (kvstore=None) training from
    identical inits give near-identical weights."""
    X, y = make_blobs(256, 8, 3, seed=3)

    def run(kv):
        it = tmx.io.NDArrayIter(X, y, batch_size=32)
        mod = _module(mlp_sym(nh=16))
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        tmx.random.seed(7)
        mod.init_params(tmx.initializer.Xavier(rnd_type="gaussian"))
        mod.init_optimizer(kvstore=kv, optimizer="sgd",
                           optimizer_params={"learning_rate": 0.05,
                                             "momentum": 0.9})
        for _ in range(2):
            it.reset()
            for batch in it:
                mod.forward_backward(batch)
                mod.update()
        assert (mod._fused is not None) == (kv == "tpu")
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    ref = run(None)
    fused = run("tpu")
    for name in ref:
        np.testing.assert_allclose(fused[name], ref[name], rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_module_fused_optimizer_state_roundtrip(tmp_path):
    X, y = make_blobs(128, 6, 3, seed=5)
    it = tmx.io.NDArrayIter(X, y, batch_size=32)
    mod = _module(mlp_sym(nh=8))
    mod.fit(it, num_epoch=1, kvstore="tpu", optimizer="adam",
            optimizer_params={"learning_rate": 0.01})
    fname = str(tmp_path / "opt.states")
    mod.save_optimizer_states(fname)
    before = {k: tuple(x.clone() for x in s)
              for k, s in mod._fused.opt_state.items()}
    n_update = mod._fused._num_update
    for s in mod._fused.opt_state.values():
        for x in s:
            x.zero_()
    mod.load_optimizer_states(fname)
    assert mod._fused._num_update == n_update == 4
    for k in before:
        for a, b in zip(before[k], mod._fused.opt_state[k]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_module_fused_fallback_unsupported_optimizer():
    """Optimizers without an in-step rule fall back to the executor
    route instead of failing."""
    X, y = make_blobs(128, 6, 3)
    it = tmx.io.NDArrayIter(X, y, batch_size=32)
    mod = _module(mlp_sym(nh=8))
    mod.fit(it, num_epoch=1, kvstore="tpu", optimizer="norulesgd",
            optimizer_params={"learning_rate": 0.05})
    assert mod._fused is None


def test_module_fused_force_init_fallback_keeps_weights():
    """Re-running init_optimizer with a non-fusable config after fused
    training carries the trained weights over."""
    X, y = make_blobs(256, 8, 3, seed=11)
    it = tmx.io.NDArrayIter(X, y, batch_size=32)
    mod = _module(mlp_sym(nh=16))
    mod.fit(it, num_epoch=3, kvstore="tpu", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    assert mod._fused is not None
    trained = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    mod.init_optimizer(kvstore="tpu", optimizer="norulesgd",
                       optimizer_params={"learning_rate": 0.05},
                       force_init=True)
    assert mod._fused is None
    after = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k in trained:
        np.testing.assert_array_equal(trained[k], after[k], err_msg=k)


def test_optimizer_states_cross_path(tmp_path):
    """Optimizer-state files resume across the fused/executor boundary."""
    X, y = make_blobs(128, 6, 3, seed=9)

    def make(kv):
        it = tmx.io.NDArrayIter(X, y, batch_size=32)
        mod = _module(mlp_sym(nh=8))
        mod.fit(it, num_epoch=1, kvstore=kv, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
        return mod

    fused, plain = make("tpu"), make(None)
    names = fused._fused.param_names
    f_mom = {n: s[0].numpy().copy() for n, s in fused._fused.opt_state.items()}
    p_mom = {names[k]: v.asnumpy() for k, v in plain._updater.states.items()}
    f_states = str(tmp_path / "fused.states")
    p_states = str(tmp_path / "plain.states")
    fused.save_optimizer_states(f_states)
    plain.save_optimizer_states(p_states)
    # each side loads the other's format, and then holds its momentum
    fused.load_optimizer_states(p_states)
    plain.load_optimizer_states(f_states)
    for name in names:
        np.testing.assert_array_equal(
            fused._fused.opt_state[name][0].numpy(), p_mom[name])
        np.testing.assert_array_equal(
            plain._updater.states[names.index(name)].asnumpy(), f_mom[name])


def test_module_exec_to_fused_force_init_keeps_weights():
    """Switching from the executor route into the fused one mid-training
    seeds the trainer from the trained device weights."""
    X, y = make_blobs(256, 8, 3, seed=13)
    it = tmx.io.NDArrayIter(X, y, batch_size=32)
    mod = _module(mlp_sym(nh=16))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(tmx.initializer.Xavier())
    mod.init_optimizer(kvstore=None, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    for _ in range(2):
        it.reset()
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
    assert mod._params_dirty
    names = [n for n in mod._param_names if n in mod._symbol.list_arguments()]
    trained = {n: block[0].asnumpy()
               for n, block in zip(names, mod._exec_group.param_arrays)}
    mod.init_optimizer(kvstore="tpu", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1},
                       force_init=True)
    assert mod._fused is not None
    seeded = {k: v.numpy() for k, v in mod._fused.params.items()}
    for k in trained:
        np.testing.assert_allclose(seeded[k], trained[k], rtol=1e-6,
                                   err_msg=k)
    # the executor group's device buffers were released
    assert all(block[0].size == 0 for block in mod._exec_group.param_arrays)


def test_module_output_shapes_with_fused():
    X, y = make_blobs(64, 8, 3)
    it = tmx.io.NDArrayIter(X, y, batch_size=32)
    mod = _module(mlp_sym(nh=8))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    mod.init_optimizer(kvstore="tpu")
    assert mod.output_shapes == [("softmax_output", (32, 3))]


def test_shared_module_against_fused_raises():
    X, y = make_blobs(64, 6, 3)
    it = tmx.io.NDArrayIter(X, y, batch_size=32)
    a = _module(mlp_sym(nh=8))
    a.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    a.init_params()
    a.init_optimizer(kvstore="tpu")
    assert a._fused is not None
    b = _module(mlp_sym(nh=8))
    with pytest.raises(tmx.MXNetError, match="fused SPMDTrainer"):
        b.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
               shared_module=a)


def test_fused_declined_after_sharing_out():
    X, y = make_blobs(64, 6, 3)
    it = tmx.io.NDArrayIter(X, y, batch_size=32)
    a = _module(mlp_sym(nh=8))
    a.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    a.init_params()
    b = _module(mlp_sym(nh=8))
    b.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
           shared_module=a)
    a.init_optimizer(kvstore="tpu")
    assert a._fused is None  # declined: cells are shared with b
    for batch in it:
        a.forward_backward(batch)
        a.update()
        b.forward(batch, is_train=False)  # shared cells remain valid
        np.testing.assert_array_equal(
            b.get_outputs()[0].asnumpy().shape, (32, 3))
        break


def test_module_reshape_keeps_params():
    X, y = make_blobs(64, 6, 3)
    mod = _module(mlp_sym(nh=8))
    mod.bind(data_shapes=[("data", (32, 6))],
             label_shapes=[("softmax_label", (32,))])
    mod.init_params(tmx.initializer.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    w = mod.get_params()[0]["fc1_weight"].asnumpy()
    mod.reshape([("data", (8, 6))], [("softmax_label", (8,))])
    batch = tmx.io.DataBatch(data=[tmx.nd.array(X[:8], ctx=tmx.cpu())],
                             label=[tmx.nd.array(y[:8], ctx=tmx.cpu())])
    mod.forward(batch, is_train=False)
    assert mod.get_outputs()[0].shape == (8, 3)
    np.testing.assert_array_equal(mod.get_params()[0]["fc1_weight"]
                                  .asnumpy(), w)


def test_unported_options_raise(tmp_path, monkeypatch):
    """``dist_async`` raises (no collective analog, as in the JAX
    package); several distinct contexts in one process take the fused
    step over an in-process dp mesh, while repeated contexts and an
    indivisible batch take the executor-group route, as in the JAX
    package (tests/test_torch_tp.py holds the fused route against it);
    the dist stores work as a world of one
    (tests/test_torch_dist.py runs them across processes); the
    resilience options and their knobs do not raise
    (tests/test_torch_resilience.py holds them against the JAX package),
    nor do step traces (MXTPU_PROFILE_DIR: tests/test_torch_tools.py)."""
    net = mlp_sym(nh=8)
    X, y = make_blobs(64, 6, 3)
    it = tmx.io.NDArrayIter(X, y, batch_size=32)
    mod = tmx.mod.Module(net, context=[tmx.cpu(0), tmx.cpu(1)])
    mod.fit(it, num_epoch=1, kvstore="tpu")
    assert mod._fused is not None and mod._fused.mesh.in_process
    assert dict(mod._fused.mesh.shape) == {"dp": 2}
    for ctxs, batch in (([tmx.cpu(0), tmx.cpu(0)], 32),
                        ([tmx.cpu(0), tmx.cpu(1), tmx.cpu(2)], 32)):
        it = tmx.io.NDArrayIter(X, y, batch_size=batch)
        mod = tmx.mod.Module(net, context=ctxs)
        mod.fit(it, num_epoch=1, kvstore="tpu")
        assert mod._fused is None and len(mod._exec_group.execs) == \
            len(ctxs)
    it.reset()
    with pytest.raises(tmx.MXNetError, match="dist_async"):
        tmx.kvstore.create("dist_async")
    kv = tmx.kvstore.create("dist_sync")
    assert (kv.rank, kv.num_workers, kv.get_num_dead_node()) == (0, 1, 0)
    monkeypatch.setenv("MXTPU_PROFILE_DIR", str(tmp_path / "trace"))
    _module(net).fit(it, num_epoch=1)
    monkeypatch.delenv("MXTPU_PROFILE_DIR")
    it.reset()
    for i, kw in enumerate(({"checkpoint": str(tmp_path / "a")},
                            {"resume": True,
                             "checkpoint": str(tmp_path / "b")},
                            {"preemption_safe": True,
                             "checkpoint": str(tmp_path / "c")},
                            {"watchdog": True})):
        it.reset()
        _module(net).fit(it, num_epoch=1, **kw)
    assert tmx.resilience.CheckpointManager(str(tmp_path / "a")).latest() \
        == 1
    monkeypatch.setenv("MXTPU_RESUME", "1")
    it.reset()
    _module(net).fit(it, num_epoch=2, checkpoint=str(tmp_path / "a"))
    assert tmx.resilience.CheckpointManager(str(tmp_path / "a")).latest() \
        == 2
    monkeypatch.delenv("MXTPU_RESUME")
    man = tmx.resilience.CheckpointManager(str(tmp_path / "d"))
    with tmx.callback.PreemptionCheckpoint(None, man) as cb:
        assert not cb.handler.triggered


# ---------------------------------------------------------------------------
# parity with the JAX package: iterators, metrics, the fine-tune flow
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_batches_match_jax(handle):
    rs = np.random.RandomState(3)
    X = rs.standard_normal((10, 2, 3)).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    its = [mx.io.NDArrayIter(X, y, batch_size=4, last_batch_handle=handle)
           for mx in (jmx, tmx)]
    assert [tuple(d) for d in its[0].provide_data] == \
        [tuple(d) for d in its[1].provide_data]
    for epoch in range(3):
        got = [[(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in it] for it in its]
        assert len(got[0]) == len(got[1]) > 0, (epoch, handle)
        for (jd, jl, jp), (td, tl, tp) in zip(*got):
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tl, jl)
            assert tp == jp
        for it in its:
            it.reset()


def _metric_inputs(kind, seed=11):
    rs = np.random.RandomState(seed)
    if kind == "binary":
        pred = rs.rand(16, 2).astype(np.float32)
        label = rs.randint(0, 2, 16).astype(np.float32)
    elif kind == "regression":
        pred = rs.standard_normal((16, 1)).astype(np.float32)
        label = rs.standard_normal(16).astype(np.float32)
    else:
        logits = rs.standard_normal((16, 7)).astype(np.float32)
        pred = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        label = rs.randint(0, 7, 16).astype(np.float32)
    return pred, label


METRICS = [("acc", {}, "class"), ("top_k_accuracy", {"top_k": 3}, "class"),
           ("f1", {}, "binary"), ("mae", {}, "regression"),
           ("mse", {}, "regression"), ("rmse", {}, "regression"),
           ("ce", {}, "class"), ("loss", {}, "class"),
           ("custom", {}, "class"), ("composite", {}, "class")]


@pytest.mark.parametrize("name,kwargs,kind", METRICS,
                         ids=[m[0] for m in METRICS])
def test_metric_matches_jax(name, kwargs, kind):
    def feval(label, pred):
        return float((pred.argmax(1) == label).mean())

    values = []
    for mx, ctx in ((jmx, None), (tmx, tmx.cpu())):
        if name == "custom":
            m = mx.metric.np(feval)
        elif name == "composite":
            m = mx.metric.create(["acc", mx.metric.create(
                "top_k_accuracy", top_k=2)])
        else:
            m = mx.metric.create(name, **kwargs)
        for seed in (11, 12):
            pred, label = _metric_inputs(kind, seed)
            if ctx is None:
                m.update([mx.nd.array(label)], [mx.nd.array(pred)])
            else:
                m.update([mx.nd.array(label, ctx=ctx)],
                         [mx.nd.array(pred, ctx=ctx)])
        values.append(m.get_name_value())
    assert [n for n, _ in values[0]] == [n for n, _ in values[1]]
    np.testing.assert_allclose([v for _, v in values[1]],
                               [v for _, v in values[0]], rtol=1e-6)


# -- the fine-tune flow ------------------------------------------------------

IMAGE = (3, 16, 16)
BATCH = 8
NEW_CLASSES = 10
FT_OP = "tmod_silu"


def _register_rtc_silu():
    """``tmod_silu`` in both packages, each with its hand-written vjp:
    the port's CUDA body (plain version here), the JAX package's Pallas
    body (interpret mode)."""
    if FT_OP not in tmx.ops.registry.OP_REGISTRY:
        silu = tmx.rtc.elementwise_cuda_kernel(
            "out = in / (1.0f + expf(-in));",
            plain=lambda x: x / (1.0 + torch.exp(-x)))
        dsilu = tmx.rtc.elementwise_cuda_kernel(
            "float s = 1.0f / (1.0f + expf(-in)); "
            "out = s * (1.0f + in * (1.0f - s));",
            plain=lambda x: torch.sigmoid(x) * (1 + x * (1 - torch.sigmoid(
                x))))
        tmx.rtc.register_kernel(FT_OP, vjp=lambda x, g: dsilu(x) * g)(
            lambda data: silu(data))
    if FT_OP not in jmx.ops.registry.OP_REGISTRY:
        def fwd_body(in_ref, out_ref):
            x = in_ref[...]
            out_ref[...] = x / (1.0 + jnp.exp(-x))

        def d_body(in_ref, out_ref):
            x = in_ref[...]
            s = 1.0 / (1.0 + jnp.exp(-x))
            out_ref[...] = s * (1.0 + x * (1.0 - s))

        jfwd = jmx.rtc.elementwise_pallas_kernel(fwd_body)
        jd = jmx.rtc.elementwise_pallas_kernel(d_body)
        jmx.rtc.register_kernel(FT_OP, vjp=lambda x, g: (jd(x) * g,))(
            lambda data: jfwd(data))


def _body_checkpoint(prefix):
    """A ResNet-8 body with seeded numpy weights, saved by the port as
    the checkpoint the fine-tune starts from."""
    with tmx.name.NameManager():
        body = tmx.models.get_symbol("resnet", num_layers=8, num_classes=4,
                                     image_shape=IMAGE)
    rs = np.random.RandomState(60)
    arg_shapes, _, aux_shapes = body.infer_shape(data=(BATCH,) + IMAGE)
    args = {}
    for n, s in zip(body.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight"):
            args[n] = np.sqrt(2.0 / np.prod(s[1:])) * rs.standard_normal(s)
        elif n.endswith("_gamma"):
            args[n] = rs.uniform(0.8, 1.2, s)
        else:
            args[n] = 0.1 * rs.standard_normal(s)
    aux = {n: (rs.uniform(0.8, 1.2, s) if n.endswith("_var")
               else 0.1 * rs.standard_normal(s))
           for n, s in zip(body.list_auxiliary_states(), aux_shapes)}
    tmx.model.save_checkpoint(
        prefix, 0, body,
        {k: tmx.nd.array(v.astype(np.float32), ctx=tmx.cpu())
         for k, v in args.items()},
        {k: tmx.nd.array(v.astype(np.float32), ctx=tmx.cpu())
         for k, v in aux.items()})
    return rs


def _fine_tune_symbol(mx, prefix):
    """fine-tune.py's get_fine_tune_model: load, cut at flatten0, then the
    rtc op, a new FullyConnected head and SoftmaxOutput."""
    sym, args, aux = mx.model.load_checkpoint(prefix, 0)
    internals = sym.get_internals()
    assert "flatten0_output" in internals.list_outputs()
    net = getattr(mx.sym, FT_OP)(internals["flatten0_output"],
                                 name="rtc_silu0")
    net = mx.sym.FullyConnected(net, num_hidden=NEW_CLASSES, name="fc-new")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    args = {k: v for k, v in args.items() if "fc" not in k}
    return net, args, aux


@pytest.mark.parametrize("kvstore", ["local", "tpu"])
def test_fine_tune_fit_matches_jax(kvstore, tmp_path, monkeypatch):
    """3 batches of Module.fit with fit.py's wiring in both packages from
    one checkpoint; the port's executor or fused route against the JAX
    package's same route."""
    monkeypatch.setenv("MXTPU_METRIC_BLOCKING", "1")
    _register_rtc_silu()
    prefix = str(tmp_path / "body")
    rs = _body_checkpoint(prefix)
    head = {"fc-new_weight": (0.05 * rs.standard_normal(
                (NEW_CLASSES, 64))).astype(np.float32),
            "fc-new_bias": np.zeros(NEW_CLASSES, np.float32)}
    X = rs.standard_normal((3 * BATCH,) + IMAGE).astype(np.float32)
    y = rs.randint(0, NEW_CLASSES, 3 * BATCH).astype(np.float32)
    results = []
    for mx, ctx in ((jmx, jmx.cpu()), (tmx, tmx.cpu())):
        net, args, aux = _fine_tune_symbol(mx, prefix)
        args.update({k: mx.nd.array(v, ctx=ctx) for k, v in head.items()})
        mod = mx.mod.Module(net, context=ctx)
        metric = mx.metric.create(
            ["accuracy", mx.metric.create("top_k_accuracy", top_k=5)])
        ck = str(tmp_path / ("ft-%s" % mx.__name__))
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=BATCH),
                eval_metric=metric, kvstore=kvstore, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                initializer=mx.initializer.Xavier(
                    rnd_type="gaussian", factor_type="in", magnitude=2),
                arg_params=args, aux_params=aux, allow_missing=True,
                batch_end_callback=mx.callback.Speedometer(BATCH, 2),
                epoch_end_callback=mx.callback.do_checkpoint(ck),
                num_epoch=1)
        assert (mod._fused is not None) == (kvstore == "tpu")
        arg_p, aux_p = mod.get_params()
        values = metric.get_name_value()
        preds = mod.predict(mx.io.NDArrayIter(X[:BATCH], y[:BATCH],
                                              batch_size=BATCH)).asnumpy()
        results.append(({k: v.asnumpy() for k, v in arg_p.items()},
                        {k: v.asnumpy() for k, v in aux_p.items()},
                        values, preds, ck))
    (ja, jx, jv, jp, jck), (ta, tx, tv, tp, tck) = results
    assert set(ja) == set(ta) and set(jx) == set(tx)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for k in jx:
        np.testing.assert_allclose(tx[k], jx[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert [n for n, _ in tv] == [n for n, _ in jv]
    np.testing.assert_allclose([v for _, v in tv], [v for _, v in jv],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL)
    # the new head moved, and each epoch checkpoint loads in the other
    # package
    assert not np.allclose(ta["fc-new_weight"], head["fc-new_weight"])
    _, targs, _ = jmx.model.load_checkpoint(tck, 1)
    _, jargs, _ = tmx.model.load_checkpoint(jck, 1)
    np.testing.assert_array_equal(targs["fc-new_weight"].asnumpy(),
                                  ta["fc-new_weight"])
    np.testing.assert_array_equal(jargs["fc-new_weight"].asnumpy(),
                                  ja["fc-new_weight"])


def test_fine_tune_score_and_predict(tmp_path):
    """score and predict through the rtc op on the port, both routes:
    one rtc forward per batch, none backward, the predictions its
    softmax rows."""
    _register_rtc_silu()
    prefix = str(tmp_path / "body")
    rs = _body_checkpoint(prefix)
    X = rs.standard_normal((2 * BATCH,) + IMAGE).astype(np.float32)
    y = rs.randint(0, NEW_CLASSES, 2 * BATCH).astype(np.float32)
    net, args, aux = _fine_tune_symbol(tmx, prefix)
    for kv in ("tpu", "local"):
        mod = _module(net)
        it = tmx.io.NDArrayIter(X, y, batch_size=BATCH)
        mod.bind(it.provide_data, it.provide_label)
        tmx.random.seed(3)
        mod.init_params(tmx.initializer.Xavier(), arg_params=args,
                        aux_params=aux, allow_missing=True)
        mod.init_optimizer(kvstore=kv)
        calls = []
        opdef = tmx.ops.registry.OP_REGISTRY[FT_OP]
        real = opdef.fn
        opdef.fn = lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            score = dict(mod.score(it, ["acc", "ce"]))
            preds = mod.predict(it).asnumpy()
        finally:
            opdef.fn = real
        assert len(calls) == 4
        assert preds.shape == (2 * BATCH, NEW_CLASSES)
        np.testing.assert_allclose(preds.sum(1), 1.0, rtol=1e-5)
        assert 0.0 <= score["accuracy"] <= 1.0 and np.isfinite(
            score["cross-entropy"])


def test_callbacks_log(caplog):
    caplog.set_level(logging.INFO)
    m = tmx.metric.create("acc")
    m.update([tmx.nd.array([1, 0], ctx=tmx.cpu())],
             [tmx.nd.array([[0.1, 0.9], [0.8, 0.2]], ctx=tmx.cpu())])
    speed = tmx.callback.Speedometer(2, frequent=1)
    for nbatch in range(3):
        speed(tmx.model.BatchEndParam(0, nbatch, m, None))
    tmx.callback.log_train_metric(1)(tmx.model.BatchEndParam(0, 0, None,
                                                             None))
    assert "samples/sec" in caplog.text
