"""The rest of the port's Module stack against the JAX package's, on the
CPU: ``SequentialModule`` and ``PythonLossModule`` running the flows of
``example/module/{sequential_module,python_loss}.py`` at a small size,
the legacy ``FeedForward`` (fit, predict, score, save, load) and its
``DataParallelExecutorManager``, the ``Poly`` and ``Cosine`` learning-rate
schedules, and the ``Bilinear`` and ``Orthogonal`` initializers.

Both packages start from the same numpy weights and read the same
unshuffled batches.  Tolerances: parameters, outputs, gradients and
metric values at rtol 1e-4 / atol 1e-5 (float32 on both sides, matmuls
summed in other orders, carried through a few sgd updates); the
schedules to float64 rounding (the same formulas); ``Bilinear`` exactly;
``Orthogonal`` by its properties, to 1e-5 (its draws are the package's
own)."""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-4, 1e-5
DIM, CLASSES, BATCH = 12, 4, 16


def make_blobs(n, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(CLASSES, DIM) * 2
    y = rs.randint(0, CLASSES, n)
    X = (centers[y] + rs.randn(n, DIM)).astype(np.float32)
    return X, y.astype(np.float32)


def _iter(mx, X, y):
    return mx.io.NDArrayIter(X, y, batch_size=BATCH)


def _draw(shapes, seed=1):
    rs = np.random.RandomState(seed)
    return {n: rs.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in shapes.items()}


def _nd(mx, weights):
    return {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in weights.items()}


def _sequential(mx, python_loss):
    """The example's chain: a feature Module, then a classifier Module
    with SoftmaxOutput, or the scores Module and a PythonLossModule with
    the multiclass hinge gradient."""
    ctx = mx.cpu()
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, name="fc1", num_hidden=16)
    net = mx.sym.Activation(net, name="relu1", act_type="relu")
    if python_loss:
        net = mx.sym.FullyConnected(net, name="fc3", num_hidden=CLASSES)
        first = mx.mod.Module(net, label_names=[], context=ctx)
        second = mx.mod.PythonLossModule(grad_func=mc_hinge_grad)
    else:
        first = mx.mod.Module(net, label_names=[], context=ctx)
        data = mx.sym.Variable("data")
        fc2 = mx.sym.FullyConnected(data, name="fc2", num_hidden=8)
        act2 = mx.sym.Activation(fc2, name="relu2", act_type="relu")
        fc3 = mx.sym.FullyConnected(act2, name="fc3", num_hidden=CLASSES)
        second = mx.mod.Module(mx.sym.SoftmaxOutput(fc3, name="softmax"),
                               context=ctx)
    seq = mx.mod.SequentialModule()
    seq.add(first).add(second, take_labels=True, auto_wiring=True)
    return seq


def mc_hinge_grad(scores, labels):
    """d/d(scores) of the Crammer-Singer multiclass hinge loss
    (example/module/python_loss.py)."""
    scores = scores.asnumpy()
    labels = labels.asnumpy().astype(int)
    rows = np.arange(scores.shape[0])
    margin = 1.0 + scores - scores[rows, labels][:, None]
    margin[rows, labels] = 0.0
    ind_pred = margin.argmax(axis=1)
    grad = np.zeros_like(scores)
    grad[rows, labels] -= 1.0
    grad[rows, ind_pred] += 1.0
    return grad


SEQ_SHAPES = {
    False: {"fc1_weight": (16, DIM), "fc1_bias": (16,),
            "fc2_weight": (8, 16), "fc2_bias": (8,),
            "fc3_weight": (CLASSES, 8), "fc3_bias": (CLASSES,)},
    True: {"fc1_weight": (16, DIM), "fc1_bias": (16,),
           "fc3_weight": (CLASSES, 16), "fc3_bias": (CLASSES,)}}


@pytest.mark.parametrize("python_loss", [False, True],
                         ids=["sequential_module", "python_loss"])
def test_sequential_module_flows_match_jax(python_loss):
    """Two epochs of ``SequentialModule.fit`` (sgd, momentum 0.9) with a
    validation score, then ``score``/``iter_predict``: the parameters,
    metrics and predictions agree with the JAX package's."""
    X, y = make_blobs(4 * BATCH)
    Xv, yv = make_blobs(2 * BATCH, seed=3)
    weights = _draw(SEQ_SHAPES[python_loss])
    res = []
    for mx in (jmx, tmx):
        seq = _sequential(mx, python_loss)
        val = []
        seq.fit(_iter(mx, X, y), eval_data=_iter(mx, Xv, yv),
                arg_params=_nd(mx, weights),
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                eval_end_callback=lambda p: val.append(
                    p.eval_metric.get()[1]),
                num_epoch=2)
        args, aux = seq.get_params()
        score = dict(seq.score(_iter(mx, Xv, yv), mx.metric.create("acc")))
        preds = np.concatenate([o[0].asnumpy() for o, _, _ in
                                seq.iter_predict(_iter(mx, Xv, yv))])
        assert seq.output_shapes[0][1] == (BATCH, CLASSES)
        first = seq.data_shapes[0]
        assert tuple(getattr(first, "shape", first[1])) == (BATCH, DIM)
        res.append(({k: v.asnumpy() for k, v in args.items()}, aux, val,
                    score, preds))
    (ja, jx, jv, js, jp), (ta, tx, tv, ts, tp) = res
    assert set(ta) == set(ja) == set(weights) and tx == jx == {}
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        assert not np.array_equal(ta[k], weights[k]), k
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    assert ts.keys() == js.keys()
    np.testing.assert_allclose(list(ts.values()), list(js.values()),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL)


def test_sequential_module_input_grads_cross_the_boundary():
    """forward -> backward through the chain: the first module's input
    gradients (inputs_need_grad) equal a single Module's over the whole
    network, and the first module's parameter gradients too."""
    X, y = make_blobs(BATCH)
    weights = _draw(SEQ_SHAPES[False])
    ctx = tmx.cpu()
    seq = _sequential(tmx, False)
    seq.bind([("data", (BATCH, DIM))], [("softmax_label", (BATCH,))],
             inputs_need_grad=True)
    seq.init_params(arg_params=_nd(tmx, weights))
    batch = tmx.io.DataBatch([tmx.nd.array(X, ctx=ctx)],
                             [tmx.nd.array(y, ctx=ctx)])
    seq.forward(batch, is_train=True)
    seq.backward()
    d_seq = seq.get_input_grads()[0].asnumpy()
    g_seq = seq._modules[0]._exec_group.grad_arrays[0][0].asnumpy()

    data = tmx.sym.Variable("data")
    net = tmx.sym.Activation(tmx.sym.FullyConnected(
        data, name="fc1", num_hidden=16), act_type="relu")
    net = tmx.sym.Activation(tmx.sym.FullyConnected(
        net, name="fc2", num_hidden=8), act_type="relu")
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        net, name="fc3", num_hidden=CLASSES), name="softmax")
    whole = tmx.mod.Module(net, context=ctx)
    whole.bind([("data", (BATCH, DIM))], [("softmax_label", (BATCH,))],
               inputs_need_grad=True)
    whole.init_params(arg_params=_nd(tmx, weights))
    whole.forward(batch, is_train=True)
    whole.backward()
    np.testing.assert_allclose(d_seq, whole.get_input_grads()[0].asnumpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        g_seq, whole._exec_group.execs[0].grad_dict["fc1_weight"].asnumpy(),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(seq.get_outputs()[0].asnumpy(),
                                  seq._modules[1].get_outputs()[0].asnumpy())


def test_python_module_surface():
    """PythonLossModule: no parameters, scores passed through, the
    gradient function's result on the scores' context, and the checks
    the JAX package makes."""
    loss = tmx.mod.PythonLossModule(grad_func=mc_hinge_grad)
    assert loss.get_params() == ({}, {})
    with pytest.raises(tmx.MXNetError):
        loss.bind([("other", (2, 3))])
    loss.bind([("data", (2, 3))], [("softmax_label", (2,))])
    assert loss.output_shapes == [("pyloss_output", (2, 3))]
    scores = tmx.nd.array([[1.0, 2.0, 0.5], [0.0, -1.0, 3.0]],
                          ctx=tmx.cpu())
    label = tmx.nd.array([0, 2], ctx=tmx.cpu())
    loss.forward(tmx.io.DataBatch([scores], [label]), is_train=True)
    assert loss.get_outputs()[0] is scores
    loss.backward()
    g = loss.get_input_grads()[0]
    assert g.context == tmx.cpu()
    np.testing.assert_array_equal(g.asnumpy(), mc_hinge_grad(scores, label))
    with pytest.raises(tmx.MXNetError):
        loss.backward(out_grads=[g])
    with pytest.raises(tmx.MXNetError):
        tmx.mod.PythonLossModule(grad_func=3)


def _mlp(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=CLASSES, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


MLP_SHAPES = {"fc1_weight": (16, DIM), "fc1_bias": (16,),
              "fc2_weight": (CLASSES, 16), "fc2_bias": (CLASSES,)}


def test_feedforward_fit_predict_score_save_load(tmp_path):
    """FeedForward over numpy inputs (shuffled with numpy's global
    generator, seeded alike): fit, predict, score, then save and load,
    against the JAX package's; the loaded model predicts what the trained
    one did (in the port; the JAX package's raises there)."""
    X, y = make_blobs(4 * BATCH)
    weights = _draw(MLP_SHAPES)
    res = []
    for mx in (jmx, tmx):
        np.random.seed(5)
        model = mx.model.FeedForward(
            _mlp(mx), ctx=mx.cpu(), num_epoch=3, numpy_batch_size=BATCH,
            arg_params=_nd(mx, weights), aux_params={},
            learning_rate=0.1, momentum=0.9)
        model.fit(X, y)
        prob = model.predict(X)
        acc = model.score(_iter(mx, X, y))
        prefix = str(tmp_path / mx.__name__)
        model.save(prefix)
        assert os.path.exists("%s-0003.params" % prefix)
        again = mx.model.FeedForward.load(prefix, 3, ctx=mx.cpu(),
                                          numpy_batch_size=BATCH)
        assert again.begin_epoch == 3
        if mx is tmx:
            # the JAX package's loaded model cannot predict: it asks for
            # "softmax_label" as a parameter
            np.testing.assert_array_equal(again.predict(X), prob)
        res.append(({k: v.asnumpy() for k, v in model.arg_params.items()},
                    prob, acc))
    (ja, jp, jc), (ta, tp, tc) = res
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        assert not np.array_equal(ta[k], weights[k])
    assert tp.shape == (4 * BATCH, CLASSES)
    np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL)
    assert tc == pytest.approx(jc) and tc > 0.5


def test_feedforward_create_trains():
    X, y = make_blobs(4 * BATCH, seed=7)
    tmx.random.seed(0)
    model = tmx.model.FeedForward.create(
        _mlp(tmx), X, y, ctx=tmx.cpu(), num_epoch=4,
        initializer=tmx.initializer.Xavier(), numpy_batch_size=BATCH,
        learning_rate=0.2, momentum=0.9)
    assert model.score(_iter(tmx, X, y)) > 0.8


def test_executor_manager_matches_jax():
    """DataParallelExecutorManager on one context: set_params, a batch's
    forward and backward, its metric and copy_to, against the JAX
    package's manager."""
    X, y = make_blobs(BATCH)
    weights = _draw(MLP_SHAPES, seed=2)
    res = []
    for mx in (jmx, tmx):
        sym = _mlp(mx)
        it = _iter(mx, X, y)
        arg_names = sym.list_arguments()
        params = [n for n in arg_names if n in weights]
        mgr = mx.executor_manager.DataParallelExecutorManager(
            sym, [mx.cpu()], it, arg_names, params,
            sym.list_auxiliary_states())
        mgr.set_params(_nd(mx, weights), {})
        mgr.load_data_batch(next(iter(it)))
        mgr.forward(is_train=True)
        mgr.backward()
        metric = mx.metric.create("ce")
        mgr.update_metric(metric, [mx.nd.array(y, ctx=mx.cpu())])
        grads = {n: g[0].asnumpy() for n, g in zip(params, mgr.grad_arrays)}
        out = {n: mx.nd.zeros(s, ctx=mx.cpu())
               for n, s in MLP_SHAPES.items()}
        mgr.copy_to(out, {})
        assert len(mgr.param_arrays) == len(params) and mgr.aux_arrays == []
        res.append((grads, metric.get()[1],
                    {k: v.asnumpy() for k, v in out.items()}))
    (jg, jm, jo), (tg, tm, to) = res
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        np.testing.assert_array_equal(to[k], weights[k])
    assert tm == pytest.approx(jm, rel=RTOL)


def test_executor_manager_load_helpers():
    """_load_data / _load_label copy each slice into its target, on the
    target's device and in its dtype, along the batch axis given."""
    ctx = tmx.cpu()
    src = tmx.nd.array(np.arange(24, dtype=np.float32).reshape(4, 6),
                       ctx=ctx)
    dst = [tmx.nd.zeros((2, 6), ctx=ctx, dtype="float64"),
           tmx.nd.zeros((2, 6), ctx=ctx, dtype="float64")]
    batch = tmx.io.DataBatch([src], [src])
    tmx.executor_manager._load_data(
        batch, [[(slice(0, 2), dst[0]), (slice(2, 4), dst[1])]])
    np.testing.assert_array_equal(dst[1].asnumpy(), src.asnumpy()[2:])
    assert dst[1]._data.dtype == dst[0]._data.dtype
    cols = tmx.nd.zeros((4, 3), ctx=ctx)
    tmx.executor_manager._load_label(batch, [[(slice(3, 6), cols)]],
                                     batch_axis=1)
    np.testing.assert_array_equal(cols.asnumpy(), src.asnumpy()[:, 3:])


SCHEDULES = [("PolyScheduler", {"max_update": 20, "base_lr": 0.5, "pwr": 2}),
             ("PolyScheduler", {"max_update": 7, "base_lr": 0.1, "pwr": 1}),
             ("CosineScheduler", {"max_update": 20, "base_lr": 0.5}),
             ("CosineScheduler", {"max_update": 30, "base_lr": 0.2,
                                  "final_lr": 0.01, "warmup_steps": 5})]


@pytest.mark.parametrize("case", SCHEDULES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(SCHEDULES)])
def test_schedules_match_jax_step_by_step(case):
    name, kwargs = case
    t = getattr(tmx.lr_scheduler, name)(**kwargs)
    j = getattr(jmx.lr_scheduler, name)(**kwargs)
    got = [t(n) for n in range(kwargs["max_update"] + 6)]
    ref = [j(n) for n in range(kwargs["max_update"] + 6)]
    np.testing.assert_allclose(got, ref, rtol=1e-15, atol=0)
    assert got[0] == pytest.approx(0.0 if kwargs.get("warmup_steps")
                                   else kwargs["base_lr"])


def test_schedule_drives_an_optimizer():
    sched = tmx.lr_scheduler.PolyScheduler(max_update=4, base_lr=1.0)
    opt = tmx.optimizer.create("sgd", learning_rate=1.0,
                               lr_scheduler=sched)
    w = tmx.nd.array(np.ones(3, np.float32), ctx=tmx.cpu())
    g = tmx.nd.array(np.ones(3, np.float32), ctx=tmx.cpu())
    upd = tmx.optimizer.get_updater(opt)
    for _ in range(4):
        upd(0, g, w)
    # lr at updates 1..4: (3/4)^2, (2/4)^2, (1/4)^2, 0
    np.testing.assert_allclose(w.asnumpy(), 1 - (9 + 4 + 1) / 16.0,
                               rtol=1e-6)


@pytest.mark.parametrize("shape", [(2, 1, 4, 4), (3, 2, 5, 3)])
def test_bilinear_matches_jax_exactly(shape):
    t = tmx.nd.zeros(shape, ctx=tmx.cpu())
    j = jmx.nd.zeros(shape)
    tmx.initializer.Bilinear()("up_weight", t)
    jmx.initializer.Bilinear()("up_weight", j)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    assert t.asnumpy().max() > 0


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (3, 2, 2, 2)])
def test_orthogonal_properties_in_both_packages(shape, rand_type):
    """The flattened (nout, nin) matrix has orthogonal columns (nout >=
    nin) or rows, each of norm ``scale``, in both packages; the port's
    draws follow ``mx.random.seed``."""
    scale = 1.7
    nout, nin = shape[0], int(np.prod(shape[1:]))
    mats = []
    for mx in (jmx, tmx):
        mx.random.seed(3)
        arr = mx.nd.zeros(shape, ctx=mx.cpu())
        mx.initializer.Orthogonal(scale=scale, rand_type=rand_type)(
            "w_weight", arr)
        m = arr.asnumpy().reshape(nout, nin).astype(np.float64)
        gram = m.T @ m if nout >= nin else m @ m.T
        np.testing.assert_allclose(gram, scale ** 2 * np.eye(min(nout, nin)),
                                   atol=1e-5)
        mats.append(m)
    tmx.random.seed(3)
    again = tmx.nd.zeros(shape, ctx=tmx.cpu())
    tmx.initializer.Orthogonal(scale=scale, rand_type=rand_type)(
        "w_weight", again)
    np.testing.assert_array_equal(again.asnumpy().reshape(nout, nin),
                                  mats[1])
