"""``mx.operator`` (CustomOp/CustomOpProp, NumpyOp, ``mx.sym.Custom`` and
``mx.nd.Custom``) in the PyTorch port against the JAX package, on the CPU.

The 7 cases of ``tests/test_operator_custom.py`` run in both packages on
the same numpy inputs; outputs and gradients agree within rtol 1e-5 /
atol 1e-6 (the user's numpy code computes them on the host in both), and
fitted parameters within rtol 1e-4 / atol 1e-5 (float32 training steps
summed in another order).  The examples' own op classes are loaded from
their sources into each package (``example/numpy-ops/numpy_softmax.py``'s
``NumpySoftmax`` MLP trained through ``Module.fit``,
``example/stochastic-depth/sd_module.py``'s gate, ``example/dec/dec.py``'s
``DECLoss``) and held the same way.

Further cases hold the port's own contract: aux states come back as aux
updates, the liveness pass keeps a Custom node that writes aux, the plan
optimizer leaves Custom nodes alone,
integer inputs take no gradient, the Prop cache is keyed by attributes,
and each training step makes one host forward and one host backward,
with ``need_top_grad=False`` head gradients never copied.
"""
import ast
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5


def _ctx(mx):
    return mx.cpu()


def _define(mx):
    """The test file's op classes, registered in ``mx``'s registry."""
    @mx.operator.register("sqr")
    class SqrProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Sqr()

    class Sqr(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])

    @mx.operator.register("scale_by")
    class ScaleProp(mx.operator.CustomOpProp):
        def __init__(self, factor="1"):
            super().__init__(need_top_grad=True)
            self.factor = float(factor)

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            factor = self.factor

            class Scale(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * factor)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * factor)
            return Scale()

    @mx.operator.register("count_calls")
    class CountProp(mx.operator.CustomOpProp):
        """Doubles its input and counts its train forwards in an aux
        state."""

        def list_auxiliary_states(self):
            return ["count"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], [(1,)]

        def create_operator(self, ctx, shapes, dtypes):
            class Count(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * 2)
                    if is_train:
                        aux[0][:] = aux[0] + 1

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * 2)
            return Count()

    @mx.operator.register("pick_rows")
    class PickProp(mx.operator.CustomOpProp):
        """data[idx] with an integer index input."""

        def list_arguments(self):
            return ["data", "idx"]

        def infer_shape(self, in_shape):
            return in_shape, [(in_shape[1][0], in_shape[0][1])], []

        def infer_type(self, in_type):
            return in_type, [in_type[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            class Pick(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    idx = np.asarray(in_data[1]).astype(int)
                    self.assign(out_data[0], req[0], in_data[0][idx])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    g = np.zeros(in_data[0].shape, np.float32)
                    np.add.at(g, np.asarray(in_data[1]).astype(int),
                              np.asarray(out_grad[0]))
                    self.assign(in_grad[0], req[0], g)
            return Pick()


_define(jmx)
_define(tmx)


def _example(mx, relpath, names):
    """Classes and functions ``names`` of an example's source, defined
    against package ``mx`` (a decorated Prop registers itself there)."""
    with open(os.path.join(REPO, relpath)) as f:
        tree = ast.parse(f.read())
    ns = {"mx": mx, "np": np}
    for node in tree.body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)) and \
                node.name in names:
            exec(compile(ast.Module([node], []), relpath, "exec"), ns)
    return ns


def _both(fn):
    """``fn(mx)`` in each package: (JAX result, port result)."""
    ref = fn(jmx)
    with tmx.cpu():
        got = fn(tmx)
    return ref, got


def _close(ref, got, rtol=RTOL, atol=ATOL):
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _bind_run(mx, net, vals, grad_names, out_grads=None, is_train=True,
              aux=None):
    ctx = _ctx(mx)
    args = {k: mx.nd.array(v, ctx=ctx, dtype=v.dtype)
            for k, v in vals.items()}
    grads = {k: mx.nd.zeros(vals[k].shape, ctx=ctx) for k in grad_names}
    req = {k: ("write" if k in grad_names else "null") for k in vals}
    ex = net.bind(ctx, args, args_grad=grads, grad_req=req,
                  aux_states=None if aux is None else
                  {k: mx.nd.array(v, ctx=ctx) for k, v in aux.items()})
    out = ex.forward(is_train=is_train)
    res = {"out%d" % i: o.asnumpy() for i, o in enumerate(out)}
    if is_train:
        ex.backward(None if out_grads is None else
                    [mx.nd.array(g, ctx=ctx) for g in out_grads])
        res.update({"grad_" + k: g.asnumpy() for k, g in grads.items()})
    return res


# -- the 7 cases of tests/test_operator_custom.py ---------------------------

def test_custom_op_imperative():
    x = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    ref, got = _both(lambda mx: mx.nd.Custom(mx.nd.array(x),
                                             op_type="sqr").asnumpy())
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    np.testing.assert_allclose(got, x ** 2)


def test_custom_op_symbolic_forward_backward():
    x = np.random.RandomState(0).uniform(-1, 1, (4, 5)).astype(np.float32)
    g = np.random.RandomState(1).uniform(-1, 1, (4, 5)).astype(np.float32)

    def run(mx):
        y = mx.sym.Custom(mx.sym.Variable("data"), op_type="sqr", name="sqr")
        return _bind_run(mx, y, {"data": x}, ["data"], out_grads=[g])
    ref, got = _both(run)
    _close(ref, got)
    np.testing.assert_allclose(got["grad_data"], 2 * x * g, rtol=1e-6)


def test_custom_op_in_larger_graph():
    x = np.random.RandomState(2).uniform(0.5, 1, (3, 3)).astype(np.float32)

    def run(mx):
        y = mx.sym.Custom(mx.sym.Variable("data") * 2, op_type="sqr")
        return _bind_run(mx, mx.sym.MakeLoss(mx.sym.sum(y)), {"data": x},
                         ["data"])
    ref, got = _both(run)
    _close(ref, got)
    np.testing.assert_allclose(got["grad_data"], 8 * x, rtol=1e-5)


def test_custom_op_with_kwargs():
    ref, got = _both(lambda mx: mx.nd.Custom(
        mx.nd.ones((2, 3)), factor=2.5, op_type="scale_by").asnumpy())
    np.testing.assert_allclose(got, ref)
    np.testing.assert_allclose(got, np.full((2, 3), 2.5))


def test_numpy_op():
    x = np.random.RandomState(3).uniform(-1, 1, (4,)).astype(np.float32)

    def run(mx):
        class NumpySqr(mx.operator.NumpyOp):
            def __init__(self):
                super().__init__(need_top_grad=True)

            def forward(self, in_data, out_data):
                out_data[0][:] = in_data[0] ** 2

            def backward(self, out_grad, in_data, out_data, in_grad):
                in_grad[0][:] = 2 * in_data[0] * out_grad[0]

        y = NumpySqr()(mx.sym.Variable("data"))
        return _bind_run(mx, y, {"data": x}, ["data"],
                         out_grads=[np.ones(4, np.float32)])
    ref, got = _both(run)
    _close(ref, got)
    np.testing.assert_allclose(got["grad_data"], 2 * x, rtol=1e-6)


def _fit_custom_mlp(mx, x, yl, init, num_epoch):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Custom(net, factor=1.0, op_type="scale_by")
    net = mx.sym.FullyConnected(net, num_hidden=2, name="fc2")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    it = mx.io.NDArrayIter(x, yl, batch_size=50, label_name="softmax_label")
    mod = mx.mod.Module(net, data_names=["data"],
                        label_names=["softmax_label"], context=_ctx(mx))
    mod.fit(it, num_epoch=num_epoch, kvstore="local",
            optimizer_params={"learning_rate": 0.5},
            arg_params={k: mx.nd.array(v) for k, v in init.items()})
    score = dict(mod.score(it, mx.metric.Accuracy()))["accuracy"]
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, score


def test_custom_op_module_training(monkeypatch):
    """The Faster R-CNN pattern: a CustomOp in the gradient path of a
    Module.fit loop; both packages fit from the same weights on the same
    batches (no shuffle)."""
    monkeypatch.setenv("MXTPU_METRIC_BLOCKING", "1")
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (200, 10)).astype(np.float32)
    yl = (x @ rs.uniform(-1, 1, (10,)) > 0).astype(np.float32)
    init = {"fc1_weight": rs.uniform(-0.3, 0.3, (8, 10)),
            "fc1_bias": np.zeros(8), "fc2_weight": rs.uniform(-0.3, 0.3,
                                                              (2, 8)),
            "fc2_bias": np.zeros(2)}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    (ref, ref_acc), (got, got_acc) = _both(
        lambda mx: _fit_custom_mlp(mx, x, yl, init, 10))
    _close(ref, got, FIT_RTOL, FIT_ATOL)
    assert got_acc == ref_acc and got_acc > 0.85, (got_acc, ref_acc)


def test_custom_op_sequential_fits():
    """Two Module.fit runs with a CustomOp in one process give the same
    parameters from the same start (no state carried between them)."""
    rs = np.random.RandomState(1)
    x = rs.randn(128, 10).astype(np.float32)
    yl = (x.sum(1) > 0).astype(np.float32)
    init = {"fc1_weight": rs.uniform(-0.3, 0.3, (8, 10)),
            "fc1_bias": np.zeros(8), "fc2_weight": rs.uniform(-0.3, 0.3,
                                                              (2, 8)),
            "fc2_bias": np.zeros(2)}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    with tmx.cpu():
        first = _fit_custom_mlp(tmx, x, yl, init, 2)[0]
        second = _fit_custom_mlp(tmx, x, yl, init, 2)[0]
    for k in first:
        np.testing.assert_array_equal(second[k], first[k], err_msg=k)


# -- the examples' ops --------------------------------------------------------

def _mlp_params(rs):
    shapes = {"fc1_weight": (128, 32), "fc1_bias": (128,),
              "fc2_weight": (64, 128), "fc2_bias": (64,),
              "fc3_weight": (10, 64), "fc3_bias": (10,)}
    return {k: (rs.standard_normal(s) * (0.1 if len(s) > 1 else 0.0))
            .astype(np.float32) for k, s in shapes.items()}


def test_numpy_softmax_mlp_training_matches_jax(monkeypatch):
    """example/numpy-ops: the MLP with ``NumpySoftmax`` as its head,
    trained through Module.fit (sgd, momentum 0.9) from the same weights
    on the example's blobs; the host op computes the head gradient in
    both packages."""
    monkeypatch.setenv("MXTPU_METRIC_BLOCKING", "1")
    path = "example/numpy-ops/numpy_softmax.py"
    rs = np.random.RandomState(4)
    X = rs.standard_normal((256, 32)).astype(np.float32)
    y = rs.randint(0, 10, 256).astype(np.float32)
    init = _mlp_params(rs)

    def run(mx):
        ns = _example(mx, path, ("NumpySoftmax", "build_mlp"))
        mod = mx.mod.Module(ns["build_mlp"](), context=_ctx(mx))
        it = mx.io.NDArrayIter(X, y, batch_size=64)
        mod.fit(it, num_epoch=2, kvstore="local", optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                arg_params={k: mx.nd.array(v) for k, v in init.items()})
        out = mod.predict(mx.io.NDArrayIter(X[:64], y[:64],
                                            batch_size=64)).asnumpy()
        res = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        res["predict"] = out
        return res
    ref, got = _both(run)
    _close(ref, got, FIT_RTOL, FIT_ATOL)
    np.testing.assert_allclose(got["predict"].sum(1), 1.0, rtol=1e-5)


def test_numpy_softmax_head_gradient_equals_softmax_output():
    """``NumpySoftmax``'s backward is SoftmaxOutput's: y - onehot(label)
    (the card phase holds ResNet-50's gradients on this)."""
    path = "example/numpy-ops/numpy_softmax.py"
    rs = np.random.RandomState(5)
    x = rs.standard_normal((16, 32)).astype(np.float32)
    lab = rs.randint(0, 10, 16).astype(np.float32)
    vals = dict(_mlp_params(rs), data=x, softmax_label=lab)
    grads = [k for k in vals if k.startswith("fc")]
    with tmx.cpu():
        ns = _example(tmx, path, ("NumpySoftmax", "build_mlp"))
        custom = _bind_run(tmx, ns["build_mlp"](), vals, grads)
        body = ns["build_mlp"]().get_internals()["fc3_output"]
        plain = _bind_run(tmx, tmx.sym.SoftmaxOutput(body, name="softmax"),
                          vals, grads)
    _close(plain, custom, 1e-5, 1e-7)


def test_stochastic_depth_gate_matches_jax():
    """example/stochastic-depth: the gate CustomOp (its own RandomState,
    train/test mode) inside the residual net; one train step's outputs and
    gradients, and an inference forward, in both packages."""
    path = "example/stochastic-depth/sd_module.py"
    names = ("StochasticGate", "StochasticGateProp", "residual_block",
             "build_net")
    rs = np.random.RandomState(6)

    def run(mx):
        ns = _example(mx, path, names)
        net = ns["build_net"](num_blocks=2, num_filter=4)
        shapes = net.infer_shape(data=(4, 3, 16, 16), softmax_label=(4,))[0]
        vals = {n: (np.random.RandomState(7 + i).standard_normal(s) * 0.2)
                .astype(np.float32)
                for i, (n, s) in enumerate(zip(net.list_arguments(),
                                               shapes))}
        vals["softmax_label"] = np.array([0, 1, 2, 3], np.float32)
        grads = [n for n in vals if n not in ("data", "softmax_label")]
        res = _bind_run(mx, net, vals, grads)
        res.update({"infer_" + k: v for k, v in
                    _bind_run(mx, net, vals, [], is_train=False).items()})
        return res
    ref, got = _both(run)
    _close(ref, got, 1e-5, 1e-6)
    del rs


def test_dec_loss_matches_jax():
    """example/dec: ``DECLoss`` (a need_top_grad=False NumpyOp writing the
    gradients of the embedding and of the centers) over an encoder; one
    train step in both packages."""
    rs = np.random.RandomState(8)
    x = rs.standard_normal((16, 6)).astype(np.float32)
    p = rs.dirichlet(np.ones(3), 16).astype(np.float32)

    def run(mx):
        ns = _example(mx, "example/dec/dec.py", ("DECLoss",))
        z = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                                  name="enc")
        loss = ns["DECLoss"](3, 1.0)(data=z, name="dec")
        vals = {"data": x, "enc_weight": rs_w.copy(),
                "enc_bias": np.zeros(4, np.float32), "dec_mu": mu.copy(),
                "dec_label": p}
        return _bind_run(mx, loss, vals, ["enc_weight", "enc_bias",
                                          "dec_mu"])
    rs_w = (rs.standard_normal((4, 6)) * 0.5).astype(np.float32)
    mu = rs.standard_normal((3, 4)).astype(np.float32)
    ref, got = _both(run)
    _close(ref, got)
    assert np.abs(got["grad_dec_mu"]).sum() > 0


# -- the port's own contract --------------------------------------------------

def test_aux_state_comes_back_as_aux_update():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)

    def run(mx):
        ctx = _ctx(mx)
        y = mx.sym.Custom(mx.sym.Variable("data"), op_type="count_calls",
                          name="cnt")
        args = {"data": mx.nd.array(x, ctx=ctx)}
        ex = y.bind(ctx, args, args_grad={"data": mx.nd.zeros((2, 3),
                                                               ctx=ctx)},
                    aux_states={"cnt_count": mx.nd.zeros((1,), ctx=ctx)})
        for _ in range(3):
            ex.forward(is_train=True)
            ex.backward([mx.nd.ones((2, 3), ctx=ctx)])
        ex.forward(is_train=False)
        return {"count": ex.aux_dict["cnt_count"].asnumpy(),
                "out": ex.outputs[0].asnumpy(),
                "grad": ex.grad_dict["data"].asnumpy()}
    ref, got = _both(run)
    _close(ref, got)
    np.testing.assert_array_equal(got["count"], [3.0])


def test_liveness_keeps_custom_node_that_writes_aux():
    """In training the liveness pass keeps an entry that updates aux state
    even when no output reads it."""
    from mxnet_tpu_torch import executor as texec, mxfuse
    with tmx.cpu():
        data = tmx.sym.Variable("data")
        cnt = tmx.sym.Custom(data, op_type="count_calls", name="cnt")
        main = tmx.sym.FullyConnected(data, num_hidden=2, name="fc")
        sym = tmx.sym.Group([main, cnt])
        plan = texec._node_plan(sym)
        out_refs = [(id(n), i) for n, i in main._outputs]
        train = {e[0].name for e in mxfuse.live_entries(plan, out_refs,
                                                        is_train=True)}
        infer = {e[0].name for e in mxfuse.live_entries(plan, out_refs)}
    assert "cnt" in train and "cnt" not in infer


def test_plan_optimizer_leaves_custom_alone(monkeypatch):
    """conv -> Custom -> BatchNorm -> relu: the bn_act pass must not fuse
    across the Custom node; fused and unfused runs agree exactly."""
    rs = np.random.RandomState(9)
    vals = {"data": rs.standard_normal((2, 3, 6, 6)).astype(np.float32),
            "conv_weight": rs.standard_normal((4, 3, 3, 3))
            .astype(np.float32) * 0.3}
    from mxnet_tpu_torch import executor as texec

    def run(fused):
        monkeypatch.setenv("MXTPU_FUSED_KERNELS", "" if fused else "0")
        if fused:
            monkeypatch.delenv("MXTPU_FUSED_KERNELS")
        with tmx.cpu():
            net = tmx.sym.Convolution(tmx.sym.Variable("data"), kernel=(3, 3),
                                      num_filter=4, no_bias=True, name="conv")
            net = tmx.sym.Custom(net, factor=1.0, op_type="scale_by",
                                 name="gate")
            net = tmx.sym.Activation(tmx.sym.BatchNorm(net, name="bn"),
                                     act_type="relu")
            net = tmx.sym.MakeLoss(tmx.sym.sum(net))
            plan = texec._build_eval(net).plan
            by_name = {e[0].name: e for e in plan}
            # neither the Custom node nor the conv feeding it is rewritten
            assert by_name["gate"][5] is None and by_name["conv"][5] is None
            vals2 = dict(vals, bn_gamma=np.ones(4, np.float32),
                         bn_beta=np.zeros(4, np.float32))
            return _bind_run(tmx, net, vals2, ["data", "conv_weight"],
                             aux={"bn_moving_mean": np.zeros(4, np.float32),
                                  "bn_moving_var": np.ones(4, np.float32)})
    fused, plain = run(True), run(False)
    # BatchNorm -> relu after the Custom node still fuses (bn_act), which
    # reassociates its sums
    _close(plain, fused)


def test_integer_input_takes_no_gradient():
    rs = np.random.RandomState(10)
    x = rs.standard_normal((5, 3)).astype(np.float32)
    idx = np.array([4, 0, 4], np.int32)

    def run(mx):
        data = mx.sym.Variable("data")
        ix = mx.sym.Variable("idx", dtype="int32")
        y = mx.sym.Custom(data, ix, op_type="pick_rows")
        return _bind_run(mx, mx.sym.MakeLoss(mx.sym.sum(y * y)),
                         {"data": x, "idx": idx}, ["data"])
    ref, got = _both(run)
    _close(ref, got)
    expect = np.zeros_like(x)
    np.add.at(expect, idx, 2 * x[idx])
    np.testing.assert_allclose(got["grad_data"], expect, rtol=1e-6)


def test_prop_cache_keyed_by_attributes():
    from mxnet_tpu_torch import operator as top
    a = top._prop_for({"op_type": "scale_by", "factor": 2.0})
    b = top._prop_for({"op_type": "scale_by", "factor": "2.0"})
    c = top._prop_for({"op_type": "scale_by", "factor": 3.0})
    assert a is b and a is not c and c.factor == 3.0
    with pytest.raises(tmx.MXNetError):
        top._prop_for({"op_type": "no_such_custom_op"})


def test_host_round_trips_counted():
    """One host forward and one host backward a training step; with
    ``need_top_grad=False`` the head gradient is not copied to the host,
    and the label takes no gradient back."""
    from mxnet_tpu_torch import operator as top
    path = "example/numpy-ops/numpy_softmax.py"
    rs = np.random.RandomState(11)
    vals = dict(_mlp_params(rs), data=rs.standard_normal((8, 32))
                .astype(np.float32),
                softmax_label=rs.randint(0, 10, 8).astype(np.float32))
    with tmx.cpu():
        ns = _example(tmx, path, ("NumpySoftmax", "build_mlp"))
        net = ns["build_mlp"]()
        for k in top.HOST_COUNTS:
            top.HOST_COUNTS[k] = 0
        _bind_run(tmx, net, vals, [k for k in vals if k.startswith("fc")])
    # forward: logits + label down, probabilities up; backward: nothing
    # down (need_top_grad=False, inputs and outputs kept from the
    # forward), the logits' gradient up
    assert top.HOST_COUNTS == {"forward": 1, "backward": 1,
                               "bytes_to_host": 8 * 10 * 4 + 8 * 4,
                               "bytes_to_device": 2 * 8 * 10 * 4}
