"""The Symbol surface of the PyTorch port against the JAX package's, on the
CPU: ``attr``/``list_attr``/``_set_attr``, ``get_children``, ``grad``,
``eval``, ``var``/``pow``/``maximum``/``minimum``, the comparison
operators, a graph built from Symbol arithmetic (the same JSON, then
forward and backward through ``simple_bind``), a two-output ``topk`` and
a sampling op bound in a graph.

Tolerance: rtol 1e-5 / atol 1e-6 (float32 on both sides, chains of a few
elementwise ops), gradients the same.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

PKGS = {"jax": jmx, "torch": tmx}


def test_attr_list_attr_set_attr():
    for mx in PKGS.values():
        with mx.name.NameManager():
            x = mx.sym.var("x", lr_mult=2.0)
            y = mx.sym.FullyConnected(x, num_hidden=3, name="fc",
                                      attr={"ctx_group": "dev1"})
        assert x.attr("lr_mult") == "2.0"
        assert x.attr("missing") is None
        assert y.attr("num_hidden") == "3"
        assert y.list_attr() == {"num_hidden": "3", "ctx_group": "dev1"}
        y._set_attr(mood="calm")
        assert y.attr("mood") == "calm"
        group = mx.sym.Group([x, y])
        assert group.attr("lr_mult") is None and group.list_attr() == {}


def test_get_children():
    names = {}
    for key, mx in PKGS.items():
        with mx.name.NameManager():
            x = mx.sym.var("x")
            w = mx.sym.var("w")
            y = mx.sym.FullyConnected(x, weight=w, num_hidden=3, name="fc")
            z = mx.sym.relu(y)
        assert x.get_children() is None
        assert mx.sym.Group([x, y]).get_children() is None
        names[key] = (y.get_children().list_outputs(),
                      z.get_children().list_outputs())
    assert names["jax"] == names["torch"]
    assert names["torch"][0] == ["x", "w", "fc_bias"]


def test_grad_is_not_available():
    for mx in PKGS.values():
        with pytest.raises(NotImplementedError):
            mx.sym.var("x").grad(["x"])


def _arith_graph(mx):
    x, y = mx.sym.var("x"), mx.sym.var("y")
    out = (x * y + 2) / (x - 0.5) ** 2
    out = out - 1 / y + mx.sym.pow(y, 3) + mx.sym.pow(x, y)
    out = mx.sym.maximum(out, x) + mx.sym.minimum(0.25, y)
    out = out + mx.sym.maximum(2, x) * mx.sym.minimum(x, y)
    out = out + (x > y) + (x <= 1) * (y == y) + (x != 0.5) - (y >= x) \
        + (x < y)
    return -out


def _inputs():
    rs = np.random.RandomState(0)
    return (rs.uniform(0.6, 2.0, (3, 4)).astype(np.float32),
            rs.uniform(0.6, 2.0, (3, 4)).astype(np.float32))


def test_arithmetic_graph_json_forward_and_backward():
    x, y = _inputs()
    head = np.random.RandomState(1).standard_normal((3, 4)) \
        .astype(np.float32)
    res = {}
    for key, mx in PKGS.items():
        with mx.name.NameManager():
            net = _arith_graph(mx)
        ex = net.simple_bind(mx.cpu(), grad_req="write", x=x.shape,
                             y=y.shape)
        ex.arg_dict["x"][:] = x
        ex.arg_dict["y"][:] = y
        ex.forward(is_train=True)
        ex.backward(out_grads=[mx.nd.array(head, ctx=mx.cpu())])
        res[key] = (net.tojson(), ex.outputs[0].asnumpy(),
                    ex.grad_dict["x"].asnumpy(), ex.grad_dict["y"].asnumpy())
    assert res["jax"][0] == res["torch"][0]
    for j, t in zip(res["jax"][1:], res["torch"][1:]):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_div_rdiv_pow_dispatch_to_the_reference_ops():
    for mx in PKGS.values():
        x = mx.sym.var("x")
        for s, op in ((x / x, "elemwise_div"), (x / 2, "_div_scalar"),
                      (2 / x, "_rdiv_scalar"), (x.__div__(x), "elemwise_div"),
                      (x.__rdiv__(3), "_rdiv_scalar"), (x ** x, "_power"),
                      (x ** 2, "_power_scalar"), (x == x, "broadcast_equal"),
                      (x == 1, "_equal_scalar"), (x + x, "elemwise_add")):
            assert s.tojson().count('"op": "%s"' % op) == 1, op


def test_eval():
    x, y = _inputs()
    outs = {}
    for key, mx in PKGS.items():
        a, b = mx.sym.var("a"), mx.sym.var("b")
        net = mx.sym.Group([a * b + 1, mx.sym.sum(a, axis=1)])
        got = net.eval(ctx=mx.cpu(), a=mx.nd.array(x, ctx=mx.cpu()),
                       b=mx.nd.array(y, ctx=mx.cpu()))
        outs[key] = [o.asnumpy() for o in got]
    assert len(outs["torch"]) == 2
    for j, t in zip(outs["jax"], outs["torch"]):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


def test_topk_both_binds_two_outputs():
    data = np.random.RandomState(2).randint(-3, 4, (4, 9)) \
        .astype(np.float32)
    outs = {}
    for key, mx in PKGS.items():
        net = mx.sym.topk(mx.sym.var("d"), k=3, ret_typ="both")
        assert len(net.list_outputs()) == 2
        ex = net.simple_bind(mx.cpu(), grad_req="null", d=data.shape)
        ex.arg_dict["d"][:] = data
        outs[key] = [o.asnumpy() for o in ex.forward()]
    for j, t in zip(outs["jax"], outs["torch"]):
        np.testing.assert_array_equal(t, j)


def test_sampling_op_in_a_graph_draws_anew_each_forward():
    mx = tmx
    x = mx.sym.var("x")
    net = x + mx.sym.uniform(low=0, high=1, shape=(2, 3)) + \
        mx.sym.normal(shape=(2, 3))
    ex = net.simple_bind(mx.cpu(), grad_req="write", x=(2, 3))
    mx.random.seed(5)
    first = ex.forward(is_train=True)[0].asnumpy()
    ex.backward(out_grads=[mx.nd.ones((2, 3), ctx=mx.cpu())])
    np.testing.assert_array_equal(ex.grad_dict["x"].asnumpy(),
                                  np.ones((2, 3)))
    second = ex.forward()[0].asnumpy()
    assert not np.array_equal(first, second)
    mx.random.seed(5)
    np.testing.assert_array_equal(ex.forward(is_train=True)[0].asnumpy(),
                                  first)
    # shape inference of the input-less nodes
    _, out_shapes, _ = net.infer_shape(x=(2, 3))
    assert out_shapes == [(2, 3)]
    zeros = mx.sym.zeros(shape=(2, 2)) + mx.sym.var("z")
    ex = zeros.simple_bind(mx.cpu(), z=(2, 2))
    np.testing.assert_array_equal(ex.forward()[0].asnumpy(), np.zeros((2, 2)))
