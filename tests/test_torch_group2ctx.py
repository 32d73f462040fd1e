"""``group2ctx`` model parallelism over several contexts on the port,
against the JAX executor, on the CPU.

``cpu(0)``, ``cpu(1)`` and ``cpu(2)`` are distinct contexts in both
packages (the JAX package's are three virtual host devices; the port's
are one torch device), so a binding over them places each node on its
group's context and runs the plain plan node by node:

- the JAX package's ``tests/test_executor.py`` model-parallel graph over
  ``cpu(0)``/``cpu(1)``: outputs and gradients equal to the JAX
  executor's at rtol 1e-5 / atol 1e-6, the ``dev2`` output carrying
  ``cpu(1)``;
- ``example/model-parallel-lstm/lstm_ctx_group.py``'s graph (loaded by
  ``chip_smoke.load_example`` on the port, as it is on the JAX package)
  at 2 layers, hidden 8, seq 4 over three ``cpu(k)`` groups: 3 steps of
  the example's sgd loop, the softmax outputs and every updated weight
  within rtol 1e-5 / atol 1e-6 of the JAX run;
- a BatchNorm group (aux updates cross the boundary back to the bind
  context) and user head gradients;
- ``MXNET_BACKWARD_DO_MIRROR=1`` is ignored under placement with the
  JAX package's warning."""
import importlib.util
import logging
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
EXAMPLE = "example/model-parallel-lstm/lstm_ctx_group.py"


def _jax_example():
    root = logging.getLogger()
    saved = (root.level, list(root.handlers))
    spec = importlib.util.spec_from_file_location(
        "jax_lstm_ctx_group", os.path.join(REPO, EXAMPLE))
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        root.setLevel(saved[0])
        root.handlers[:] = saved[1]
    return module


def _grouped(mx):
    data = mx.sym.Variable("data")
    with mx.AttrScope(ctx_group="dev1"):
        fc1 = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
        act1 = mx.sym.Activation(fc1, act_type="tanh")
    with mx.AttrScope(ctx_group="dev2"):
        fc2 = mx.sym.FullyConnected(act1, num_hidden=4, name="fc2")
        out = mx.sym.sum(mx.sym.square(fc2))
    return out


def _values(net, **shapes):
    rs = np.random.RandomState(0)
    arg_shapes, _, _ = net.infer_shape(**shapes)
    return {n: rs.uniform(-1, 1, s).astype("f")
            for n, s in zip(net.list_arguments(), arg_shapes)}


def _run_grouped(mx, group2ctx):
    net = _grouped(mx)
    vals = _values(net, data=(3, 5))
    args = {k: mx.nd.array(v, ctx=mx.cpu(0)) for k, v in vals.items()}
    grads = {k: mx.nd.zeros(v.shape, ctx=mx.cpu(0))
             for k, v in vals.items()}
    ex = net.bind(mx.cpu(0), args, args_grad=grads, group2ctx=group2ctx)
    out = ex.forward(is_train=True)[0]
    ex.backward()
    return out, {k: g.asnumpy() for k, g in grads.items()}, ex


def test_model_parallel_graph_matches_jax():
    with tmx.cpu():
        out, grads, ex = _run_grouped(
            tmx, {"dev1": tmx.cpu(0), "dev2": tmx.cpu(1)})
        ref_out, ref_grads, _ = _run_grouped(tmx, None)
    j_out, j_grads, jex = _run_grouped(
        jmx, {"dev1": jmx.cpu(0), "dev2": jmx.cpu(1)})
    assert ex._placement and jex._placement
    assert out.context == tmx.cpu(1)
    np.testing.assert_allclose(out.asnumpy(), j_out.asnumpy(), **TOL)
    np.testing.assert_allclose(out.asnumpy(), ref_out.asnumpy(), **TOL)
    for k in j_grads:
        np.testing.assert_allclose(grads[k], j_grads[k], err_msg=k, **TOL)
        np.testing.assert_allclose(grads[k], ref_grads[k], err_msg=k, **TOL)


def test_placement_maps_each_node_to_its_group():
    with tmx.cpu():
        net = _grouped(tmx)
        ex = net.simple_bind(tmx.cpu(0), data=(3, 5),
                             group2ctx={"dev1": tmx.cpu(0),
                                        "dev2": tmx.cpu(1)})
    by_name = {n.name: ex._placement[id(n)] for n in net._nodes()}
    assert by_name["data"] == tmx.cpu(0)        # no group: the bind ctx
    assert by_name["fc1"] == tmx.cpu(0)
    assert by_name["fc2"] == tmx.cpu(1)
    assert by_name["fc2_weight"] == tmx.cpu(1)
    # every path interprets the plain plan
    assert ex._eval.train_plan is ex._eval.plain_plan
    assert ex._eval.infer_plan is ex._eval.plain_plan
    out = ex.forward(is_train=False, data=np.ones((3, 5), "f"))[0]
    assert out.context == tmx.cpu(1)


def _lstm_run(module, group2ctx, steps=3, layers=2, hidden=8, seq=4,
               vocab=20, batch=3, lr=0.5):
    """The example's training loop (``main`` without its device query)."""
    net = module.build(seq, layers, hidden, vocab)
    ex = net.simple_bind(group2ctx["embed"], group2ctx=group2ctx,
                         data=(batch, seq), softmax_label=(batch, seq))
    rs = np.random.RandomState(0)
    names = sorted(ex.arg_dict)
    init = {k: rs.uniform(-0.08, 0.08, ex.arg_dict[k].shape).astype("f")
            for k in names if k not in ("data", "softmax_label")}
    for k, v in init.items():
        ex.arg_dict[k][:] = v
    toks = rs.randint(1, vocab, size=(batch, seq + 1))
    x, y = toks[:, :-1].astype("f"), toks[:, 1:].astype("f")
    ex.arg_dict["data"][:] = x
    ex.arg_dict["softmax_label"][:] = y
    outs, nll = [], []
    for _ in range(steps):
        out = ex.forward(is_train=True)[0]
        ex.backward()
        for name in init:
            w, g = ex.arg_dict[name], ex.grad_dict[name]
            w._data = w._data - lr / x.size * g._data
        p = out.asnumpy()
        outs.append(p)
        nll.append(-np.log(p[np.arange(p.shape[0]),
                             y.reshape(-1).astype(int)]).mean())
    return ex, outs, {k: ex.arg_dict[k].asnumpy() for k in init}, nll


def test_lstm_ctx_group_example_matches_jax():
    port = chip_smoke.example_modules()["lstm_ctx_group"]
    jax_mod = _jax_example()
    groups = {"embed": 0, "layer0": 1, "layer1": 2, "out": 0}
    with tmx.cpu():
        ex, outs, weights, nll = _lstm_run(
            port, {g: tmx.cpu(k) for g, k in groups.items()})
    jex, j_outs, j_weights, _ = _lstm_run(
        jax_mod, {g: jmx.cpu(k) for g, k in groups.items()})
    assert ex._placement and jex._placement
    assert len({str(c) for c in ex._placement.values()}) == 3
    assert ex.outputs[0].context == tmx.cpu(0)
    for step, (got, want) in enumerate(zip(outs, j_outs)):
        np.testing.assert_allclose(got, want, err_msg="step %d" % step,
                                   **TOL)
    assert set(weights) == set(j_weights)
    for k in j_weights:
        np.testing.assert_allclose(weights[k], j_weights[k], err_msg=k,
                                   **TOL)
    assert nll[-1] < nll[0], nll


def _bn_net(mx):
    data = mx.sym.Variable("data")
    with mx.AttrScope(ctx_group="a"):
        net = mx.sym.FullyConnected(data, num_hidden=6, name="fc1")
        net = mx.sym.BatchNorm(net, name="bn", fix_gamma=False)
    with mx.AttrScope(ctx_group="b"):
        net = mx.sym.FullyConnected(mx.sym.Activation(net, act_type="relu"),
                                    num_hidden=3, name="fc2")
    return net


def _bn_run(mx, group2ctx):
    net = _bn_net(mx)
    ex = net.simple_bind(mx.cpu(0), data=(4, 5), group2ctx=group2ctx)
    rs = np.random.RandomState(1)
    for k in sorted(ex.arg_dict):
        ex.arg_dict[k][:] = rs.uniform(-1, 1, ex.arg_dict[k].shape)
    ex.aux_dict["bn_moving_var"][:] = 1.0
    head = rs.uniform(-1, 1, (4, 3)).astype("f")
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward(out_grads=[mx.nd.array(head, ctx=mx.cpu(0))])
    return (out, {k: g.asnumpy() for k, g in ex.grad_dict.items()},
            {k: a for k, a in ex.aux_dict.items()}, ex)


def test_batchnorm_aux_and_head_gradients_under_placement():
    g2c = {"a": 1, "b": 2}
    with tmx.cpu():
        out, grads, aux, ex = _bn_run(
            tmx, {k: tmx.cpu(v) for k, v in g2c.items()})
    j_out, j_grads, j_aux, _ = _bn_run(
        jmx, {k: jmx.cpu(v) for k, v in g2c.items()})
    assert ex._placement
    np.testing.assert_allclose(out, j_out, **TOL)
    for k in j_grads:
        np.testing.assert_allclose(grads[k], j_grads[k], err_msg=k, **TOL)
    for k in j_aux:
        # the moving statistics stay bound to the executor's context
        assert aux[k].context == tmx.cpu(0)
        np.testing.assert_allclose(aux[k].asnumpy(), j_aux[k].asnumpy(),
                                   err_msg=k, **TOL)


def test_mirror_is_ignored_under_placement(monkeypatch, caplog):
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    g2c = {"dev1": tmx.cpu(0), "dev2": tmx.cpu(1)}
    with caplog.at_level(logging.WARNING):
        with tmx.cpu():
            out, grads, ex = _run_grouped(tmx, g2c)
    assert any("MXNET_BACKWARD_DO_MIRROR ignored: group2ctx placement "
               "runs per-op eagerly" in r.getMessage()
               for r in caplog.records)
    assert ex._eval.segments is None
    monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR")
    with tmx.cpu():
        ref_out, ref_grads, _ = _run_grouped(tmx, g2c)
    np.testing.assert_array_equal(out.asnumpy(), ref_out.asnumpy())
    for k in ref_grads:
        np.testing.assert_array_equal(grads[k], ref_grads[k])


@pytest.mark.parametrize("g2c", [None, {"dev1": 0}, {"dev1": 0, "dev2": 0}])
def test_one_context_binds_a_plain_executor(g2c):
    with tmx.cpu():
        net = _grouped(tmx)
        ex = net.simple_bind(
            tmx.cpu(0), data=(3, 5),
            group2ctx=None if g2c is None else
            {k: tmx.cpu(v) for k, v in g2c.items()})
    assert ex._placement == {}
    assert ex._out_ctx == [tmx.cpu(0)]
