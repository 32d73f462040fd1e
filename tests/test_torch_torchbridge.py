"""The torch bridge (``mx.torch_bridge.TorchModule``/``TorchCriterion``,
``mx.th``) in the PyTorch port against the JAX package, on the CPU: the 4
cases of ``tests/test_torch_bridge.py`` run in both packages.

The JAX package runs the torch module on the host behind a Custom op; the
port runs it in the graph through ``torch.func.functional_call``, on the
node's device.  Both compute the same float32 torch arithmetic, so
outputs and gradients agree within rtol 1e-5 / atol 1e-6, and 20 manual
SGD steps within rtol 1e-4 / atol 1e-5.  Further cases hold the port's
own contract: no host round trip (``operator.HOST_COUNTS`` stays 0), the
module's buffers move to the node's device and update in training, a
``CrossEntropyLoss`` criterion takes float class labels and its loss
falls, and ``mx.th`` returns an NDArray on its input's context.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6


def _both(fn):
    ref = fn(jmx)
    with tmx.cpu():
        got = fn(tmx)
    return ref, got


def test_th_namespace():
    a_np = np.array([1.0, 2.0, 3.0], "f")
    b_np = np.array([4.0, 5.0, 6.0], "f")

    def run(mx):
        a, b = mx.nd.array(a_np), mx.nd.array(b_np)
        return mx.th.add(a, b).asnumpy(), mx.th.sum(a).asnumpy()
    ref, got = _both(run)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r)
    np.testing.assert_allclose(got[0], [5, 7, 9])


def _linear(seed, n_in, n_out):
    torch.manual_seed(seed)
    return torch.nn.Linear(n_in, n_out)


def test_torch_module_trains():
    rs = np.random.RandomState(0)
    X = rs.randn(8, 10).astype("f")
    y = (X @ rs.randn(10, 4).astype("f")).argmax(1).astype("f")
    init = {"tl_torch_weight": rs.randn(4, 10).astype("f") * 0.1,
            "tl_torch_bias": rs.randn(4).astype("f") * 0.1}

    def run(mx, steps=20):
        net = mx.torch_bridge.TorchModule(_linear(0, 10, 4),
                                          mx.sym.Variable("data"), name="tl")
        net = mx.sym.SoftmaxOutput(net, name="softmax")
        ex = net.simple_bind(mx.cpu(), data=(8, 10), grad_req="write")
        assert sorted(ex.arg_dict) == ["data", "softmax_label",
                                       "tl_torch_bias", "tl_torch_weight"]
        for n, v in init.items():
            ex.arg_dict[n][:] = v
        ex.arg_dict["data"][:] = X
        ex.arg_dict["softmax_label"][:] = y
        for _ in range(steps):
            ex.forward(is_train=True)
            ex.backward()
            for n in init:
                ex.arg_dict[n][:] = ex.arg_dict[n].asnumpy() \
                    - 0.5 * ex.grad_dict[n].asnumpy()
        res = {n: ex.arg_dict[n].asnumpy() for n in init}
        res["out"] = ex.forward()[0].asnumpy()
        return res
    ref, got = _both(run)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    with tmx.cpu():
        out = run(tmx, steps=100)["out"]
    assert (out.argmax(1) == y).mean() > 0.9


def test_torch_module_grad_matches_jax_and_fd():
    rs = np.random.RandomState(1)
    shapes = {"data": (4, 6), "fdl_torch_weight": (3, 6),
              "fdl_torch_bias": (3,)}
    vals = {k: rs.randn(*s).astype("f") * 0.5 for k, s in shapes.items()}

    def run(mx):
        net = mx.torch_bridge.TorchModule(_linear(1, 6, 3),
                                          mx.sym.Variable("data"),
                                          name="fdl")
        net = mx.sym.MakeLoss(mx.sym.sum(net * net))
        ex = net.simple_bind(mx.cpu(), data=(4, 6), grad_req="write")
        for n, arr in ex.arg_dict.items():
            arr[:] = vals[n]
        ex.forward(is_train=True)
        ex.backward()
        return {n: g.asnumpy() for n, g in ex.grad_dict.items()}, ex
    (ref, _), (got, ex) = _both(run)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    # and against finite differences, as the JAX test holds it
    name = "fdl_torch_weight"
    w0 = vals[name].copy()
    eps = 1e-3
    with tmx.cpu():
        for (i, j) in [(0, 0), (2, 5), (1, 3)]:
            loss = []
            for sign in (1, -1):
                w = w0.copy()
                w[i, j] += sign * eps
                ex.arg_dict[name][:] = w
                loss.append(float(ex.forward(is_train=True)[0].asnumpy()))
            np.testing.assert_allclose(got[name][i, j],
                                       (loss[0] - loss[1]) / (2 * eps),
                                       rtol=2e-2, atol=1e-3)


def test_torch_criterion():
    rs = np.random.RandomState(2)
    dv = rs.randn(4, 3).astype("f")
    lv = rs.randn(4, 3).astype("f")

    def run(mx):
        lsym = mx.torch_bridge.TorchCriterion(
            torch.nn.MSELoss(), mx.sym.Variable("d"), mx.sym.Variable("l"))
        ex = lsym.simple_bind(mx.cpu(), d=(4, 3), l=(4, 3),
                              grad_req={"d": "write", "l": "null"})
        ex.arg_dict["d"][:] = dv
        ex.arg_dict["l"][:] = lv
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        return out, ex.grad_dict["d"].asnumpy()
    ref, got = _both(run)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[0], ((dv - lv) ** 2).mean(), rtol=1e-5)
    np.testing.assert_allclose(got[1], 2 * (dv - lv) / 12, rtol=1e-5)


# -- the port's own contract --------------------------------------------------

def test_torch_module_runs_in_graph_without_host_round_trip():
    """The node is autograd inside the executor's graph: no Custom host
    call, and a module with buffers (BatchNorm1d) keeps them on the
    node's device and updates its running mean in training only."""
    from mxnet_tpu_torch import operator as top
    torch.manual_seed(3)
    tmod = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.BatchNorm1d(4))
    rs = np.random.RandomState(3)
    with tmx.cpu():
        net = tmx.torch_bridge.TorchModule(tmod, tmx.sym.Variable("data"),
                                           name="tm")
        net = tmx.sym.MakeLoss(tmx.sym.sum(net * net))
        ex = net.simple_bind(tmx.cpu(), data=(6, 5))
        assert "tm_torch_1_weight" in ex.arg_dict
        for n, arr in ex.arg_dict.items():
            arr[:] = rs.randn(*arr.shape).astype("f")
        before = dict(top.HOST_COUNTS)
        mean0 = tmod[1].running_mean.clone()
        ex.forward(is_train=True)
        ex.backward()
        assert top.HOST_COUNTS == before
        assert not torch.equal(tmod[1].running_mean, mean0)
        assert float(np.abs(ex.grad_dict["tm_torch_0_weight"].asnumpy())
                     .sum()) > 0
        mean1 = tmod[1].running_mean.clone()
        ex.forward(is_train=False)
        assert torch.equal(tmod[1].running_mean, mean1)
        assert tmod.training          # the module's own mode is restored


def test_cross_entropy_criterion_takes_float_labels_and_loss_falls():
    rs = np.random.RandomState(4)
    X = rs.randn(16, 8).astype("f")
    y = rs.randint(0, 5, 16).astype("f")
    with tmx.cpu():
        fc = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=5,
                                    name="fc")
        net = tmx.torch_bridge.TorchCriterion(
            torch.nn.CrossEntropyLoss(), fc, tmx.sym.Variable("label"))
        ex = net.simple_bind(tmx.cpu(), data=(16, 8), label=(16,),
                             grad_req={"fc_weight": "write",
                                       "fc_bias": "write"})
        ex.arg_dict["data"][:] = X
        ex.arg_dict["label"][:] = y
        ex.arg_dict["fc_weight"][:] = rs.randn(5, 8).astype("f") * 0.1
        losses = []
        for _ in range(10):
            losses.append(float(ex.forward(is_train=True)[0].asnumpy()[0]))
            ex.backward()
            for n in ("fc_weight", "fc_bias"):
                ex.arg_dict[n][:] = ex.arg_dict[n].asnumpy() \
                    - 0.5 * ex.grad_dict[n].asnumpy()
    expect = torch.nn.functional.cross_entropy(
        torch.from_numpy(X) @ torch.zeros(8, 5), torch.from_numpy(y).long())
    assert losses[-1] < losses[0] * 0.5, losses
    assert np.isfinite(losses).all() and float(expect) > losses[-1]


def test_th_returns_ndarray_on_input_context():
    with tmx.cpu():
        a = tmx.nd.array(np.arange(4, dtype="f"), ctx=tmx.cpu())
        out = tmx.th.mul(a, 2.0)
        assert isinstance(out, tmx.nd.NDArray)
        assert out.context == tmx.cpu()
        np.testing.assert_allclose(out.asnumpy(), [0, 2, 4, 6])
        assert tmx.th.numel(a) == 4
        with pytest.raises(AttributeError):
            tmx.th.no_such_torch_function
