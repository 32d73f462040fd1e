"""The memory mirror mode (``MXNET_BACKWARD_DO_MIRROR=1``,
``SPMDTrainer(remat=True)``) and ``Executor.close`` in the PyTorch port,
on the CPU.

The mirror runs the training forward as ``torch.utils.checkpoint``
segments that the backward recomputes.  Recomputing is the same
arithmetic, so the mirrored gradients equal the plain ones within rtol
1e-6 (``tests/test_executor.py::test_backward_do_mirror_numerics``'s
bound), in the port as in the JAX package, and the port's mirrored
gradients equal the JAX package's within rtol 1e-5 / atol 1e-6.  Further
cases hold the three places the design must get right: a segment boundary
inside a merged ``concat_fuse`` group (the merged body is handed on, not
recomputed in the later segment), BatchNorm's moving statistics updated
once, and Dropout masks that repeat in the recompute; and that the mirror
keeps fewer activation bytes for the backward.  The close cases are
``tests/test_lifecycle.py``'s.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import executor as texec
from mxnet_tpu_torch.kernels import concat_fuse

MIRROR_RTOL = 1e-6


def _mlp(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = mx.sym.Activation(net, act_type="tanh")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _set_mirror(monkeypatch, on, segments=None):
    if on:
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    else:
        monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR", raising=False)
    if segments is None:
        monkeypatch.delenv("MXNET_MIRROR_SEGMENTS", raising=False)
    else:
        monkeypatch.setenv("MXNET_MIRROR_SEGMENTS", str(segments))


def test_backward_do_mirror_numerics(monkeypatch):
    """tests/test_executor.py's case in both packages."""
    def run(mx, mirror):
        _set_mirror(monkeypatch, mirror)
        ex = _mlp(mx).simple_bind(mx.cpu(0), data=(4, 6))
        rs = np.random.RandomState(0)
        for k, v in ex.arg_dict.items():
            v[:] = rs.uniform(-1, 1, v.shape)
        ex.forward(is_train=True)
        ex.backward()
        return {k: g.asnumpy() for k, g in ex.grad_dict.items()}
    res = {}
    for mx in (jmx, tmx):
        with tmx.cpu():
            res[mx] = (run(mx, False), run(mx, True))
    for mx in (jmx, tmx):
        plain, mirrored = res[mx]
        for k in plain:
            np.testing.assert_allclose(mirrored[k], plain[k],
                                       rtol=MIRROR_RTOL, err_msg=k)
    for k in res[jmx][1]:
        np.testing.assert_allclose(res[tmx][1][k], res[jmx][1][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_segments_follow_the_reference_count(monkeypatch):
    net = tmx.models.get_symbol("resnet", num_layers=8, num_classes=4,
                                image_shape=(3, 8, 8))
    n_ops = sum(1 for n in net._nodes() if n.op is not None)
    _set_mirror(monkeypatch, False)
    assert texec.mirror_segments_for(net) == 0
    assert texec.mirror_segments_for(net, force=True) == int(np.sqrt(n_ops))
    _set_mirror(monkeypatch, True, 5)
    assert texec.mirror_segments_for(net) == 5
    assert jmx.executor.mirror_segments_for(
        jmx.models.get_symbol("resnet", num_layers=8, num_classes=4,
                              image_shape=(3, 8, 8))) == 5


def _towers():
    """Two conv -> BN -> relu towers over one input, concatenated: a
    shared-input concat_fuse group, then a conv and a loss."""
    sym = tmx.sym
    data = sym.Variable("data")
    towers = []
    for i, nf in enumerate((4, 6)):
        t = sym.Convolution(data, kernel=(1, 1), num_filter=nf,
                            name="t%d_conv" % i)
        t = sym.BatchNorm(t, fix_gamma=False, name="t%d_bn" % i)
        towers.append(sym.Activation(t, act_type="relu", name="t%d_relu" % i))
    net = sym.Concat(*towers, name="cat")
    net = sym.Convolution(net, kernel=(3, 3), pad=(1, 1), num_filter=3,
                          name="head")
    net = sym.Dropout(net, p=0.3, name="drop")
    return sym.MakeLoss(sym.sum(net * net), name="loss")


def _tower_values(net, rs):
    shapes = net.infer_shape(data=(2, 5, 6, 6))
    args = {n: rs.standard_normal(s).astype(np.float32) * 0.5
            for n, s in zip(net.list_arguments(), shapes[0])}
    aux = {n: (np.ones if "var" in n else np.zeros)(s, np.float32)
           for n, s in zip(net.list_auxiliary_states(), shapes[2])}
    return args, aux


def _train_once(net, args, aux, seed=7):
    with tmx.cpu():
        ex = net.bind(tmx.cpu(), {k: tmx.nd.array(v) for k, v in
                                  args.items()},
                      args_grad={k: tmx.nd.zeros(v.shape) for k, v in
                                 args.items()},
                      aux_states={k: tmx.nd.array(v) for k, v in
                                  aux.items()})
        tmx.random.seed(seed)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        return ex, out, {k: g.asnumpy() for k, g in ex.grad_dict.items()}


def test_boundary_inside_merged_group(monkeypatch):
    """A segment boundary between the two members of a merged group: the
    later member slices the body the earlier segment handed on, so each
    forward computes the body once and the recompute once more; the
    gradients, the loss, the moving statistics (updated once) and the
    Dropout mask all equal the plain run's."""
    net = _towers()
    args, aux = _tower_values(net, np.random.RandomState(1))
    _set_mirror(monkeypatch, False)
    ex0, out0, g0 = _train_once(net, args, aux)
    train_plan = ex0._eval.train_plan
    n_ops = sum(1 for e in train_plan if e[0].op is not None)
    found = None
    for n in range(2, n_ops + 1):
        segs = texec._segments(train_plan, ex0._eval.out_refs, n)
        if any(s.memo_out for s in segs):
            found = n
            break
    assert found, "no segmentation splits the merged group"
    _set_mirror(monkeypatch, True, found)
    concat_fuse.MERGED_BODIES = 0
    ex1, out1, g1 = _train_once(net, args, aux)
    assert concat_fuse.MERGED_BODIES == 2      # the forward's + the recompute
    assert ex1._eval.segments and any(s.memo_out for s in ex1._eval.segments)
    np.testing.assert_allclose(out1, out0, rtol=MIRROR_RTOL)
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=MIRROR_RTOL,
                                   atol=1e-7, err_msg=k)
    for k in aux:
        np.testing.assert_array_equal(ex1.aux_dict[k].asnumpy(),
                                      ex0.aux_dict[k].asnumpy())
        assert not np.array_equal(ex1.aux_dict[k].asnumpy(), aux[k])


@pytest.mark.parametrize("segments", [2, 3, 7])
def test_mirror_keeps_fewer_activation_bytes(monkeypatch, segments):
    """Bytes the training forward saves for the backward, outside the
    checkpointed segments, against the plain forward's; gradients equal
    at every segment count."""
    net = tmx.models.get_symbol("resnet", num_layers=8, num_classes=4,
                                image_shape=(3, 8, 8))
    rs = np.random.RandomState(2)
    shapes = net.infer_shape(data=(2, 3, 8, 8), softmax_label=(2,))
    args = {n: rs.standard_normal(s).astype(np.float32) * 0.3
            for n, s in zip(net.list_arguments(), shapes[0])}
    args["softmax_label"] = np.array([1, 3], np.float32)
    aux = {n: (np.ones if "var" in n else np.zeros)(s, np.float32)
           for n, s in zip(net.list_auxiliary_states(), shapes[2])}

    def run(mirror):
        _set_mirror(monkeypatch, mirror, segments)
        saved = []

        def pack(t):
            saved.append(t.numel() * t.element_size())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            ex, _out, grads = _train_once(net, args, aux)
        return sum(saved), grads
    plain_bytes, g0 = run(False)
    mirror_bytes, g1 = run(True)
    assert mirror_bytes < 0.5 * plain_bytes, (mirror_bytes, plain_bytes)
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=MIRROR_RTOL,
                                   atol=1e-7, err_msg=k)


def test_trainer_remat_steps_match(monkeypatch):
    """SPMDTrainer(remat=True): two steps equal remat=False's (params,
    moving statistics and outputs)."""
    _set_mirror(monkeypatch, False)
    net = tmx.models.get_symbol("resnet", num_layers=8, num_classes=4,
                                image_shape=(3, 8, 8))
    rs = np.random.RandomState(3)
    x = rs.standard_normal((2, 3, 8, 8)).astype(np.float32)
    y = np.array([0, 2], np.float32)
    res = []
    for remat in (False, True):
        with tmx.cpu():
            tmx.random.seed(0)
            tr = tmx.parallel.SPMDTrainer(
                net, "sgd", {"learning_rate": 0.1, "momentum": 0.9,
                             "rescale_grad": 0.5}, ctx=tmx.cpu(),
                remat=remat)
            assert bool(tr._eval.segments) == remat
            tr.bind([("data", x.shape)], [("softmax_label", y.shape)])
            tr.init_params(tmx.initializer.Xavier())
            outs = [tr.step(x, y)[0].numpy() for _ in range(2)]
            args, aux = tr.get_params()
            res.append((outs, {k: v.asnumpy() for k, v in args.items()},
                        {k: v.asnumpy() for k, v in aux.items()}))
    (o0, a0, x0), (o1, a1, x1) = res
    for a, b in zip(o0, o1):
        np.testing.assert_allclose(b, a, rtol=MIRROR_RTOL, atol=1e-7)
    for d0, d1 in ((a0, a1), (x0, x1)):
        for k in d0:
            np.testing.assert_allclose(d1[k], d0[k], rtol=MIRROR_RTOL,
                                       atol=1e-7, err_msg=k)


# -- Executor.close (tests/test_lifecycle.py's cases) -------------------------

def _small_net():
    data = tmx.sym.Variable("data")
    net = tmx.sym.FullyConnected(data, num_hidden=64, name="fc1")
    net = tmx.sym.Activation(net, act_type="relu")
    net = tmx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return tmx.sym.SoftmaxOutput(net, name="softmax")


def test_executor_close_releases_own_buffers_only():
    with tmx.cpu():
        ex = _small_net().simple_bind(tmx.cpu(), data=(8, 32),
                                      grad_req="write")
        ex.arg_dict["data"][:] = np.random.rand(8, 32).astype("f")
        caller = list(ex.arg_dict.values()) + list(ex.grad_dict.values())
        ex.forward(is_train=True)
        ex.backward()
        outs = ex.forward(is_train=True)   # a graph not yet used
        assert ex._graph is not None
        ex.close()
        assert all(o._data.numel() == 0 for o in outs)
        assert ex.arg_dict == {} and ex._outputs is None
        assert ex._graph is None and ex._eval is None
        for a in caller:
            assert np.isfinite(a.asnumpy()).all()
        ex.close()                         # idempotent
        with pytest.raises(tmx.MXNetError, match="closed"):
            ex.forward()


def test_executor_context_manager_and_passthrough_output():
    """``with executor:`` closes it; an output that IS a bound array (an
    identity graph) is the caller's and stays."""
    with tmx.cpu():
        x = tmx.nd.array(np.arange(4, dtype="f"))
        net = tmx.sym.Variable("x")
        with net.bind(tmx.cpu(), {"x": x}) as ex:
            out = ex.forward()[0]
        assert ex._eval is None
        np.testing.assert_allclose(x.asnumpy(), np.arange(4))
        del out


def test_trainer_close_and_context_manager():
    with tmx.cpu():
        t = tmx.parallel.SPMDTrainer(_small_net(), "sgd",
                                     {"learning_rate": 0.1}, ctx=tmx.cpu())
        t.bind([("data", (32, 32))], [("softmax_label", (32,))])
        t.init_params(tmx.initializer.Xavier())
        with t:
            t.step(np.random.rand(32, 32).astype("f"),
                   np.zeros(32, np.float32))
        assert t.params is None and t._eval is None
        t.close()                          # idempotent


def test_module_sequential_lifecycle():
    """Two Modules back to back in one process train, and the first one's
    executor can be closed explicitly."""
    X = np.random.RandomState(0).randn(128, 32).astype("f")
    y = (X.sum(1) > 0).astype("f")
    with tmx.cpu():
        for _ in range(2):
            it = tmx.io.NDArrayIter(X, y, batch_size=32)
            mod = tmx.mod.Module(_small_net(), context=tmx.cpu())
            mod.fit(it, num_epoch=1, optimizer="sgd", kvstore="local",
                    initializer=tmx.initializer.Xavier())
            exe = mod._exec_group.execs[0]
            params = mod.get_params()[0]
            exe.close()
            assert exe._eval is None
            assert all(np.isfinite(v.asnumpy()).all()
                       for v in params.values())
