"""``mx.mon.Monitor`` and ``Executor.set_monitor_callback`` in the PyTorch
port against the JAX package, on the CPU: the monitor cases of
``tests/test_monitor_profiler_viz.py`` run in both packages.

The tests compare the statistics' names and values (``Monitor.queue``
before ``toc``), not the printed strings: the tap names must be equal and
in the same order, the values within rtol 1e-5 / atol 1e-6 (float32, the
plain plan in both).  Further cases hold the install points (Module on
both kvstore routes, the executor manager, ``FeedForward.fit``,
``install_step_guard`` on an SPMDTrainer), ``monitor_all``, and that a
monitored forward gives the unmonitored outputs (within 1e-6 x max
|output|: the plain plan against the fused one) and the same gradients
(rtol 1e-4 / atol 1e-6: the plain BatchNorm against the fused bn_act).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6


def _mlp(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _params(rs):
    return {"fc1_weight": rs.uniform(-0.3, 0.3, (16, 10)),
            "fc1_bias": rs.uniform(-0.1, 0.1, (16,)),
            "fc2_weight": rs.uniform(-0.3, 0.3, (4, 16)),
            "fc2_bias": rs.uniform(-0.1, 0.1, (4,))}


def _values(queue):
    """(step, name, float) rows of a Monitor queue."""
    out = []
    for step, name, v in queue:
        v = v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)
        out.append((step, name, float(np.asarray(v).reshape(-1)[0])))
    return out


def _same_rows(ref, got):
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in ref]
    np.testing.assert_allclose([v for *_r, v in got], [v for *_r, v in ref],
                               rtol=RTOL, atol=ATOL)


def _norm_stat(mx):
    def norm_stat(d):       # example/python-howto/monitor_weights.py's
        return mx.nd.norm(d) / np.sqrt(d.size)
    return norm_stat


def _both(fn):
    ref = fn(jmx)
    with tmx.cpu():
        got = fn(tmx)
    return ref, got


def test_monitor_collects_stats():
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (8, 10)).astype(np.float32)
    params = {k: v.astype(np.float32) for k, v in _params(rs).items()}

    def run(mx):
        ex = _mlp(mx).simple_bind(mx.cpu(), data=(8, 10),
                                  softmax_label=(8,))
        for k, v in params.items():
            ex.arg_dict[k][:] = v
        mon = mx.Monitor(interval=1, pattern=".*fc.*")
        mon.install(ex)
        mon.tic()
        ex.forward(is_train=True, data=x)
        rows = _values(mon.queue)
        res = mon.toc()
        assert [n for _s, n, _v in res] == [n for _s, n, _v in rows]
        mon2 = mx.Monitor(interval=2)
        mon2.install(ex)
        mon2.tic()
        ex.forward(is_train=False)
        first = mon2.toc()
        mon2.tic()
        ex.forward(is_train=False)
        second = mon2.toc()
        return rows, bool(first), bool(second)
    (ref, rf, rs2), (got, gf, gs2) = _both(run)
    _same_rows(ref, got)
    names = [n for _s, n, _v in got]
    assert names == ["fc1_output", "fc2_output"]
    assert (gf, gs2) == (rf, rs2) == (True, False)


def test_monitor_all_taps_args_and_aux_first():
    rs = np.random.RandomState(1)
    x = rs.uniform(-1, 1, (4, 10)).astype(np.float32)
    params = {k: v.astype(np.float32) for k, v in _params(rs).items()}

    def run(mx):
        ex = _mlp(mx).simple_bind(mx.cpu(), data=(4, 10),
                                  softmax_label=(4,))
        for k, v in params.items():
            ex.arg_dict[k][:] = v
        mon = mx.Monitor(interval=1, stat_func=_norm_stat(mx),
                         monitor_all=True)
        mon.install(ex)
        mon.tic()
        ex.forward(is_train=False, data=x)
        rows = _values(mon.queue)
        mon.toc()
        return rows
    ref, got = _both(run)
    _same_rows(ref, got)
    names = [n for _s, n, _v in got]
    assert names[:6] == ["data", "fc1_weight", "fc1_bias", "fc2_weight",
                         "fc2_bias", "softmax_label"]
    assert names[6:] == ["fc1_output", "relu1_output", "fc2_output",
                         "softmax_output"]


def test_monitor_in_module_fit(monkeypatch):
    """Module.fit(monitor=) on the executor route, every batch sampled,
    from the same weights over the same batches in both packages."""
    monkeypatch.setenv("MXTPU_METRIC_BLOCKING", "1")
    rs = np.random.RandomState(2)
    x = rs.uniform(-1, 1, (40, 10)).astype(np.float32)
    y = rs.randint(0, 4, (40,)).astype(np.float32)
    params = {k: v.astype(np.float32) for k, v in _params(rs).items()}

    def run(mx):
        it = mx.io.NDArrayIter(x, y, batch_size=20,
                               label_name="softmax_label")
        mod = mx.mod.Module(_mlp(mx), label_names=["softmax_label"],
                            context=mx.cpu())
        rows = []
        mon = mx.Monitor(interval=1, stat_func=_norm_stat(mx),
                         pattern=".*output")
        toc = mon.toc

        def record():
            rows.extend(_values(mon.queue))
            return toc()
        mon.toc = record
        mod.fit(it, num_epoch=2, monitor=mon, kvstore="local",
                arg_params={k: mx.nd.array(v) for k, v in params.items()},
                optimizer_params={"learning_rate": 0.1})
        return rows
    ref, got = _both(run)
    _same_rows(ref, got)
    assert len(got) == 4 * 4     # 4 batches x 4 tapped outputs


def test_monitored_forward_matches_unmonitored():
    """The tapped (plain) forward gives the fused forward's outputs, and a
    training step's gradients are the untapped step's."""
    rs = np.random.RandomState(3)
    with tmx.cpu():
        net = tmx.models.get_symbol("resnet", num_layers=8, num_classes=4,
                                    image_shape=(3, 8, 8))
        ex = net.simple_bind(tmx.cpu(), data=(2, 3, 8, 8),
                             softmax_label=(2,))
        for k, v in ex.arg_dict.items():
            if k != "softmax_label":
                v[:] = rs.standard_normal(v.shape).astype("f") * 0.3
        for k, v in ex.aux_dict.items():
            v[:] = (np.ones if "var" in k else np.zeros)(v.shape, "f")
        plain = ex.forward(is_train=False)[0].asnumpy()
        ex.forward(is_train=True)
        ex.backward()
        grads = {k: g.asnumpy() for k, g in ex.grad_dict.items()}
        names = []
        ex.set_monitor_callback(lambda n, a: names.append(n))
        for k, v in ex.aux_dict.items():    # undo the first step's update
            v[:] = (np.ones if "var" in k else np.zeros)(v.shape, "f")
        tapped = ex.forward(is_train=False)[0].asnumpy()
        ex.forward(is_train=True)
        ex.backward()
        tapped_grads = {k: g.asnumpy() for k, g in ex.grad_dict.items()}
    np.testing.assert_allclose(tapped, plain, rtol=0,
                               atol=1e-6 * np.abs(plain).max())
    for k in grads:
        np.testing.assert_allclose(tapped_grads[k], grads[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    n_ops = sum(1 for node in net._nodes() if node.op is not None)
    assert len(names) == 2 * n_ops      # every node of the plain plan


def test_install_points():
    """Module on the 'tpu' kvstore keeps the executor route when a monitor
    is installed (fit installs it before init_optimizer) and refuses one
    after; the executor manager and FeedForward.fit install theirs."""
    rs = np.random.RandomState(4)
    x = rs.uniform(-1, 1, (20, 10)).astype(np.float32)
    y = rs.randint(0, 4, (20,)).astype(np.float32)
    with tmx.cpu():
        it = tmx.io.NDArrayIter(x, y, batch_size=10)
        mon = tmx.mon.Monitor(1)
        mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
        mod.fit(it, num_epoch=1, kvstore="tpu", monitor=mon)
        assert mod._fused is None and mon.exes
        fused = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
        fused.fit(it, num_epoch=1, kvstore="tpu")
        assert fused._fused is not None
        with pytest.raises(tmx.MXNetError, match="Monitor taps"):
            fused.install_monitor(tmx.mon.Monitor(1))
        from mxnet_tpu_torch.executor_manager import \
            DataParallelExecutorManager
        it.reset()
        net = _mlp(tmx)
        names = net.list_arguments()
        mgr = DataParallelExecutorManager(
            net, [tmx.cpu()], it, names,
            [n for n in names if n not in ("data", "softmax_label")],
            net.list_auxiliary_states())
        mon2 = tmx.mon.Monitor(1)
        mgr.install_monitor(mon2)
        assert mon2.exes == mgr.execgrp.execs
        mon3 = tmx.mon.Monitor(1, pattern="fc2.*")
        ff = tmx.model.FeedForward(_mlp(tmx), ctx=tmx.cpu(), num_epoch=1,
                                   numpy_batch_size=10,
                                   initializer=tmx.initializer.Xavier())
        ff.fit(x, y, monitor=mon3)
        assert mon3.exes and mon3.step == 2


def test_step_guard_rows():
    """install_step_guard reports the SPMDTrainer's guard counters."""
    with tmx.cpu():
        tr = tmx.parallel.SPMDTrainer(_mlp(tmx), "sgd",
                                      {"learning_rate": 0.1},
                                      ctx=tmx.cpu())
        tr.bind([("data", (4, 10))], [("softmax_label", (4,))])
        tr.init_params(tmx.initializer.Xavier())
        x = np.full((4, 10), np.nan, np.float32)
        tr.step(x, np.zeros(4, np.float32))
        mon = tmx.mon.Monitor(1)
        mon.install_step_guard(tr)
        mon.tic()
        rows = {k: v for _s, k, v in mon.toc()}
    assert rows == {"step_guard_skipped": "1.0",
                    "step_guard_consecutive_bad": "1.0"}
