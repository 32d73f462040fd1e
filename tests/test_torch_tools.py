"""The port's tools (``profiler``, ``contrib/flops``,
``contrib/tensorboard``, ``visualization``, ``test_utils``,
``notebook``, ``libinfo``) against the JAX package's, on the CPU.

- ``model_flops``: equal counts (exact integers) for ResNet-50 at 224,
  Inception-BN, the LSTM LM and the standard MLP.
- ``print_summary``: identical text and totals for ResNet-50 and
  Inception-BN.
- TensorBoard: identical event-file bytes and names for the same scalars
  with the clock patched.
- ``test_utils``: the oracles give the same answers in both packages on
  the same inputs; ``check_consistency`` runs forward and backward.
- The profiler: on the CPU ``get_op_stats`` names ``conv1`` and
  ``_backward_conv1`` with times above 0 (the CPU form of
  ``tests/test_monitor_profiler_viz.py::test_per_op_stats_over_fused_program``,
  which the JAX package skips on the CPU); ``fit`` with
  ``MXTPU_PROFILE_DIR`` writes a trace of its steps 10-15.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.contrib.flops as jflops
import mxnet_tpu.contrib.tensorboard as jtb
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.contrib.flops as tflops
import mxnet_tpu_torch.contrib.tensorboard as ttb
from mxnet_tpu_torch import profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()


def _models(mx):
    """(name, symbol, input shapes) of the four counted models, built
    under a fresh name manager so auto-names match across packages."""
    out = []
    with mx.name.NameManager():
        out.append(("resnet-50", mx.models.get_symbol(
            "resnet", num_layers=50, num_classes=1000,
            image_shape=(3, 224, 224)), {"data": (32, 3, 224, 224)}))
    with mx.name.NameManager():
        out.append(("inception-bn", mx.models.get_symbol(
            "inception-bn", num_classes=1000),
            {"data": (8, 3, 224, 224)}))
    with mx.name.NameManager():
        lm, _, _ = mx.models.lstm_lm.lstm_lm_sym(35, 10000, 200, 200, 2)
        out.append(("lstm-lm", lm, {"data": (32, 35),
                                    "softmax_label": (32, 35)}))
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(data, num_hidden=64, name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
        out.append(("mlp", mx.sym.SoftmaxOutput(net, name="softmax"),
                    {"data": (64, 32)}))
    return out


@pytest.mark.parametrize("index", range(4))
def test_model_flops_equal(index):
    jname, jsym, shapes = _models(jmx)[index]
    tname, tsym, _ = _models(tmx)[index]
    assert jname == tname
    want = jflops.model_flops(jsym, **shapes)
    got = tflops.model_flops(tsym, **shapes)
    assert isinstance(got, int) and got == want and got > 0
    if tname == "resnet-50":
        # about 4.1 GFLOP a 224x224 image forward (2 FLOPs a MAC)
        assert 7.5e9 < got / 32 < 8.5e9


@pytest.mark.parametrize("index", range(2))
def test_print_summary_identical(index, capsys):
    _, jsym, shapes = _models(jmx)[index]
    _, tsym, _ = _models(tmx)[index]
    jtotal = jmx.viz.print_summary(jsym, shape=shapes)
    jtext = capsys.readouterr().out
    ttotal = tmx.viz.print_summary(tsym, shape=shapes)
    ttext = capsys.readouterr().out
    assert ttotal == jtotal and ttotal > 0
    assert ttext == jtext
    assert "Total params: %d" % ttotal in ttext


def test_plot_network_builds_a_digraph():
    pytest.importorskip("graphviz")
    _, sym, shapes = _models(tmx)[3]
    dot = tmx.viz.plot_network(sym, shape=shapes)
    assert "fc1" in dot.source and "softmax" in dot.source


def test_tensorboard_event_bytes_identical(tmp_path, monkeypatch):
    import time
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    files = []
    for tb, mx, ctx in ((jtb, jmx, jmx.cpu()), (ttb, tmx, CPU)):
        d = tmp_path / tb.__name__.split(".")[0]
        cb = tb.LogMetricsCallback(str(d), prefix="train")
        metric = mx.metric.Accuracy()
        metric.update([mx.nd.array(np.array([0, 1, 1], "f"), ctx=ctx)],
                      [mx.nd.array(np.eye(3, 2, dtype="f"), ctx=ctx)])

        class Param(object):
            eval_metric = metric
            epoch = 0
            nbatch = 3
        for _ in range(3):
            cb(Param)
        cb.summary_writer.add_scalar("loss", -0.5, global_step=-1)
        cb.summary_writer.close()
        name, = os.listdir(str(d))
        files.append((name, (d / name).read_bytes()))
    assert files[0] == files[1]
    assert len(files[1][1]) > 100


def _fc_sym(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    return mx.sym.Activation(net, act_type="tanh", name="act")


def test_test_utils_oracles_agree():
    rs = np.random.RandomState(5)
    loc = {"data": rs.standard_normal((4, 5)).astype("f"),
           "fc_weight": rs.standard_normal((3, 5)).astype("f"),
           "fc_bias": rs.standard_normal(3).astype("f")}
    head = rs.standard_normal((4, 3)).astype("f")
    fwd = np.tanh(loc["data"] @ loc["fc_weight"].T + loc["fc_bias"])
    res = {}
    for mx, ctx in ((jmx, jmx.cpu()), (tmx, CPU)):
        tu = mx.test_utils
        res[mx.__name__] = (
            tu.check_symbolic_forward(_fc_sym(mx), loc, [fwd], ctx=ctx),
            tu.check_symbolic_backward(
                _fc_sym(mx), loc, [head],
                {"fc_bias": ((1 - fwd ** 2) * head).sum(0)}, ctx=ctx),
            tu.simple_forward(_fc_sym(mx), ctx=ctx, **loc))
        tu.check_numeric_gradient(_fc_sym(mx), loc, ctx=ctx,
                                  numeric_eps=1e-2, rtol=5e-2, atol=5e-3)
    (jf, jb, js), (tf, tb, ts) = res["mxnet_tpu"], res["mxnet_tpu_torch"]
    np.testing.assert_allclose(tf[0], jf[0], rtol=1e-5, atol=1e-6)
    for k in jb:
        np.testing.assert_allclose(tb[k], jb[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)


def test_check_consistency_runs_forward_and_backward():
    data = tmx.sym.Variable("data")
    net = tmx.sym.Convolution(data, num_filter=4, kernel=(3, 3),
                              pad=(1, 1), name="conv")
    net = tmx.sym.BatchNorm(net, name="bn")
    net = tmx.sym.Activation(net, act_type="relu", name="relu")
    shapes = {"data": (2, 3, 6, 6)}
    for is_train in (False, True):
        outs = tmx.test_utils.check_consistency(
            net, [CPU, {"ctx": tmx.cpu(1), "shapes": shapes}],
            shapes=shapes, is_train=is_train)
        assert len(outs) == 2 and outs[0][0].shape == (2, 4, 6, 6)


def test_default_context_honours_the_env(monkeypatch):
    monkeypatch.setenv("MXNET_TEST_DEVICE", "cpu:0")
    assert tmx.test_utils.default_context() == CPU
    monkeypatch.delenv("MXNET_TEST_DEVICE")
    assert tmx.test_utils.default_context() == tmx.current_context()


def _conv_net(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3),
                             pad=(1, 1), name="conv1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=10,
                                name="fc1")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def test_per_op_stats_name_forward_and_backward_nodes(tmp_path):
    rs = np.random.RandomState(0)
    it = tmx.io.NDArrayIter(rs.rand(64, 3, 16, 16).astype("f"),
                            rs.randint(0, 10, 64).astype("f"),
                            batch_size=32)
    mod = tmx.mod.Module(_conv_net(tmx), context=CPU)
    profiler.profiler_set_config(
        mode="all_xla", filename=str(tmp_path / "prof.json"),
        trace_dir=str(tmp_path / "trace"))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=tmx.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd")
    b = next(iter(it))
    mod.forward_backward(b)
    mod.update()
    profiler.profiler_set_state("run")
    try:
        for _ in range(3):
            mod.forward_backward(b)
            mod.update()
    finally:
        profiler.profiler_set_state("stop")
    assert not tmx.executor._NODE_RANGES[0]
    stats = profiler.get_op_stats()
    for name in ("conv1", "_backward_conv1", "fc1", "_backward_fc1"):
        assert name in stats, sorted(stats)
        # one range a forward; one or more backward nodes a node
        assert stats[name]["count"] % 3 == 0, (name, stats[name])
        assert stats[name]["total_us"] > 0
    assert stats["conv1"]["count"] == 3
    table = profiler.dumps()
    assert "conv1" in table and "_backward_conv1" in table
    assert table.startswith("Profile Statistics")
    # the host engine's trace dumps too
    assert profiler.dump_profile() == str(tmp_path / "prof.json")
    assert "traceEvents" in json.load(open(str(tmp_path / "prof.json")))


def test_fit_with_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_PROFILE_DIR", str(tmp_path / "fit"))
    rs = np.random.RandomState(1)
    it = tmx.io.NDArrayIter(rs.rand(64, 3, 8, 8).astype("f"),
                            rs.randint(0, 10, 64).astype("f"),
                            batch_size=4)
    mod = tmx.mod.Module(_conv_net(tmx), context=CPU)
    mod.fit(it, num_epoch=2, optimizer_params={"learning_rate": 0.01})
    traces = os.listdir(str(tmp_path / "fit"))
    assert len(traces) == 1 and traces[0].startswith(profiler.TRACE_PREFIX)
    stats = profiler.get_op_stats(str(tmp_path / "fit"))
    # steps 10-15 of the first epoch: six forwards of conv1
    assert stats["conv1"]["count"] == 6, stats["conv1"]
    assert stats["_backward_conv1"]["count"] % 6 == 0
    assert not tmx.executor._NODE_RANGES[0]


def test_profiler_modes_and_errors(tmp_path):
    with pytest.raises(tmx.MXNetError, match="mode"):
        profiler.profiler_set_config(mode="nope")
    with pytest.raises(tmx.MXNetError, match="state"):
        profiler.profiler_set_state("paused")
    with pytest.raises(tmx.MXNetError, match="no device trace"):
        profiler.get_op_stats(str(tmp_path))
    assert tmx.profiler_set_state is profiler.profiler_set_state
    assert tmx.dump_profile is profiler.dump_profile


def test_notebook_logger_collects_fit_frames():
    pytest.importorskip("pandas")
    from mxnet_tpu_torch.notebook import callback
    rs = np.random.RandomState(2)
    it = tmx.io.NDArrayIter(rs.rand(32, 6).astype("f"),
                            rs.randint(0, 3, 32).astype("f"), batch_size=8)
    data = tmx.sym.Variable("data")
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        data, num_hidden=3, name="fc"), name="softmax")
    logger = callback.PandasLogger(batch_size=8, frequent=2)
    mod = tmx.mod.Module(net, context=CPU)
    mod.fit(it, eval_data=it, num_epoch=2, **logger.callback_args())
    assert len(logger.train_df) == 4 and len(logger.eval_df) == 2
    assert len(logger.epoch_df) == 2
    assert "accuracy" in logger.train_df.columns


def test_notebook_imports_no_plotting_stack():
    code = ("import sys\n"
            "import mxnet_tpu_torch.notebook\n"
            "bad = [m for m in ('pandas', 'matplotlib', 'IPython')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_libinfo_finds_the_native_library():
    paths = tmx.libinfo.find_lib_path()
    assert paths and all(os.path.exists(p) for p in paths)
    assert any("libmxt_native" in os.path.basename(p) for p in paths)
