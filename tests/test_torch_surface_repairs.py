"""Repairs of the port's surface against the JAX package, on the CPU:
``group2ctx`` onto one context and ``shared_exec`` on ``bind``/
``simple_bind`` (``group2ctx`` over several contexts is
``tests/test_torch_group2ctx.py``'s), the public
top-level names, ``Executor.debug_str``, the one-process ``KVStore``
trivia and ``DataParallelExecutorGroup``'s ``state_names``/``reshape``.

Outputs compare exactly (the same executor either way); ``debug_str``
compares as text.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: top-level names of the JAX package the port does not have yet, each
#: with the ROADMAP queue 1 item that brings it (``distributed`` came
#: with item 4's data-parallel half: none is left)
LATER = {}


def _public_names():
    """Each package's public top-level names right after its import, in a
    fresh process (a test process's other imports add submodules)."""
    code = ("import json, mxnet_tpu as j, mxnet_tpu_torch as t\n"
            "print(json.dumps([sorted(n for n in dir(m) if not "
            "n.startswith('_')) for m in (j, t)]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-2000:]
    jax_names, port_names = json.loads(res.stdout.splitlines()[-1])
    return set(jax_names), set(port_names)


def test_public_names_match_jax_but_later_slices():
    jax_names, port_names = _public_names()
    missing = jax_names - port_names
    assert missing == set(LATER), sorted(missing ^ set(LATER))
    for name in ("AttrScope", "FeedForward", "rnd", "init_registry",
                 "operator", "autograd", "monitor", "mon", "Monitor",
                 "torch_bridge", "th", "tpu", "num_tpus", "recordio",
                 "image", "img", "image_det", "dataflow",
                 "DevicePrefetchIter", "engine", "native", "resilience",
                 "data_service", "CheckpointManager", "PreemptionHandler",
                 "StepWatchdog", "serving", "fleet", "analysis",
                 "profiler", "profiler_set_config", "profiler_set_state",
                 "dump_profile", "visualization", "viz", "test_utils",
                 "libinfo"):
        assert hasattr(tmx, name), name
    assert tmx.rnd is tmx.random and tmx.mon is tmx.monitor
    assert tmx.img is tmx.image
    assert tmx.io.ImageRecordIter is tmx.image.ImageRecordIter
    assert tmx.contrib.autograd.mark_variables is \
        tmx.autograd.mark_variables
    assert hasattr(tmx.sym, "Custom") and hasattr(tmx.nd, "Custom")
    # the data-service slice's names, as the JAX package exports them
    assert tmx.data_service.__all__ == jmx.data_service.__all__
    for name in jmx.data_service.__all__:
        assert hasattr(tmx.data_service, name), name
    from mxnet_tpu.data_service import net as jnet
    from mxnet_tpu_torch.data_service import net as tnet
    assert tnet.__all__ == jnet.__all__
    # the serving slice's names, as the JAX package exports them
    assert tmx.serving.__all__ == jmx.serving.__all__
    for name in ("ModelPool", "ServingFrontend"):
        assert getattr(tmx.serving, name).__name__ == name
    assert tmx.kernels.augment.DeviceAugment.__name__ == "DeviceAugment"
    assert "augment" in tmx.kernels.__all__


def _grouped_net(mx):
    data = mx.sym.Variable("data")
    with mx.AttrScope(ctx_group="dev1"):
        fc1 = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
        act1 = mx.sym.Activation(fc1, act_type="tanh")
    with mx.AttrScope(ctx_group="dev2"):
        fc2 = mx.sym.FullyConnected(act1, num_hidden=4, name="fc2")
        out = mx.sym.sum(mx.sym.square(fc2))
    return out


def test_group2ctx_one_device_binds_a_plain_executor():
    """tests/test_executor.py:223-230, on bind and simple_bind; the
    results equal the bind without a map."""
    rs = np.random.RandomState(0)
    with tmx.cpu():
        net = _grouped_net(tmx)
        assert net.attr_dict()["fc1"]["ctx_group"] == "dev1"
        shapes = net.infer_shape(data=(3, 5))[0]
        vals = {n: rs.uniform(-1, 1, s).astype("f")
                for n, s in zip(net.list_arguments(), shapes)}
        res = []
        for g2c in (None, {"dev1": tmx.cpu(0), "dev2": tmx.cpu(0)}):
            args = {k: tmx.nd.array(v) for k, v in vals.items()}
            grads = {k: tmx.nd.zeros(v.shape) for k, v in vals.items()}
            ex = net.bind(tmx.cpu(), args, args_grad=grads, group2ctx=g2c)
            assert ex._placement == {}
            out = ex.forward(is_train=True)[0].asnumpy()
            ex.backward()
            res.append((out, {k: g.asnumpy() for k, g in grads.items()}))
        np.testing.assert_array_equal(res[1][0], res[0][0])
        for k in vals:
            np.testing.assert_array_equal(res[1][1][k], res[0][1][k])
        ex = net.simple_bind(tmx.cpu(0), data=(3, 5),
                             group2ctx={"dev1": tmx.cpu(0)})
        assert not ex._placement
        assert sorted(ex.arg_dict) == sorted(vals)
        ex2 = net.simple_bind(tmx.cpu(), data=(3, 5), shared_exec=ex)
        assert sorted(ex2.arg_dict) == sorted(vals)
    jex = _grouped_net(jmx).simple_bind(jmx.cpu(0), data=(3, 5),
                                        group2ctx={"dev1": jmx.cpu(0)})
    assert not jex._placement


def test_debug_str_matches_jax():
    def build(mx):
        data = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(data, num_hidden=4, name="fc")
        return mx.sym.SoftmaxOutput(mx.sym.Activation(
            net, act_type="relu", name="relu"), name="softmax")
    with tmx.cpu():
        got = build(tmx).simple_bind(tmx.cpu(), data=(2, 3)).debug_str()
    ref = build(jmx).simple_bind(jmx.cpu(), data=(2, 3)).debug_str()
    assert got == ref


def test_kvstore_one_process_trivia():
    for mx in (jmx, tmx):
        kv = mx.kv.create("local")
        assert kv.barrier() is None
        assert kv.get_num_dead_node(0) == 0
        assert kv.is_recovery is False


def test_executor_group_state_names_and_reshape_flag():
    from mxnet_tpu_torch.module.executor_group import \
        DataParallelExecutorGroup
    with tmx.cpu():
        data = tmx.sym.Variable("data")
        state = tmx.sym.Variable("state")
        net = tmx.sym.FullyConnected(data, num_hidden=3, name="fc") + state
        grp = DataParallelExecutorGroup(
            net, [tmx.cpu()], None, [("data", (2, 4)), ("state", (2, 3))],
            None, ["fc_weight", "fc_bias"], for_training=True,
            inputs_need_grad=False, state_names=["state"])
        assert grp.state_names == ["state"]
        grp.bind_exec([("data", (2, 4)), ("state", (2, 3))], None,
                      reshape=True)
        assert grp.execs[0].arg_dict["state"].shape == (2, 3)
