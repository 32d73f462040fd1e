"""The same calls give the same auto-names in the port and in the JAX
package.

Auto-names (``convolution0``, ``elemwise_add3``) count per process, so a
comparison of names across the packages holds only when both sides have
used up the same names.  From a fresh ``NameManager`` in each package, a
ResNet-8 is built and fit on the fused route (``Module.fit`` with
``kvstore='tpu'``), then the same auto-named symbol is built again: its
JSON must be the same text in both packages, so neither fit route takes
names the other does not."""
import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

IMAGE = (3, 8, 8)
BATCH = 4


def _auto_named(mx):
    """A small graph whose every node takes an auto-name."""
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=4)
    net = mx.sym.BatchNorm(net)
    net = mx.sym.Activation(net, act_type="relu") + net
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=3)
    return mx.sym.SoftmaxOutput(net)


def _fit_then_build(mx, ctx, kvstore):
    rs = np.random.RandomState(0)
    X = rs.standard_normal((BATCH,) + IMAGE).astype(np.float32)
    y = rs.randint(0, 4, BATCH).astype(np.float32)
    with mx.name.NameManager():
        first = _auto_named(mx).tojson()
        net = mx.models.get_symbol("resnet", num_layers=8, num_classes=4,
                                   image_shape=IMAGE)
        mod = mx.mod.Module(net, context=ctx)
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=BATCH), num_epoch=1,
                kvstore=kvstore, optimizer="sgd",
                optimizer_params={"learning_rate": 0.01},
                initializer=mx.initializer.Xavier())
        after = _auto_named(mx).tojson()
    return first, net.tojson(), after


def test_fused_fit_route_names_alike(monkeypatch):
    monkeypatch.setenv("MXTPU_METRIC_BLOCKING", "1")
    j = _fit_then_build(jmx, jmx.cpu(), "tpu")
    t = _fit_then_build(tmx, tmx.cpu(), "tpu")
    assert t[0] == j[0]
    assert t[1] == j[1]
    assert t[2] == j[2]
    # the names went on counting past the first graph and ResNet-8
    assert t[2] != t[0]


def test_fresh_manager_restarts_the_count():
    """Names used up outside a fresh manager do not reach inside it, in
    either package."""
    for mx in (jmx, tmx):
        _auto_named(mx)
        with mx.name.NameManager():
            inner = _auto_named(mx).tojson()
        with mx.name.NameManager():
            assert _auto_named(mx).tojson() == inner
        assert '"convolution0"' in inner
