"""The adversarial-example flow of ``example/adversary/adversary_generation.py``
(FGSM) at the example's own widths (a 1x16x16 CNN, batch 64) in the
PyTorch port against the JAX package, on the CPU.

The port trains the example's network for two epochs; both packages then
load those weights (numpy), bind a Module ``for_training=True,
inputs_need_grad=True``, take the loss gradient with respect to the
input pixels and perturb each batch by ``eps * sign(grad)`` in ``mx.nd``
ops (``mx.nd.clip(x + eps * mx.nd.sign(g), 0, 1)``), and score clean and
perturbed batches with ``mx.nd.argmax(out, axis=1) == label``.

Held: the input gradients within 1e-4 relative L2 per batch, their signs
wherever |g| > 1e-3 max |g|, the perturbed images where those signs
decide them, and the clean and adversarial accuracies equal.
"""
import importlib.util
import os

import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 0.3
BATCH = 64


def _example():
    path = os.path.join(REPO, "example", "adversary", "adversary_generation.py")
    spec = importlib.util.spec_from_file_location("adversary_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _symbol(mx):
    """The example's ``get_symbol``, in either package."""
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                             name="conv1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=32,
                                name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=2, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _train_weights(X, y):
    mx = tmx
    mx.random.seed(0)
    with mx.name.NameManager():
        net = _symbol(mx)
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=BATCH), num_epoch=2,
            optimizer="sgd", kvstore="local",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.initializer.Xavier())
    args, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


def _attack(mx, weights, X, y):
    """Per batch: clean and adversarial hits (mx.nd), the input gradient
    and the perturbed batch."""
    ctx = mx.cpu()
    with mx.name.NameManager():
        net = _symbol(mx)
    atk = mx.mod.Module(net, context=ctx)
    atk.bind(data_shapes=[("data", (BATCH, 1, 16, 16))],
             label_shapes=[("softmax_label", (BATCH,))],
             for_training=True, inputs_need_grad=True)
    atk.set_params({k: mx.nd.array(v, ctx=ctx) for k, v in weights.items()},
                   {})
    out = {"clean": [], "adv": [], "grad": [], "x_adv": []}

    def hits(x, label):
        atk.forward(mx.io.DataBatch([x], [label]), is_train=False)
        pred = mx.nd.argmax(atk.get_outputs()[0], axis=1)
        return mx.nd.sum(pred == label).asscalar()

    for i in range(0, len(X) - BATCH + 1, BATCH):
        x = mx.nd.array(X[i:i + BATCH], ctx=ctx)
        label = mx.nd.array(y[i:i + BATCH], ctx=ctx)
        out["clean"].append(hits(x, label))
        atk.forward(mx.io.DataBatch([x], [label]), is_train=True)
        atk.backward()
        g = atk.get_input_grads()[0]
        x_adv = mx.nd.clip(x + EPS * mx.nd.sign(g), 0, 1)
        out["adv"].append(hits(x_adv, label))
        out["grad"].append(g.asnumpy())
        out["x_adv"].append(x_adv.asnumpy())
    return out


def test_fgsm_flow_matches_jax():
    ex = _example()
    rs = np.random.RandomState(0)
    Xtr, ytr = ex.make_dataset(640, rs)
    Xte, yte = ex.make_dataset(256, rs)
    weights = _train_weights(Xtr, ytr)
    j = _attack(jmx, weights, Xte, yte)
    t = _attack(tmx, weights, Xte, yte)
    for jg, tg, jx, tx in zip(j["grad"], t["grad"], j["x_adv"], t["x_adv"]):
        rel = np.linalg.norm(tg - jg) / np.linalg.norm(jg)
        assert rel <= 1e-4, rel
        decided = np.abs(jg) > 1e-3 * np.abs(jg).max()
        assert decided.mean() > 0.2
        np.testing.assert_array_equal(np.sign(tg)[decided],
                                      np.sign(jg)[decided])
        np.testing.assert_allclose(tx[decided], jx[decided], rtol=0,
                                   atol=1e-6)
    assert t["clean"] == j["clean"] and t["adv"] == j["adv"]
    clean = sum(t["clean"]) / len(Xte)
    adv = sum(t["adv"]) / len(Xte)
    assert clean > 0.9 and adv < clean - 0.2, (clean, adv)
