"""The detection and sequence examples (``example/ssd``, ``example/rcnn``,
``example/warpctc``) on the port, against the same files on the JAX
package, on the CPU.

The port runs the example files themselves, loaded by
``chip_smoke.load_example`` with their ``mxnet_tpu`` imports rewritten
to ``mxnet_tpu_torch``; the JAX package runs them as they are.  Both get
the same numpy weights and batches from a seed:

- the toy SSD's training graph (``symbol_ssd.get_symbol_train``: the
  multibox heads, MultiBoxPrior/Target with hard negative mining, the
  loss group) forward and backward, then its detection graph's rows;
- one batch of the Faster R-CNN example's ``Module.fit`` (RPN, the
  ``anchor_target``/``proposal_target`` Custom ops, which seed their own
  ``RandomState(0)``, Proposal, ROIPooling, the heads);
- three sgd steps of the toy CTC ``fc`` net through WarpCTC.

Tolerances: float32 convolutions and matmuls sum in other orders, so
outputs, gradients and updated weights agree at rtol 1e-4 / atol 1e-5;
class targets, mined negatives, detection ids and the ROI labels are
exact, since no value lies within rounding of a threshold."""
import importlib.util
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
PORT = chip_smoke.example_modules()


def _load_jax(relpath, name, siblings=None):
    """The example file as it is, on the JAX package."""
    path = os.path.join(REPO, relpath)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    stand_in = dict(siblings or {})
    saved = {k: sys.modules.get(k) for k in stand_in}
    sys.modules.update(stand_in)
    try:
        spec.loader.exec_module(module)
    finally:
        for k, old in saved.items():
            if old is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = old
    return module


def _jax_examples():
    ssd = _load_jax("example/ssd/symbol_ssd.py", "jax_symbol_ssd")
    target = _load_jax("example/rcnn/rcnn_target.py", "jax_rcnn_target")
    return {"symbol_ssd": ssd, "rcnn_target": target,
            "train_rcnn": _load_jax("example/rcnn/train_rcnn.py",
                                    "jax_train_rcnn",
                                    {"rcnn_target": target}),
            "toy_ctc": _load_jax("example/warpctc/toy_ctc.py",
                                 "jax_toy_ctc")}


JAX = _jax_examples()


def _weights(sym, shapes, seed, skip):
    """He-scaled seeded weights for every argument not in ``skip``."""
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in skip:
            continue
        if name.endswith("_weight") and len(shape) > 1:
            std = np.sqrt(2.0 / np.prod(shape[1:]))
            out[name] = (std * rs.standard_normal(shape)).astype(np.float32)
        else:
            out[name] = (0.1 * rs.standard_normal(shape)).astype(np.float32)
    return out


def _ssd_batch(seed=3, n=2, objects=4, size=64):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((n, 3, size, size)).astype(np.float32)
    lab = -np.ones((n, objects, 5), np.float32)
    for i in range(n):
        for k in range(1 + i):
            x0, y0 = rs.uniform(0, 0.6, 2)
            lab[i, k] = [rs.randint(0, 3), x0, y0, x0 + rs.uniform(0.2, 0.4),
                         y0 + rs.uniform(0.2, 0.4)]
    return x, lab


def _bind(mx, sym, weights, inputs, train):
    shapes = {k: v.shape for k, v in inputs.items()}
    req = {n: ("write" if train and n in weights else "null")
           for n in sym.list_arguments()}
    ex = sym.simple_bind(mx.cpu(), grad_req=req, **shapes)
    for n, v in list(weights.items()) + list(inputs.items()):
        if n in ex.arg_dict:
            ex.arg_dict[n][:] = v
    outs = [o.asnumpy() for o in ex.forward(is_train=train)]
    grads = {}
    if train:
        ex.backward()
        grads = {n: g.asnumpy() for n, g in ex.grad_dict.items()
                 if g is not None and n in weights}
    return outs, grads


def test_toy_ssd_train_and_detect_graphs():
    x, lab = _ssd_batch()
    with tmx.name.NameManager():
        t_train = PORT["symbol_ssd"].get_symbol_train(num_classes=3)
    with jmx.name.NameManager():
        j_train = JAX["symbol_ssd"].get_symbol_train(num_classes=3)
    assert t_train.tojson() == j_train.tojson()
    weights = _weights(t_train, {"data": x.shape, "label": lab.shape}, 5,
                       ("data", "label"))
    inputs = {"data": x, "label": lab}
    (t_prob, t_loss, t_cls), t_grads = _bind(tmx, t_train, weights, inputs,
                                             True)
    (j_prob, j_loss, j_cls), j_grads = _bind(jmx, j_train, weights, inputs,
                                             True)
    np.testing.assert_array_equal(t_cls, j_cls)
    assert (t_cls > 0).any() and (t_cls == 0).any() and (t_cls == -1).any()
    np.testing.assert_allclose(t_prob, j_prob, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_loss, j_loss, rtol=RTOL, atol=ATOL)
    assert set(t_grads) == set(j_grads) == set(weights)
    for k in weights:
        np.testing.assert_allclose(t_grads[k], j_grads[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    # the deployment graph on the same weights: the same rows
    with tmx.name.NameManager():
        t_det = PORT["symbol_ssd"].get_symbol_detect(num_classes=3,
                                                     threshold=0.05)
    with jmx.name.NameManager():
        j_det = JAX["symbol_ssd"].get_symbol_detect(num_classes=3,
                                                    threshold=0.05)
    assert t_det.tojson() == j_det.tojson()
    (t_rows,), _ = _bind(tmx, t_det, weights, {"data": x}, False)
    (j_rows,), _ = _bind(jmx, j_det, weights, {"data": x}, False)
    np.testing.assert_array_equal(t_rows[..., 0], j_rows[..., 0])
    np.testing.assert_allclose(t_rows[..., 1:], j_rows[..., 1:], rtol=RTOL,
                               atol=ATOL)
    kept = (t_rows[..., 0] >= 0).sum(1)
    assert (kept > 0).all() and (kept < t_rows.shape[1]).all()


def _rcnn_fit(mx, examples, weights, batch):
    train = examples["train_rcnn"]
    it = train.ToyDetIter(n=batch, batch_size=batch)
    with mx.cpu():      # the iterator's mx.nd.array lands on the host
        return _rcnn_fit_on(mx, train, it, weights)


def _rcnn_fit_on(mx, train, it, weights):
    with mx.name.NameManager():
        net = train.get_symbol_train(batch_rois=16)
    mod = mx.mod.Module(net, data_names=("data", "im_info", "gt_boxes"),
                        label_names=None, context=mx.cpu())
    outs = []
    metric = train.RcnnMetric()
    mod.fit(it, num_epoch=1, eval_metric=metric, optimizer="sgd",
            optimizer_params={"learning_rate": 0.002, "momentum": 0.9,
                              "wd": 5e-4},
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in weights.items()},
            batch_end_callback=lambda p: outs.append(
                [o.asnumpy() for o in mod.get_outputs()]),
            kvstore=None)
    args, _ = mod.get_params()
    return net, outs, {k: v.asnumpy() for k, v in args.items()}, \
        dict(metric.get_name_value())


def test_rcnn_fit_batch(monkeypatch):
    monkeypatch.setenv("MXTPU_METRIC_BLOCKING", "1")
    batch = 4
    with tmx.name.NameManager():
        net = PORT["train_rcnn"].get_symbol_train(batch_rois=16)
    img = PORT["train_rcnn"].IMG
    weights = _weights(net, {"data": (batch, 3, img, img),
                             "im_info": (batch, 3),
                             "gt_boxes": (batch, 4, 5)}, 7,
                       ("data", "im_info", "gt_boxes"))
    t_net, t_outs, t_args, t_metric = _rcnn_fit(tmx, PORT, weights, batch)
    j_net, j_outs, j_args, j_metric = _rcnn_fit(jmx, JAX, weights, batch)
    assert t_net.tojson() == j_net.tojson()
    assert len(t_outs) == len(j_outs) == 1
    for k, (a, b) in enumerate(zip(t_outs[0], j_outs[0])):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg="output %d" % k)
    # the sampled ROI labels: some foreground
    np.testing.assert_array_equal(t_outs[0][4], j_outs[0][4])
    assert (t_outs[0][4] > 0).any()
    assert set(t_args) == set(j_args) == set(weights)
    for k in weights:
        np.testing.assert_allclose(t_args[k], j_args[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        assert not np.array_equal(t_args[k], weights[k]), k
    assert t_metric.keys() == j_metric.keys()
    for k in t_metric:
        np.testing.assert_allclose(t_metric[k], j_metric[k], rtol=RTOL)


def _ctc_steps(mx, toy, weights, batch, steps):
    """The toy CTC example's training step (``toy_ctc.train``'s loop body:
    forward, backward, the example's optimizer settings) from given
    weights on the example's own batches."""
    sym = toy.build_sym(toy.ALPHABET, net="fc")
    ex = sym.simple_bind(mx.cpu(), data=(toy.SEQ_LEN * batch, toy.FEAT),
                         label=(batch, toy.NUM_LABEL), grad_req="write")
    for n, v in weights.items():
        ex.arg_dict[n][:] = v
    opt = mx.optimizer.create("sgd", learning_rate=2.0,
                              rescale_grad=1.0 / batch, clip_gradient=10.0,
                              momentum=0.9)
    names = [n for n in ex.arg_dict if n not in ("data", "label")]
    states = {n: opt.create_state(i, ex.arg_dict[n])
              for i, n in enumerate(names)}
    rs = np.random.RandomState(0)

    class _R:
        def randint(self, a, b):
            return rs.randint(a, b + 1)

    outs = []
    for _ in range(steps):
        data, labels = toy.gen_batch(batch, _R())
        ex.arg_dict["data"][:] = data
        ex.arg_dict["label"][:] = labels
        outs.append(ex.forward(is_train=True)[0].asnumpy())
        ex.backward()
        for i, n in enumerate(names):
            opt.update(i, ex.arg_dict[n], ex.grad_dict[n], states[n])
    probs = outs[-1].reshape(toy.SEQ_LEN, batch, toy.ALPHABET)
    decoded = [toy.greedy_decode(probs[:, n]) for n in range(batch)]
    return outs, {n: ex.arg_dict[n].asnumpy() for n in names}, decoded


@pytest.mark.parametrize("steps", [3])
def test_toy_ctc_fc_steps(steps):
    batch = 8
    toy = PORT["toy_ctc"]
    sym = toy.build_sym(toy.ALPHABET, net="fc")
    weights = _weights(sym, {"data": (toy.SEQ_LEN * batch, toy.FEAT),
                             "label": (batch, toy.NUM_LABEL)}, 9,
                       ("data", "label"))
    t_outs, t_w, t_dec = _ctc_steps(tmx, toy, weights, batch, steps)
    j_outs, j_w, j_dec = _ctc_steps(jmx, JAX["toy_ctc"], weights, batch,
                                    steps)
    for a, b in zip(t_outs, j_outs):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for k in weights:
        np.testing.assert_allclose(t_w[k], j_w[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        assert not np.array_equal(t_w[k], weights[k]), k
    assert t_dec == j_dec
