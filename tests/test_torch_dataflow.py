"""The port's ``DevicePrefetchIter`` (``mxnet_tpu_torch/dataflow.py``),
``SPMDTrainer.stage_batch`` and the ``StagedBatch`` paths of the trainer
and the Module, on the CPU, and a ResNet-8 ``Module.fit`` fed by
``ImageRecordIter`` against the JAX package's.

Tolerances: batches through ``DevicePrefetchIter`` and steps fed a
``StagedBatch`` equal their plain counterparts exactly (the same tensors
reach the same arithmetic).  The ResNet-8 fit against the JAX package:
rtol 1e-4 / atol 1e-5 on each batch's outputs and the final parameters
(float32 convolutions and BatchNorm sums in another order, carried
through the updates); its input batches are byte-equal."""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402

BATCH = 4
IMAGE = (3, 16, 16)
RTOL, ATOL = 1e-4, 1e-5
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
       "rescale_grad": 1.0 / BATCH}


def _symbol(mx, classes=10):
    return mx.models.get_symbol("resnet", num_layers=8, num_classes=classes,
                                image_shape=IMAGE)


def _weights(seed=50, classes=10):
    rs = np.random.RandomState(seed)
    # a fresh NameManager, so that this shape-only build uses up no
    # auto-names of the process (ResNet-8's elemwise_add0..2)
    with tmx.name.NameManager():
        sym = _symbol(tmx, classes)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(BATCH,) + IMAGE)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight"):
            std = np.sqrt(2.0 / np.prod(s[1:]))
            args[n] = (std * rs.standard_normal(s)).astype(np.float32)
        elif n.endswith("_gamma"):
            args[n] = rs.uniform(0.8, 1.2, s).astype(np.float32)
        else:
            args[n] = (0.1 * rs.standard_normal(s)).astype(np.float32)
    aux = {n: (rs.uniform(0.8, 1.2, s) if n.endswith("_var")
               else 0.1 * rs.standard_normal(s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _data(n=12, seed=1):
    rs = np.random.RandomState(seed)
    return rs.standard_normal((n,) + IMAGE).astype(np.float32), \
        rs.randint(0, 10, n).astype(np.float32)


class _Source(tmx.io.DataIter):
    """Batches 0..n-1 as host arrays; raises ``exc`` at batch ``fail_at``
    once per epoch."""

    def __init__(self, n=5, fail_at=None, exc=ValueError):
        super().__init__(2)
        self.n, self.fail_at, self.exc = n, fail_at, exc
        self.i = 0

    def next(self):
        if self.i == self.fail_at:
            self.fail_at = None
            raise self.exc("source failed at %d" % self.i)
        if self.i >= self.n:
            raise StopIteration
        self.i += 1
        with tmx.cpu():
            return tmx.io.DataBatch(
                [tmx.nd.array(np.full((2, 3), self.i, np.float32))],
                [tmx.nd.array(np.full((2,), -self.i, np.float32))])

    def reset(self):
        self.i = 0


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_identical_batches_in_order(depth):
    X, y = _data(10)
    outs = []
    for mod in (jmx, tmx):
        with mod.cpu():
            it = mod.DevicePrefetchIter(
                mod.io.NDArrayIter(X, y, batch_size=4), depth=depth)
            got = []
            for _ in range(2):
                got += [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                        for b in it]
                it.reset()
            it.close()
        outs.append(got)
    assert len(outs[0]) == len(outs[1]) == 6
    for (dj, lj, pj), (dt, lt, pt) in zip(*outs):
        np.testing.assert_array_equal(dj, dt)
        np.testing.assert_array_equal(lj, lt)
        assert pj == pt


def test_prefetch_error_surfaced_then_reset():
    src = _Source(fail_at=2)
    it = tmx.DevicePrefetchIter(src, depth=2)
    assert it.next().data[0].asnumpy()[0, 0] == 1
    assert it.next().data[0].asnumpy()[0, 0] == 2
    with pytest.raises(ValueError, match="failed at 2"):
        it.next()
    with pytest.raises(StopIteration):
        it.next()
    it.reset()
    assert [int(b.data[0].asnumpy()[0, 0]) for b in it] == [1, 2, 3, 4, 5]
    it.close()
    # a transient source error is retried through
    it = tmx.DevicePrefetchIter(_Source(fail_at=1, exc=IOError), depth=1)
    assert [int(b.data[0].asnumpy()[0, 0]) for b in it] == [1, 2, 3, 4, 5]
    it.close()


def test_prefetch_close_mid_epoch():
    it = tmx.DevicePrefetchIter(_Source(n=50), depth=2)
    it.next()
    worker = it._thread
    it.close()
    worker.join(5)
    assert not worker.is_alive()
    with pytest.raises(StopIteration):
        it.next()
    it.close()
    it.reset()
    assert it.next().data[0].asnumpy()[0, 0] == 1
    it.close()
    with pytest.raises(tmx.MXNetError):
        tmx.DevicePrefetchIter(_Source(), stage=object())


def _port_trainer(args, aux):
    tr = tmx.parallel.SPMDTrainer(_symbol(tmx), "sgd", dict(SGD), mesh=None,
                                  ctx=tmx.cpu())
    tr.bind([("data", (BATCH,) + IMAGE)], [("softmax_label", (BATCH,))])
    with tmx.cpu():
        tr.init_params(None, {k: tmx.nd.array(v) for k, v in args.items()},
                       {k: tmx.nd.array(v) for k, v in aux.items()})
    return tr


def test_step_on_staged_batch_equals_step_on_arrays():
    args, aux = _weights()
    X, y = _data(8)
    plain, staged = _port_trainer(args, aux), _port_trainer(args, aux)
    for i in range(2):
        xb, yb = X[i * 4:(i + 1) * 4], y[i * 4:(i + 1) * 4]
        sb = staged.stage_batch(xb, yb)
        assert isinstance(sb, tmx.dataflow.Staged) and sb.event is None
        batch = tmx.io.StagedBatch(sb, data=[xb], label=[yb])
        np.testing.assert_array_equal(
            staged.forward_only(batch, key=3)[0].numpy(),
            plain.forward_only(xb, yb, key=3)[0].numpy())
        o1 = plain.step(xb, yb, key=i)[0]
        o2 = staged.step(batch, key=i)[0]
        assert torch.equal(o1, o2)
    np.testing.assert_array_equal(staged.eval_step(batch)[0].numpy(),
                                  plain.eval_step(xb, yb)[0].numpy())
    for k in plain.params:
        assert torch.equal(plain.params[k], staged.params[k]), k
    for k in plain.aux:
        assert torch.equal(plain.aux[k], staged.aux[k]), k
    it = tmx.DevicePrefetchIter(
        tmx.io.NDArrayIter(X, y, batch_size=BATCH), stage=staged)
    b = it.next()
    assert isinstance(b, tmx.io.StagedBatch)
    np.testing.assert_array_equal(b.staged["data"].numpy(), X[:4])
    it.close()


def _fit(mx, train, args, aux, kvstore, ctx, prefetch=False):
    """One epoch of Module.fit; returns each batch's outputs and the final
    params."""
    mod = mx.mod.Module(_symbol(mx), context=ctx)
    outs = []

    def record(param):
        outs.append(param.locals["self"].get_outputs()[0].asnumpy())

    kw = dict(arg_params={k: mx.nd.array(v, ctx=ctx)
                          for k, v in args.items()},
              aux_params={k: mx.nd.array(v, ctx=ctx)
                          for k, v in aux.items()})
    if prefetch:
        mod.bind(train.provide_data, train.provide_label)
        mod.init_params(**kw)
        mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                           optimizer_params=dict(SGD))
        train = mx.DevicePrefetchIter(
            train, stage=mod if kvstore == "tpu" else (
                lambda *a: {"data": a[0]._data, "softmax_label": a[1]._data}))
    mod.fit(train, kvstore=kvstore, optimizer="sgd",
            optimizer_params=dict(SGD), batch_end_callback=record,
            num_epoch=1, **kw)
    if prefetch:
        assert isinstance(train.current_batch, mx.io.StagedBatch)
        train.close()
    assert (mod._fused is not None) == (kvstore == "tpu")
    a, x = mod.get_params()
    return outs, {k: v.asnumpy() for k, v in a.items()}, \
        {k: v.asnumpy() for k, v in x.items()}


@pytest.mark.parametrize("kvstore", ["tpu", "local"])
def test_resnet8_fit_from_image_record_iter_matches_jax(
        tmp_path, monkeypatch, kvstore):
    """ResNet-8 fit by each package's ImageRecordIter (native route) over
    one seeded .rec; the port also through DevicePrefetchIter (a Module
    with a fused trainer as the stage on 'tpu', host arrays on 'local')."""
    monkeypatch.setenv("MXTPU_METRIC_BLOCKING", "1")
    prefix = str(tmp_path / "r")
    chip_smoke.write_seeded_rec(tmx.recordio, prefix, 3 * BATCH, 20, seed=3,
                                classes=10)
    args, aux = _weights()
    kw = dict(batch_size=BATCH, data_shape=IMAGE, rand_crop=True,
              rand_mirror=True, seed=5, mean_r=123.68, mean_g=116.28,
              mean_b=103.53, std_r=58.395, std_g=57.12, std_b=57.375)
    results = []
    for mx, prefetch in ((jmx, False), (tmx, False), (tmx, True)):
        ctx = mx.cpu()
        with ctx:
            it = mx.io.ImageRecordIter(prefix + ".rec", **kw)
            results.append(_fit(mx, it, args, aux, kvstore, ctx, prefetch))
            it.close()
    (jo, ja, jx), (to, ta, tx), (po, pa, px) = results
    assert len(jo) == len(to) == len(po) == 3
    for a, b, c in zip(jo, to, po):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(c, b)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        np.testing.assert_array_equal(pa[k], ta[k], err_msg=k)
    for k in jx:
        np.testing.assert_allclose(tx[k], jx[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_uploader_on_the_cpu_copies_nothing():
    up = tmx.dataflow.Uploader("cpu")
    t = torch.arange(6.0)
    (out,), event = up.upload([t])
    assert out is t and event is None
    buf = up.host_buffer((2, 3), torch.uint8, zero=True)
    assert not buf.is_pinned() and int(buf.sum()) == 0
    tmx.dataflow.wait([t], None)        # no event: nothing to wait on
