"""The port's bucketing path (``mxnet_tpu_torch/module/bucketing_module.py``,
``rnn/io.py`` and ``metric.Perplexity``) against the JAX package's, on the
CPU: the bucketed LSTM language model of ``example/rnn/lstm_bucketing.py``
at a small size (vocab 50, embed 8, hidden 16, 2 layers, buckets [5, 10],
batch 4), trained two epochs through ``BucketingModule.fit`` on both of
the example's stacks from the same numpy weights and the same batches.

Tolerances: per-batch outputs, final parameters and the perplexities at
rtol 1e-4 / atol 1e-5 (float32 on both sides, matmuls and the recurrence
summed in other orders and carried through 2 epochs of updates); the
iterator's batches and the device-pick ``Perplexity`` exactly."""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-4, 1e-5
VOCAB, EMBED, HIDDEN, LAYERS = 50, 8, 16, 2
BUCKETS, BATCH, INVALID = [5, 10], 4, 0


def markov_corpus(n_sent, vocab, seed, max_len=10):
    """Sentences of 2 to ``max_len`` tokens from a sparse Markov chain
    (the example's ``synthetic_corpus`` at a small size)."""
    rs = np.random.RandomState(seed)
    succ = np.random.RandomState(1234).randint(1, vocab, size=(vocab, 4))
    out = []
    for _ in range(n_sent):
        tok = rs.randint(1, vocab)
        sent = [tok]
        for _ in range(rs.randint(2, max_len + 1) - 1):
            tok = succ[tok][rs.randint(4)] if rs.rand() < 0.9 \
                else rs.randint(1, vocab)
            sent.append(tok)
        out.append(sent)
    return out


def _iters(mx, seed):
    """Train and validation iterators with both global generators seeded
    alike, as the reference's shuffles draw from them."""
    random.seed(seed)
    np.random.seed(seed)
    train = mx.rnn.BucketSentenceIter(markov_corpus(40, VOCAB, 0), BATCH,
                                      buckets=list(BUCKETS),
                                      invalid_label=INVALID)
    val = mx.rnn.BucketSentenceIter(markov_corpus(16, VOCAB, 1), BATCH,
                                    buckets=list(BUCKETS),
                                    invalid_label=INVALID)
    return train, val


def _stack(mx, fused):
    if fused:
        return mx.rnn.FusedRNNCell(HIDDEN, num_layers=LAYERS, mode="lstm",
                                   prefix="lstm_")
    stack = mx.rnn.SequentialRNNCell()
    for i in range(LAYERS):
        stack.add(mx.rnn.LSTMCell(num_hidden=HIDDEN, prefix="lstm_l%d_" % i))
    return stack


def _sym_gen(mx, stack):
    """The example's sym_gen."""
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=VOCAB,
                                 output_dim=EMBED, name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, HIDDEN))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=VOCAB,
                                     name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def _weights(mx, fused, seed=3):
    """Seeded numpy weights of the default bucket's symbol, built under a
    fresh NameManager (auto-names count per process)."""
    with mx.name.NameManager():
        sym, _, _ = _sym_gen(mx, _stack(mx, fused))(max(BUCKETS))
    shape = (BATCH, max(BUCKETS))
    arg_shapes, _, _ = sym.infer_shape(data=shape, softmax_label=shape)
    rs = np.random.RandomState(seed)
    return {n: rs.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def _fit(mx, fused, weights, kvstore="local", num_epoch=2):
    """The example's fit (sgd lr 0.1 here, momentum 0, wd 1e-5,
    Perplexity(invalid_label)), recording each batch's bucket, data and
    outputs and each epoch's validation perplexity."""
    ctx = mx.cpu()
    train, val = _iters(mx, 11)
    mod = mx.mod.BucketingModule(_sym_gen(mx, _stack(mx, fused)),
                                 default_bucket_key=train.default_bucket_key,
                                 context=ctx)
    seen = []

    def record(param):
        batch = param.locals["data_batch"]
        seen.append((batch.bucket_key, batch.data[0].asnumpy(),
                     mod.get_outputs()[0].asnumpy()))

    val_ppl = []

    def record_val(param):
        val_ppl.append(param.eval_metric.get()[1])

    mod.fit(train, eval_data=val,
            eval_metric=mx.metric.Perplexity(INVALID), kvstore=kvstore,
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.0,
                              "wd": 1e-5},
            initializer=mx.initializer.Xavier(factor_type="in",
                                              magnitude=2.34),
            arg_params={k: mx.nd.array(v, ctx=ctx)
                        for k, v in weights.items()},
            batch_end_callback=record, eval_end_callback=record_val,
            num_epoch=num_epoch)
    args, _ = mod.get_params()
    return mod, seen, val_ppl, {k: v.asnumpy() for k, v in args.items()}


@pytest.mark.parametrize("fused", [False, True], ids=["unrolled", "fused"])
def test_bucketing_fit_matches_jax(fused, monkeypatch):
    """Two epochs of BucketingModule.fit on one stack: every batch's
    bucket, data and outputs, the validation perplexity of each epoch and
    the final parameters agree with the JAX package's."""
    monkeypatch.setenv("MXTPU_METRIC_BLOCKING", "1")
    weights = _weights(tmx, fused)
    assert set(weights) == set(_weights(jmx, fused))
    _, j_seen, j_ppl, j_args = _fit(jmx, fused, weights)
    mod, t_seen, t_ppl, t_args = _fit(tmx, fused, weights)
    assert len(t_seen) == len(j_seen) > 2 * len(BUCKETS)
    assert {k for k, _, _ in t_seen} == set(BUCKETS)
    for (tk, td, to), (jk, jd, jo) in zip(t_seen, j_seen):
        assert tk == jk
        np.testing.assert_array_equal(td, jd)
        assert to.shape == (BATCH * tk, VOCAB)
        np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)
    assert len(t_ppl) == len(j_ppl) == 2
    np.testing.assert_allclose(t_ppl, j_ppl, rtol=RTOL, atol=ATOL)
    assert set(t_args) == set(j_args)
    for k in j_args:
        np.testing.assert_allclose(t_args[k], j_args[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        assert not np.array_equal(t_args[k], weights[k]), k
    # one module a bucket, all sharing the default bucket's cells
    assert sorted(mod._buckets) == BUCKETS
    base = mod._buckets[max(BUCKETS)]._exec_group.execs[0].arg_dict
    for key, bucket in mod._buckets.items():
        for name, arr in bucket._exec_group.execs[0].arg_dict.items():
            if name in weights:
                assert arr is base[name], (key, name)


def test_bucket_switch_computes_with_updated_weights():
    """After updates taken in one bucket, another bucket's executor
    computes what a fresh Module of that bucket given get_params()
    computes (no stale parameter tensor survives a switch)."""
    ctx = tmx.cpu()
    weights = _weights(tmx, False)
    train, _ = _iters(tmx, 5)
    mod = tmx.mod.BucketingModule(_sym_gen(tmx, _stack(tmx, False)),
                                  default_bucket_key=max(BUCKETS),
                                  context=ctx)
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params(arg_params={k: tmx.nd.array(v, ctx=ctx)
                                for k, v in weights.items()})
    mod.init_optimizer(optimizer_params={"learning_rate": 0.5})
    batches = {}
    for b in train:
        batches.setdefault(b.bucket_key, b)
    short, long_ = batches[min(BUCKETS)], batches[max(BUCKETS)]
    mod.forward(short, is_train=False)         # bind the short bucket
    for _ in range(3):
        mod.forward_backward(long_)
        mod.update()
    mod.forward(short, is_train=False)
    got = mod.get_outputs()[0].asnumpy()
    args, aux = mod.get_params()
    assert not np.allclose(args["pred_weight"].asnumpy(),
                           weights["pred_weight"])
    sym, data_names, label_names = _sym_gen(tmx, _stack(tmx, False))(
        min(BUCKETS))
    fresh = tmx.mod.Module(sym, data_names, label_names, context=ctx)
    fresh.bind(short.provide_data, short.provide_label, for_training=False)
    fresh.set_params(args, aux)
    fresh.forward(short, is_train=False)
    np.testing.assert_array_equal(got, fresh.get_outputs()[0].asnumpy())


def test_bucket_sentence_iter_matches_jax():
    """Same buckets, same batches in the same order, over two resets, as
    host float32 arrays whose labels are the data shifted by one."""
    for layout in ("NT", "TN"):
        its = []
        for mx in (jmx, tmx):
            random.seed(4)
            np.random.seed(4)
            it = mx.rnn.BucketSentenceIter(
                markov_corpus(60, VOCAB, 2, max_len=14), BATCH,
                buckets=None, invalid_label=-1, layout=layout)
            its.append(it)
        j_it, t_it = its
        assert t_it.buckets == j_it.buckets
        assert t_it.default_bucket_key == j_it.default_bucket_key
        assert [tuple(d) for d in t_it.provide_data] == \
            [tuple(d) for d in j_it.provide_data]
        for _epoch in range(2):
            j_batches, t_batches = list(j_it), list(t_it)
            assert len(t_batches) == len(j_batches) > 0
            for tb, jb in zip(t_batches, j_batches):
                assert tb.bucket_key == jb.bucket_key
                assert tb.data[0].context == tmx.cpu()
                assert tb.data[0].dtype == np.float32
                np.testing.assert_array_equal(tb.data[0].asnumpy(),
                                              jb.data[0].asnumpy())
                np.testing.assert_array_equal(tb.label[0].asnumpy(),
                                              jb.label[0].asnumpy())
                assert [tuple(d) for d in tb.provide_data] == \
                    [tuple(d) for d in jb.provide_data]
                assert [tuple(d) for d in tb.provide_label] == \
                    [tuple(d) for d in jb.provide_label]
            random.seed(9)
            np.random.seed(9)
            j_it.reset()
            random.seed(9)
            np.random.seed(9)
            t_it.reset()


def test_encode_sentences_matches_jax():
    sents = [["a", "b", "c"], ["b", "d"], ["e", "a", "a"]]
    for kwargs in ({}, {"invalid_label": 0, "start_label": 0},
                   {"invalid_label": 0, "start_label": 1}):
        t_res, t_vocab = tmx.rnn.encode_sentences(sents, **kwargs)
        j_res, j_vocab = jmx.rnn.encode_sentences(sents, **kwargs)
        assert t_res == j_res and t_vocab == j_vocab
        again, _ = tmx.rnn.encode_sentences([["b", "a"]], vocab=t_vocab)
        assert again == [[t_vocab["b"], t_vocab["a"]]]
        with pytest.raises(AssertionError):
            tmx.rnn.encode_sentences([["zz"]], vocab=t_vocab)


@pytest.mark.parametrize("ignore", [None, 0, 3])
def test_perplexity_device_pick_is_bit_equal_to_host_formula(ignore):
    """The pick on the prediction's device, then numpy, against the JAX
    package's host formula on the whole prediction: the same bits, for
    NDArray and numpy predictions and for 2-D and 3-D ones."""
    rs = np.random.RandomState(0)
    for shape in ((40, 7), (4, 10, 7)):
        logits = rs.standard_normal(shape).astype(np.float32) * 3
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        probs = probs.astype(np.float32)
        probs.reshape(-1, 7)[0, 2] = 0.0     # clipped at 1e-10
        label = rs.randint(0, 7, (int(np.prod(shape[:-1])),))
        label = label.astype(np.float32).reshape(shape[:-1])
        host = jmx.metric.Perplexity(ignore)
        host.update([jmx.nd.array(label)], [jmx.nd.array(probs)])
        for pred in (tmx.nd.array(probs, ctx=tmx.cpu()), probs):
            got = tmx.metric.Perplexity(ignore)
            got.update([tmx.nd.array(label, ctx=tmx.cpu())], [pred])
            assert got.num_inst == host.num_inst
            assert got.sum_metric == host.sum_metric
            assert got.get() == host.get()
        # the pick itself returns the indexed float32 values
        flat = label.reshape(-1).astype(np.int32)
        picked = tmx.metric.pick_probs(tmx.nd.array(probs, ctx=tmx.cpu()),
                                       flat)
        np.testing.assert_array_equal(
            picked, probs.reshape(-1, 7)[np.arange(flat.size), flat])
        assert picked.dtype == np.float32


def test_perplexity_negative_labels_index_from_the_end():
    probs = np.random.RandomState(1).rand(6, 5).astype(np.float32)
    label = np.array([0, -1, 4, -5, 2, 1], np.int32)
    got = tmx.metric.pick_probs(tmx.nd.array(probs, ctx=tmx.cpu()), label)
    np.testing.assert_array_equal(got, probs[np.arange(6), label])


def test_torch_and_caffe_metrics_match_jax():
    rs = np.random.RandomState(2)
    preds = [rs.rand(3, 4).astype(np.float32), rs.rand(5).astype(np.float32)]
    for name in ("Torch", "Caffe"):
        t = getattr(tmx.metric, name)()
        j = getattr(jmx.metric, name)()
        t.update(None, [tmx.nd.array(p, ctx=tmx.cpu()) for p in preds])
        j.update(None, [jmx.nd.array(p) for p in preds])
        assert t.get() == j.get()
        assert t.name == j.name


def test_bucketing_module_tpu_kvstore():
    """The single-device case of tests/test_module.py: under
    kvstore='tpu' the bucket modules decline the fused route (their
    executors share parameter cells) and train across bucket switches on
    the kvstore push/pull path."""
    def sym_gen(seq_len):
        data = tmx.sym.Variable("data")
        net = tmx.sym.FullyConnected(data, num_hidden=8, name="fc")
        net = tmx.sym.SoftmaxOutput(net, name="softmax")
        return net, ("data",), ("softmax_label",)

    mod = tmx.mod.BucketingModule(sym_gen, default_bucket_key=10,
                                  context=tmx.cpu())
    mod.bind(data_shapes=[("data", (8, 10))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params()
    mod.init_optimizer(kvstore="tpu")
    assert mod._curr_module._fused is None
    assert mod._curr_module._update_on_kvstore
    w0 = mod.get_params()[0]["fc_weight"].asnumpy().copy()
    for key, bs in ((10, 8), (4, 4), (10, 8)):
        b = tmx.io.DataBatch(
            data=[tmx.nd.ones((bs, 10), ctx=tmx.cpu())],
            label=[tmx.nd.zeros((bs,), ctx=tmx.cpu())],
            bucket_key=key,
            provide_data=[tmx.io.DataDesc("data", (bs, 10))],
            provide_label=[tmx.io.DataDesc("softmax_label", (bs,))])
        mod.forward_backward(b)
        mod.update()
        assert mod._curr_module._fused is None
    assert sorted(mod._buckets) == [4, 10]
    w = mod.get_params()[0]["fc_weight"].asnumpy()
    assert np.isfinite(w).all() and not np.array_equal(w, w0)


def test_bucketing_module_surface():
    """Names and shapes come from the current bucket; an unbound module
    answers data and output names from the default bucket's symbol."""
    mod = tmx.mod.BucketingModule(_sym_gen(tmx, _stack(tmx, True)),
                                  default_bucket_key=10, context=tmx.cpu())
    assert mod.data_names == ("data",)
    assert mod.output_names == ["softmax_output"]
    mod.bind([("data", (BATCH, 10))], [("softmax_label", (BATCH, 10))])
    mod.init_params(tmx.initializer.Xavier())
    assert mod.output_shapes == [("softmax_output", (BATCH * 10, VOCAB))]
    mod.switch_bucket(5, [("data", (BATCH, 5))],
                      [("softmax_label", (BATCH, 5))])
    assert mod.output_shapes == [("softmax_output", (BATCH * 5, VOCAB))]
    assert mod.data_shapes == [("data", (BATCH, 5))]
    assert mod.symbol.list_outputs() == ["softmax_output"]
    with pytest.raises(AssertionError):
        mod.bind([("data", (BATCH, 10))], shared_module=mod)


def test_asnumpy_is_a_copy_on_the_host():
    """A numpy snapshot of a host parameter (get_params) does not follow
    later updates: asnumpy copies, as the reference's does."""
    arr = tmx.nd.array(np.ones(3, np.float32), ctx=tmx.cpu())
    snap = arr.asnumpy()
    arr[:] = 5.0
    np.testing.assert_array_equal(snap, np.ones(3, np.float32))
    snap[0] = 7.0
    np.testing.assert_array_equal(arr.asnumpy(), np.full(3, 5.0, np.float32))
