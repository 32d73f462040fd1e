"""The LSTM language model (``models/lstm_lm.py``) in the port against the
JAX package on the CPU, through both routes to the ``lstm_cell`` kernels:

- route A, the fused ``RNN`` op: ``lstm_lm_sym(6, 50, 16, 16, 2)`` through
  ``SPMDTrainer`` in both packages at batch 4 (sgd, momentum 0.9, wd 1e-5,
  ``rescale_grad`` 1/4), from identical numpy weights on the same seeded
  batches; served through ``Predictor`` from a checkpoint;
- route B, the unrolled cells: the example's ``sym_gen`` (a
  ``SequentialRNNCell`` of two ``LSTMCell``s) through ``simple_bind`` ->
  ``forward(is_train=True)`` -> ``backward()`` in both packages.

Tolerance: rtol 1e-4 / atol 1e-5 in float32 (matmuls, bias sums and the
recurrence in other orders, carried through several updates); bfloat16
compute at 5e-2 of each tensor's range."""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.models import lstm_lm as jlm
from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.kernels import lstm_cell as tlc
from mxnet_tpu_torch.models import lstm_lm as tlm

BATCH, SEQ, VOCAB, HIDDEN = 4, 6, 50, 16
RTOL, ATOL = 1e-4, 1e-5
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-5,
       "rescale_grad": 1.0 / BATCH}


def _weights(seed=60):
    """Seeded numpy weights for every parameter of the LM, non-zero init
    states included (so their gradients and updates are exercised)."""
    rs = np.random.RandomState(seed)
    sym, _, _ = tlm.lstm_lm_sym(SEQ, VOCAB, HIDDEN, HIDDEN, 2)
    shapes, _, _ = sym.infer_shape(data=(BATCH, SEQ),
                                   softmax_label=(BATCH, SEQ))
    return {n: (0.3 * rs.standard_normal(s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _batches(n, vocab=VOCAB, seed=61):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, vocab, (BATCH, SEQ)).astype(np.float32),
             rs.randint(0, vocab, (BATCH, SEQ)).astype(np.float32))
            for _ in range(n)]


def _trainer(mx, **kw):
    sym, _, _ = (tlm if mx is tmx else jlm).lstm_lm_sym(SEQ, VOCAB, HIDDEN,
                                                        HIDDEN, 2)
    if mx is tmx:
        tr = tmx.parallel.SPMDTrainer(sym, "sgd", dict(SGD), ctx=tmx.cpu(),
                                      **kw)
    else:
        tr = JaxTrainer(sym, "sgd", dict(SGD), mesh=None, **kw)
    tr.bind([("data", (BATCH, SEQ))], [("softmax_label", (BATCH, SEQ))])
    tr.init_params(None, arg_params=_weights())
    return tr


def _out(o):
    return o.float().numpy() if isinstance(o, torch.Tensor) \
        else np.asarray(o, np.float32)


def _params(tr):
    return {k: v.asnumpy() for k, v in tr.get_params()[0].items()}


def _steps(tr, batches):
    return [_out(tr.step(x, y)[0]) for x, y in batches]


def test_trainer_five_steps_match_jax():
    batches = _batches(5)
    j, t = _trainer(jmx), _trainer(tmx)
    before = (tlc.LAUNCHES, tlc.BWD_LAUNCHES)
    for step, (jo, to) in enumerate(zip(_steps(j, batches),
                                        _steps(t, batches))):
        assert to.shape == (BATCH * SEQ, VOCAB)
        np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL,
                                   err_msg="step %d" % step)
    jp, tp = _params(j), _params(t)
    assert set(jp) == set(tp) and "lstm_init_h" in tp
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    start = _weights()
    for k in ("lstm_init_h", "lstm_init_c", "lstm_parameters", "pred_bias"):
        assert not np.allclose(tp[k], start[k]), k    # trained, like JAX
    # no weight decay for names that end neither in _weight nor _gamma
    assert t.optimizer.wd_mult == {"lstm_parameters": 0.0,
                                   "lstm_init_h": 0.0, "lstm_init_c": 0.0,
                                   "pred_bias": 0.0}
    assert t.skipped_steps == 0
    # the CPU path takes the plain versions: no kernel launch
    assert (tlc.LAUNCHES, tlc.BWD_LAUNCHES) == before


def test_fused_cell_and_unfused_trainers_agree(monkeypatch):
    """MXTPU_FUSED_KERNELS=0 runs the unfused gate composition under
    torch autograd; the fused cell's hand backward agrees to rounding."""
    batches = _batches(3, seed=62)
    fused = _steps(_trainer(tmx), batches)
    monkeypatch.setenv("MXTPU_FUSED_KERNELS", "0")
    t = _trainer(tmx)
    unfused = _steps(t, batches)
    np.testing.assert_array_equal(fused[0], unfused[0])  # same forward ops
    for a, b in zip(fused, unfused):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_bfloat16_compute_step_matches_jax():
    """The bench's compute_dtype: one step, ids exact in bfloat16 (vocab
    50 < 256); outputs and updated params at bfloat16 tolerance."""
    x, y = _batches(1, seed=63)[0]
    j = _trainer(jmx, compute_dtype="bfloat16")
    t = _trainer(tmx, compute_dtype="bfloat16")
    jo, to = _out(j.step(x, y)[0]), _out(t.step(x, y)[0])
    tol = 5e-2 * np.abs(jo).max()
    np.testing.assert_allclose(to, jo, rtol=5e-2, atol=tol)
    jp, tp = _params(j), _params(t)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=5e-2,
                                   atol=5e-2 * np.abs(jp[k]).max(),
                                   err_msg=k)


def _route_b_symbol(mx, vocab, hidden, layers=2):
    """The example's default ``sym_gen`` (example/rnn/lstm_bucketing.py,
    ``--fused 0``): Embedding -> SequentialRNNCell of LSTMCells unrolled
    with merged outputs -> Reshape -> FC -> SoftmaxOutput."""
    stack = mx.rnn.SequentialRNNCell()
    for i in range(layers):
        stack.add(mx.rnn.LSTMCell(num_hidden=hidden, prefix="lstm_l%d_" % i))
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    embed = mx.sym.Embedding(data=data, input_dim=vocab, output_dim=hidden,
                             name="embed")
    stack.reset()
    outputs, _ = stack.unroll(SEQ, inputs=embed, merge_outputs=True)
    pred = mx.sym.Reshape(outputs, shape=(-1, hidden))
    pred = mx.sym.FullyConnected(data=pred, num_hidden=vocab, name="pred")
    label = mx.sym.Reshape(label, shape=(-1,))
    return mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")


def _route_b_step(mx, weights, x, y):
    sym = _route_b_symbol(mx, VOCAB, HIDDEN)
    ex = sym.simple_bind(mx.cpu(), data=(BATCH, SEQ),
                         softmax_label=(BATCH, SEQ))
    for n, v in weights.items():
        ex.arg_dict[n][:] = v
    ex.forward(is_train=True, data=x, softmax_label=y)
    ex.backward()
    out = {"output": ex.outputs[0].asnumpy()}
    out.update({n: g.asnumpy() for n, g in ex.grad_dict.items()
                if n not in ("data", "softmax_label")})
    return sym, out


@pytest.mark.parametrize("fused_kernel", ["1", "0"])
def test_route_b_unrolled_cells_match_jax_executor(fused_kernel,
                                                   monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_KERNELS", fused_kernel)
    sym = _route_b_symbol(tmx, VOCAB, HIDDEN)
    ops = {n.op.name for n in sym._nodes() if n.op is not None}
    assert ("_FusedLSTMCell" in ops) == (fused_kernel == "1")
    shapes, _, _ = sym.infer_shape(data=(BATCH, SEQ),
                                   softmax_label=(BATCH, SEQ))
    rs = np.random.RandomState(64)
    weights = {n: (0.3 * rs.standard_normal(s)).astype(np.float32)
               for n, s in zip(sym.list_arguments(), shapes)
               if n not in ("data", "softmax_label")}
    x, y = _batches(1, seed=65)[0]
    _, ref = _route_b_step(jmx, weights, x, y)
    _, got = _route_b_step(tmx, weights, x, y)
    assert set(got) == set(ref) and "lstm_l1_h2h_weight" in got
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_route_b_matches_route_a_through_pack_weights():
    """The same weights through the unrolled cells and, packed by
    ``FusedRNNCell.pack_weights``, through the fused RNN op of the
    example's ``--fused 1`` graph: the same outputs and gradients."""
    sym_b = _route_b_symbol(tmx, VOCAB, HIDDEN)
    shapes, _, _ = sym_b.infer_shape(data=(BATCH, SEQ),
                                     softmax_label=(BATCH, SEQ))
    rs = np.random.RandomState(66)
    w_b = {n: (0.3 * rs.standard_normal(s)).astype(np.float32)
           for n, s in zip(sym_b.list_arguments(), shapes)
           if n not in ("data", "softmax_label")}
    x, y = _batches(1, seed=67)[0]
    _, got_b = _route_b_step(tmx, w_b, x, y)

    fused = tmx.rnn.FusedRNNCell(HIDDEN, num_layers=2, mode="lstm",
                                 prefix="lstm_")
    data = tmx.sym.Variable("data")
    embed = tmx.sym.Embedding(data=data, input_dim=VOCAB, output_dim=HIDDEN,
                              name="embed")
    outputs, _ = fused.unroll(SEQ, inputs=embed, merge_outputs=True)
    pred = tmx.sym.Reshape(outputs, shape=(-1, HIDDEN))
    pred = tmx.sym.FullyConnected(data=pred, num_hidden=VOCAB, name="pred")
    label = tmx.sym.Reshape(tmx.sym.Variable("softmax_label"), shape=(-1,))
    sym_a = tmx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
    cells = {k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in w_b.items()
             if k.startswith("lstm_")}
    packed = fused.pack_weights(fused.unfuse().unpack_weights(cells))
    w_a = {k: v for k, v in w_b.items() if not k.startswith("lstm_")}
    w_a["lstm_parameters"] = packed["lstm_parameters"].asnumpy()
    ex = sym_a.simple_bind(tmx.cpu(), data=(BATCH, SEQ),
                           softmax_label=(BATCH, SEQ))
    for n, v in w_a.items():
        ex.arg_dict[n][:] = v
    ex.forward(is_train=True, data=x, softmax_label=y)
    ex.backward()
    np.testing.assert_allclose(ex.outputs[0].asnumpy(), got_b["output"],
                               rtol=RTOL, atol=ATOL)
    grads = {n: tmx.nd.array(g.asnumpy(), ctx=tmx.cpu())
             for n, g in ex.grad_dict.items()}
    unpacked = fused.unfuse().pack_weights(fused.unpack_weights(
        {"lstm_parameters": grads["lstm_parameters"]}))
    for k in got_b:
        if k == "output":
            continue
        ref = unpacked[k] if k.startswith("lstm_") else grads[k]
        np.testing.assert_allclose(ref.asnumpy(), got_b[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_lm_checkpoint_serves_in_both_packages(tmp_path):
    """Train two steps with the port, save a checkpoint (1-D
    ``lstm_parameters`` and the init states included), and serve it
    through each package's ``Predictor``; the JAX package's own trained
    params cross back through ``convert``."""
    t = _trainer(tmx)
    _steps(t, _batches(2, seed=68))
    args, aux = t.get_params()
    prefix = os.path.join(str(tmp_path), "lm")
    tmx.model.save_checkpoint(prefix, 1, t.symbol, args, aux)
    x = _batches(1, seed=69)[0][0]
    shapes = {"data": (BATCH, SEQ), "softmax_label": (BATCH, SEQ)}
    outs = []
    for mx in (jmx, tmx):
        sym, arg_p, aux_p = mx.model.load_checkpoint(prefix, 1)
        params = {"arg:" + k: v for k, v in arg_p.items()}
        pred = mx.predict.Predictor(sym, params, shapes, ctx=mx.cpu())
        outs.append(pred.forward(data=x, softmax_label=np.zeros_like(x))
                    .get_output(0))
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)
    assert outs[1].shape == (BATCH * SEQ, VOCAB)
    j = _trainer(jmx)
    j_args = {k: v.asnumpy() for k, v in j.get_params()[0].items()}
    back_args, _ = tmx.convert.params_from_numpy((j_args, {}),
                                                 ctx=tmx.cpu())
    t.set_params(back_args, {})
    for k, v in tmx.convert.params_to_numpy(t.get_params()[0]).items():
        np.testing.assert_array_equal(v, j_args[k])


def test_lm_symbol_arguments_and_inferred_shapes_match_jax():
    """The RNN op's custom shape inference back-fills the parameter
    vector and both init states from the data shape alone."""
    got, ref = [], []
    for mx, lm, out in ((tmx, tlm, got), (jmx, jlm, ref)):
        sym, data_names, label_names = lm.lstm_lm_sym(SEQ, VOCAB, HIDDEN,
                                                      HIDDEN, 2)
        out.append(sym.list_arguments())
        out.append(sym.infer_shape(data=(BATCH, SEQ),
                                   softmax_label=(BATCH, SEQ)))
        out.append(sym.list_outputs())
        assert (data_names, label_names) == (("data",), ("softmax_label",))
    assert got[0] == ref[0] and got[2] == ref[2]
    assert [list(map(tuple, s)) for s in got[1]] == \
        [list(map(tuple, s)) for s in ref[1]]
    shapes = dict(zip(got[0], got[1][0]))
    assert shapes["lstm_init_h"] == shapes["lstm_init_c"] == (2, BATCH,
                                                              HIDDEN)
    assert shapes["lstm_parameters"] == (tmx.ops.nn.rnn_param_size(
        2, HIDDEN, HIDDEN, False, "lstm"),)


def test_trainer_key_seeds_the_dropout_masks():
    """With inter-layer dropout, ``forward_only(key=k)`` draws the masks
    that ``step(key=k)`` then trains with; other keys draw other masks."""
    sym, _, _ = tlm.lstm_lm_sym(SEQ, VOCAB, HIDDEN, HIDDEN, 2, dropout=0.5)
    tr = tmx.parallel.SPMDTrainer(sym, "sgd", dict(SGD), ctx=tmx.cpu())
    tr.bind([("data", (BATCH, SEQ))], [("softmax_label", (BATCH, SEQ))])
    tr.init_params(None, arg_params=_weights())
    x, y = _batches(1, seed=70)[0]
    preview = tr.forward_only(x, y, key=7)[0]
    other = tr.forward_only(x, y, key=8)[0]
    assert not torch.equal(preview, other)
    assert torch.equal(tr.step(x, y, key=7)[0], preview)
    inference = tr.eval_step(x, y)[0]
    assert torch.equal(inference, tr.eval_step(x, y)[0])   # no dropout
