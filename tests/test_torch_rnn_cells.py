"""The port's RNN cells (``mxnet_tpu_torch/rnn/rnn_cell.py``), the
``Sequence*`` ops (``ops/nn.py``) and the RNN checkpoint helpers
(``rnn/rnn.py``) against the JAX package's, on the CPU.

Each cell is unrolled into a graph in both packages, bound on the CPU
with the same numpy weights and inputs, run forward in training mode and
backward with the same head gradients.  ``DropoutCell`` and
``ZoneoutCell`` run with p = 0 and, with p > 0, in inference, where they
are exact; with p > 0 in training only their mask statistics are
checked.  ``FusedRNNCell.unfuse()`` is held against the fused ``RNN`` op
for every mode, bidirectional and with dropout.

Tolerances: rtol 1e-4 / atol 1e-5 for outputs and gradients (float32 on
both sides, matmuls summed in other orders over up to 6 steps); the
``Sequence*`` ops, which only move and mask values, exactly."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import nn as jnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import nn as tnn

RTOL, ATOL = 1e-4, 1e-5
N, T, I, H = 3, 6, 5, 4


def _cell(mx, kind, prefix=""):
    """A fresh cell (or stack) of ``kind`` in package ``mx``."""
    r = mx.rnn
    if kind == "rnn_tanh":
        return r.RNNCell(H, activation="tanh", prefix=prefix + "rnn_")
    if kind == "rnn_relu":
        return r.RNNCell(H, activation="relu", prefix=prefix + "rnn_")
    if kind == "gru":
        return r.GRUCell(H, prefix=prefix + "gru_")
    if kind == "lstm":
        return r.LSTMCell(H, prefix=prefix + "lstm_")
    if kind == "dropout0":
        stack = r.SequentialRNNCell()
        stack.add(r.GRUCell(H, prefix="g0_"))
        stack.add(r.DropoutCell(0.0, prefix="d0_"))
        stack.add(r.GRUCell(H, prefix="g1_"))
        return stack
    if kind == "zoneout0":
        return r.ZoneoutCell(r.LSTMCell(H, prefix="z_"), 0.0, 0.0)
    if kind == "residual":
        return r.ResidualCell(r.RNNCell(I, activation="tanh", prefix="res_"))
    if kind == "bi_lstm":
        return r.BidirectionalCell(r.LSTMCell(H, prefix="bl_"),
                                   r.LSTMCell(H, prefix="br_"),
                                   output_prefix="bi_")
    if kind == "bi_gru_stack":
        stack = r.SequentialRNNCell()
        stack.add(r.BidirectionalCell(r.GRUCell(H, prefix="l0l_"),
                                      r.GRUCell(H, prefix="l0r_"),
                                      output_prefix="bi0_"))
        stack.add(r.LSTMCell(H, prefix="top_"))
        return stack
    raise ValueError(kind)


def _graph(mx, cell, merged=True):
    """The cell unrolled over T steps of a (N, T, I) input, merged outputs
    and the final states grouped."""
    data = mx.sym.Variable("data")
    inputs = data if merged else [
        mx.sym.Reshape(s, shape=(0, -1)) for s in mx.sym.SliceChannel(
            data, axis=1, num_outputs=T, squeeze_axis=1)]
    outputs, states = cell.unroll(T, inputs=inputs, merge_outputs=True)
    return mx.sym.Group([outputs] + list(states))


def _draw(sym, seed):
    arg_shapes, out_shapes, _ = sym.infer_shape(data=(N, T, I))
    rs = np.random.RandomState(seed)
    args = {n: (rs.uniform(-0.6, 0.6, s) if n != "data"
                else rs.standard_normal(s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    heads = [rs.standard_normal(s).astype(np.float32) for s in out_shapes]
    return args, heads


def _run(mx, sym, args, heads, is_train=True):
    """Bind on the CPU, forward, and (in training, given ``heads``)
    backward: (outputs, gradients) as numpy."""
    ctx = mx.cpu()
    ex = sym.simple_bind(ctx, grad_req="write" if is_train else "null",
                         **{n: a.shape for n, a in args.items()})
    for n, a in args.items():
        ex.arg_dict[n][:] = a
    outs = [o.asnumpy() for o in ex.forward(is_train=is_train)]
    grads = {}
    if is_train and heads is not None:
        ex.backward([mx.nd.array(h, ctx=ctx) for h in heads])
        grads = {n: g.asnumpy() for n, g in ex.grad_dict.items()
                 if g is not None}
    return outs, grads


def _assert_close(got, ref):
    (go, gg), (ro, rg) = got, ref
    assert len(go) == len(ro)
    for a, b in zip(go, ro):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert set(gg) == set(rg)
    for k in rg:
        np.testing.assert_allclose(gg[k], rg[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


CELLS = ["rnn_tanh", "rnn_relu", "gru", "lstm", "dropout0", "zoneout0",
         "residual", "bi_lstm", "bi_gru_stack"]


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "list"])
@pytest.mark.parametrize("kind", CELLS)
def test_cell_unroll_matches_jax(kind, merged):
    """Forward (outputs and final states) and backward (every argument's
    gradient, the input's included) of the unrolled cell."""
    syms = {mx: _graph(mx, _cell(mx, kind), merged) for mx in (jmx, tmx)}
    assert syms[tmx].list_arguments() == syms[jmx].list_arguments()
    assert syms[tmx].list_outputs() == syms[jmx].list_outputs()
    args, heads = _draw(syms[tmx], 1)
    _assert_close(_run(tmx, syms[tmx], args, heads),
                  _run(jmx, syms[jmx], args, heads))


def test_bidirectional_merged_input_reverses_on_the_device():
    """A merged input reaches the reversed cell through SequenceReverse
    (no host step): the graph holds the op, and the right cell's first
    step sees the last input step."""
    sym = _graph(tmx, _cell(tmx, "bi_lstm"), merged=True)
    ops = {n["op"] for n in json.loads(sym.tojson())["nodes"]}
    assert "SequenceReverse" in ops
    args, heads = _draw(sym, 2)
    out, _ = _run(tmx, sym, args, heads, is_train=False)
    # the left half of the last step equals a forward LSTM's last output
    one = _graph(tmx, tmx.rnn.LSTMCell(H, prefix="bl_"), merged=True)
    sub = {k: v for k, v in args.items() if k in one.list_arguments()}
    ref, _ = _run(tmx, one, sub, None, is_train=False)
    np.testing.assert_allclose(out[0][:, :, :H], ref[0], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kind", ["dropout", "zoneout"])
def test_dropout_and_zoneout_exact_in_inference(kind):
    """p > 0 in inference: no mask, the same graph value as the JAX
    package's."""
    outs = []
    for mx in (jmx, tmx):
        if kind == "dropout":
            cell = mx.rnn.SequentialRNNCell()
            cell.add(mx.rnn.LSTMCell(H, prefix="a_"))
            cell.add(mx.rnn.DropoutCell(0.5, prefix="d_"))
            cell.add(mx.rnn.LSTMCell(H, prefix="b_"))
        else:
            cell = mx.rnn.ZoneoutCell(mx.rnn.GRUCell(H, prefix="z_"),
                                      zoneout_outputs=0.5,
                                      zoneout_states=0.3)
        outs.append(_graph(mx, cell))
    args, _ = _draw(outs[1], 3)
    got, _ = _run(tmx, outs[1], args, None, is_train=False)
    ref, _ = _run(jmx, outs[0], args, None, is_train=False)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_dropout_cell_mask_statistics_in_training():
    """p = 0.4 in training: about 40 % of the units are zero and the rest
    are the input over 0.6."""
    p = 0.4
    cell = tmx.rnn.DropoutCell(p)
    data = tmx.sym.Variable("data")
    outputs, _ = cell.unroll(T, inputs=data, merge_outputs=True)
    x = np.random.RandomState(4).uniform(1, 2, (64, T, 50)).astype("f")
    ex = outputs.simple_bind(tmx.cpu(), grad_req="null", data=x.shape)
    ex.arg_dict["data"][:] = x
    y = ex.forward(is_train=True)[0].asnumpy()
    zero = y == 0
    assert abs(zero.mean() - p) < 0.02
    np.testing.assert_allclose(y[~zero], x[~zero] / (1 - p), rtol=1e-6)


def test_zoneout_cell_mask_statistics_in_training():
    """zoneout_outputs 0.5: each output unit is either the cell's new
    output or the previous step's output, about half of each."""
    cell = tmx.rnn.ZoneoutCell(tmx.rnn.RNNCell(32, prefix="z_"),
                               zoneout_outputs=0.5)
    base = tmx.rnn.RNNCell(32, prefix="z_")
    data = tmx.sym.Variable("data")
    out_z, _ = cell.unroll(2, inputs=data, merge_outputs=True)
    out_b, _ = base.unroll(2, inputs=data, merge_outputs=True)
    rs = np.random.RandomState(5)
    args = {"data": rs.standard_normal((256, 2, 8)).astype("f"),
            "z_i2h_weight": rs.uniform(-1, 1, (32, 8)).astype("f"),
            "z_i2h_bias": np.zeros(32, "f"),
            "z_h2h_weight": rs.uniform(-1, 1, (32, 32)).astype("f"),
            "z_h2h_bias": np.zeros(32, "f")}
    zo, _ = _run(tmx, out_z, args, None, is_train=True)
    # step 0: a zoned-out unit keeps the zero previous output
    step0 = zo[0][:, 0]
    kept = step0 == 0
    assert abs(kept.mean() - 0.5) < 0.03
    bo, _ = _run(tmx, out_b, args, None, is_train=False)
    np.testing.assert_allclose(step0[~kept], bo[0][:, 0][~kept], rtol=1e-6)


UNFUSE = [("rnn_relu", 2, False, 0.0), ("rnn_tanh", 1, False, 0.0),
          ("gru", 2, False, 0.0), ("lstm", 2, False, 0.0),
          ("lstm", 2, True, 0.0), ("gru", 2, True, 0.0),
          ("lstm", 3, False, 0.5), ("rnn_tanh", 2, True, 0.5)]


@pytest.mark.parametrize("case", UNFUSE, ids=["-".join(map(str, c))
                                              for c in UNFUSE])
def test_unfuse_matches_the_fused_op(case):
    """``FusedRNNCell.unfuse()`` gives a stack whose graph, given the
    fused vector's weights through ``unpack_weights`` and the stack's
    ``pack_weights``, computes the fused ``RNN`` op's outputs (in
    inference when there is dropout) and, without dropout, its
    gradients; the port's stack equals the JAX package's."""
    mode, layers, bi, p = case
    results = {}
    for mx in (jmx, tmx):
        fused = mx.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                    bidirectional=bi, dropout=p,
                                    prefix="f_")
        stack = fused.unfuse()
        n_cells = layers * (1 if p == 0 else 2) - (1 if p else 0)
        assert len(stack._cells) == n_cells
        data = mx.sym.Variable("data")
        f_out, _ = fused.unroll(T, inputs=data, merge_outputs=True)
        s_out, _ = stack.unroll(T, inputs=data, merge_outputs=True)
        results[mx] = (fused, stack, f_out, s_out)
    fused, stack, f_out, s_out = results[tmx]
    f_args, heads = _draw(f_out, 6)
    ctx = tmx.cpu()
    per_gate = fused.unpack_weights(
        {"f_parameters": tmx.nd.array(f_args["f_parameters"], ctx=ctx)})
    cells = stack.pack_weights(per_gate)
    s_args = {"data": f_args["data"]}
    s_args.update({k: v.asnumpy() for k, v in cells.items()})
    assert set(s_args) == set(s_out.list_arguments())
    train = p == 0
    f_res = _run(tmx, f_out, f_args, heads, is_train=train)
    s_res = _run(tmx, s_out, s_args, heads, is_train=train)
    np.testing.assert_allclose(s_res[0][0], f_res[0][0], rtol=RTOL,
                               atol=ATOL)
    if train:
        np.testing.assert_allclose(s_res[1]["data"], f_res[1]["data"],
                                   rtol=RTOL, atol=ATOL)
        back = fused.pack_weights(stack.unpack_weights(
            {k: tmx.nd.array(g, ctx=ctx) for k, g in s_res[1].items()
             if k != "data"}))
        np.testing.assert_allclose(back["f_parameters"].asnumpy(),
                                   f_res[1]["f_parameters"], rtol=RTOL,
                                   atol=ATOL)
    j_res = _run(jmx, results[jmx][3], s_args, heads, is_train=train)
    np.testing.assert_allclose(s_res[0][0], j_res[0][0], rtol=RTOL,
                               atol=ATOL)


def test_pack_unpack_roundtrip_every_mode():
    """Unpack then pack returns the fused vector, for every mode, both
    directions and 2 layers; the unpacked entries are copies."""
    for mode in ("rnn_relu", "rnn_tanh", "gru", "lstm"):
        for bi in (False, True):
            fused = tmx.rnn.FusedRNNCell(5, num_layers=2, mode=mode,
                                         bidirectional=bi, prefix="p_")
            size = tnn.rnn_param_size(2, 4, 5, bi, mode)
            flat = np.random.RandomState(7).rand(size).astype("f")
            params = tmx.nd.array(flat, ctx=tmx.cpu())
            unpacked = fused.unpack_weights({"p_parameters": params})
            j_unpacked = jmx.rnn.FusedRNNCell(
                5, num_layers=2, mode=mode, bidirectional=bi,
                prefix="p_").unpack_weights({"p_parameters":
                                             jmx.nd.array(flat)})
            assert set(unpacked) == set(j_unpacked)
            for k in j_unpacked:
                np.testing.assert_array_equal(unpacked[k].asnumpy(),
                                              j_unpacked[k].asnumpy())
            packed = fused.pack_weights(unpacked)
            np.testing.assert_array_equal(packed["p_parameters"].asnumpy(),
                                          flat)


def test_rnn_checkpoint_roundtrip(tmp_path):
    """save_rnn_checkpoint writes per-gate weights; load_rnn_checkpoint
    packs them back; either package reads the other's files; the epoch
    callback saves every ``period`` epochs."""
    fused = tmx.rnn.FusedRNNCell(H, num_layers=2, mode="lstm", prefix="c_")
    data = tmx.sym.Variable("data")
    out, _ = fused.unroll(T, inputs=data, merge_outputs=True)
    size = tnn.rnn_param_size(2, I, H, False, "lstm")
    flat = np.random.RandomState(8).rand(size).astype("f")
    args = {"c_parameters": tmx.nd.array(flat, ctx=tmx.cpu())}
    prefix = str(tmp_path / "rnn")
    tmx.rnn.save_rnn_checkpoint(fused, prefix, 3, out, args, {})
    _, raw, _ = tmx.model.load_checkpoint(prefix, 3)
    assert "c_parameters" not in raw and "c_l1_h2h_o_weight" in raw
    sym, arg, aux = tmx.rnn.load_rnn_checkpoint(fused, prefix, 3)
    np.testing.assert_array_equal(arg["c_parameters"].asnumpy(), flat)
    assert sym.list_arguments() == out.list_arguments() and aux == {}
    j_fused = jmx.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                   prefix="c_")
    _, j_arg, _ = jmx.rnn.load_rnn_checkpoint(j_fused, prefix, 3)
    np.testing.assert_array_equal(j_arg["c_parameters"].asnumpy(), flat)
    # the unfused stack loads the per-gate form as its own
    _, u_arg, _ = tmx.rnn.load_rnn_checkpoint(fused.unfuse(), prefix, 3)
    assert u_arg["c_l0_i2h_weight"].shape == (4 * H, I)
    cb = tmx.rnn.do_rnn_checkpoint([fused], prefix + "-cb", period=2)
    for epoch in range(4):
        cb(epoch, out, args, {})
    for epoch, present in ((1, False), (2, True), (3, False), (4, True)):
        assert os.path.exists("%s-cb-%04d.params" % (prefix, epoch)) \
            == present


SEQ_CASES = [(op, use) for op in ("sequence_last", "sequence_mask",
                                  "sequence_reverse")
             for use in (False, True)]


@pytest.mark.parametrize("case", SEQ_CASES,
                         ids=["%s-%s" % c for c in SEQ_CASES])
def test_sequence_ops_match_jax(case):
    """Forward exactly, and the data gradient exactly, with and without
    ``sequence_length``; (T, N, C, D) data so the gather broadcasts over
    two trailing axes."""
    op, use = case
    rs = np.random.RandomState(9)
    x = rs.standard_normal((5, 4, 3, 2)).astype(np.float32)
    lens = np.array([2, 5, 1, 3], np.float32)
    attrs = {"use_sequence_length": use}
    if op == "sequence_mask":
        attrs["value"] = -1.5

    def jfn(a, b):
        return getattr(jnn, op)(a, b, **attrs)
    j_out, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(lens))
    head = rs.standard_normal(j_out.shape).astype(np.float32)
    j_dx, _ = vjp(jnp.asarray(head))
    xt = torch.from_numpy(x).requires_grad_(True)
    t_out = getattr(tnn, op)(xt, torch.from_numpy(lens), **attrs)
    (t_dx,) = torch.autograd.grad(t_out, [xt], torch.from_numpy(head))
    np.testing.assert_array_equal(t_out.detach().numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_dx.numpy(), np.asarray(j_dx))


@pytest.mark.parametrize("name", ["SequenceLast", "SequenceMask",
                                  "SequenceReverse"])
def test_sequence_symbols_bind_like_jax(name):
    """The symbols' input names and shapes, and a bound forward/backward
    with a ``sequence_length`` input, as in the JAX package."""
    rs = np.random.RandomState(10)
    x = rs.standard_normal((4, 3, 2)).astype(np.float32)
    lens = np.array([1, 4, 2], np.float32)
    res = []
    for mx in (jmx, tmx):
        sym = getattr(mx.sym, name)(mx.sym.Variable("data"),
                                    mx.sym.Variable("len"),
                                    use_sequence_length=True)
        assert sym.list_arguments() == ["data", "len"]
        shapes = sym.infer_shape(data=x.shape, len=lens.shape)
        out_shape = shapes[1][0]
        head = np.ones(out_shape, np.float32)
        ex = sym.simple_bind(mx.cpu(), grad_req={"data": "write",
                                                 "len": "null"},
                             data=x.shape, len=lens.shape)
        ex.arg_dict["data"][:] = x
        ex.arg_dict["len"][:] = lens
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([mx.nd.array(head, ctx=mx.cpu())])
        res.append((shapes, out, ex.grad_dict["data"].asnumpy()))
    (js, jo, jg), (ts, to, tg) = res
    assert ts == js
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tg, jg)
