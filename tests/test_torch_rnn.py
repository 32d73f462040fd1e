"""The port's RNN op set against the JAX package's on the CPU: the fused
``RNN`` op (forward and gradients through ``jax.vjp``), the shape and
arithmetic ops of the LSTM language model, ``FusedRNNCell`` against the
unrolled ``LSTMCell`` graph, the RNN initializers and ``Dropout``.

Tolerances: the RNN op at rtol 1e-4 / atol 1e-5 (float32, a recurrence of
up to 5 steps whose matmuls and bias sums are taken in other orders);
the data-movement ops exactly; the scalar ops to float32 rounding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import tensor as jtensor
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import tensor as ttensor

RTOL, ATOL = 1e-4, 1e-5

# (mode, num_layers, bidirectional, state_outputs)
RNN_CASES = [("lstm", 1, False, False), ("lstm", 1, False, True),
             ("lstm", 2, False, False), ("lstm", 2, False, True),
             ("gru", 2, False, True), ("rnn_tanh", 1, False, False),
             ("lstm", 2, True, True)]


def _rnn_inputs(mode, layers, bi, T=5, N=3, I=6, H=4, seed=0):
    rs = np.random.RandomState(seed)
    dirs = 2 if bi else 1
    psize = tnn.rnn_param_size(layers, I, H, bi, mode)
    assert psize == jnn.rnn_param_size(layers, I, H, bi, mode)
    arrays = [rs.standard_normal((T, N, I)).astype(np.float32),
              rs.uniform(-0.5, 0.5, psize).astype(np.float32),
              (0.5 * rs.standard_normal((layers * dirs, N, H))).astype(
                  np.float32)]
    if mode == "lstm":
        arrays.append((0.5 * rs.standard_normal((layers * dirs, N, H)))
                      .astype(np.float32))
    return arrays, H


@pytest.mark.parametrize("case", RNN_CASES,
                         ids=["-".join(map(str, c)) for c in RNN_CASES])
def test_rnn_op_forward_and_gradients_match_jax(case, monkeypatch):
    mode, layers, bi, state_outputs = case
    arrays, H = _rnn_inputs(mode, layers, bi)
    attrs = dict(state_size=H, num_layers=layers, bidirectional=bi,
                 mode=mode, state_outputs=state_outputs)

    def jax_fn(*xs):
        out = jnn.rnn(*xs, **attrs)
        return out if isinstance(out, tuple) else (out,)
    j_outs, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in arrays])
    rs = np.random.RandomState(1)
    heads = [rs.standard_normal(o.shape).astype(np.float32) for o in j_outs]
    j_grads = vjp(tuple(jnp.asarray(h) for h in heads))

    results = []
    for fused in ("1", "0"):
        monkeypatch.setenv("MXTPU_FUSED_KERNELS", fused)
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        out = tnn.rnn(*leaves, **attrs)
        out = out if isinstance(out, tuple) else (out,)
        grads = torch.autograd.grad(out, leaves,
                                    [torch.from_numpy(h) for h in heads])
        results.append(([o.detach().numpy() for o in out],
                        [g.numpy() for g in grads]))
        for got, ref in zip(results[-1][0], j_outs):
            np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL,
                                       atol=ATOL)
        for got, ref in zip(results[-1][1], j_grads):
            np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL,
                                       atol=ATOL)
    # the fused cell's forward repeats the unfused ops: equal bit for bit
    for a, b in zip(results[0][0], results[1][0]):
        np.testing.assert_array_equal(a, b)


def test_rnn_op_shape_inference_matches_jax():
    for mode, layers, bi, so in RNN_CASES:
        attrs = {"state_size": 4, "num_layers": layers, "bidirectional": bi,
                 "mode": mode, "state_outputs": so}
        for data in ((5, 3, 6), None):
            in_shapes = [data, None, None] + ([None] if mode == "lstm"
                                              else [])
            assert tnn._rnn_infer(attrs, in_shapes) == \
                jnn._rnn_infer(attrs, in_shapes)
        assert tnn._rnn_inputs(attrs) == jnn._rnn_inputs(attrs)
        assert tnn._rnn_num_outputs(attrs) == jnn._rnn_num_outputs(attrs)


def _both(jfn, tfn, arrays, **attrs):
    """Run a JAX op and the port's on the same numpy inputs."""
    j = jfn(*[jnp.asarray(a) for a in arrays], **attrs)
    t = tfn(*[torch.from_numpy(np.array(a)) for a in arrays], **attrs)
    j = j if isinstance(j, tuple) else (j,)
    t = t if isinstance(t, tuple) else (t,)
    assert len(j) == len(t)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


RESHAPES = [((4, 6), (0, -1)), ((4, 6), (-1, 3)), ((4, 6), (-1,)),
            ((2, 3, 4), (-2,)), ((2, 3, 4), (0, -2)), ((2, 3, 4), (-3, 0)),
            ((2, 3, 4), (0, -3)), ((2, 12), (0, -4, 3, -1)),
            ((2, 12), (-4, 1, 2, -1)), ((2, 3, 4), (6, 1, -1)),
            ((2, 3, 4), (-1, 0), True), ((2, 3, 4), (0, -1), True),
            ((2, 3, 4), (-4, 1, -1, 0, 0))]


@pytest.mark.parametrize("case", RESHAPES, ids=[str(c) for c in RESHAPES])
def test_reshape_codes_match_jax(case):
    shape, target = case[0], case[1]
    reverse = len(case) > 2
    assert ttensor.infer_reshape(shape, target, reverse) == \
        jtensor.infer_reshape(shape, target, reverse)
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    j, t = _both(jtensor.reshape, ttensor.reshape, [x], shape=target,
                 reverse=reverse)
    np.testing.assert_array_equal(t[0], j[0])
    nd = tmx.nd.array(x, ctx=tmx.cpu()).reshape(target, reverse=reverse)
    np.testing.assert_array_equal(nd.asnumpy(), j[0])


def test_reshape_legacy_target_shape_matches_jax():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for kw in ({"target_shape": (0, 4)}, {"target_shape": (6, 0)},
               {"target_shape": (0, 12), "keep_highest": True}):
        j, t = _both(jtensor.reshape, ttensor.reshape, [x], **kw)
        np.testing.assert_array_equal(t[0], j[0])


def test_shape_ops_match_jax():
    rs = np.random.RandomState(2)
    x = rs.standard_normal((2, 3, 4)).astype(np.float32)
    cases = [
        (jtensor.swapaxes, ttensor.swapaxes, [x], dict(dim1=0, dim2=1)),
        (jtensor.swapaxes, ttensor.swapaxes, [x], dict(dim1=2, dim2=0)),
        (jtensor.expand_dims, ttensor.expand_dims, [x], dict(axis=1)),
        (jtensor.expand_dims, ttensor.expand_dims, [x], dict(axis=-1)),
        (jtensor.tile, ttensor.tile, [x], dict(reps=(1, 2, 1))),
        (jtensor.tile, ttensor.tile, [x[0]], dict(reps=(3,))),
        (jtensor.tile, ttensor.tile, [x[0]], dict(reps=(2, 1, 2))),
        (jnn.concat, tnn.concat, [x, x[:, :1], x], dict(num_args=3, dim=1)),
        (jnn.slice_channel, tnn.slice_channel, [x],
         dict(num_outputs=3, axis=1, squeeze_axis=True)),
        (jnn.slice_channel, tnn.slice_channel, [x],
         dict(num_outputs=2, axis=2)),
    ]
    for jfn, tfn, arrays, attrs in cases:
        j, t = _both(jfn, tfn, arrays, **attrs)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b, err_msg=str(attrs))
    for attrs in (dict(axis=1, keepdims=True), dict(axis=(0, 2)),
                  dict(), dict(axis=1, exclude=True)):
        j = jmx.ops.get_op("sum").fn(jnp.asarray(x), **attrs)
        t = tmx.ops.get_op("sum").fn(torch.from_numpy(x), **attrs)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)


def test_scalar_and_elementwise_ops_match_jax():
    rs = np.random.RandomState(3)
    x = rs.uniform(0.5, 2.0, (3, 5)).astype(np.float32)
    y = rs.uniform(0.5, 2.0, (3, 5)).astype(np.float32)
    for name in ("_plus_scalar", "_minus_scalar", "_rminus_scalar",
                 "_mul_scalar", "_div_scalar", "_rdiv_scalar"):
        j = jmx.ops.get_op(name).fn(jnp.asarray(x), scalar=0.3)
        t = tmx.ops.get_op(name).fn(torch.from_numpy(x), scalar=0.3)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   err_msg=name)
    for name in ("elemwise_add", "elemwise_sub", "elemwise_mul",
                 "elemwise_div"):
        j = jmx.ops.get_op(name).fn(jnp.asarray(x), jnp.asarray(y))
        t = tmx.ops.get_op(name).fn(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   err_msg=name)


def test_symbol_arithmetic_matches_jax():
    x = np.random.RandomState(4).uniform(0.5, 2.0, (2, 3)).astype(np.float32)
    y = x[::-1].copy()
    outs = []
    for mx in (jmx, tmx):
        a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
        net = mx.sym.Group([(a * 2 - b) / 4 + 1 - a * b, -a, 3 - a, 2 / b,
                            a / b, 0.5 * a, a + 2, b - a])
        ex = net.bind(mx.cpu(), {"a": mx.nd.array(x, ctx=mx.cpu()),
                                 "b": mx.nd.array(y, ctx=mx.cpu())})
        outs.append([o.asnumpy() for o in ex.forward()])
        assert len(net) == 8 and len(list(net)) == 8
    for j, t in zip(*outs):
        np.testing.assert_allclose(t, j, rtol=1e-6)


def test_embedding_matches_jax_take():
    rs = np.random.RandomState(5)
    w = rs.standard_normal((7, 3)).astype(np.float32)
    ids = np.array([[0, 6.9, 3.2], [-1, -7, 2]], np.float32)
    j, t = _both(jnn.embedding, tnn.embedding, [ids, w], input_dim=7,
                 output_dim=3)
    np.testing.assert_array_equal(t[0], j[0])
    bad = np.array([7, -8, 1], np.float32)
    j, t = _both(jnn.embedding, tnn.embedding, [bad, w], input_dim=7,
                 output_dim=3)
    np.testing.assert_array_equal(t[0], j[0])   # NaN rows out of range
    assert np.isnan(t[0][:2]).all() and np.isfinite(t[0][2]).all()


def _fused_vs_unfused(mx, params, x, h0, c0, T, H, layers):
    """The fused LSTM stack and its unfused SequentialRNNCell, the latter
    given the fused weights through unpack_weights/pack_weights
    (tests/test_rnn.py:21-72)."""
    ctx = mx.cpu()
    fused = mx.rnn.FusedRNNCell(H, num_layers=layers, mode="lstm",
                                prefix="lstm_", get_next_state=True)
    data = mx.sym.Variable("data")
    f_out, f_states = fused.unroll(T, inputs=data, layout="NTC",
                                   begin_state=fused.begin_state(),
                                   merge_outputs=True)
    fg = mx.sym.Group([f_out] + list(f_states))
    ex = fg.bind(ctx, {"data": mx.nd.array(x, ctx=ctx),
                       "lstm_parameters": mx.nd.array(params, ctx=ctx),
                       "lstm_begin_state_0": mx.nd.array(h0, ctx=ctx),
                       "lstm_begin_state_1": mx.nd.array(c0, ctx=ctx)})
    fused_outs = [o.asnumpy() for o in ex.forward()]
    unfused = fused.unfuse()
    u_out, u_states = unfused.unroll(T, inputs=data, layout="NTC",
                                     begin_state=unfused.begin_state(),
                                     merge_outputs=True)
    unpacked = fused.unpack_weights(
        {"lstm_parameters": mx.nd.array(params, ctx=ctx)})
    grouped = unfused.pack_weights(unpacked)
    bind_args = {"data": mx.nd.array(x, ctx=ctx)}
    bind_args.update(grouped)
    for layer in range(layers):
        bind_args["lstm_l%d_begin_state_0" % layer] = \
            mx.nd.array(h0[layer], ctx=ctx)
        bind_args["lstm_l%d_begin_state_1" % layer] = \
            mx.nd.array(c0[layer], ctx=ctx)
    ug = mx.sym.Group([u_out] + list(u_states))
    ex2 = ug.bind(ctx, bind_args)
    unfused_outs = [o.asnumpy() for o in ex2.forward()]
    return fused_outs, unfused_outs, unpacked


@pytest.mark.parametrize("fused_kernel", ["1", "0"])
def test_fused_rnn_cell_vs_unrolled_lstm_cells(fused_kernel, monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_KERNELS", fused_kernel)
    T, N, I, H, L = 5, 4, 6, 8, 2
    rs = np.random.RandomState(6)
    params = rs.uniform(-0.5, 0.5, tnn.rnn_param_size(L, I, H, False,
                                                      "lstm")).astype("f")
    x = rs.standard_normal((N, T, I)).astype("f")
    h0 = (0.3 * rs.standard_normal((L, N, H))).astype("f")
    c0 = (0.3 * rs.standard_normal((L, N, H))).astype("f")
    t_f, t_u, t_unpacked = _fused_vs_unfused(tmx, params, x, h0, c0, T, H, L)
    j_f, j_u, j_unpacked = _fused_vs_unfused(jmx, params, x, h0, c0, T, H, L)
    # outputs (N, T, H); final states: fused (L, N, H), unfused per layer
    assert len(t_u) == 1 + 2 * L
    np.testing.assert_allclose(t_u[0], t_f[0], rtol=RTOL, atol=ATOL)
    for layer in range(L):
        np.testing.assert_allclose(t_u[1 + 2 * layer], t_f[1][layer],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(t_u[2 + 2 * layer], t_f[2][layer],
                                   rtol=RTOL, atol=ATOL)
    for got, ref in ((t_f, j_f), (t_u, j_u)):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert set(t_unpacked) == set(j_unpacked)
    for k in j_unpacked:
        np.testing.assert_array_equal(t_unpacked[k].asnumpy(),
                                      j_unpacked[k].asnumpy())


def test_pack_unpack_roundtrip_and_unfuse_limits():
    fused = tmx.rnn.FusedRNNCell(5, num_layers=2, mode="lstm",
                                 prefix="lstm_")
    psize = tnn.rnn_param_size(2, 4, 5, False, "lstm")
    flat = np.random.RandomState(7).rand(psize).astype("f")
    params = tmx.nd.array(flat, ctx=tmx.cpu())
    unpacked = fused.unpack_weights({"lstm_parameters": params})
    assert unpacked["lstm_l1_h2h_o_weight"].shape == (5, 5)
    packed = fused.pack_weights(unpacked)
    np.testing.assert_array_equal(packed["lstm_parameters"].asnumpy(), flat)
    np.testing.assert_array_equal(params.asnumpy(), flat)  # copies, no alias
    # every mode unfuses now, into the JAX package's cells
    for kw, kinds in (
            ({"mode": "gru"}, ["GRUCell"]),
            ({"mode": "rnn_tanh"}, ["RNNCell"]),
            ({"mode": "lstm", "bidirectional": True}, ["BidirectionalCell"]),
            ({"mode": "lstm", "num_layers": 2, "dropout": 0.5},
             ["LSTMCell", "DropoutCell", "LSTMCell"])):
        for mx in (tmx, jmx):
            stack = mx.rnn.FusedRNNCell(4, **kw).unfuse()
            assert [type(c).__name__ for c in stack._cells] == kinds


def test_lstm_bias_and_fused_rnn_initializers_match_jax():
    outs = []
    for mx in (jmx, tmx):
        ctx = mx.cpu()
        b = mx.nd.zeros((16,), ctx=ctx)
        mx.initializer.LSTMBias(forget_bias=2.5)("lstm_i2h_bias", b)
        psize = jnn.rnn_param_size(2, 3, 4, False, "lstm")
        p = mx.nd.zeros((psize,), ctx=ctx)
        mx.initializer.FusedRNN(mx.initializer.Constant(0.25), 4, 2,
                                "lstm", forget_bias=1.5)("lstm_parameters", p)
        desc = mx.initializer.InitDesc(
            "lstm_l0_i2h_bias",
            {"__init__": '["lstmbias", {"forget_bias": 3.0}]'})
        b2 = mx.nd.zeros((8,), ctx=ctx)
        mx.initializer.Xavier()(desc, b2)
        outs.append([b.asnumpy(), p.asnumpy(), b2.asnumpy()])
    for j, t in zip(*outs):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(outs[1][0][4:8], 2.5)
    assert outs[1][0].sum() == 10.0


def test_dropout_identity_at_inference_and_rate_in_training():
    x = torch.ones(400, 500)
    gen = torch.Generator().manual_seed(0)
    assert tnn.dropout(x, p=0.3, is_train=False, rng=gen) is x
    y = tnn.dropout(x, p=0.3, is_train=True, rng=gen)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.7) < 0.02
    np.testing.assert_allclose(y[y != 0].numpy(), 1.0 / 0.7, rtol=1e-6)
    # the same generator state draws the same mask
    a = tnn.dropout(x, p=0.5, is_train=True,
                    rng=torch.Generator().manual_seed(3))
    b = tnn.dropout(x, p=0.5, is_train=True,
                    rng=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_dropout_through_the_executor_draws_per_forward():
    """An executor forward hands a needs_rng node a generator seeded from
    the forward's seed and the node's position: two forwards draw two
    masks; backward with out_grads reuses the last forward's mask."""
    data = tmx.sym.Variable("data")
    net = tmx.sym.Dropout(data, p=0.5, name="drop")
    x = np.ones((64, 64), np.float32)
    ex = net.simple_bind(tmx.cpu(), data=x.shape)
    tmx.random.seed(11)
    m1 = ex.forward(is_train=True, data=x)[0].asnumpy()
    m2 = ex.forward(is_train=True, data=x)[0].asnumpy()
    assert not np.array_equal(m1, m2)
    ex.backward(tmx.nd.array(np.ones_like(x), ctx=tmx.cpu()))
    np.testing.assert_array_equal(ex.grad_dict["data"].asnumpy(), m2)
    tmx.random.seed(11)
    again = ex.forward(is_train=True, data=x)[0].asnumpy()
    np.testing.assert_array_equal(again, m1)
    np.testing.assert_array_equal(ex.forward(is_train=False,
                                             data=x)[0].asnumpy(), x)
