"""The port's fused LSTM cell (``kernels/lstm_cell.py``) against the JAX
package's Pallas kernels (run in interpret mode on the CPU, as the JAX
package's own tests run them) and its fused-lax tier.

On the CPU the port's wrappers take the plain versions; the CUDA kernels
themselves are held against the plain versions by the ``cuda``-marked
test at the end (and by ``chip_smoke.py`` on the H100).

Tolerances: float32 at rtol 1e-5 / atol 1e-6 (the same op order; the
sigmoid, tanh and exp of two libraries differ by a few ulp); bfloat16 at
5e-2 (the JAX suite's ``TOL``, tests/test_kernels.py:38-39: the frameworks
round the intermediate products at different points)."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mxnet_tpu.kernels import lstm_cell as jlc
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.kernels import lstm_cell as tlc
from mxnet_tpu_torch.ndarray import tensor_from_numpy

SHAPES = [(5, 7), (16, 128), (3, 50)]
TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _draw(shape, seed=0):
    """gates (B, 4H) with pre-activations spread over the sigmoid's and
    tanh's curved range, c_prev (B, H), and two cotangents."""
    b, h = shape
    rs = np.random.RandomState(seed)
    return [(2.0 * rs.standard_normal((b, 4 * h))).astype(np.float32),
            rs.standard_normal((b, h)).astype(np.float32),
            rs.standard_normal((b, h)).astype(np.float32),
            rs.standard_normal((b, h)).astype(np.float32)]


def _np_dtype(dtype):
    return np.float32 if dtype == "float32" else ml_dtypes.bfloat16


def _port(arrays, dtype):
    return [tensor_from_numpy(a.astype(_np_dtype(dtype))) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _f32(xs):
    return [np.asarray(jnp.asarray(x).astype(jnp.float32))
            if not isinstance(x, torch.Tensor) else x.float().numpy()
            for x in xs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["5x7", "16x128", "3x50"])
def test_plain_forward_matches_pallas_interpret_and_lax(shape, dtype):
    arrays = _draw(shape)
    g, c = _port(arrays[:2], dtype)
    got = _f32(tlc.lstm_cell_plain(g, c))
    jg, jc = _jax(arrays[:2], dtype)
    pallas = _f32(jlc.lstm_cell_pallas(jg, jc, interpret=True))
    lax = _f32(jlc.lstm_cell_lax(jg, jc))
    for ref in (pallas, lax):
        for a, b in zip(got, ref):
            assert a.shape == (shape[0], shape[1])
            np.testing.assert_allclose(a, b, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["5x7", "16x128", "3x50"])
def test_backward_matches_jax_vjp_of_pallas_interpret(shape, dtype):
    """``lstm_cell_bwd_plain`` and the gradients of ``LSTMCellFn``
    against ``jax.vjp`` of the interpret-mode Pallas cell, which reaches
    the Pallas ``_bwd_kernel``."""
    arrays = _draw(shape, seed=1)
    jg, jc, jdh, jdc = _jax(arrays, dtype)
    _, vjp = jax.vjp(lambda a, b: jlc.lstm_cell_pallas(a, b, interpret=True),
                     jg, jc)
    ref = _f32(vjp((jdh, jdc)))
    g, c, dh, dc = _port(arrays, dtype)
    plain = _f32(tlc.lstm_cell_bwd_plain(g, c, dh, dc))
    gl = g.clone().requires_grad_(True)
    cl = c.clone().requires_grad_(True)
    h_out, c_out = tlc.lstm_cell(gl, cl)
    auto = _f32(torch.autograd.grad((h_out, c_out), (gl, cl), (dh, dc)))
    for got in (plain, auto):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, **TOL[dtype])
    assert plain[0].shape == (shape[0], 4 * shape[1])


def test_cpu_routes_to_plain_and_counts_no_launch():
    """A CPU tensor takes the plain versions and launches nothing; the
    backward receives a contiguous zero for an unused output."""
    g, c, dh, _ = _port(_draw((4, 6), seed=2), "float32")
    before = (tlc.LAUNCHES, tlc.BWD_LAUNCHES)
    gl = g.clone().requires_grad_(True)
    h_out, _c = tlc.lstm_cell(gl, c)
    (dg,) = torch.autograd.grad(h_out, gl, dh)
    ref, _ = tlc.lstm_cell_bwd_plain(g, c, dh, torch.zeros_like(c))
    assert torch.equal(dg, ref)
    assert torch.equal(h_out.detach(), tlc.lstm_cell_plain(g, c)[0])
    assert (tlc.LAUNCHES, tlc.BWD_LAUNCHES) == before


def test_fused_lstm_cell_op_shape_inference():
    op = mxt.ops.get_op("_FusedLSTMCell")
    assert op.hidden and op.get_output_names({}) == ("h", "c")
    assert op.get_input_names({}) == ("gates", "prev_c")
    for in_shapes in ([(4, 32), None], [None, (4, 8)], [None, None]):
        assert tlc._flc_infer({}, in_shapes) == jlc._flc_infer({}, in_shapes)
    gates = mxt.sym.Variable("gates")
    prev_c = mxt.sym.Variable("prev_c")
    cell = mxt.sym._FusedLSTMCell(gates, prev_c, name="cell")
    assert cell.list_outputs() == ["cell_h", "cell_c"]
    args, outs, _ = cell.infer_shape(gates=(3, 20))
    assert args == [(3, 20), (3, 5)] and outs == [(3, 5), (3, 5)]
    args, outs, _ = cell.infer_shape_partial(prev_c=(2, 9))
    assert args == [(2, 36), (2, 9)] and outs == [(2, 9), (2, 9)]


def test_fused_lstm_cell_op_forward_matches_jax_op():
    """The registered op, run through each package's executor."""
    import mxnet_tpu as jmx
    arrays = _draw((3, 50), seed=3)
    outs = []
    for mx in (jmx, mxt):
        with mx.name.NameManager():
            cell = mx.sym._FusedLSTMCell(mx.sym.Variable("gates"),
                                         mx.sym.Variable("prev_c"),
                                         name="cell")
        ex = cell.bind(mx.cpu(), {
            "gates": mx.nd.array(arrays[0], ctx=mx.cpu()),
            "prev_c": mx.nd.array(arrays[1], ctx=mx.cpu())})
        outs.append([o.asnumpy() for o in ex.forward()])
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, **TOL["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(7, 13), (32, 200), (3, 2, 50)])
def test_cuda_kernels_match_plain(dtype, shape):
    """On a CUDA card: both kernels against their plain versions, float32
    to 2e-6 (h, c) and 1e-5 (dgates, dc_prev) absolute, bfloat16 to 1e-2
    of each output's range; one launch each; bad inputs raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    b, h = int(np.prod(shape[:-1])), shape[-1]
    arrays = _draw((b, h), seed=4)
    g, c, dh, dc = (torch.from_numpy(a).cuda().to(dt) for a in arrays)
    g = g.reshape(shape[:-1] + (4 * h,))
    c, dh, dc = (t.reshape(shape) for t in (c, dh, dc))
    before = (tlc.LAUNCHES, tlc.BWD_LAUNCHES)
    got = tlc.lstm_cell_fwd(g, c) + tlc.lstm_cell_bwd(g, c, dh, dc)
    ref = tlc.lstm_cell_plain(g, c) + tlc.lstm_cell_bwd_plain(g, c, dh, dc)
    torch.cuda.synchronize()
    assert (tlc.LAUNCHES, tlc.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    for k, (a, r) in enumerate(zip(got, ref)):
        assert a.shape == r.shape and a.dtype == r.dtype
        err = (a.float() - r.float()).abs().max().item()
        if dt == torch.float32:
            assert err <= (2e-6 if k < 2 else 1e-5), (k, err)
        else:
            assert err <= 1e-2 * r.float().abs().max().item(), (k, err)
    with pytest.raises(ValueError):
        tlc.lstm_cell_fwd(g[..., :-1], c)
    with pytest.raises(ValueError):
        tlc.lstm_cell_fwd(g, c.transpose(0, -1).contiguous().transpose(0, -1)
                          if c.ndim == 2 and c.shape[0] > 1 else c.cpu())
    with pytest.raises(TypeError):
        tlc.lstm_cell_fwd(g.half(), c.half())
