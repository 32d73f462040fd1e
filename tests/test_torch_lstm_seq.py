"""The port's LSTM recurrence (``kernels/lstm_cell.py`` ``lstm_seq``: one
layer and direction of the fused ``RNN`` op) against the JAX package's
``lax.scan`` of its Pallas cell (run in interpret mode on the CPU, as the
JAX package's own tests run it).

On the CPU the port takes the plain versions; the persistent CUDA kernels
themselves are held against the plain versions by the ``cuda``-marked test
at the end (and by ``chip_smoke.py`` on the H100).

Tolerances: float32 against JAX at rtol 1e-4 / atol 1e-5, as the other
parity tests (two libraries' sigmoid, tanh and matmul round differently,
carried over the steps); the hand backward against torch autograd in
float64 at 1e-10 (the same function, summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from mxnet_tpu.kernels import lstm_cell as jlc
import mxnet_tpu_torch  # noqa: F401  (registers the ops)
from mxnet_tpu_torch.kernels import lstm_cell as tlc
from mxnet_tpu_torch.ops import nn as tnn

RTOL, ATOL = 1e-4, 1e-5
SHAPES = [(6, 3, 5), (4, 2, 16)]   # (T, N, H)
IDS = ["6x3x5", "4x2x16"]


def _draw(shape, seed=0):
    """xg (T, N, 4H) spread over the sigmoid's and tanh's curved range,
    W_h2h (4H, H) at about Xavier's scale, h0 and c0 (N, H), and the
    cotangents of (hs, hT, cT)."""
    T, N, H = shape
    rs = np.random.RandomState(seed)
    f = np.float32
    return {"xg": (1.5 * rs.standard_normal((T, N, 4 * H))).astype(f),
            "w": rs.uniform(-0.5, 0.5, (4 * H, H)).astype(f),
            "h0": (0.5 * rs.standard_normal((N, H))).astype(f),
            "c0": (0.5 * rs.standard_normal((N, H))).astype(f),
            "dhs": rs.standard_normal((T, N, H)).astype(f),
            "dhT": rs.standard_normal((N, H)).astype(f),
            "dcT": rs.standard_normal((N, H)).astype(f)}


def _jax_scan(xg, w, h0, c0):
    """The JAX package's fused-RNN step (mxnet_tpu/ops/nn.py:927-931)
    under lax.scan (:1030-1032), its cell the interpret-mode Pallas kernel
    pair (custom_vjp: the backward reaches the Pallas _bwd_kernel).
    Returns ``(hs, cs, hT, cT)``."""
    def step(carry, x):
        h, c = carry
        h, c = jlc.lstm_cell_pallas(x + jnp.dot(h, w.T), c, interpret=True)
        return (h, c), (h, c)
    (hT, cT), (hs, cs) = lax.scan(step, (h0, c0), xg)
    return hs, cs, hT, cT


def _jax_seq(xg, w, h0, c0):
    hs, _, hT, cT = _jax_scan(xg, w, h0, c0)
    return hs, hT, cT


def _torch(arrays, dtype=torch.float32, grad=False):
    return {k: torch.tensor(v, dtype=dtype, requires_grad=grad)
            for k, v in arrays.items()}


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_forward_and_gradients_match_jax_scan_of_pallas_cell(shape):
    a = _draw(shape)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    ref, vjp = jax.vjp(_jax_seq, j["xg"], j["w"], j["h0"], j["c0"])
    ref_grads = vjp((j["dhs"], j["dhT"], j["dcT"]))

    t = _torch(a)
    plain = tlc.lstm_seq_plain(t["xg"], t["w"], t["h0"], t["c0"])
    jhs, jcs, jhT, jcT = _jax_scan(j["xg"], j["w"], j["h0"], j["c0"])
    for got, r in zip(plain, (jhs, jcs, jhT, jcT)):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)

    g = _torch(a, grad=True)
    leaves = (g["xg"], g["w"], g["h0"], g["c0"])
    hs, hT, cT = tlc.lstm_seq(*leaves)
    assert type(hs.grad_fn).__name__ == "LSTMSeqFnBackward"
    grads = torch.autograd.grad((hs, hT, cT), leaves,
                                (t["dhs"], t["dhT"], t["dcT"]))
    for got, r in zip((hs, hT, cT), ref):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(r),
                                   rtol=RTOL, atol=ATOL)
    for name, got, r in zip(("dxg", "dW_h2h", "dh0", "dc0"), grads,
                            ref_grads):
        assert got.shape == r.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bwd_plain_matches_autograd_of_the_step_loop_float64(shape):
    """``lstm_seq_bwd_plain`` (and dW_h2h = dgates^T . h_prev) against
    torch autograd through the per-step plain loop, in float64."""
    a = _draw(shape, seed=1)
    t = _torch(a, dtype=torch.float64)
    g = _torch(a, dtype=torch.float64, grad=True)
    leaves = (g["xg"], g["w"], g["h0"], g["c0"])
    out = tlc.lstm_seq_plain(*leaves)
    auto = torch.autograd.grad((out.hs, out.hT, out.cT), leaves,
                               (t["dhs"], t["dhT"], t["dcT"]))
    kept = tlc.lstm_seq_plain(t["xg"], t["w"], t["h0"], t["c0"], keep=True)
    assert kept.gates.shape == a["xg"].shape
    torch.testing.assert_close(kept.h_prev[1:], kept.hs[:-1])
    torch.testing.assert_close(kept.c_prev[0], t["c0"])
    dgates, dh0, dc0 = tlc.lstm_seq_bwd_plain(
        kept.gates, kept.c_prev, t["w"], t["dhs"], t["dhT"], t["dcT"])
    T, N, G = dgates.shape
    dw = dgates.reshape(T * N, G).t() @ kept.h_prev.reshape(T * N, G // 4)
    for got, ref in zip((dgates, dw, dh0, dc0), auto):
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-10)


def test_route_and_plan_at_the_lm_the_size_limit_and_h1024():
    f32, bf16 = torch.float32, torch.bfloat16
    assert tlc.lstm_seq_route(32, 200, f32) == "persistent"
    assert tlc.lstm_seq_route(32, 200, bf16) == "persistent"
    assert tlc.lstm_seq_route(128, 1024, f32) == "per_step"
    assert tlc.lstm_seq_route(128, 1024, bf16) == "per_step"
    assert tlc.lstm_seq_route(32, 200, torch.float16) == "per_step"
    # the LM's layer: 8 blocks a cluster, 25 units a block, the batch over
    # no more clusters than the card holds at once
    plan = tlc.lstm_seq_plan(32, 200, f32)
    assert (plan["cluster"], plan["rows"], plan["clusters"]) == (8, 3, 11)
    assert plan["clusters"] <= tlc.SEQ_RESIDENT[plan["cluster"]]
    # float32 at batch 32: the largest H whose weight slice fits one block
    # (W^T 452 x 116 floats of the 16-block cluster: 230128 bytes)
    last = max(h for h in range(200, 1100)
               if tlc.lstm_seq_route(32, h, f32) == "persistent")
    assert last == 452
    plan = tlc.lstm_seq_plan(32, last, f32)
    assert plan["cluster"] == 16
    assert max(plan["smem_fwd"], plan["smem_bwd"]) <= tlc.SEQ_SMEM_LIMIT
    assert tlc.lstm_seq_route(32, last + 1, f32) == "per_step"
    for cluster in tlc.SEQ_CLUSTERS:
        rows = min(8, -(-32 // tlc.SEQ_RESIDENT[cluster]))
        assert max(tlc._seq_smem(last + 1, cluster, rows, 4, bwd)
                   for bwd in (False, True)) > tlc.SEQ_SMEM_LIMIT
    # every shared-memory row pitch is 16 mod 32 bytes (no bank conflict
    # between the rows a warp reads)
    for size in (4, 2):
        for n in (1, 13, 100, 200, 452, 1024):
            p = tlc._pitch(n, size)
            assert p >= n and p * size % 32 == 16


def _lstm_seq_nodes(t):
    """``LSTMSeqFnBackward`` nodes in the autograd graph of ``t``."""
    seen, todo, found = set(), [t.grad_fn], 0
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        found += type(fn).__name__ == "LSTMSeqFnBackward"
        todo.extend(f for f, _ in fn.next_functions)
    return found


@pytest.mark.parametrize("fused", ["1", "0"])
def test_cpu_rnn_op_goes_through_lstm_seq_fn_and_counts_no_launch(
        fused, monkeypatch):
    """The fused ``RNN`` op on the CPU: one ``LSTMSeqFn`` a layer when
    ``MXTPU_FUSED_KERNELS`` enables ``lstm_cell`` (none with 0), no kernel
    launch counted, and the same outputs and gradients either way."""
    monkeypatch.setenv("MXTPU_FUSED_KERNELS", fused)
    T, N, I, H, L = 5, 3, 4, 6, 2
    rs = np.random.RandomState(3)
    size = tnn.rnn_param_size(L, I, H, False, "lstm")
    params = torch.tensor(rs.uniform(-0.5, 0.5, size).astype("f"),
                          requires_grad=True)
    data = torch.tensor(rs.standard_normal((T, N, I)).astype("f"))
    h0 = torch.tensor((0.3 * rs.standard_normal((L, N, H))).astype("f"))
    c0 = torch.tensor((0.3 * rs.standard_normal((L, N, H))).astype("f"))
    counts = (tlc.LAUNCHES, tlc.BWD_LAUNCHES, tlc.SEQ_LAUNCHES,
              tlc.SEQ_BWD_LAUNCHES, dict(tlc.ROUTE_LAUNCHES))
    out, hT, cT = tnn.rnn(data, params, h0, c0, state_size=H, num_layers=L,
                          mode="lstm", state_outputs=True)
    assert _lstm_seq_nodes(out) == (L if fused == "1" else 0)
    (grad,) = torch.autograd.grad(out.sum() + hT.sum() + cT.sum(), params)
    assert (tlc.LAUNCHES, tlc.BWD_LAUNCHES, tlc.SEQ_LAUNCHES,
            tlc.SEQ_BWD_LAUNCHES, dict(tlc.ROUTE_LAUNCHES)) == counts
    monkeypatch.setenv("MXTPU_FUSED_KERNELS", "0" if fused == "1" else "1")
    out2, hT2, cT2 = tnn.rnn(data, params, h0, c0, state_size=H,
                             num_layers=L, mode="lstm", state_outputs=True)
    (grad2,) = torch.autograd.grad(out2.sum() + hT2.sum() + cT2.sum(),
                                   params)
    for a, b in ((out, out2), (hT, hT2), (cT, cT2), (grad, grad2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the persistent LSTM kernels)")
    return torch.device("cuda", 0)


#: chip_smoke.py's shapes: the LM's layer, the agreement batch's, an odd
#: one, the float32 size limit at batch 32, and one that takes per_step
CUDA_SHAPES = [(32, 32, 200), (32, 4, 200), (5, 7, 13), (32, 32, 452),
               (8, 128, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CUDA_SHAPES,
                         ids=["x".join(map(str, s)) for s in CUDA_SHAPES])
def test_cuda_kernels_match_plain(card, shape, dtype):
    """On a CUDA card: the route lstm_seq_route picks, forward and
    backward against the plain versions, float32 within 1e-5 and bfloat16
    within 1e-2 of each output's largest magnitude; one launch each on
    the persistent route; bad inputs raise."""
    T, N, H = shape
    a = _draw(shape, seed=4)
    a["w"] = (a["w"] * (6.0 / (5 * H)) ** 0.5 / 0.5).astype(np.float32)
    t = {k: torch.from_numpy(v).to(card).to(dtype) for k, v in a.items()}
    route = tlc.lstm_seq_route(N, H, dtype)
    assert route == ("per_step" if H == 1024 else "persistent")
    before = (tlc.SEQ_LAUNCHES, tlc.SEQ_BWD_LAUNCHES)
    got = tlc.lstm_seq_fwd(t["xg"], t["w"], t["h0"], t["c0"], keep=True,
                           route=route)
    ref = tlc.lstm_seq_plain(t["xg"], t["w"], t["h0"], t["c0"], keep=True)
    got_b = tlc.lstm_seq_bwd(ref.gates, ref.c_prev, t["w"], t["dhs"],
                             t["dhT"], t["dcT"], route=route)
    ref_b = tlc.lstm_seq_bwd_plain(ref.gates, ref.c_prev, t["w"], t["dhs"],
                                   t["dhT"], t["dcT"])
    torch.cuda.synchronize()
    n = 1 if route == "persistent" else 0
    assert (tlc.SEQ_LAUNCHES, tlc.SEQ_BWD_LAUNCHES) == (before[0] + n,
                                                        before[1] + n)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    pairs = [(getattr(got, k), getattr(ref, k))
             for k in ("hs", "cs", "hT", "cT", "gates", "h_prev", "c_prev")]
    for g, r in pairs + list(zip(got_b, ref_b)):
        assert g.shape == r.shape and g.dtype == r.dtype
        err = (g.float() - r.float()).abs().max().item()
        assert err <= tol * r.float().abs().max().item(), err
    if route == "persistent":
        with pytest.raises(ValueError):
            tlc.lstm_seq_fwd(t["xg"][:, :, :-4], t["w"], t["h0"], t["c0"])
        with pytest.raises(ValueError):
            tlc.lstm_seq_fwd(t["xg"], t["w"].t(), t["h0"], t["c0"])
        with pytest.raises(TypeError):
            tlc.lstm_seq_fwd(t["xg"].half(), t["w"].half(), t["h0"].half(),
                             t["c0"].half())
