"""Analytic roofline accounting for the fused kernels.

The port's own copy of ``mxnet_tpu/kernels/roofline.py`` (jax-free and
analytic there too; the port imports nothing of the JAX package), so the
bounds ``chip_smoke.py`` prints use the reference's accounting.

A kernel's best-case time on a device is bounded below by
``max(flops / peak_flops, bytes_moved / mem_bandwidth)`` — the classic
roofline.  ``workload(name, **shape)`` returns the analytic ``(flops,
bytes)`` for one kernel invocation at the given shapes, counting ideal
traffic: every input read once, every output written once — exactly what
a perfectly fused single pass moves.  The unfused composition's traffic
is also reported (``unfused_bytes``): each intermediate materialized to
memory and read back.

The counts are the reference's formulas unchanged: the flash-attention
workload bills the full T x T square even when the attention is causal
(a causal kernel needs about half of it).
"""
from __future__ import annotations

__all__ = ["workload", "roofline_seconds", "bound_side"]


def _bn_act(n, c, hw, itemsize):
    """Fused BatchNorm(+activation) training pass over NCHW data.

    flops: ~2 passes over the data for the batch stats (sum, sumsq) and
    ~4 ops/element for normalize+scale+shift+activate.
    fused bytes: read x once for stats, read x once for normalize, write
    y once, plus the tiny per-channel vectors.
    unfused bytes: the composition additionally materializes the
    normalized output and re-reads it for the activation (+2 passes).
    """
    elems = n * c * hw
    flops = 6 * elems
    chan = 6 * c * itemsize                 # gamma/beta/stats vectors
    fused = (2 * elems + elems) * itemsize + chan
    unfused = fused + 2 * elems * itemsize
    return flops, fused, unfused


def _lstm_cell(b, h, itemsize):
    """Fused LSTM cell elementwise block: gates (B, 4H) + c_prev (B, H)
    -> h, c.  ~10 transcendental-ish ops per hidden element.

    fused: read gates + c_prev, write h + c.
    unfused: the split/sigmoid/tanh/mul/add chain materializes ~7
    intermediate (B, H) tensors (4 activated gates, candidate product,
    forget product, tanh(c)) and re-reads each.
    """
    elems = b * h
    flops = 10 * elems
    fused = (4 * elems + elems + 2 * elems) * itemsize
    unfused = fused + 2 * 7 * elems * itemsize
    return flops, fused, unfused


def _lstm_seq(t, n, h, itemsize, backward=False, keep=True):
    """One layer and direction of the LSTM recurrence in one kernel
    (``kernels/lstm_cell.py`` ``lstm_seq_fwd`` / ``lstm_seq_bwd``):
    2 T N 4H H flops of recurrent products (h . W^T forward, dgates . W
    backward) plus the cell's ~10 (forward) or ~20 (backward) per hidden
    element.

    fused: forward reads xg (T, N, 4H), W_h2h (4H, H), h0 and c0 and
    writes hs and cs (T, N, H), hT and cT and, with ``keep``, the gate
    pre-activations (T, N, 4H); backward reads the gates, c_prev and dhs,
    W_h2h, dhT and dcT and writes dgates, dh0 and dc0.
    unfused (the per-step route): each step's product re-reads W_h2h and
    writes the (N, 4H) pre-activations, which the cell kernel reads back.
    """
    cells = t * n * h
    flops = 2 * t * n * 4 * h * h + (20 if backward else 10) * cells
    weight = 4 * h * h
    if backward:
        fused = (4 * cells + cells + cells + weight + 2 * n * h
                 + 4 * cells + 2 * n * h) * itemsize
    else:
        fused = (4 * cells + weight + 2 * n * h + 2 * cells
                 + (4 * cells if keep else 0) + 2 * n * h) * itemsize
    unfused = fused + (t - 1) * weight * itemsize + 2 * 4 * cells * itemsize
    return flops, fused, unfused


def _flash_attention(b, t, heads, d, itemsize):
    """Attention over (B, T, H, D): 2 matmuls of 2*B*H*T*T*D flops plus
    softmax (~5 flops/score).

    fused (flash): q/k/v read once, output written once — the T x T
    score matrix never exists.
    unfused: scores and probabilities each materialized AND re-read
    (4 passes over B*H*T*T).
    """
    scores = b * heads * t * t
    flops = 2 * 2 * scores * d + 5 * scores
    qkv = 3 * b * t * heads * d * itemsize
    out = b * t * heads * d * itemsize
    fused = qkv + out
    unfused = fused + 4 * scores * itemsize
    return flops, fused, unfused


def _eltwise_chain(n, c, hw, depth, itemsize):
    """A ``depth``-op private elementwise run over an (N, C, HW)
    tensor, ~1 flop per element per op.

    fused: one read + one write for the whole chain.
    unfused: EVERY stage materializes its output and the next reads it
    back — ``depth`` read+write round trips, the entire reason the
    chain pass exists.
    """
    elems = n * c * hw
    flops = depth * elems
    fused = 2 * elems * itemsize
    unfused = 2 * depth * elems * itemsize
    return flops, fused, unfused


def _concat_fuse(n, c, hw, widths, itemsize):
    """``len(widths)`` sibling 1x1 convs over one (N, C, HW) input
    merged into a single GEMM of ``sum(widths)`` output channels.

    flops are identical (per-output-channel math is unchanged); the
    fused form reads the input ONCE instead of once per sibling — plus
    the (dominant, unmodeled) GEMM-efficiency win of one wide matmul
    over several narrow ones, which is why the measured speedup beats
    this bytes-only bound.
    """
    total = sum(widths)
    elems_in = n * c * hw
    flops = 2 * c * total * n * hw
    w_bytes = c * total * itemsize
    out_bytes = n * total * hw * itemsize
    fused = elems_in * itemsize + w_bytes + out_bytes
    unfused = len(widths) * elems_in * itemsize + w_bytes + out_bytes
    return flops, fused, unfused


def _pool_act(n, c, hw, stride, itemsize):
    """act→max-pool reordered to pool-first over (N, C, HW), pool
    stride ``stride`` per spatial dim (output HW/stride² elements).

    flops: ~window compares per output + 1 act op per element touched.
    fused (pool first): read x, write pooled, activate in-register —
    the activation touches stride²-fewer elements.
    unfused (act first): activate AND materialize the full tensor,
    read it back for pooling, write pooled.
    """
    elems = n * c * hw
    pooled = elems // (stride * stride)
    flops = 9 * pooled + pooled          # compares + act on pooled
    fused = (elems + pooled) * itemsize
    unfused = (elems + elems + elems + pooled) * itemsize
    return flops, fused, unfused


_WORKLOADS = {
    "bn_act": _bn_act,
    "lstm_cell": _lstm_cell,
    "lstm_seq": _lstm_seq,
    "flash_attention": _flash_attention,
    "eltwise_chain": _eltwise_chain,
    "concat_fuse": _concat_fuse,
    "pool_act": _pool_act,
}


def workload(name, itemsize=4, **shape):
    """Analytic cost of one fused-kernel invocation.

    Returns ``{"flops", "fused_bytes", "unfused_bytes"}``.  Shapes:
    ``bn_act(n, c, hw)``, ``lstm_cell(b, h)``,
    ``lstm_seq(t, n, h, backward=False, keep=True)``,
    ``flash_attention(b, t, heads, d)``,
    ``eltwise_chain(n, c, hw, depth)``,
    ``concat_fuse(n, c, hw, widths)``, ``pool_act(n, c, hw, stride)``.
    """
    if name not in _WORKLOADS:
        raise KeyError("unknown kernel workload %r (have: %s)"
                       % (name, sorted(_WORKLOADS)))
    flops, fused, unfused = _WORKLOADS[name](itemsize=itemsize, **shape)
    return {"flops": int(flops), "fused_bytes": int(fused),
            "unfused_bytes": int(unfused)}


def roofline_seconds(flops, nbytes, peak_flops, mem_bw):
    """Lower-bound seconds for a kernel moving ``nbytes`` and computing
    ``flops`` on a machine with the given peaks (flops/s, bytes/s)."""
    t_c = flops / peak_flops if peak_flops else 0.0
    t_m = nbytes / mem_bw if mem_bw else 0.0
    return max(t_c, t_m)


def bound_side(flops, nbytes, peak_flops, mem_bw):
    """Which roofline side binds: 'compute' or 'memory'."""
    t_c = flops / peak_flops if peak_flops else 0.0
    t_m = nbytes / mem_bw if mem_bw else 0.0
    return "compute" if t_c >= t_m else "memory"
