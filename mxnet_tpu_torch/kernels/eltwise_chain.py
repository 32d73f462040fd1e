"""eltwise_chain — collapse private elementwise runs into one plan entry.

Port of ``mxnet_tpu/kernels/eltwise_chain.py``.  A run of elementwise ops
is one memory round trip per op: each stage writes its full tensor and the
next reads it back.  The pass (:func:`mxnet_tpu_torch.mxfuse.
pass_eltwise_chain`) makes such a run ONE plan entry at its tail whose
body applies the same op sequence, so values and gradients are those of
the plain plan bit for bit.  In the eager port the body still launches one
kernel per stage: a single generated kernel per chain is later work
(``PERF.md`` counts the launches it would remove).

:data:`ELTWISE_OPS` is the fusable catalog: plain, deterministic,
single-output elementwise math.  Ops with RNG (Dropout), train-mode
branches or a hand-written backward (the loss layers) are absent.
"""
from __future__ import annotations

__all__ = ["ELTWISE_OPS", "make_chain_fn"]

#: registered op names the chain pass may absorb
ELTWISE_OPS = frozenset((
    # unary math
    "Activation", "abs", "sign", "ceil", "floor", "round", "rint",
    "trunc", "fix", "square", "sqrt", "rsqrt", "cbrt", "rcbrt",
    "exp", "log", "log10", "log2", "log1p", "expm1", "clip",
    "smooth_l1", "sin", "cos", "tan", "sinh", "cosh", "tanh",
    "arcsin", "arccos", "arctan", "arcsinh", "arccosh", "arctanh",
    "relu", "sigmoid", "softsign", "negative", "reciprocal", "erf",
    # scalar-attr binary
    "_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
    "_div_scalar", "_rdiv_scalar", "_power_scalar", "_rpower_scalar",
    "_maximum_scalar", "_minimum_scalar",
    # tensor binary (the second operand rides as an extra ref)
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "_maximum", "_minimum",
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_maximum", "broadcast_minimum",
))


def make_chain_fn(stages):
    """Compose a chain body from ``stages`` — a list of ``(op_fn,
    call_attrs, n_side_inputs)`` in chain order.

    The interpreter calls the override at the chain TAIL with the tail's
    own inputs first (the chain value slot plus the tail's side operands)
    followed by the extra refs: the side operands of every earlier stage,
    flattened in chain order.  The tail's ``call_attrs`` arrive as
    keywords too; they are ignored in favour of the closed-over copy (the
    same values).
    """
    head_to_last = stages[:-1]
    tail_fn, tail_attrs, tail_nside = stages[-1]

    def fused(*vals, **_tail_kw):
        x = vals[0]
        tail_sides = vals[1:1 + tail_nside]
        extras = vals[1 + tail_nside:]
        k = 0
        for fn, attrs, nside in head_to_last:
            sides = extras[k:k + nside]
            k += nside
            x = fn(x, *sides, **attrs)
        return tail_fn(x, *tail_sides, **tail_attrs)

    fused.n_stages = len(stages)
    return fused
