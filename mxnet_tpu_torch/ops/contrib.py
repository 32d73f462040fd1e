"""Contrib ops (port of ``mxnet_tpu/ops/contrib.py``): ``_contrib_Attention``
for now.  The other contrib ops (MultiBox*, Proposal, fft, count_sketch,
...) come with the op-library slice.
"""
from __future__ import annotations

from .registry import register
from ..base import MXNetError


# ---------------------------------------------------------------------------
# Attention — the symbol-level entry to ``parallel/ring_attention.py``'s
# full_attention (the flash kernel for sequences above one flash block)
# ---------------------------------------------------------------------------

def _attention_infer(attrs, in_shapes):
    q = in_shapes[0]
    if q is None:
        return list(in_shapes), [None], []
    return [tuple(s) if s is not None else None for s in in_shapes], \
        [tuple(q)], []


@register("_contrib_Attention", aliases=("Attention", "attention"),
          input_names=("query", "key", "value"),
          infer_shape=_attention_infer)
def contrib_attention(query, key, value, num_heads=1, causal=False,
                      scale=-1.0):
    """Multi-head scaled-dot-product attention (numerically-stable
    softmax; sequences longer than ``MXTPU_FLASH_BLOCK`` keys take the
    flash kernel).  query/key/value: (batch, seq, d_model); heads split
    from d_model.  Output: (batch, seq_q, d_model)."""
    from ..parallel.ring_attention import full_attention
    num_heads = int(num_heads)
    B, T, D = query.shape
    Tk = key.shape[1]
    if D % num_heads != 0:
        raise MXNetError("d_model %d not divisible by num_heads %d"
                         % (D, num_heads))
    if causal and T > Tk:
        raise MXNetError(
            "causal attention needs seq_q (%d) <= seq_k (%d): earlier "
            "query positions would have no visible keys" % (T, Tk))
    hd = D // num_heads
    q = query.reshape(B, T, num_heads, hd)
    k = key.reshape(B, Tk, num_heads, hd)
    v = value.reshape(B, Tk, num_heads, hd)
    s = None if float(scale) <= 0 else float(scale)
    out = full_attention(q, k, v, causal=bool(causal), scale=s)
    return out.reshape(B, T, D)
