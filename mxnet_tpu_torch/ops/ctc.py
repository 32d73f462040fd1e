"""CTC loss (port of ``mxnet_tpu/ops/ctc.py``; the reference's warpctc
plugin, plugin/warpctc/warpctc-inl.h).

The forward recursion is a loop over time in log space with the JAX
package's own log-sum-exp (``_NEG_INF = -1e30``, the same masks), so
values and masks agree; autograd through it gives the gradient, as
``jax.grad`` through the JAX package's ``lax.scan`` does (warp-ctc's
softmax minus alignment posteriors).

Conventions of the reference plugin:
  - blank label id = 0; ``label`` entries equal to 0 are padding and are
    compacted out, keeping order;
  - ``WarpCTC``'s ``data`` is (T*N, alphabet), time-major flattened; its
    output is softmax(data) and its backward writes d(sum of NLL)/d(data),
    IGNORING the incoming head gradient (a loss layer); the label gets no
    gradient.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register

_NEG_INF = -1e30


def _compact_labels(labels):
    """Move non-blank (non-zero) labels to the front of each row, keeping
    order (reference removeBlank): (compacted, lengths)."""
    blank = (labels == 0).to(torch.int8)
    order = torch.argsort(blank, dim=1, stable=True)
    return torch.gather(labels, 1, order), (1 - blank).sum(1)


def _shift(x, k):
    """x [N, S] shifted right by k along S, _NEG_INF filling the front."""
    return torch.nn.functional.pad(x, (k, 0), value=_NEG_INF)[:, :x.shape[1]]


def ctc_nll(logits, labels):
    """Negative log likelihood of ``labels`` under CTC with blank 0.

    logits: (T, N, A) unnormalized activations (time-major).
    labels: (N, L) int labels; 0 entries are padding.
    Returns (N,) per-sample losses, differentiable in logits."""
    T, N, A = logits.shape
    dev = logits.device
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    labels, lab_len = _compact_labels(labels.to(torch.int64))
    L = labels.shape[1]
    S = 2 * L + 1
    # extended sequence: blank, l1, blank, l2, ..., blank
    ext = torch.zeros((N, S), dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    s_idx = torch.arange(S, device=dev)
    valid = s_idx[None, :] < (2 * lab_len + 1)[:, None]           # (N, S)
    # a path may skip ext[s-2] -> ext[s] only between distinct non-blank
    # labels (odd s, a different char than two slots back)
    ext_m2 = torch.nn.functional.pad(ext, (2, 0), value=-1)[:, :S]
    can_skip = (s_idx[None, :] % 2 == 1) & (ext != ext_m2)
    emit = torch.gather(logp, 2, ext[None].expand(T, N, S))      # (T, N, S)
    neg = torch.full((N, S), _NEG_INF, device=dev)
    alpha = torch.cat([
        emit[0, :, 0:1],
        torch.where(lab_len > 0, emit[0, :, 1], _NEG_INF)[:, None],
        neg[:, 2:]], dim=1)
    for t in range(1, T):
        a1 = _shift(alpha, 1)
        a2 = torch.where(can_skip, _shift(alpha, 2), _NEG_INF)
        m = torch.maximum(alpha, torch.maximum(a1, a2))
        tot = m + torch.log(torch.exp(alpha - m) + torch.exp(a1 - m)
                            + torch.exp(a2 - m))
        tot = torch.where(m <= _NEG_INF / 2, _NEG_INF, tot)
        alpha = torch.where(valid, tot + emit[t], _NEG_INF)
    # logZ = logsumexp over the last two valid extended positions
    last = 2 * lab_len
    a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, (last - 1).clamp(min=0)[:, None])[:, 0]
    a_prev = torch.where(lab_len > 0, a_prev, _NEG_INF)
    m = torch.maximum(a_last, a_prev)
    logz = m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m))
    return -logz


def _ctc_shape(attrs, in_shapes):
    data = in_shapes[0]
    return list(in_shapes), [tuple(data) if data else None], []


class _WarpCTCFn(torch.autograd.Function):
    """softmax(data) forward; the backward recomputes the CTC NLL under
    autograd and returns its gradient, whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, input_length, label_length):
        ctx.save_for_backward(data, label)
        ctx.lengths = (input_length, label_length)
        return torch.softmax(data.to(torch.float32), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        data, label = ctx.saved_tensors
        T, label_length = ctx.lengths
        N = data.shape[0] // T
        A = data.shape[1]
        with torch.enable_grad():
            logits = data.detach().reshape(T, N, A).requires_grad_()
            labels = label.reshape(N, label_length).to(torch.int64)
            (g,) = torch.autograd.grad(ctc_nll(logits, labels).sum(),
                                       logits)
        return g.reshape(T * N, A).to(data.dtype), None, None, None


@register("WarpCTC", input_names=("data", "label"), infer_shape=_ctc_shape)
def warpctc(data, label, label_length=0, input_length=0):
    """CTC loss layer (reference plugin/warpctc).  data: (T*N, alphabet)
    time-major activations; label: (N, label_length) with 0 = blank/pad.
    Output: softmax(data); backward = CTC gradient."""
    label_length = int(label_length)
    input_length = int(input_length)
    if input_length <= 0 or label_length <= 0:
        raise MXNetError("WarpCTC requires input_length and label_length")
    if data.dim() != 2:
        raise MXNetError("WarpCTC data must be 2-D (T*N, alphabet)")
    return _WarpCTCFn.apply(data, label.detach().reshape(-1, label_length),
                            input_length, label_length)


def _ctc_loss_shape(attrs, in_shapes):
    data = in_shapes[0]
    out = (data[1],) if data else None
    return list(in_shapes), [out], []


@register("ctc_loss", input_names=("data", "label"),
          aliases=("_contrib_ctc_loss", "CTCLoss"),
          infer_shape=_ctc_loss_shape)
def ctc_loss_op(data, label):
    """Per-sample CTC negative log likelihood.  data: (T, N, A) time-major
    activations, label: (N, L) with 0 = padding.  Returns (N,) losses,
    differentiable in data."""
    if data.dim() != 3:
        raise MXNetError("ctc_loss data must be 3-D (T, N, alphabet)")
    return ctc_nll(data, label.detach())
