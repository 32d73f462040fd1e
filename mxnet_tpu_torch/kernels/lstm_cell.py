"""Fused LSTM cell — all gate math in one kernel.

Port of ``mxnet_tpu/kernels/lstm_cell.py``.  From the (..., 4H) gate
pre-activations in gate order [i, f, c, o] (i2h + h2h + biases already
summed) and the previous cell (..., H)::

    c = sigmoid(f) * c_prev + sigmoid(i) * tanh(g)
    h = sigmoid(o) * tanh(c)

- :func:`lstm_cell` — the cell through :class:`LSTMCellFn`, a
  ``torch.autograd.Function`` (the JAX package's ``custom_vjp``,
  :126-141).  It saves the INPUTS (gates, c_prev) and nothing else, as
  ``cell_fwd`` does (:130-133); the backward recomputes every activation.
  On a CUDA tensor its forward and backward are the hand-written kernels
  of ``csrc/lstm_cell.cu`` (replacing the Pallas ``_fwd_kernel`` and
  ``_bwd_kernel``, :57-89), at every shape: the TPU's ``H % 128 == 0 and
  rows % 8 == 0`` gate (:175) does not exist here.  On a CPU tensor they
  are :func:`lstm_cell_plain` and :func:`lstm_cell_bwd_plain`.
- :func:`lstm_cell_plain` / :func:`lstm_cell_bwd_plain` — the kernels'
  functions in the JAX kernels' op order as plain torch ops: the CPU path
  and the oracle the tests and ``chip_smoke.py`` hold the kernels against.
- the ``_FusedLSTMCell`` op (:184-215), which ``rnn.LSTMCell`` emits when
  ``MXTPU_FUSED_KERNELS`` enables ``lstm_cell``; the fused ``RNN`` op
  (``ops/nn.py``) calls :func:`lstm_cell` at each step directly.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.registry import register

__all__ = ["lstm_cell", "LSTMCellFn", "lstm_cell_fwd", "lstm_cell_bwd",
           "lstm_cell_plain", "lstm_cell_bwd_plain", "LAUNCHES",
           "BWD_LAUNCHES"]

#: launches of the CUDA forward kernel since the process started (or the
#: caller last reset it); incremented only where the kernel is launched
LAUNCHES = 0
#: launches of the CUDA backward kernel, counted the same way
BWD_LAUNCHES = 0

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _split(gates, hidden):
    return (torch.sigmoid(gates[..., 0 * hidden:1 * hidden]),
            torch.sigmoid(gates[..., 1 * hidden:2 * hidden]),
            torch.tanh(gates[..., 2 * hidden:3 * hidden]),
            torch.sigmoid(gates[..., 3 * hidden:4 * hidden]))


def lstm_cell_plain(gates, c_prev):
    """The forward kernel's function (the JAX package's ``_fwd_kernel``,
    :57-67) in plain torch: ``(h, c)`` in c_prev's shape and dtype."""
    i, f, g, o = _split(gates, c_prev.shape[-1])
    c = f * c_prev + i * g
    return o * torch.tanh(c), c


def lstm_cell_bwd_plain(gates, c_prev, dh, dc):
    """The backward kernel's function (``_bwd_kernel``, :70-89) in plain
    torch: recompute the activations from (gates, c_prev), then
    ``(dgates, dc_prev)`` for the cotangents ``(dh, dc)`` of ``(h, c)``."""
    i, f, g, o = _split(gates, c_prev.shape[-1])
    c = f * c_prev + i * g
    tanh_c = torch.tanh(c)
    # dc accumulates the explicit cotangent and the h = o * tanh(c) path
    dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
    do = dh * tanh_c * o * (1.0 - o)
    di = dc * g * i * (1.0 - i)
    df = dc * c_prev * f * (1.0 - f)
    dg = dc * i * (1.0 - g * g)
    return torch.cat([di, df, dg, do], dim=-1), dc * f


def _bind(lib):
    fwd = lib.mxt_lstm_cell_fwd
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + \
        [ctypes.c_int, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.mxt_lstm_cell_bwd
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 + \
        [ctypes.c_int, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return fwd, bwd


_FNS = []


def _kernels():
    """``(forward, backward)`` C entry points of ``csrc/lstm_cell.cu``,
    built and loaded on first use."""
    if not _FNS:
        from . import load_library
        _FNS.append(_bind(load_library("lstm_cell")))
    return _FNS[0]


def _check_cuda_args(gates, c_prev, cell_shaped=()):
    """Raise unless the kernels take these tensors: contiguous
    float32/bfloat16 ``gates`` (..., 4H) and (..., H) tensors of its
    dtype, device and leading shape.  Returns ``(rows, H)``."""
    if gates.dtype not in _KERNEL_DTYPES:
        raise TypeError("lstm_cell kernel: dtype %s (float32 or bfloat16)"
                        % gates.dtype)
    hidden = c_prev.shape[-1] if c_prev.ndim else 0
    if gates.ndim < 1 or not gates.is_contiguous() or hidden == 0 \
            or tuple(gates.shape) != tuple(c_prev.shape[:-1]) + (4 * hidden,):
        raise ValueError(
            "lstm_cell kernel: needs contiguous gates (..., 4H) and c_prev "
            "(..., H), got gates %s strides %s, c_prev %s"
            % (tuple(gates.shape), gates.stride(), tuple(c_prev.shape)))
    for name, t in (("c_prev", c_prev),) + tuple(cell_shaped):
        if t.device != gates.device or t.dtype != gates.dtype \
                or t.shape != c_prev.shape or not t.is_contiguous():
            raise ValueError(
                "lstm_cell kernel: %s must be a contiguous %s %s tensor on "
                "%s, got %s %s on %s" % (name, tuple(c_prev.shape),
                                         gates.dtype, gates.device,
                                         tuple(t.shape), t.dtype, t.device))
    return c_prev.numel() // hidden, hidden


def lstm_cell_fwd(gates, c_prev):
    """The forward kernel's wrapper: ``(h, c)``.

    A CPU tensor takes :func:`lstm_cell_plain`.  A CUDA tensor launches
    ``csrc/lstm_cell.cu`` on the current stream, or raises: contiguous
    float32/bfloat16 gates (..., 4H) and c_prev (..., H) of one dtype and
    device.  The outputs are new tensors; nothing synchronises."""
    global LAUNCHES
    if not gates.is_cuda:
        return lstm_cell_plain(gates, c_prev)
    rows, hidden = _check_cuda_args(gates, c_prev)
    fwd, _ = _kernels()
    h = torch.empty_like(c_prev)
    c = torch.empty_like(c_prev)
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    with torch.cuda.device(gates.device):
        err = fwd(gates.data_ptr(), c_prev.data_ptr(), h.data_ptr(),
                  c.data_ptr(), rows, hidden, _KERNEL_DTYPES[gates.dtype],
                  stream)
    if err != 0:
        raise RuntimeError("lstm_cell kernel launch failed: CUDA error %d"
                           % err)
    LAUNCHES += 1
    return h, c


def lstm_cell_bwd(gates, c_prev, dh, dc):
    """The backward kernel's wrapper: ``(dgates, dc_prev)``.

    A CPU tensor takes :func:`lstm_cell_bwd_plain`.  A CUDA tensor
    launches ``csrc/lstm_cell.cu``'s backward on the current stream, or
    raises.  ``dh`` and ``dc`` are made contiguous first: autograd may
    hand in an expanded zero for an output nothing consumed."""
    global BWD_LAUNCHES
    if not gates.is_cuda:
        return lstm_cell_bwd_plain(gates, c_prev, dh, dc)
    dh, dc = dh.contiguous(), dc.contiguous()
    rows, hidden = _check_cuda_args(gates, c_prev, (("dh", dh), ("dc", dc)))
    _, bwd = _kernels()
    dgates = torch.empty_like(gates)
    dc_prev = torch.empty_like(c_prev)
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    with torch.cuda.device(gates.device):
        err = bwd(gates.data_ptr(), c_prev.data_ptr(), dh.data_ptr(),
                  dc.data_ptr(), dgates.data_ptr(), dc_prev.data_ptr(), rows,
                  hidden, _KERNEL_DTYPES[gates.dtype], stream)
    if err != 0:
        raise RuntimeError("lstm_cell backward kernel launch failed: CUDA "
                           "error %d" % err)
    BWD_LAUNCHES += 1
    return dgates, dc_prev


class LSTMCellFn(torch.autograd.Function):
    """The cell with its hand-written backward: the JAX package's
    ``custom_vjp`` pair (:126-141).  The forward saves its inputs, not
    the activations; the backward recomputes them inside the kernel."""

    @staticmethod
    def forward(ctx, gates, c_prev):
        ctx.save_for_backward(gates, c_prev)
        return lstm_cell_fwd(gates, c_prev)

    @staticmethod
    def backward(ctx, dh, dc):
        gates, c_prev = ctx.saved_tensors
        return lstm_cell_bwd(gates, c_prev, dh, dc)


def lstm_cell(gates, c_prev):
    """The fused cell: ``(h, c)`` through :class:`LSTMCellFn` — the CUDA
    kernels for CUDA tensors, their plain versions for CPU ones."""
    return LSTMCellFn.apply(gates.contiguous(), c_prev.contiguous())


# ---------------------------------------------------------------------------
# symbolic surface: the op rnn_cell.LSTMCell emits when fusion is enabled
# ---------------------------------------------------------------------------

def _flc_infer(attrs, in_shapes):
    g = in_shapes[0]
    if g is None:
        if len(in_shapes) > 1 and in_shapes[1] is not None:
            c = tuple(in_shapes[1])
            return [(c[0], 4 * c[1]), c], [c, c], []
        return in_shapes, [None, None], []
    c = (g[0], g[1] // 4)
    return [tuple(g), c], [c, c], []


@register("_FusedLSTMCell", input_names=("gates", "prev_c"), num_outputs=2,
          output_names=("h", "c"), infer_shape=_flc_infer, hidden=True)
def _fused_lstm_cell(gates, prev_c):
    """Fused LSTM gate block (kernels/lstm_cell.py): (B, 4H)
    pre-activations + previous cell -> (next_h, next_c)."""
    return lstm_cell(gates, prev_c)
