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
  ``MXTPU_FUSED_KERNELS`` enables ``lstm_cell``; each step of that
  unrolled graph is its own node and launches the cell kernels.

The recurrence of one layer and direction of the fused ``RNN`` op
(``ops/nn.py``; the JAX package's ``lax.scan`` of ``x_proj + h . W^T +
b`` and the cell, ``mxnet_tpu/ops/nn.py:927-931, 1030-1032``) is
:func:`lstm_seq`, through :class:`LSTMSeqFn`, on one of two routes that
:func:`lstm_seq_route` picks from (N, H, dtype):

- ``persistent`` — one launch of ``csrc/lstm_cell.cu``'s
  ``mxt_lstm_seq_fwd`` for all T steps (and one of ``mxt_lstm_seq_bwd``
  for the backward): a grid of thread-block clusters that holds W_h2h in
  the clusters' shared memory (:func:`lstm_seq_plan`).
- ``per_step`` — the loop of one ``addmm`` and one cell-kernel launch a
  step (and a cell-kernel launch and a matmul a step backward), for
  shapes whose W_h2h does not fit (H = 1024 in float32).

:func:`lstm_seq_plain` / :func:`lstm_seq_bwd_plain` are the plain
versions (the forward op for op the per-step loop over
:func:`lstm_cell_plain`; the backward a reverse loop over
:func:`lstm_cell_bwd_plain` and the products), which CPU tensors take.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ..ops.registry import register

__all__ = ["lstm_cell", "LSTMCellFn", "lstm_cell_fwd", "lstm_cell_bwd",
           "lstm_cell_plain", "lstm_cell_bwd_plain", "LAUNCHES",
           "BWD_LAUNCHES", "lstm_seq", "LSTMSeqFn", "lstm_seq_fwd",
           "lstm_seq_bwd", "lstm_seq_plain", "lstm_seq_bwd_plain",
           "lstm_seq_route", "lstm_seq_plan", "lstm_seq_resident", "SeqOut",
           "SEQ_ROUTES", "SEQ_RESIDENT", "SEQ_LAUNCHES", "SEQ_BWD_LAUNCHES",
           "SEQ_GATES_WRITTEN", "ROUTE_LAUNCHES", "SEQ_ROUTE"]

#: launches of the CUDA forward kernel since the process started (or the
#: caller last reset it); incremented only where the kernel is launched
LAUNCHES = 0
#: launches of the CUDA backward kernel, counted the same way
BWD_LAUNCHES = 0

#: the recurrence's routes on the card (see the module docstring)
SEQ_ROUTES = ("persistent", "per_step")
#: launches of the persistent forward kernel, counted as ``LAUNCHES``
SEQ_LAUNCHES = 0
#: launches of the persistent backward kernel
SEQ_BWD_LAUNCHES = 0
#: persistent forward launches that also wrote the gate residuals
SEQ_GATES_WRITTEN = 0
#: sequence passes (forward or backward) run on the card, per route: one a
#: persistent launch, one a per-step loop of T cell launches
ROUTE_LAUNCHES = dict.fromkeys(SEQ_ROUTES, 0)
#: the route :func:`lstm_seq` takes on the card when the caller names
#: none; ``None`` lets :func:`lstm_seq_route` pick.  A script that compares
#: the routes end to end through the ``RNN`` op sets it and restores it.
SEQ_ROUTE = None

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _split(gates, hidden):
    return (torch.sigmoid(gates[..., 0 * hidden:1 * hidden]),
            torch.sigmoid(gates[..., 1 * hidden:2 * hidden]),
            torch.tanh(gates[..., 2 * hidden:3 * hidden]),
            torch.sigmoid(gates[..., 3 * hidden:4 * hidden]))


#: storage types the kernels compute in float32 and round only at their
#: outputs; the plain versions do the same, so in bfloat16 a kernel and its
#: plain version round at the same points
_NARROW = (torch.bfloat16, torch.float16)


def lstm_cell_plain(gates, c_prev):
    """The forward kernel's function (the JAX package's ``_fwd_kernel``,
    :57-67) in plain torch: ``(h, c)`` in c_prev's shape and dtype.  A
    bfloat16 (or float16) cell is computed in float32 and rounded once at
    its outputs, as the kernel computes it."""
    if c_prev.dtype in _NARROW:
        h, c = lstm_cell_plain(gates.float(), c_prev.float())
        return h.to(c_prev.dtype), c.to(c_prev.dtype)
    i, f, g, o = _split(gates, c_prev.shape[-1])
    c = f * c_prev + i * g
    return o * torch.tanh(c), c


def lstm_cell_bwd_plain(gates, c_prev, dh, dc):
    """The backward kernel's function (``_bwd_kernel``, :70-89) in plain
    torch: recompute the activations from (gates, c_prev), then
    ``(dgates, dc_prev)`` for the cotangents ``(dh, dc)`` of ``(h, c)``;
    in float32 for a bfloat16 (or float16) cell, rounded at the outputs."""
    if c_prev.dtype in _NARROW:
        dgates, dc_prev = lstm_cell_bwd_plain(
            gates.float(), c_prev.float(), dh.float(), dc.float())
        return dgates.to(c_prev.dtype), dc_prev.to(c_prev.dtype)
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
    """The C entry points of ``csrc/lstm_cell.cu`` by name."""
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    sigs = {"mxt_lstm_cell_fwd": [ptr] * 4 + [ll] * 2 + [i, ptr],
            "mxt_lstm_cell_bwd": [ptr] * 6 + [ll] * 2 + [i, ptr],
            "mxt_lstm_seq_fwd": [ptr] * 9 + [ll] * 3 + [i] * 3 + [ptr],
            "mxt_lstm_seq_bwd": [ptr] * 9 + [ll] * 3 + [i] * 3 + [ptr],
            "mxt_lstm_seq_smem": [ll, i, i, i, i],
            "mxt_lstm_seq_resident": [ll, ll, i, i, i, i]}
    fns = {}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong if name.endswith("smem") \
            else ctypes.c_int
        fns[name[len("mxt_"):]] = fn
    return fns


_FNS = []


def _kernels():
    """``{name: C entry point}`` of ``csrc/lstm_cell.cu`` (``lstm_cell_fwd``,
    ``lstm_cell_bwd``, ``lstm_seq_fwd``, ``lstm_seq_bwd``,
    ``lstm_seq_smem``, ``lstm_seq_resident``), built and loaded on first
    use."""
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
    fwd = _kernels()["lstm_cell_fwd"]
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
    bwd = _kernels()["lstm_cell_bwd"]
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
# the recurrence: one layer and direction of the fused RNN op
# ---------------------------------------------------------------------------

#: what a sequence forward returns: hs, cs (T, N, H); the final hT, cT
#: (N, H); and, when a gradient is wanted, the residuals of the backward:
#: the gate pre-activations (T, N, 4H) and the states before each step,
#: h_prev = [h0; hs[:-1]] and c_prev = [c0; cs[:-1]] (T, N, H), else None
SeqOut = collections.namedtuple(
    "SeqOut", "hs cs hT cT gates h_prev c_prev")

#: the persistent kernels' block size and per-thread cells (csrc kSeq*)
_SEQ_THREADS = 256
_SEQ_ELEMS = 2
#: dynamic shared memory one block may hold on an H100 (227 KB)
SEQ_SMEM_LIMIT = 232448
#: cluster sizes tried in order: 8 is portable, 16 needs the non-portable
#: attribute and takes the shapes whose weight slice is too large for 8
SEQ_CLUSTERS = (8, 16)
#: clusters of each size an H100 SXM holds at once with one block of the
#: persistent kernels on an SM (cudaOccupancyMaxActiveClusters on the card,
#: chip_smoke.py logs it for every plan it runs): a plan asks for no more,
#: since a cluster beyond them waits for a whole sequence to end
SEQ_RESIDENT = {8: 15, 16: 7}
#: at most this many batch rows a cluster
_SEQ_ROWS = 8
_NO_CLUSTER = 10000   # csrc kErrNoCluster


def _pitch(length, size):
    """Elements of a shared-memory row of ``length`` values (csrc
    ``seq_pitch``): the product's depth step (4 float32, 16 bfloat16),
    then a pitch of 16 mod 32 bytes."""
    step = 4 if size == 4 else 16
    p = -(-length // step) * step
    if p * size % 32 == 0:
        p += 16 // size
    return p


def _seq_smem(hidden, cluster, rows, size, backward):
    """Dynamic shared memory bytes of one block (csrc ``seq_smem``)."""
    units = -(-hidden // cluster)
    R = 4 * units
    if not backward:
        ph = _pitch(hidden, size)
        return R * ph * size + 2 * rows * ph * size + rows * R * 4
    pr = _pitch(R, size)
    return hidden * pr * size + rows * pr * size + 2 * rows * hidden * 4


def lstm_seq_plan(batch, hidden, dtype):
    """The persistent kernels' launch plan for (N, H, dtype), or ``None``
    when no cluster size up to 16 holds the weight slice and buffers in
    one block's shared memory (or the dtype is neither float32 nor
    bfloat16).  A pure function of its arguments.

    Returns ``{"cluster": K, "rows": batch rows a cluster, "clusters",
    "smem_fwd", "smem_bwd"}``: block k of a cluster owns ceil(H / K)
    hidden units and their 4 rows of W_h2h each; a cluster takes as few
    batch rows as let :data:`SEQ_RESIDENT` clusters share the batch, at
    most 8 and at most as many as its threads hold cells for."""
    size = {torch.float32: 4, torch.bfloat16: 2}.get(dtype)
    if size is None or batch < 1 or hidden < 1:
        return None
    for cluster in SEQ_CLUSTERS:
        # the threads hold every cell (row, unit) of a block's tile
        rows = min(_SEQ_ROWS, -(-batch // SEQ_RESIDENT[cluster]),
                   _SEQ_THREADS * _SEQ_ELEMS // -(-hidden // cluster))
        if rows < 1:
            continue
        fwd = _seq_smem(hidden, cluster, rows, size, False)
        bwd = _seq_smem(hidden, cluster, rows, size, True)
        if max(fwd, bwd) <= SEQ_SMEM_LIMIT:
            return {"cluster": cluster, "rows": rows,
                    "clusters": -(-batch // rows), "smem_fwd": fwd,
                    "smem_bwd": bwd}
    return None


def lstm_seq_resident(batch, hidden, dtype, backward=False):
    """Clusters of :func:`lstm_seq_plan`'s plan for (N, H, dtype) that the
    current CUDA device holds at once (the forward kernel's, or the
    backward's); raises when there is no plan or the query fails."""
    plan = _plan_for(batch, hidden, dtype, "backward" if backward
                     else "forward")
    n = _kernels()["lstm_seq_resident"](
        batch, hidden, plan["cluster"], plan["rows"], _KERNEL_DTYPES[dtype],
        int(bool(backward)))
    if n < 0:
        raise RuntimeError("lstm_seq occupancy query failed: CUDA error %d"
                           % -n)
    return n


def lstm_seq_route(batch, hidden, dtype):
    """``"persistent"`` where :func:`lstm_seq_plan` has a plan for (N, H,
    dtype), else ``"per_step"``."""
    return "persistent" if lstm_seq_plan(batch, hidden, dtype) is not None \
        else "per_step"


def _seq_loop(cell, xg, w_h2h, h0, c0, keep):
    """The per-step recurrence: at each step one ``addmm`` (the h2h
    product into the hoisted projection) and ``cell(gates, c) -> (h,
    c)``."""
    h, c = h0, c0
    hs, cs, gates = [], [], []
    wt = w_h2h.t()
    for xb in torch.unbind(xg, dim=0):
        g = torch.addmm(xb, h, wt)
        h, c = cell(g, c)
        hs.append(h)
        cs.append(c)
        if keep:
            gates.append(g)
    if not keep:
        return SeqOut(torch.stack(hs), torch.stack(cs), h, c, None, None,
                      None)
    h_all = torch.stack([h0] + hs)
    c_all = torch.stack([c0] + cs)
    return SeqOut(h_all[1:], c_all[1:], h, c, torch.stack(gates),
                  h_all[:-1], c_all[:-1])


def _seq_bwd_loop(cell_bwd, gates, c_prev, w_h2h, dhs, dhT, dcT):
    """The per-step backward: for t = T-1 .. 0, ``dh = dhs[t] + dh_rec``,
    ``cell_bwd(gates[t], c_prev[t], dh, dc) -> (dgates[t], dc)`` and
    ``dh_rec = dgates[t] . W_h2h``.  Returns ``(dgates, dh0, dc0)``."""
    dh_rec, dc = dhT, dcT
    dgates = [None] * gates.shape[0]
    for t in range(gates.shape[0] - 1, -1, -1):
        dg, dc = cell_bwd(gates[t], c_prev[t], dhs[t] + dh_rec, dc)
        dgates[t] = dg
        dh_rec = torch.matmul(dg, w_h2h)
    return torch.stack(dgates), dh_rec, dc


def lstm_seq_plain(xg, w_h2h, h0, c0, keep=False):
    """The recurrence in plain torch (:class:`SeqOut`): op for op the
    fused ``RNN`` op's per-step loop, ``addmm`` then
    :func:`lstm_cell_plain`; ``keep`` also returns the backward's
    residuals."""
    return _seq_loop(lstm_cell_plain, xg, w_h2h, h0, c0, keep)


def lstm_seq_bwd_plain(gates, c_prev, w_h2h, dhs, dhT, dcT):
    """The recurrence's backward in plain torch: a reverse loop over
    :func:`lstm_cell_bwd_plain` and the ``dgates[t] . W_h2h`` products.
    ``(dgates, dh0, dc0)`` for the cotangents of ``(hs, hT, cT)``; dW_h2h
    is ``dgates^T . h_prev`` (:class:`LSTMSeqFn`)."""
    return _seq_bwd_loop(lstm_cell_bwd_plain, gates, c_prev, w_h2h, dhs,
                         dhT, dcT)


def _check_seq_args(what, first, weight, others):
    """Raise unless the persistent kernels take these tensors: contiguous,
    float32 or bfloat16, of ``first``'s device and dtype: ``first`` a
    (T, N, 4H) sequence, ``weight`` (4H, H), and ``others`` (name, tensor)
    pairs of (T, N, H) sequences or (N, H) states.  Returns ``(T, N, H)``.
    """
    if first.dtype not in _KERNEL_DTYPES:
        raise TypeError("lstm_seq %s kernel: dtype %s (float32 or bfloat16)"
                        % (what, first.dtype))
    T, N, G = first.shape if first.ndim == 3 else (0, 0, 0)
    H = G // 4
    if T < 1 or N < 1 or H < 1 or G != 4 * H:
        raise ValueError("lstm_seq %s kernel: needs a (T, N, 4H) sequence "
                         "with T, N, H >= 1, got %s"
                         % (what, tuple(first.shape)))
    want = [("w_h2h", weight, (4 * H, H))] + [
        (n, t, (N, H) if t.ndim == 2 else (T, N, H)) for n, t in others]
    for name, t, shape in [("xg/gates", first, (T, N, 4 * H))] + want:
        if t.device != first.device or t.dtype != first.dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                "lstm_seq %s kernel: %s must be a contiguous %s %s tensor "
                "on %s, got %s %s on %s (contiguous %s)" % (
                    what, name, shape, first.dtype, first.device,
                    tuple(t.shape), t.dtype, t.device, t.is_contiguous()))
    return T, N, H


def _seq_launch(fn, what, args, T, N, H, dtype, device, plan):
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*[a if isinstance(a, int) or a is None else a.data_ptr()
                   for a in args], T, N, H, plan["cluster"], plan["rows"],
                 _KERNEL_DTYPES[dtype], stream)
    if err == _NO_CLUSTER:
        raise RuntimeError(
            "lstm_seq %s kernel: no cluster of %d blocks with %d bytes of "
            "shared memory each can be resident on this device"
            % (what, plan["cluster"], plan["smem_bwd" if what == "backward"
                                           else "smem_fwd"]))
    if err != 0:
        raise RuntimeError("lstm_seq %s kernel launch failed: CUDA error %d"
                           % (what, err))


def _plan_for(N, H, dtype, what):
    plan = lstm_seq_plan(N, H, dtype)
    if plan is None:
        raise ValueError("lstm_seq %s kernel: (N, H) = (%d, %d) in %s does "
                         "not fit the persistent kernel (route per_step)"
                         % (what, N, H, dtype))
    return plan


def _check_route(route):
    if route not in SEQ_ROUTES:
        raise ValueError("lstm_seq: route %r (routes: %s)"
                         % (route, ", ".join(SEQ_ROUTES)))


def lstm_seq_fwd(xg, w_h2h, h0, c0, keep=False, route="persistent"):
    """The recurrence's forward on the card (:class:`SeqOut`).

    A CPU tensor takes :func:`lstm_seq_plain`.  On a CUDA tensor, route
    ``persistent`` launches ``mxt_lstm_seq_fwd`` once on the current
    stream, or raises: contiguous float32/bfloat16 xg (T, N, 4H), w_h2h
    (4H, H), h0 and c0 (N, H) of one dtype and device, at a shape
    :func:`lstm_seq_plan` has a plan for.  With ``keep`` the kernel also
    writes the gate pre-activations, and hs and cs are written into
    (T + 1)-step buffers whose first step holds h0 and c0 (two copies), so
    h_prev and c_prev are views of them.  Route ``per_step`` runs the loop
    of ``addmm`` and :func:`lstm_cell_fwd` (one cell-kernel launch a
    step)."""
    global SEQ_LAUNCHES, SEQ_GATES_WRITTEN
    if not xg.is_cuda:
        return lstm_seq_plain(xg, w_h2h, h0, c0, keep)
    _check_route(route)
    if route == "per_step":
        ROUTE_LAUNCHES["per_step"] += 1
        return _seq_loop(lstm_cell_fwd, xg, w_h2h, h0, c0, keep)
    T, N, H = _check_seq_args("forward", xg, w_h2h,
                              (("h0", h0), ("c0", c0)))
    plan = _plan_for(N, H, xg.dtype, "forward")
    new = dict(dtype=xg.dtype, device=xg.device)
    if keep:
        h_all = torch.empty((T + 1, N, H), **new)
        c_all = torch.empty((T + 1, N, H), **new)
        h_all[0].copy_(h0)
        c_all[0].copy_(c0)
        hs, cs = h_all[1:], c_all[1:]
        gates = torch.empty_like(xg)
    else:
        hs = torch.empty((T, N, H), **new)
        cs = torch.empty((T, N, H), **new)
        gates = None
    hT = torch.empty((N, H), **new)
    cT = torch.empty((N, H), **new)
    _seq_launch(_kernels()["lstm_seq_fwd"], "forward",
                (xg, w_h2h, h0, c0, hs, cs, gates, hT, cT), T, N, H,
                xg.dtype, xg.device, plan)
    SEQ_LAUNCHES += 1
    ROUTE_LAUNCHES["persistent"] += 1
    if not keep:
        return SeqOut(hs, cs, hT, cT, None, None, None)
    SEQ_GATES_WRITTEN += 1
    return SeqOut(hs, cs, hT, cT, gates, h_all[:-1], c_all[:-1])


def lstm_seq_bwd(gates, c_prev, w_h2h, dhs, dhT, dcT, route="persistent"):
    """The recurrence's backward on the card: ``(dgates, dh0, dc0)``.

    A CPU tensor takes :func:`lstm_seq_bwd_plain`.  On a CUDA tensor,
    route ``persistent`` launches ``mxt_lstm_seq_bwd`` once on the current
    stream, or raises: gates (T, N, 4H), c_prev and dhs (T, N, H), dhT and
    dcT (N, H), w_h2h (4H, H), contiguous, of one float32/bfloat16 dtype
    and device.  Route ``per_step`` runs the reverse loop of
    :func:`lstm_cell_bwd` (one cell-kernel launch a step) and the
    products."""
    global SEQ_BWD_LAUNCHES
    if not gates.is_cuda:
        return lstm_seq_bwd_plain(gates, c_prev, w_h2h, dhs, dhT, dcT)
    _check_route(route)
    if route == "per_step":
        ROUTE_LAUNCHES["per_step"] += 1
        return _seq_bwd_loop(lstm_cell_bwd, gates, c_prev, w_h2h, dhs, dhT,
                             dcT)
    T, N, H = _check_seq_args(
        "backward", gates, w_h2h, (("c_prev", c_prev), ("dhs", dhs),
                                   ("dhT", dhT), ("dcT", dcT)))
    plan = _plan_for(N, H, gates.dtype, "backward")
    dgates = torch.empty_like(gates)
    dh0 = torch.empty_like(dhT)
    dc0 = torch.empty_like(dcT)
    _seq_launch(_kernels()["lstm_seq_bwd"], "backward",
                (gates, c_prev, w_h2h, dhs, dhT, dcT, dgates, dh0, dc0), T,
                N, H, gates.dtype, gates.device, plan)
    SEQ_BWD_LAUNCHES += 1
    ROUTE_LAUNCHES["persistent"] += 1
    return dgates, dh0, dc0


def _route(xg, route):
    """The route a sequence on ``xg``'s device takes: ``None`` on the CPU
    (the plain versions), else ``route``, :data:`SEQ_ROUTE`, or
    :func:`lstm_seq_route`'s pick, checked."""
    if not xg.is_cuda:
        return None
    route = route or SEQ_ROUTE or lstm_seq_route(
        xg.shape[1], xg.shape[2] // 4, xg.dtype)
    _check_route(route)
    return route


class LSTMSeqFn(torch.autograd.Function):
    """``(xg, w_h2h, h0, c0) -> (hs, hT, cT)`` with a hand-written
    backward.  The forward saves the gate pre-activations and the h and c
    sequences before each step; the backward returns dxg = dgates,
    dW_h2h = dgates^T . h_prev (one matmul), dh0 and dc0.  ``route`` is
    the card's route (``None`` on the CPU: the plain versions)."""

    @staticmethod
    def forward(ctx, xg, w_h2h, h0, c0, route):
        out = lstm_seq_fwd(xg, w_h2h, h0, c0, keep=True, route=route)
        ctx.route = route
        ctx.save_for_backward(out.gates, out.c_prev, out.h_prev, w_h2h)
        return out.hs, out.hT, out.cT

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        gates, c_prev, h_prev, w_h2h = ctx.saved_tensors
        dgates, dh0, dc0 = lstm_seq_bwd(
            gates, c_prev, w_h2h, dhs.contiguous(), dhT.contiguous(),
            dcT.contiguous(), route=ctx.route)
        T, N, G = dgates.shape
        dw = torch.matmul(dgates.reshape(T * N, G).t(),
                          h_prev.reshape(T * N, G // 4))
        return dgates, dw, dh0, dc0, None


def lstm_seq(xg, w_h2h, h0, c0, route=None):
    """One layer and direction of the LSTM recurrence: ``(hs, hT, cT)``
    from the hoisted projection xg (T, N, 4H) with both biases added,
    w_h2h (4H, H) and the initial states (N, H).

    On the card it takes ``route`` (``"persistent"`` or ``"per_step"``)
    or, when none is named, :data:`SEQ_ROUTE` or :func:`lstm_seq_route`'s
    pick; on the CPU the plain versions.  Through :class:`LSTMSeqFn` when
    a gradient is wanted; otherwise the forward alone, which writes no
    residuals."""
    args = tuple(t.contiguous() for t in (xg, w_h2h, h0, c0))
    route = _route(args[0], route)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return LSTMSeqFn.apply(*args, route)
    out = lstm_seq_fwd(*args, route=route)
    return out.hs, out.hT, out.cT


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
