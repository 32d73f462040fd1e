"""Flash attention — tiled online-softmax attention.

Port of ``mxnet_tpu/kernels/flash_attention.py``.  Plain attention
materializes the (Tq x Tk) score and probability matrices; the flash
formulation (Dao et al., 2022) streams over key blocks keeping a running
(max, sum-of-exp, accumulator) triple per query row, so nothing quadratic
exists beyond one tile.  Layout (B, T, H, D) at every public function, as
in the JAX package.

- :func:`online_update` — ONE streaming-softmax accumulation step (the
  JAX function, :56-83, with its guards): the plain flash loop runs it per
  key block.
- :func:`flash_attention_plain` — the port of ``flash_attention_lax``
  (:91-130): a Python loop over key blocks in float32.  It is the CPU
  path, the oracle ``chip_smoke.py`` and the tests hold the kernel
  against, and the backward's recompute.
- :func:`flash_attention_fwd` — the kernel wrapper: a CPU tensor takes
  the plain version; a CUDA tensor launches ``csrc/flash_attention.cu``
  (which replaces ``_flash_pallas_fwd`` / ``_flash_kernel``, :137-220) or
  raises.  :func:`flash_route` picks the kernel's route from the dtype and
  head dim: ``mma_bf16`` (bfloat16 on the tensor cores, D <= 128),
  ``tiled_f32`` (register-tiled float32, D <= 128) or ``rowwise`` (the
  first kernel, D up to 256).
- :class:`FlashAttentionFn` — the port of the ``custom_vjp`` pair
  (:223-244): the forward is the kernel and saves q, k, v only; the
  backward recomputes through :func:`flash_attention_plain` with torch
  autograd, as ``_fp_bwd`` recomputes through the lax tier.  The JAX
  package has no backward kernel, and neither has the port.
- :func:`flash_attention` — the routed public function.

Numerics: the streaming softmax reassociates the sum of exponentials, so
parity with the exact softmax of ``parallel.ring_attention.full_attention``
is tolerance-checked (float32 about 1e-5 relative), not bitwise.  A query
row that sees no key (causal with Tq > Tk) gives 0 here, through the
1e-20 floor of the final division, where the exact route gives NaN.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..base import get_env

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_fwd",
           "FlashAttentionFn", "online_update", "default_block", "flash_route",
           "vector_aligned", "LAUNCHES", "ROUTE_LAUNCHES", "ALIGN_COPIES",
           "ROUTES", "MAX_HEAD_DIM", "TILED_MAX_HEAD_DIM"]

#: launches of the CUDA kernel (any route) since the process started (or
#: the caller last reset it); incremented only where a kernel is launched
LAUNCHES = 0

#: the kernel's routes: bfloat16 on the tensor cores, register-tiled
#: float32, and the first kernel (one query row per group of lanes)
ROUTES = ("mma_bf16", "tiled_f32", "rowwise")

#: launches per route, beside ``LAUNCHES`` (which counts them all)
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)

#: tensors the wrapper copied to meet the tiled routes' 16-byte alignment
ALIGN_COPIES = 0

#: the largest head dim the kernel is instantiated for
MAX_HEAD_DIM = 256

#: the largest head dim of the tiled routes; above it, ``rowwise``
TILED_MAX_HEAD_DIM = 128

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def default_block():
    """``MXTPU_FLASH_BLOCK`` (at least 8; 128 when it does not parse)."""
    from . import ENV_FLASH_BLOCK
    try:
        return max(8, int(get_env(ENV_FLASH_BLOCK, 128)))
    except (TypeError, ValueError):
        return 128


def online_update(acc, m_run, s_run, q, k, v, scale, mask):
    """One streaming-softmax accumulation step.

    ``acc`` (B, Tq, H, D) float32, ``m_run``/``s_run`` (B, H, Tq); ``q``
    (B, Tq, H, D); ``k``/``v`` (B, Tk, H, D); ``mask`` broadcastable to
    (B, H, Tq, Tk), True = attend.  Returns the updated triple."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    scores = torch.where(mask, scores, -math.inf)
    m_blk = scores.amax(dim=-1)
    # guard fully-masked rows
    finite = torch.isfinite(m_blk)
    m_safe = torch.where(finite, m_blk, 0.0)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(mask, p, 0.0)
    s_blk = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    # rescale both running state and the new block to the common max; a
    # fully-masked block (s_blk == 0) must not move the running max
    m_new = torch.maximum(m_run, torch.where(s_blk > 0, m_safe, m_run))
    alpha = torch.where(torch.isfinite(m_run), torch.exp(m_run - m_new), 0.0)
    beta = torch.where(finite & (s_blk > 0), torch.exp(m_safe - m_new), 0.0)
    s_new = s_run * alpha + s_blk * beta
    acc_new = acc * alpha.transpose(1, 2)[..., None] + \
        out.to(acc.dtype) * beta.transpose(1, 2)[..., None]
    return acc_new, m_new, s_new


def _finalize(acc, s_run, dtype):
    s = torch.clamp(s_run, min=1e-20)
    return (acc / s.transpose(1, 2)[..., None]).to(dtype)


def _scale(scale, head_dim):
    return scale or (1.0 / math.sqrt(head_dim))


def flash_attention_plain(q, k, v, causal=False, scale=None, block_k=None):
    """Tiled online-softmax attention in plain torch: a loop over key
    blocks of ``block_k`` (default ``MXTPU_FLASH_BLOCK``).  q (B, Tq, H, D),
    k/v (B, Tk, H, D) -> (B, Tq, H, D) in q's dtype, computed in float32.
    Query row i sees key j iff ``j < Tk`` and, when causal,
    ``i + (Tk - Tq) >= j``."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = _scale(scale, D)
    out_dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    bk = min(block_k or default_block(), Tk)
    nk = -(-Tk // bk)
    pad = nk * bk - Tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    # absolute positions: q row i attends k col j iff j - i <= Tk - Tq
    q_pos = torch.arange(Tq, device=dev) + (Tk - Tq)
    acc = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=dev)
    m_run = torch.full((B, H, Tq), -math.inf, device=dev)
    s_run = torch.zeros((B, H, Tq), device=dev)
    for idx in range(nk):
        k_pos = idx * bk + torch.arange(bk, device=dev)
        valid = k_pos < Tk                                 # padding tail
        if causal:
            mask = (q_pos[:, None] >= k_pos[None, :]) & valid[None, :]
        else:
            mask = valid[None, :].expand(Tq, bk)
        blk = slice(idx * bk, (idx + 1) * bk)
        acc, m_run, s_run = online_update(acc, m_run, s_run, q, k[:, blk],
                                          v[:, blk], scale, mask[None, None])
    return _finalize(acc, s_run, out_dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_FNS = {}

_ENTRIES = {"mma_bf16": "mxt_flash_attention_fwd",
            "tiled_f32": "mxt_flash_attention_fwd",
            "rowwise": "mxt_flash_attention_fwd_rowwise"}


def _kernel(route):
    """The C entry point of ``csrc/flash_attention.cu`` for ``route``,
    built and loaded on first use."""
    entry = _ENTRIES[route]
    if entry not in _FNS:
        from . import load_library
        fn = getattr(load_library("flash_attention"), entry)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 14 + \
            [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[entry] = fn
    return _FNS[entry]


def flash_route(dtype, head_dim):
    """The kernel's route for q's ``dtype`` and head dim: ``"mma_bf16"``
    for bfloat16 and ``"tiled_f32"`` for float32 up to
    ``TILED_MAX_HEAD_DIM``, ``"rowwise"`` above it."""
    if head_dim <= TILED_MAX_HEAD_DIM:
        if dtype == torch.bfloat16:
            return "mma_bf16"
        if dtype == torch.float32:
            return "tiled_f32"
    return "rowwise"


def vector_aligned(t):
    """Whether the tiled routes stage (B, T, H, D) ``t`` with 16-byte
    ``cp.async`` copies: its base pointer and its b, t and h strides times
    the element size are multiples of 16 bytes (a dim of length 1 does not
    count), and a row of D elements is a whole number of 16-byte chunks.
    ``csrc/flash_attention.cu`` (``rows_aligned``) decides the same way;
    where it is False the kernel stages with element loads."""
    es = t.element_size()
    if (t.shape[-1] * es) % 16 or t.data_ptr() % 16:
        return False
    return all((st * es) % 16 == 0
               for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def _staged(t, route):
    """``t`` as the kernel takes it: a non-unit head stride is made
    contiguous; for a tiled route, a view whose rows could take 16-byte
    copies but whose base or strides are misaligned is copied into a new
    contiguous tensor (counted in ``ALIGN_COPIES``).  A row that is not a
    whole number of 16-byte chunks (D 5, D 12 in bfloat16) is not copied:
    the kernel stages it with element loads."""
    global ALIGN_COPIES
    if t.stride(-1) != 1 and t.shape[-1] != 1:
        t = t.contiguous()
    if route != "rowwise" and (t.shape[-1] * t.element_size()) % 16 == 0 \
            and not vector_aligned(t):
        t = t.clone(memory_format=torch.contiguous_format)
        ALIGN_COPIES += 1
    return t


def _check_cuda_args(q, k, v):
    """Raise unless the kernel takes these tensors: float32 or bfloat16 q
    (B, Tq, H, D) and k, v (B, Tk, H, D) of its dtype and device, D at
    most ``MAX_HEAD_DIM``."""
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError("flash_attention kernel: dtype %s (float32 or "
                        "bfloat16)" % q.dtype)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention kernel: q, k, v must be (B, T, H, "
                         "D), got %s %s %s" % (tuple(q.shape),
                                               tuple(k.shape),
                                               tuple(v.shape)))
    B, _, H, D = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError("flash_attention kernel: k and v must be (B, Tk, H, "
                         "D) = (%d, Tk, %d, %d), got %s and %s"
                         % (B, H, D, tuple(k.shape), tuple(v.shape)))
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash_attention kernel: %s is %s on %s, q is "
                             "%s on %s" % (name, t.dtype, t.device, q.dtype,
                                           q.device))
    if D > MAX_HEAD_DIM:
        raise ValueError("flash_attention kernel: head dim D=%d is above "
                         "the largest instantiated (%d)" % (D, MAX_HEAD_DIM))


def flash_attention_fwd(q, k, v, causal=False, scale=None, block=None,
                        route=None):
    """The kernel's wrapper: softmax attention (B, Tq, H, D) in q's dtype.

    A CPU tensor takes :func:`flash_attention_plain` (with ``block`` as
    its key block).  A CUDA tensor launches ``csrc/flash_attention.cu`` on
    the current stream, or raises (:func:`_check_cuda_args`), through the
    route :func:`flash_route` picks (``route`` names another one for a
    comparison: ``"rowwise"`` takes any D up to 256, the tiled routes
    only their own dtype and D up to 128).  The kernel takes each
    tensor's strides, so strided views (the model's q, k, v are slices of
    one qkv product) are passed as they are; a tensor whose head dim is
    not contiguous is copied with ``.contiguous()`` first, and, for a
    tiled route, a view whose rows are not 16-byte aligned although D
    elements make whole 16-byte chunks is copied into a new contiguous
    tensor (``ALIGN_COPIES``; the model's views need no copy).  The
    output is a new contiguous tensor; nothing synchronises."""
    global LAUNCHES
    scale = _scale(scale, q.shape[-1])
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_k=block)
    _check_cuda_args(q, k, v)
    B, Tq, H, D = q.shape
    auto = flash_route(q.dtype, D)
    route = route or auto
    if route not in ROUTES or (route != "rowwise" and route != auto):
        raise ValueError("flash_attention kernel: route %r does not take "
                         "%s at D=%d (routes: %s; this one: %s)"
                         % (route, q.dtype, D, ", ".join(ROUTES), auto))
    q, k, v = (_staged(t, route) for t in (q, k, v))
    Tk = k.shape[1]
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    fn = _kernel(route)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Tq, Tk, H, D, q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2), v.stride(0),
                 v.stride(1), v.stride(2), int(bool(causal)), float(scale),
                 _KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed (route "
                           "%s): CUDA error %d" % (route, err))
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the JAX package's recompute backward: the
    forward is the kernel and saves q, k, v only; the backward runs
    :func:`flash_attention_plain` again on detached copies with the same
    key block and takes its gradients (no quadratic residual is kept
    between the passes)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale, ctx.block = causal, scale, block
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                   block=block)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = flash_attention_plain(q, k, v, causal=ctx.causal,
                                        scale=ctx.scale, block_k=ctx.block)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, block=None):
    """Flash attention through :class:`FlashAttentionFn`: the CUDA kernel
    for CUDA tensors, the plain version for CPU ones.  ``scale`` 0 or None
    means ``1/sqrt(D)``; ``block`` (default ``MXTPU_FLASH_BLOCK``) is the
    plain version's and the backward's key block."""
    scale = _scale(scale, q.shape[-1])
    return FlashAttentionFn.apply(q, k, v, bool(causal), float(scale),
                                  int(block or default_block()))
