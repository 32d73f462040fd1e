"""Attention over the sequence axis (port of
``mxnet_tpu/parallel/ring_attention.py``).

- :func:`full_attention` — single-device attention, q/k/v (B, T, H, D).
  Long sequences (``Tk > MXTPU_FLASH_BLOCK``) route through the flash
  kernel (``kernels/flash_attention.py``) when ``MXTPU_FUSED_KERNELS``
  enables ``flash_attention``; shorter ones and ``MXTPU_FUSED_KERNELS=0``
  take the exact softmax below.  The two routes differ on a query row
  that sees no key (causal with Tq > Tk): the flash route gives 0, the
  exact route NaN (softmax of an all ``-inf`` row), as in the JAX package.
- :func:`ring_attention` — the entry point: with no mesh, or a mesh whose
  ``sp`` axis has one device, it is :func:`full_attention`.
- :func:`ring_attention_sharded` — the ring schedule over the ``sp`` axis
  of a mesh inside one process (``parallel/mesh.py``): each position
  holds one query block and the K/V blocks go around the ring
  (``collectives.ppermute``), each hop one ``online_update`` of the flash
  kernel's streaming softmax, the causal mask by block index.

A mesh is anything with a ``shape`` mapping of axis name to size (the JAX
``Mesh.shape`` convention).
"""
from __future__ import annotations

import math

import torch

__all__ = ["ring_attention", "full_attention", "ring_attention_sharded"]


def full_attention(q, k, v, causal=False, scale=None):
    """Single-device attention: q (B, Tq, H, D), k/v (B, Tk, H, D) ->
    (B, Tq, H, D).  ``scale`` 0 or None means ``1/sqrt(D)``."""
    B, Tq, H, D = q.shape
    scale = scale or (1.0 / math.sqrt(D))
    Tk = k.shape[1]
    from ..kernels import fused_enabled
    if fused_enabled("flash_attention"):
        from ..kernels import flash_attention as fa
        if Tk > fa.default_block():
            return fa.flash_attention(q, k, v, causal=causal, scale=scale)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = torch.tril(torch.ones((Tq, Tk), dtype=torch.bool,
                                     device=q.device), Tk - Tq)
        scores = torch.where(mask, scores, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _ring_body(axis_name, n_blocks, causal, scale, q, k, v, my_idx):
    """The streaming accumulation over the ring's hops on one position:
    its query block against each K/V block in turn, the K/V passed to the
    next position after every hop (``collectives.ppermute``)."""
    from ..kernels.flash_attention import online_update
    from . import collectives as C
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    acc = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
    m_run = torch.full((B, H, Tq), -math.inf, device=q.device)
    s_run = torch.zeros((B, H, Tq), device=q.device)
    perm = [(i, (i + 1) % n_blocks) for i in range(n_blocks)]
    for hop in range(n_blocks):
        # after h hops of the i -> i+1 ring, position i holds block
        # (i - h) mod n
        kv_idx = (my_idx - hop) % n_blocks
        if causal:
            q_pos = my_idx * Tq + torch.arange(Tq, device=q.device)
            k_pos = kv_idx * Tk + torch.arange(Tk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        else:
            mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
        # each hop is ONE step of the flash kernel's online softmax, so the
        # ring and the single-device kernel cannot drift apart
        acc, m_run, s_run = online_update(acc, m_run, s_run, q, k, v,
                                          scale, mask[None, None])
        if hop + 1 < n_blocks:
            k = C.ppermute(k, axis_name, perm)
            v = C.ppermute(v, axis_name, perm)
    s_run = torch.clamp(s_run, min=1e-20)
    return (acc / s_run.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, axis_name="sp", causal=False,
                           scale=None):
    """Ring attention with q/k/v sharded on the sequence axis (axis 1)
    over ``axis_name`` of the in-process ``mesh``.  Called from outside
    the mesh, q/k/v are the global (B, T, H, D) tensors and the result is
    too; called inside one of the mesh's positions (``compat.shard_map``),
    they are that position's sequence block."""
    from . import collectives as C
    from .compat import shard_map
    n_blocks = mesh.shape[axis_name]
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    if C.current(mesh) is not None:
        return _ring_body(axis_name, n_blocks, causal, scale, q, k, v,
                          C.axis_index(axis_name))
    spec = C.P(None, axis_name, None, None)

    def local_fn(q_blk, k_blk, v_blk):
        return _ring_body(axis_name, n_blocks, causal, scale, q_blk, k_blk,
                          v_blk, C.axis_index(axis_name))
    return shard_map(local_fn, mesh, (spec, spec, spec), spec)(q, k, v)


def ring_attention(q, k, v, mesh=None, axis_name="sp", causal=False,
                   scale=None):
    """Entry point: ring attention when a mesh with more than one device
    on ``axis_name`` is given, :func:`full_attention` otherwise."""
    if mesh is not None and axis_name in mesh.shape and \
            mesh.shape[axis_name] > 1:
        return ring_attention_sharded(q, k, v, mesh, axis_name, causal, scale)
    return full_attention(q, k, v, causal=causal, scale=scale)
