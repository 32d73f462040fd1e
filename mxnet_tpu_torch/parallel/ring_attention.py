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
  of a mesh; it comes with the multi-GPU slice and raises here.

A mesh is anything with a ``shape`` mapping of axis name to size (the JAX
``Mesh.shape`` convention).
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError

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


def ring_attention_sharded(q, k, v, mesh, axis_name="sp", causal=False,
                           scale=None):
    """Ring attention with q/k/v sharded on the sequence axis over
    ``axis_name`` of ``mesh``: not ported yet."""
    raise MXNetError(
        "ring_attention over a mesh axis %r of size %d is not ported yet (it "
        "comes with the multi-GPU slice of mxnet_tpu_torch); pass mesh=None "
        "or a mesh whose %r axis has one device"
        % (axis_name, mesh.shape[axis_name], axis_name))


def ring_attention(q, k, v, mesh=None, axis_name="sp", causal=False,
                   scale=None):
    """Entry point: ring attention when a mesh with more than one device
    on ``axis_name`` is given, :func:`full_attention` otherwise."""
    if mesh is not None and axis_name in mesh.shape and \
            mesh.shape[axis_name] > 1:
        return ring_attention_sharded(q, k, v, mesh, axis_name, causal, scale)
    return full_attention(q, k, v, causal=causal, scale=scale)
