"""Mixture-of-Experts with expert parallelism over the ``ep`` axis of a
mesh (port of ``mxnet_tpu/parallel/moe.py``).

GShard-style top-2 routed FFN: a gating matmul scores tokens, each token
goes to its top experts within a per-expert capacity, the expert FFNs run
as one batched (E, C, d) product, and the combine weights re-mix the
expert outputs.  The JAX package places the params with
:func:`moe_shardings` and lets GSPMD partition the einsums; the port
does the partition itself when the params are placed on a mesh
(``moe_init(..., mesh=mesh)`` or ``collectives.shard_tree(params, mesh,
moe_shardings())``; over ranks too):

- each position holds E / ep experts and runs only theirs;
- tokens replicated: every position routes every token (the same
  routing everywhere), runs its experts on their slots, and a psum over
  ``ep`` sums the experts' shares of the combine;
- tokens batch-sharded over ``batch_axis``: capacity and slot positions
  still follow the GLOBAL token order (each position offsets its cumsum
  by the counts of the blocks before it, gathered over ``batch_axis``),
  the dispatched slots go to their experts' positions by an all-to-all
  (``batch_axis`` is ``ep``) or a psum over ``batch_axis`` (a separate
  ``dp`` axis), and the expert outputs come back by an all-gather over
  ``ep``.

Pattern references: GShard (Lepikhin et al. 2020), Switch Transformer.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..context import current_context
from . import collectives as C

__all__ = ["moe_init", "moe_ffn", "moe_shardings"]


def moe_init(generator, d_model, d_hidden, num_experts, dtype=torch.float32,
             ctx=None, mesh=None, axis="ep"):
    """Parameters: gate (d, E), w1 (E, d, h), b1 (E, h), w2 (E, h, d),
    b2 (E, d); normal draws from ``generator`` (a ``torch.Generator``)
    scaled by 1/sqrt(d_model) (gate, w1) and 1/sqrt(d_hidden) (w2), on
    ``ctx``'s device (``current_context()`` when None).  With ``mesh``
    each expert goes to the device of the position that owns it over
    ``axis`` (:func:`moe_shardings`; every rank of a rank-spanning mesh
    draws the same values and keeps its positions' experts)."""
    if mesh is not None:
        return C.shard_tree(moe_init(generator, d_model, d_hidden,
                                     num_experts, dtype, ctx), mesh,
                            moe_shardings(axis))
    dev = (ctx if ctx is not None else current_context()).torch_device
    s1 = 1.0 / np.sqrt(d_model)
    s2 = 1.0 / np.sqrt(d_hidden)

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return (t * scale).to(dev, dtype)
    E = num_experts
    return {
        "gate": normal((d_model, E), s1),
        "w1": normal((E, d_model, d_hidden), s1),
        "b1": torch.zeros((E, d_hidden), dtype=dtype, device=dev),
        "w2": normal((E, d_hidden, d_model), s2),
        "b2": torch.zeros((E, d_model), dtype=dtype, device=dev),
    }


def moe_shardings(axis="ep"):
    """Partition specs for :func:`moe_init` params: experts sharded over
    ``axis``, the gate replicated."""
    P = C.P
    return {"gate": P(), "w1": P(axis, None, None), "b1": P(axis, None),
            "w2": P(axis, None, None), "b2": P(axis, None)}


def _route(onehot, capacity, prior):
    """One choice's (T, E, C) dispatch and its kept counts: slot = the
    token's rank among the tokens that chose the expert (offset by
    ``prior``, the counts before this block), dropped past ``capacity``."""
    pos = torch.cumsum(onehot, dim=0) - onehot + prior
    keep = (pos < capacity) & (onehot > 0)
    slot = torch.nn.functional.one_hot(
        pos.to(torch.int64).clamp(max=capacity), capacity + 1)[..., :capacity]
    disp = slot.to(onehot.dtype) * keep[..., None].to(onehot.dtype)
    return disp, (onehot * keep).sum(dim=0)


def _gates(logits):
    """(g1, e1, g2, e2) of the top-2 gates, renormalised."""
    E = logits.shape[-1]
    gates = torch.softmax(logits, dim=-1)
    g1, e1 = gates.max(dim=-1)
    gates2 = gates * (1.0 - torch.nn.functional.one_hot(e1, E).to(
        gates.dtype))
    g2, e2 = gates2.max(dim=-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    return g1 / denom, e1, g2 / denom, e2


def _prefix(counts, batch_axis):
    """Counts of the blocks before this position's along ``batch_axis``
    and the total over all of them (no gradient flows through counts)."""
    every = C.all_gather(counts[None], batch_axis, dim=0)
    k = C.axis_index(batch_axis)
    return every[:k].sum(dim=0), every.sum(dim=0)


def _top2_dispatch(logits, capacity, batch_axis=None):
    """Token -> (expert, capacity slot) routing tensors.

    logits: (T, E).  Returns dispatch (T, E, C) in {0,1} and combine
    (T, E, C) with the renormalized top-2 gate weights; tokens overflowing
    an expert's capacity are dropped (combine weight 0), the GShard
    contract.  Inside a mesh position with ``batch_axis``, ``logits`` are
    this position's block of the global tokens and the slots follow the
    global order."""
    T, E = logits.shape
    g1, e1, g2, e2 = _gates(logits)
    oh1 = torch.nn.functional.one_hot(e1, E).to(torch.float32)
    oh2 = torch.nn.functional.one_hot(e2, E).to(torch.float32)
    zero = torch.zeros((E,), dtype=torch.float32, device=logits.device)
    if batch_axis is None:
        disp1, counts = _route(oh1, capacity, zero)
        disp2, _ = _route(oh2, capacity, counts)
    else:
        with torch.no_grad():
            before1, _ = _prefix(oh1.sum(dim=0), batch_axis)
        disp1, kept = _route(oh1, capacity, before1)
        with torch.no_grad():
            _, kept1 = _prefix(kept, batch_axis)
            before2, _ = _prefix(oh2.sum(dim=0), batch_axis)
        disp2, _ = _route(oh2, capacity, kept1 + before2)
    dispatch = disp1 + disp2
    combine = disp1 * g1[:, None, None] + disp2 * g2[:, None, None]
    return dispatch, combine


def _experts(params, expert_in, activation):
    h = activation(torch.einsum("ecd,edh->ech", expert_in, params["w1"])
                   + params["b1"][:, None, :])
    # bias on empty slots is harmless: combine is zero there
    return torch.einsum("ech,ehd->ecd", h, params["w2"]) \
        + params["b2"][:, None, :]


def _placed(params):
    """The mesh the params are placed on, or None."""
    w1 = params["w1"]
    return w1.mesh if isinstance(w1, C.Sharded) else None


def moe_ffn(params, x, capacity_factor=2.0, activation=torch.relu,
            axis="ep", batch_axis=None):
    """Top-2 MoE FFN.  x: (B, S, d) -> (B, S, d).

    With params placed on a mesh (:func:`moe_shardings` over
    ``axis``) the experts run on their positions; ``batch_axis`` None
    keeps ``x`` replicated, a mesh axis shards its batch dimension
    there."""
    mesh = _placed(params)
    if mesh is None or C.current(mesh) is not None:
        return _moe_local(params, x, capacity_factor, activation,
                          None if mesh is None else axis, batch_axis)
    from .compat import shard_map
    x_spec = C.P(batch_axis) if batch_axis else C.P()
    return shard_map(
        lambda p, xl: _moe_local(p, xl, capacity_factor, activation, axis,
                                 batch_axis),
        mesh, (moe_shardings(axis), x_spec), x_spec)(params, x)


def _moe_local(params, x, capacity_factor, activation, axis, batch_axis):
    """One position's share (or the single-device FFN when ``axis`` is
    None)."""
    B, S, d = x.shape
    E_local = params["w1"].shape[0]
    E = params["gate"].shape[1]
    T = B * S
    n_blocks = C.axis_size(batch_axis) if batch_axis else 1
    # capacity over the GLOBAL token count
    capacity = int(math.ceil(capacity_factor * T * n_blocks * 2 / E))
    tokens = torch.as_tensor(x).reshape(T, d)
    logits = tokens @ params["gate"]
    dispatch, combine = _top2_dispatch(logits, capacity, batch_axis)
    if axis is None:
        expert_in = torch.einsum("tec,td->ecd", dispatch, tokens)
        out = torch.einsum("tec,ecd->td", combine,
                           _experts(params, expert_in, activation))
        return out.reshape(B, S, d)
    first = C.axis_index(axis) * E_local
    mine = slice(first, first + E_local)
    if batch_axis is None:
        # every position routes every token: its experts' slots only, and
        # the experts' shares of the combine summed over ep
        expert_in = torch.einsum("tec,td->ecd", dispatch[:, mine], tokens)
        part = torch.einsum("tec,ecd->td", combine[:, mine],
                            _experts(params, expert_in, activation))
        return C.psum(part, axis).reshape(B, S, d)
    # this block's tokens in every expert's slots
    slots = torch.einsum("tec,td->ecd", dispatch, tokens)
    if batch_axis == axis:
        # the all-to-all dispatch: expert block j to position j, summed
        # over the source blocks (each slot holds one token)
        n = C.axis_size(axis)
        got = C.all_to_all(slots[None], axis, 1, 0)
        expert_in = got.reshape(n, E_local, capacity, d).sum(dim=0)
    else:
        expert_in = C.psum(slots[mine], batch_axis)
    expert_out = _experts(params, expert_in, activation)
    every = C.all_gather(expert_out, axis, dim=0)
    out = torch.einsum("tec,ecd->td", combine, every)
    return out.reshape(B, S, d)
