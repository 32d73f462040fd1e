"""ZeRO-3 machinery: grouped parameter gathers for the fused step (port
of ``mxnet_tpu/parallel/zero3.py``, its ``manual`` tier).

``grad_sync='zero3'`` keeps every rank's parameters, master and
optimizer state as 1/world shards.  The step gathers each parameter
GROUP on demand (one bucketed ``all_gather`` per group: members sharded
on dim 0 flatten into one collective, others gather alone), the backward
RE-GATHERS instead of keeping the replicated copies alive between the
passes, and the gradients leave the backward as one ``reduce_scatter``
per group.  The JAX package gets the backward re-gather from a remat
policy; here the gathered values are swapped out of autograd's saved
tensors by ``torch.autograd.graph.saved_tensors_hooks``
(:class:`Regather`): a saved view of a gathered parameter is stored as a
handle, and its first unpack in the backward gathers the group again.

On a mesh of positions (``build_mesh`` over a context list, or over
ranks and contexts) a group gathers as ONE bucketed
``collectives.all_gather`` over ``dp`` in each position's thread
(every member moved to its shard dimension first and flattened), whose
transpose is ``psum_scatter``: one reduce-scatter a group in the
backward (:meth:`GatherLayout.gather_mesh`).  The backward runs on autograd's
thread, where no position waits at a rendezvous, so :class:`MeshRegather`
re-gathers a group for every position of the process at once, as one
collective over the positions' shards
(:func:`collectives.all_gather_positions`; one exchange with the other
ranks where ``dp`` spans ranks).

Group boundaries come from the executor plan's topological order
(``executor._node_plan``): a parameter belongs to the plan position of
its first consuming node.  :func:`first_consumer_order` and
:func:`plan_gather_groups` are pure functions of the graph and equal the
JAX package's; ``planner.derive_gather_groups`` merges the layers toward
``MXTPU_PLAN_GATHER_BUCKET`` bytes (``MXTPU_ZERO3_GATHER_GROUP=auto``).
"""
from __future__ import annotations

import numpy as np

from ..base import register_env

__all__ = ["ENV_ZERO3_GATHER_GROUP", "first_consumer_order",
           "plan_gather_groups", "GatherLayout", "make_manual_gather",
           "Regather", "MeshRegather"]

ENV_ZERO3_GATHER_GROUP = register_env(
    "MXTPU_ZERO3_GATHER_GROUP", default="auto",
    doc="grad_sync='zero3': gather grouping.  'auto' (default) derives "
        "the groups from the executor plan's first-consumer order, "
        "merged toward MXTPU_PLAN_GATHER_BUCKET bytes per collective "
        "(parallel/planner.py).  A numeric value is the manual "
        "override — N consecutive plan-order layers per group — and "
        "warns when it loses to the planned grouping on the memory model")


def first_consumer_order(symbol, param_names):
    """``{param_name: topological position of its first consumer}`` from
    the executor plan (slot 4); params no op consumes sort last."""
    from ..executor import _node_plan
    wanted = set(param_names)
    order = {}
    last = 0
    for entry in _node_plan(symbol):
        node, ix = entry[0], entry[4]
        if node.is_variable:
            continue
        last = max(last, ix)
        for src, _ in node.inputs:
            if src.is_variable and src.name in wanted \
                    and src.name not in order:
                order[src.name] = ix
    for name in param_names:
        order.setdefault(name, last + 1)
    return order


def plan_gather_groups(symbol, param_names, group_layers=1):
    """``param_names`` chunked into groups of ``group_layers`` consecutive
    consuming nodes each, in plan order; every name in one group."""
    group_layers = max(1, int(group_layers))
    order = first_consumer_order(symbol, param_names)
    by_node = {}
    for name in param_names:
        by_node.setdefault(order[name], []).append(name)
    groups, current, nlayers = [], [], 0
    for ix in sorted(by_node):
        current.extend(sorted(by_node[ix]))
        nlayers += 1
        if nlayers >= group_layers:
            groups.append(current)
            current, nlayers = [], 0
    if current:
        groups.append(current)
    return groups


class GatherLayout(object):
    """How one group's shards gather and its gradients scatter.

    ``names``: the group, ``shard_dim``: {name: dim the dp axis shards},
    ``shapes``: {name: full shape}, ``world``: ranks.  Members sharded on
    dim 0 flatten into one bucket when there are at least two of them (a
    dim-0 shard is a contiguous row block, so the gathered bucket reshaped
    (world, -1) holds each member's full value as a column strip); the
    others gather one by one along their dimension."""

    def __init__(self, names, shard_dim, shapes, world):
        self.names = list(names)
        self.shard_dim = {n: int(shard_dim[n]) for n in self.names}
        self.shapes = {n: tuple(int(d) for d in shapes[n])
                       for n in self.names}
        self.world = int(world)
        bucket = [n for n in self.names if self.shard_dim[n] == 0]
        self.bucket = bucket if len(bucket) >= 2 else []
        self.singles = [n for n in self.names if n not in self.bucket]
        self.sizes = {n: int(np.prod(self.shapes[n])) // self.world
                      for n in self.bucket}

    def gather(self, shards):
        """``{name: full}`` from ``{name: this rank's shard}``: one
        all-gather for the bucket, one per single."""
        import torch
        from .. import distributed as dist
        full = {}
        if self.bucket:
            flat = dist.all_gather(
                torch.cat([shards[n].reshape(-1) for n in self.bucket]))
            mat = flat.reshape(self.world, -1)
            off = 0
            for n in self.bucket:
                size = self.sizes[n]
                full[n] = mat[:, off:off + size].reshape(self.shapes[n])
                off += size
        for n in self.singles:
            d = self.shard_dim[n]
            g = dist.all_gather(shards[n].movedim(d, 0).contiguous())
            full[n] = g.movedim(0, d).contiguous()
        return full

    def scatter(self, grads):
        """``{name: this rank's shard of the rank-summed gradient}`` from
        ``{name: full local gradient}``: one reduce-scatter for the
        bucket, one per single."""
        import torch
        from .. import distributed as dist
        out = {}
        if self.bucket:
            mat = torch.cat([grads[n].reshape(self.world, -1)
                             for n in self.bucket], dim=1)
            flat = dist.reduce_scatter(mat.reshape(-1))
            off = 0
            for n in self.bucket:
                size = self.sizes[n]
                shp = list(self.shapes[n])
                shp[0] //= self.world
                out[n] = flat[off:off + size].reshape(shp)
                off += size
        for n in self.singles:
            d = self.shard_dim[n]
            s = dist.reduce_scatter(grads[n].movedim(d, 0).contiguous())
            out[n] = s.movedim(0, d).contiguous()
        return out


    # -- the in-process mesh form: one bucket a group ---------------------
    def _moved(self, n):
        """Member ``n``'s full shape with its shard dimension first."""
        d, shape = self.shard_dim[n], list(self.shapes[n])
        return [shape[d]] + shape[:d] + shape[d + 1:]

    def mesh_bucket(self, shards):
        """A position's flat bucket: every member's shard with its shard
        dimension moved first, flattened, in ``names`` order."""
        import torch
        return torch.cat([(shards[n].movedim(self.shard_dim[n], 0)
                           if self.shard_dim[n] else shards[n]).reshape(-1)
                          for n in self.names])

    def mesh_unbucket(self, flat):
        """``{name: full}`` from a gathered bucket (the positions' buckets
        concatenated in coordinate order): each member its own storage."""
        mat = flat.reshape(self.world, -1)
        full, off = {}, 0
        for n in self.names:
            size = int(np.prod(self.shapes[n])) // self.world
            d = self.shard_dim[n]
            v = mat[:, off:off + size].reshape(self._moved(n))
            full[n] = v.movedim(0, d).contiguous() if d else v
            off += size
        return full

    def gather_mesh(self, shards, axis):
        """``{name: full}`` in a mesh position's thread: one
        ``collectives.all_gather`` of the group's bucket over ``axis``,
        differentiable (the shards' gradients leave as one psum_scatter,
        summed in coordinate order)."""
        from . import collectives as C
        return self.mesh_unbucket(C.all_gather(self.mesh_bucket(shards),
                                              axis))


def _gather_fn():
    import torch

    class GroupGather(torch.autograd.Function):
        """Forward: the group's all-gathers; backward: its
        reduce-scatters (the all-gather's transpose)."""

        @staticmethod
        def forward(ctx, layout, *shards):
            ctx.layout = layout
            ctx.meta = [(s.dtype, s.device) for s in shards]
            full = layout.gather(dict(zip(layout.names, shards)))
            return tuple(full[n] for n in layout.names)

        @staticmethod
        def backward(ctx, *grads):
            layout = ctx.layout
            g = {}
            for n, v, (dtype, dev) in zip(layout.names, grads, ctx.meta):
                g[n] = v if v is not None else torch.zeros(
                    layout.shapes[n], dtype=dtype, device=dev)
            shards = layout.scatter(g)
            return (None,) + tuple(shards[n] for n in layout.names)

    return GroupGather


_GATHER_FN = None


def make_manual_gather(groups, shard_dim, shapes, world):
    """``(layouts, gather)``: one :class:`GatherLayout` a group and
    ``gather(shards) -> {name: full}``, differentiable with respect to
    the shards (their gradients arrive reduce-scattered)."""
    global _GATHER_FN
    if _GATHER_FN is None:
        _GATHER_FN = _gather_fn()
    layouts = [GatherLayout(g, shard_dim, shapes, world) for g in groups]

    def gather(shards):
        full = {}
        for lay in layouts:
            outs = _GATHER_FN.apply(lay, *[shards[n] for n in lay.names])
            full.update(zip(lay.names, outs))
        return full

    return layouts, gather


class Regather(object):
    """Saved-tensor hooks that keep no gathered parameter between the
    passes: a tensor autograd saves that views a gathered value (same
    storage) is stored as ``(group, name, size, stride, offset)``, and
    the backward's first unpack of a group gathers it again from the
    shards (one all-gather a group), cached until the group's last
    handle is unpacked.

    ``layouts``: the groups' :class:`GatherLayout`s; ``shards``: {name:
    this rank's shard} (read detached); ``full``: the forward's gathered
    values, to recognise them.  Use as ``with Regather(...).hooks():``
    around the forward."""

    def __init__(self, layouts, shards, full):
        self.layouts = layouts
        self.shards = {n: v.detach() for n, v in shards.items()}
        self.where = {}
        for gi, lay in enumerate(layouts):
            for n in lay.names:
                t = full[n]
                self.where[t.untyped_storage().data_ptr()] = (gi, n)
        self.pending = [0] * len(layouts)
        self.cache = {}
        self.regathers = 0

    def pack(self, t):
        import torch
        if not isinstance(t, torch.Tensor) or t.layout != torch.strided:
            return t
        hit = self.where.get(t.untyped_storage().data_ptr())
        if hit is None:
            return t
        gi, name = hit
        self.pending[gi] += 1
        return ("zero3-regather", gi, name, tuple(t.shape), t.stride(),
                t.storage_offset(), t.requires_grad)

    def unpack(self, h):
        if not (isinstance(h, tuple) and h and h[0] == "zero3-regather"):
            return h
        _, gi, name, size, stride, offset, _rg = h
        full = self.cache.get(gi)
        if full is None:
            lay = self.layouts[gi]
            full = lay.gather({n: self.shards[n] for n in lay.names})
            self.cache[gi] = full
            self.regathers += 1
        self.pending[gi] -= 1
        out = full[name].as_strided(size, stride, offset)
        if self.pending[gi] <= 0:
            self.cache.pop(gi, None)
        return out

    def hooks(self):
        import torch
        return torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                        self.unpack)


class MeshRegather(object):
    """:class:`Regather` over an in-process mesh.  Each position's forward
    runs with ``hooks(index)``: a saved tensor that views one of that
    position's gathered values is stored as a handle.  The backward's
    first unpack of a group re-gathers it for EVERY position at once from
    the positions' shards (one collective, no rendezvous: the backward
    has no position threads), and each position's copy is dropped after
    its last handle.  Under the mirror mode (checkpointed segments) the
    segments' recomputes read the gathered values through :meth:`args`,
    which re-gathers what the forward no longer holds.

    ``layouts``: one :class:`GatherLayout` a group; ``mesh``, ``axis``:
    the mesh and its data axis; ``reads``: {name: how many checkpointed
    segments read it} (the mirror mode; a position's re-gathered copy is
    dropped after them).  Each position hands its shards and gathered
    values to :meth:`register` before its forward."""

    def __init__(self, layouts, mesh, axis, reads=None):
        import threading
        self.layouts = layouts
        self.mesh = mesh
        self.axis = axis
        n = mesh.size
        self.shards = [None] * n
        self.where = [{} for _ in range(n)]
        self.group_of = {nm: gi for gi, lay in enumerate(layouts)
                         for nm in lay.names}
        reads = reads or {}
        # a position's outstanding readers of a group: the segments'
        # recomputes that bind its names, and the saved-tensor handles
        # (counted as the forward packs them)
        self.left = [[sum(int(reads.get(nm, 0)) for nm in lay.names)] * n
                     for lay in layouts]
        self.cache = {}     # group -> every position's gathered values
        self.lock = threading.Lock()
        self.regathers = 0

    def register(self, index, shards, full):
        """Position ``index``'s shards and the values its forward
        gathered from them (its own thread calls this before the
        forward)."""
        self.shards[index] = {nm: shards[nm].detach()
                              for nm in self.group_of}
        self.where[index] = {full[nm].untyped_storage().data_ptr():
                             (gi, nm) for nm, gi in self.group_of.items()}

    def _gather(self, gi):
        """Every position's gathered group ``gi`` (one collective)."""
        from . import collectives as C
        lay = self.layouts[gi]
        outs = C.all_gather_positions(
            [None if s is None else
             lay.mesh_bucket({nm: s[nm] for nm in lay.names})
             for s in self.shards], self.mesh, self.axis)
        self.regathers += 1
        return [None if o is None else lay.mesh_unbucket(o) for o in outs]

    def _take(self, gi, index, name):
        """Position ``index``'s re-gathered ``name`` of group ``gi`` for
        one reader: the group is gathered for every position at the
        first reader that finds no copy, and a position's copy dropped
        after its last reader."""
        with self.lock:
            full = self.cache.get(gi)
            if full is None or full[index] is None:
                full = self.cache[gi] = self._gather(gi)
            out = full[index][name]
            self.left[gi][index] -= 1
            if self.left[gi][index] <= 0:
                full[index] = None
                if all(f is None for f in full):
                    del self.cache[gi]
        return out

    def _pack(self, index, t):
        import torch
        if not isinstance(t, torch.Tensor) or t.layout != torch.strided:
            return t
        hit = self.where[index].get(t.untyped_storage().data_ptr())
        if hit is None:
            return t
        gi, name = hit
        self.left[gi][index] += 1
        return ("zero3-regather", gi, name, index, tuple(t.shape),
                t.stride(), t.storage_offset())

    def _unpack(self, h):
        if not (isinstance(h, tuple) and h and h[0] == "zero3-regather"):
            return h
        _, gi, name, index, size, stride, offset = h
        return self._take(gi, index, name).as_strided(size, stride, offset)

    def hooks(self, index):
        """The saved-tensor hooks of position ``index``'s forward."""
        import torch
        return torch.autograd.graph.saved_tensors_hooks(
            lambda t: self._pack(index, t), self._unpack)

    def args(self, index, merged):
        """``merged`` (position ``index``'s argument dict) as a mapping
        that re-gathers a group's value once the forward dropped it
        (:meth:`drop`): what a checkpointed segment's recompute binds."""
        return _RegatherArgs(merged, self, index)

    def fetch(self, index, name):
        """Position ``index``'s re-gathered ``name`` (requires grad, as
        the forward's gathered value did)."""
        return self._take(self.group_of[name], index,
                          name).detach().requires_grad_(True)


class _RegatherArgs(dict):
    """A position's argument dict whose gathered entries, once dropped,
    are re-gathered on read (``MeshRegather.args``)."""

    def __init__(self, merged, regather, index):
        dict.__init__(self, merged)
        self._regather = regather
        self._index = index

    def drop(self):
        """Drop the gathered values (after the forward)."""
        for name in self._regather.group_of:
            dict.pop(self, name, None)

    def __contains__(self, name):
        return dict.__contains__(self, name) or \
            name in self._regather.group_of

    def __missing__(self, name):
        if name in self._regather.group_of:
            return self._regather.fetch(self._index, name)
        raise KeyError(name)
