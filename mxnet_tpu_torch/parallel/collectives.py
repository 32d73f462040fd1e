"""Shards and collectives on a mesh inside one process.

The JAX package partitions one program over a ``Mesh`` with GSPMD or
``shard_map`` and joins the devices with ``jax.lax`` collectives.  The
port's counterpart for a mesh over a context list
(``parallel/mesh.py``):

- :func:`shard` / :func:`unshard` place a tensor on the mesh by a spec
  (a tuple of axis names or None per dimension, :class:`P`) and gather it
  back; :class:`Sharded` holds the positions' parts (each in its own
  storage, also where contexts repeat).
- :func:`run` runs ``fn`` once per mesh position, one thread a position,
  with the position's context current.
- The collectives (:func:`psum`, :func:`all_gather`, :func:`psum_scatter`,
  :func:`ppermute`, :func:`all_to_all`, :func:`axis_index`) are
  rendezvous: each position hands in its tensor, and the last to arrive
  applies ONE ``torch.autograd.Function`` to all the positions' tensors
  and hands each its output.  The backward of that node is the
  collective's transpose over all the gradients at once (reduce-scatter
  for all-gather, psum for psum, the inverse permutation for ppermute),
  so the caller sums the positions' losses and calls ``backward`` once,
  from one thread: no collective waits inside the backward (on the card
  torch's autograd engine runs all of a device's backward work on one
  thread).
- :func:`copy_to`, :func:`reduce_from`, :func:`gather_from` and
  :func:`scatter_to` are the tensor-parallel forms, for values that every
  position of the axis holds alike downstream (the positions compute the
  same replicated loss): their backwards are psum, identity, the own
  slice and all-gather, so a gradient that every position computes alike
  is counted once.

Every output is a new tensor in its position's storage: with repeated
contexts ``t.to(device)`` would otherwise hand two positions one buffer.

A step over the mesh is reproducible from run to run: :func:`shard`
places a tensor that requires grad through ONE autograd node whose
backward adds the positions' gradients in position order, and the
rendezvous' node over all positions is always made by position 0's
thread (autograd orders ready nodes by a per-thread sequence number, so
a node made by whichever thread came last would reorder the backward's
sums).  Every collective reports its kind and the bytes one position
moves to :data:`COLLECTIVE_HOOKS` (the graph lint's recorder listens
there, as it does to ``kernels.LAUNCH_HOOKS``), in the forward and in
the backward.  Inside a checkpointed segment (the mirror mode) each
collective's output is kept on the segment's :class:`SegmentTape`, and
the backward's recompute, which runs on autograd's thread where no
position waits at a rendezvous, replays it.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["P", "Sharded", "shard", "unshard", "run", "current",
           "axis_index", "axis_size", "psum", "all_gather", "psum_scatter",
           "ppermute", "all_to_all", "copy_to", "reduce_from", "gather_from",
           "scatter_to", "tree_map", "shard_tree", "unshard_tree",
           "psum_positions", "all_gather_positions", "COLLECTIVE_HOOKS",
           "note_collective", "SegmentTape", "segment_tape"]

#: ``hook(kind, nbytes, axes)`` callables told of every collective over
#: the mesh: the JAX package's HLO kind (``all-gather``, ``all-reduce``,
#: ``reduce-scatter``, ``all-to-all``, ``collective-permute``), the bytes
#: one position receives, once a collective (not once a position), and
#: the tuple of mesh axes it runs over
COLLECTIVE_HOOKS = []


def note_collective(kind, outs, axes=()):
    """Report one collective of ``kind`` over ``axes`` whose per-position
    outputs are ``outs`` to the hooks (one list test when nothing
    listens)."""
    if not COLLECTIVE_HOOKS or kind is None:
        return
    first = next((t for t in outs if t is not None), None)
    nbytes = 0 if first is None else first.numel() * first.element_size()
    for hook in list(COLLECTIVE_HOOKS):
        hook(kind, int(nbytes), tuple(axes))


class P(tuple):
    """A partition spec: one entry a dimension, an axis name, a tuple of
    axis names or None (replicated); trailing dimensions are replicated
    (``jax.sharding.PartitionSpec``'s convention)."""

    def __new__(cls, *axes):
        return tuple.__new__(cls, axes)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self),)


def _axes_of(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec(spec):
    if spec is None:
        return P()
    if isinstance(spec, str):
        return P(spec)
    return spec if isinstance(spec, P) else P(*spec)


def _block(mesh, coords, axes):
    """(index, count) of a position's block over ``axes`` (row-major)."""
    k, n = 0, 1
    for a in axes:
        k = k * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return k, n


def _fresh(t, device):
    """``t`` on ``device`` in storage of its own."""
    return t.to(device, copy=True)


class Sharding(object):
    """What :attr:`Sharded.sharding` reports: the mesh and the spec."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self):
        return "Sharding(%r, %r)" % (self.mesh, self.spec)


class Sharded(object):
    """A tensor laid over an in-process mesh: ``parts[i]`` is position
    ``i``'s block, on that position's device; ``shape`` is the whole's."""

    def __init__(self, parts, mesh, spec, shape):
        self.parts = list(parts)
        self.mesh = mesh
        self.spec = _spec(spec)
        self.shape = tuple(int(d) for d in shape)
        self.sharding = Sharding(mesh, self.spec)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        """Position 0's device."""
        return self.parts[0].device

    def full(self, device=None):
        """The whole tensor (on position 0's device unless ``device``)."""
        return unshard(self.parts, self.mesh, self.spec, device=device)

    def __repr__(self):
        return "Sharded(shape=%s, spec=%r, %d positions)" % (
            self.shape, self.spec, len(self.parts))


def _check_spec(shape, spec, mesh):
    if len(spec) > len(shape):
        raise MXNetError("spec %r has more entries than the shape %s"
                         % (spec, tuple(shape)))
    for d, entry in enumerate(spec):
        for a in _axes_of(entry):
            if a not in mesh.shape:
                raise MXNetError("spec %r names axis %r, which mesh %s "
                                 "lacks" % (spec, a, dict(mesh.shape)))
        n = int(np.prod([mesh.shape[a] for a in _axes_of(entry)]))
        if shape[d] % n:
            raise MXNetError(
                "dimension %d (size %d) does not divide over %s (%d "
                "positions) in spec %r" % (d, shape[d], _axes_of(entry), n,
                                           spec))


def _block_of(t, mesh, index, spec):
    """Position ``index``'s block of ``t`` by ``spec`` (a view)."""
    coords = mesh.coords(index)
    blk = t
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        if axes:
            k, n = _block(mesh, coords, axes)
            size = t.shape[d] // n
            blk = blk.narrow(d, k * size, size)
    return blk


def _place_blocks(t, mesh, spec):
    return [_fresh(_block_of(t, mesh, i, spec), ctx.torch_device).contiguous()
            for i, ctx in enumerate(mesh.contexts)]


class _ShardFn(torch.autograd.Function):
    """:func:`shard` of a tensor that requires grad: one node over every
    position's block, whose backward adds the positions' gradients into
    the whole in position order (the same sums, in the same order, on
    every run)."""

    @staticmethod
    def forward(ctx, mesh, spec, t):
        ctx.mesh, ctx.spec = mesh, spec
        ctx.meta = (t.shape, t.dtype, t.device)
        return tuple(_place_blocks(t, mesh, spec))

    @staticmethod
    def backward(ctx, *gs):
        shape, dtype, device = ctx.meta
        full = torch.zeros(shape, dtype=dtype, device=device)
        for i, g in enumerate(gs):
            if g is not None:
                _block_of(full, ctx.mesh, i, ctx.spec).add_(g.to(device))
        return None, None, full


def shard(t, mesh, spec=None):
    """Place ``t`` (a tensor or numpy array) on the in-process ``mesh``
    by ``spec``: each position gets its block, a copy in its own storage
    on its context's device.  Differentiable: the gradient of ``t`` is
    the sum of the positions' gradients (a replicated input's copies
    each contribute), added in position order by one node."""
    if isinstance(t, Sharded):
        if t.mesh is mesh and t.spec == _spec(spec):
            return t
        t = t.full()
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    spec = _spec(spec)
    _check_spec(t.shape, spec, mesh)
    if torch.is_grad_enabled() and t.requires_grad:
        parts = list(_ShardFn.apply(mesh, spec, t))
    else:
        parts = _place_blocks(t, mesh, spec)
    return Sharded(parts, mesh, spec, t.shape)


def unshard(parts, mesh, spec=None, device=None):
    """The whole tensor from the positions' ``parts`` laid out by
    ``spec``: replicated axes take coordinate 0's copy, sharded ones are
    concatenated.  Differentiable (the gradient reaches the copies it
    read)."""
    spec = _spec(spec)
    ndim = parts[0].dim()
    blocks = {}
    named = {a for e in spec for a in _axes_of(e)}
    for i in range(mesh.size):
        coords = mesh.coords(i)
        if any(coords[a] for a in mesh.axis_names if a not in named):
            continue
        key = tuple(_block(mesh, coords, _axes_of(spec[d]))[0]
                    if d < len(spec) else 0 for d in range(ndim))
        blocks[key] = parts[i]
    dev = device if device is not None else parts[0].device

    def build(prefix, d):
        if d == ndim:
            return blocks[prefix].to(dev)
        n = _block(mesh, mesh.coords(0), _axes_of(spec[d]))[1] \
            if d < len(spec) else 1
        pieces = [build(prefix + (k,), d + 1) for k in range(n)]
        return pieces[0] if n == 1 else torch.cat(pieces, d)
    return build((), 0)


# ---------------------------------------------------------------------------
# trees (nested dicts / lists / tuples of tensors, the JAX pytrees)
# ---------------------------------------------------------------------------

def _is_node(x):
    return isinstance(x, dict) or (isinstance(x, (list, tuple))
                                   and not isinstance(x, P))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        out = [tree_map(fn, v, *[r[i] for r in rest])
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def _map_with_spec(fn, tree, spec):
    """``fn(leaf, spec)`` where ``spec`` is a prefix of ``tree``'s
    structure (a :class:`P` or None covers a whole subtree)."""
    if spec is None or isinstance(spec, P):
        return tree_map(lambda leaf: fn(leaf, spec), tree)
    if isinstance(spec, dict):
        return {k: _map_with_spec(fn, tree[k], spec[k]) for k in tree}
    if isinstance(spec, (list, tuple)):
        out = [_map_with_spec(fn, t, s) for t, s in zip(tree, spec)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    raise MXNetError("not a partition spec: %r" % (spec,))


def _is_array(x):
    return isinstance(x, (torch.Tensor, np.ndarray, Sharded))


def shard_tree(tree, mesh, specs):
    """:func:`shard` over a tree's array leaves (``specs`` a prefix of the
    tree); other leaves are given to every position as they are."""
    return _map_with_spec(
        lambda leaf, s: shard(leaf, mesh, s) if _is_array(leaf) else leaf,
        tree, specs)


def _part(tree, i):
    return tree_map(lambda leaf: leaf.parts[i]
                    if isinstance(leaf, Sharded) else leaf, tree)


def unshard_tree(per_position, mesh, specs, device=None):
    """The whole trees from the positions' output trees by ``specs``."""
    def go(trees, spec):
        first = trees[0]
        if spec is not None and not isinstance(spec, P):
            if isinstance(spec, dict):
                return {k: go([t[k] for t in trees], spec[k])
                        for k in first}
            out = [go([t[i] for t in trees], s) for i, s in enumerate(spec)]
            return type(first)(out) if isinstance(first, tuple) else out
        if _is_node(first):
            if isinstance(first, dict):
                return {k: go([t[k] for t in trees], spec) for k in first}
            out = [go([t[i] for t in trees], spec)
                   for i in range(len(first))]
            return type(first)(out) if isinstance(first, tuple) else out
        if isinstance(first, torch.Tensor):
            return unshard(trees, mesh, spec, device=device)
        return first
    return go(list(per_position), specs)


# ---------------------------------------------------------------------------
# the position runner and the rendezvous
# ---------------------------------------------------------------------------

_LOCAL = threading.local()


class _Aborted(MXNetError):
    """Raised in the positions still waiting when another one failed."""


class _Rendezvous(object):
    """All N positions hand in one item; once all have arrived position
    0 computes every position's result from all the items (always the
    same thread, so the autograd node it makes takes its place in the
    backward's order from that thread's sequence), and each takes its
    own."""

    def __init__(self, n):
        self.n = n
        self.cond = threading.Condition()
        self.items = [None] * n
        self.arrived = 0
        self.generation = 0
        self.result = None
        self.broken = None

    def _aborted(self):
        return _Aborted("another mesh position failed: %s" % (self.broken,))

    def exchange(self, index, key, item, combine):
        with self.cond:
            if self.broken is not None:
                raise self._aborted()
            gen = self.generation
            self.items[index] = (key, item)
            self.arrived += 1
            if self.arrived == self.n:
                self.cond.notify_all()
            if index == 0:
                while self.arrived < self.n and self.broken is None:
                    self.cond.wait()
                if self.arrived < self.n:
                    raise self._aborted()
                items, self.items = self.items, [None] * self.n
                self.arrived = 0
                keys = {k for k, _ in items}
                try:
                    if len(keys) != 1:
                        raise MXNetError(
                            "mesh positions diverged: they called the "
                            "collectives %s at one rendezvous" % sorted(keys))
                    self.result = (True, combine([v for _, v in items]))
                except BaseException as e:    # handed to every position
                    self.result = (False, e)
                self.generation += 1
                self.cond.notify_all()
            else:
                while self.generation == gen and self.broken is None:
                    self.cond.wait()
                if self.generation == gen:
                    raise self._aborted()
            ok, value = self.result
            if not ok:
                raise value
            return value[index]

    def abort(self, error):
        with self.cond:
            if self.broken is None:
                self.broken = error
            self.cond.notify_all()


class _Frame(object):
    __slots__ = ("mesh", "index", "coords", "rendezvous")

    def __init__(self, mesh, index, rendezvous):
        self.mesh = mesh
        self.index = index
        self.coords = mesh.coords(index)
        self.rendezvous = rendezvous


def current(mesh=None):
    """The running position's frame (``mesh``, ``index``, ``coords``), or
    None outside :func:`run` (or inside a run over another mesh when
    ``mesh`` is given)."""
    frame = getattr(_LOCAL, "frame", None)
    if frame is not None and mesh is not None and frame.mesh is not mesh:
        return None
    return frame


def _frame():
    frame = getattr(_LOCAL, "frame", None)
    if frame is None:
        raise MXNetError("a collective runs inside a mesh position "
                         "(parallel.collectives.run / compat.shard_map)")
    return frame


def run(mesh, fn, per_position_args):
    """``[fn(*per_position_args[i]) for every position i]``, each call in
    a thread of its own with position ``i``'s context (and its CUDA
    device) current, the caller's grad mode and the caller's
    ``TorchDispatchMode`` stack (a recorder sees every position's ops);
    the collectives inside ``fn`` join the threads.  The first failure is
    raised after every thread has ended."""
    import contextlib
    from torch.utils._python_dispatch import \
        _get_current_dispatch_mode_stack
    n = mesh.size
    rv = _Rendezvous(n)
    results = [None] * n
    errors = [None] * n
    grad = torch.is_grad_enabled()
    modes = list(_get_current_dispatch_mode_stack())
    contexts = mesh.contexts

    def body(i):
        ctx = contexts[i]
        _LOCAL.frame = _Frame(mesh, i, rv)
        try:
            dev = ctx.torch_device
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.set_grad_enabled(grad))
                stack.enter_context(ctx)
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.device(dev))
                for mode in modes:
                    stack.enter_context(mode)
                results[i] = fn(*per_position_args[i])
        except BaseException as e:    # re-raised by the caller
            errors[i] = e
            rv.abort(e)
        finally:
            _LOCAL.frame = None

    threads = [threading.Thread(target=body, args=(i,),
                                name="mesh-position-%d" % i, daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    real = [e for e in errors if e is not None and not isinstance(e,
                                                                  _Aborted)]
    if real or any(errors):
        raise (real or [e for e in errors if e is not None])[0]
    return results


def axis_index(axis):
    """This position's coordinate along ``axis`` (a name or a tuple of
    names, row-major)."""
    f = _frame()
    return _block(f.mesh, f.coords, _axes_of(axis))[0]


def axis_size(axis):
    f = _frame()
    return _block(f.mesh, f.coords, _axes_of(axis))[1]


# ---------------------------------------------------------------------------
# the collectives: each an op over ALL positions' tensors, with its
# transpose over all the gradients
# ---------------------------------------------------------------------------

class _CollectiveFn(torch.autograd.Function):
    """One autograd node over every position's tensor."""

    @staticmethod
    def forward(ctx, op, *xs):
        ctx.op = op
        return tuple(op.run_fwd(list(xs)))

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + tuple(ctx.op.run_bwd(list(gs)))


def _chunks(t, n, dim):
    size = t.shape[dim] // n
    return [t.narrow(dim, k * size, size) for k in range(n)]


def _sum_to(ts, device):
    total = ts[0].to(device)
    for t in ts[1:]:
        total = total + t.to(device)
    return total


class _Op(object):
    """A collective over the groups of one axis: ``fwd``/``bwd`` map the
    list of every position's tensor to every position's output;
    ``kinds`` names what each direction moves (None: a local copy or
    slice), which ``run_fwd``/``run_bwd`` report."""

    kinds = (None, None)

    def __init__(self, groups, devices, axes=(), **kw):
        self.groups = groups
        self.devices = devices
        self.axes = tuple(axes)
        self.kw = kw

    def run_fwd(self, xs):
        out = self.fwd(xs)
        note_collective(self.kinds[0], out, self.axes)
        return out

    def run_bwd(self, gs):
        out = self.bwd(gs)
        note_collective(self.kinds[1], out, self.axes)
        return out

    def _each(self, xs, per_group):
        out = [None] * len(xs)
        for g in self.groups:
            for pos, t in zip(g, per_group([xs[m] for m in g], g)):
                out[pos] = t
        return out

    # the building blocks, each one group at a time
    def _psum(self, xs):
        def go(ts, g):
            total = _sum_to(ts, self.devices[g[0]])
            return [total if k == 0 else _fresh(total, self.devices[m])
                    for k, m in enumerate(g)]
        return self._each(xs, go)

    def _gather(self, xs, dim, tiled=True):
        def go(ts, g):
            dev = self.devices[g[0]]
            ts = [t.to(dev) for t in ts]
            whole = torch.cat(ts, dim) if tiled else torch.stack(ts, dim)
            return [whole if k == 0 else _fresh(whole, self.devices[m])
                    for k, m in enumerate(g)]
        return self._each(xs, go)

    def _scatter_sum(self, xs, dim, tiled=True):
        def go(ts, g):
            total = _sum_to(ts, self.devices[g[0]])
            if tiled:
                parts = _chunks(total, len(g), dim)
            else:
                parts = list(total.unbind(dim))
            return [_fresh(p, self.devices[m]).contiguous()
                    for p, m in zip(parts, g)]
        return self._each(xs, go)

    def _own_slice(self, xs, dim):
        def go(ts, g):
            return [_fresh(_chunks(t, len(g), dim)[k],
                           self.devices[m]).contiguous()
                    for k, (t, m) in enumerate(zip(ts, g))]
        return self._each(xs, go)

    def _copy(self, xs):
        return [_fresh(t, self.devices[i]) for i, t in enumerate(xs)]


class _PSum(_Op):
    kinds = ("all-reduce", "all-reduce")

    def fwd(self, xs):
        return self._psum(xs)

    def bwd(self, gs):
        return self._psum(gs)


class _AllGather(_Op):
    kinds = ("all-gather", "reduce-scatter")

    def fwd(self, xs):
        return self._gather(xs, self.kw["dim"], self.kw["tiled"])

    def bwd(self, gs):
        return self._scatter_sum(gs, self.kw["dim"], self.kw["tiled"])


class _PSumScatter(_Op):
    kinds = ("reduce-scatter", "all-gather")

    def fwd(self, xs):
        return self._scatter_sum(xs, self.kw["dim"], self.kw["tiled"])

    def bwd(self, gs):
        return self._gather(gs, self.kw["dim"], self.kw["tiled"])


class _PPermute(_Op):
    kinds = ("collective-permute", "collective-permute")

    def _move(self, xs, pairs):
        out = [None] * len(xs)
        for g in self.groups:
            for src, dst in pairs:
                out[g[dst]] = _fresh(xs[g[src]], self.devices[g[dst]])
        return [o if o is not None else torch.zeros_like(x)
                for o, x in zip(out, xs)]

    def fwd(self, xs):
        return self._move(xs, self.kw["perm"])

    def bwd(self, gs):
        return self._move(gs, [(d, s) for s, d in self.kw["perm"]])


class _AllToAll(_Op):
    kinds = ("all-to-all", "all-to-all")

    def _swap(self, xs, split, concat):
        def go(ts, g):
            n = len(g)
            pieces = [_chunks(t, n, split) for t in ts]
            return [torch.cat([pieces[k][j].to(self.devices[m])
                               for k in range(n)], concat).contiguous()
                    for j, m in enumerate(g)]
        return self._each(xs, go)

    def fwd(self, xs):
        return self._swap(xs, self.kw["split"], self.kw["concat"])

    def bwd(self, gs):
        return self._swap(gs, self.kw["concat"], self.kw["split"])


class _CopyTo(_Op):
    kinds = (None, "all-reduce")

    def fwd(self, xs):
        return self._copy(xs)

    def bwd(self, gs):
        return self._psum(gs)


class _ReduceFrom(_Op):
    kinds = ("all-reduce", None)

    def fwd(self, xs):
        return self._psum(xs)

    def bwd(self, gs):
        return self._copy(gs)


class _GatherFrom(_Op):
    kinds = ("all-gather", None)

    def fwd(self, xs):
        return self._gather(xs, self.kw["dim"])

    def bwd(self, gs):
        return self._own_slice(gs, self.kw["dim"])


class _ScatterTo(_Op):
    kinds = (None, "all-gather")

    def fwd(self, xs):
        return self._own_slice(xs, self.kw["dim"])

    def bwd(self, gs):
        return self._gather(gs, self.kw["dim"])


def _collective(cls, x, axis, **kw):
    axes = _axes_of(axis)
    key = (cls.__name__, axes, tuple(sorted((k, repr(v))
                                            for k, v in kw.items())))
    replay = getattr(_LOCAL, "replay", None)
    if replay is not None:
        return replay.take(key)
    frame = _frame()
    mesh = frame.mesh

    def combine(xs):
        op = cls(mesh.groups(axes), mesh.torch_devices, axes, **kw)
        if torch.is_grad_enabled() and any(t.requires_grad for t in xs):
            return list(_CollectiveFn.apply(op, *xs))
        with torch.no_grad():
            return op.run_fwd(xs)
    out = frame.rendezvous.exchange(frame.index, key, x, combine)
    tape = getattr(_LOCAL, "tape", None)
    if tape is not None:
        tape.keep(key, out)
    return out


class SegmentTape(object):
    """The collectives of one mesh position's checkpointed segment (the
    mirror mode, ``executor._run_segments``).  The segment's first run,
    in the position's thread, keeps each collective's output; the
    backward's recompute of the segment runs on autograd's thread, where
    no other position waits at a rendezvous, so it re-enters the
    position (its frame and data-parallel scope) and replays the kept
    outputs in order instead: the recomputed values are the first run's.
    Use :meth:`scope` around every run of the segment."""

    def __init__(self, frame):
        from .. import distributed
        self.frame = frame
        self.dp_scope = distributed._dp()
        self.items = None
        self.at = 0

    def keep(self, key, out):
        self.items.append((key, out.detach(), out.requires_grad))

    def take(self, key):
        if self.at >= len(self.items) or self.items[self.at][0] != key:
            raise MXNetError(
                "a checkpointed segment's recompute called the collective "
                "%s where its first run called %s" % (
                    key, self.items[self.at][0]
                    if self.at < len(self.items) else "none"))
        _, t, grad = self.items[self.at]
        self.at += 1
        t = t.detach()
        return t.requires_grad_(True) if grad else t

    def scope(self):
        import contextlib
        from .. import distributed

        @contextlib.contextmanager
        def first():
            self.items = []
            prev = getattr(_LOCAL, "tape", None)
            _LOCAL.tape = self
            try:
                yield
            finally:
                _LOCAL.tape = prev

        @contextlib.contextmanager
        def again():
            self.at = 0
            prev = (getattr(_LOCAL, "replay", None),
                    getattr(_LOCAL, "frame", None), distributed._dp())
            _LOCAL.replay, _LOCAL.frame = self, self.frame
            distributed._DP.scope = self.dp_scope
            try:
                yield
            finally:
                _LOCAL.replay, _LOCAL.frame = prev[0], prev[1]
                distributed._DP.scope = prev[2]
        return first() if self.items is None else again()


def segment_tape():
    """A :class:`SegmentTape` for a segment run by a mesh position, or
    None outside :func:`run`."""
    frame = getattr(_LOCAL, "frame", None)
    return None if frame is None else SegmentTape(frame)


def psum(x, axis):
    """Sum over ``axis``; every position gets the sum (transpose: psum)."""
    return _collective(_PSum, x, axis)


def psum_positions(xs, mesh, axis):
    """:func:`psum` from outside :func:`run`, by a caller that holds
    every position's tensor (``xs``, in position order): every
    position's sum over ``axis``, in storage of its own."""
    axes = _axes_of(axis)
    return _PSum(mesh.groups(axes), mesh.torch_devices, axes).run_fwd(
        list(xs))


def all_gather_positions(xs, mesh, axis, dim=0):
    """:func:`all_gather` from outside :func:`run` (``xs`` every
    position's block, in position order): every position's gathered
    whole, in storage of its own, as one collective and no rendezvous
    (the backward re-gather of ``parallel/zero3.py``)."""
    axes = _axes_of(axis)
    return _AllGather(mesh.groups(axes), mesh.torch_devices, axes,
                      dim=int(dim), tiled=True).run_fwd(list(xs))


def all_gather(x, axis, dim=0, tiled=True):
    """The axis's blocks concatenated along ``dim`` (stacked on a new
    ``dim`` when not ``tiled``); transpose: reduce-scatter."""
    return _collective(_AllGather, x, axis, dim=int(dim), tiled=bool(tiled))


def psum_scatter(x, axis, dim=0, tiled=True):
    """Sum over ``axis``, each position keeping its block along ``dim``;
    transpose: all-gather."""
    return _collective(_PSumScatter, x, axis, dim=int(dim),
                       tiled=bool(tiled))


def ppermute(x, axis, perm):
    """Send this position's ``x`` along ``axis`` by ``perm`` (pairs of
    source and destination coordinates); a position no pair sends to gets
    zeros.  Transpose: the inverse permutation."""
    return _collective(_PPermute, x, axis,
                       perm=tuple((int(s), int(d)) for s, d in perm))


def all_to_all(x, axis, split_dim, concat_dim):
    """Split ``x`` in axis-size chunks along ``split_dim``; chunk j goes
    to coordinate j, which concatenates what it receives along
    ``concat_dim`` in source order.  Transpose: the reverse all-to-all."""
    return _collective(_AllToAll, x, axis, split=int(split_dim),
                       concat=int(concat_dim))


def copy_to(x, axis):
    """Identity forward, psum backward: a value every position of ``axis``
    holds alike, entering work split over ``axis``."""
    return _collective(_CopyTo, x, axis)


def reduce_from(x, axis):
    """psum forward, identity backward: partial results summed into a
    value every position then holds alike."""
    return _collective(_ReduceFrom, x, axis)


def gather_from(x, axis, dim):
    """all-gather forward, own-slice backward: blocks gathered into a
    value every position then holds alike."""
    return _collective(_GatherFrom, x, axis, dim=int(dim))


def scatter_to(x, axis, dim):
    """Own-slice forward, all-gather backward: a value every position
    holds alike, cut to this position's block."""
    return _collective(_ScatterTo, x, axis, dim=int(dim))
