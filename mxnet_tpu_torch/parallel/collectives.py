"""Shards and collectives on a mesh (``parallel/mesh.py``).

The JAX package partitions one program over a ``Mesh`` with GSPMD or
``shard_map`` and joins the devices with ``jax.lax`` collectives.  The
port's counterpart runs each mesh position in a thread of the process
that holds it:

- :func:`shard` / :func:`unshard` place a tensor on the mesh by a spec
  (a tuple of axis names or None per dimension, :class:`P`) and gather it
  back; :class:`Sharded` holds the positions' parts (each in its own
  storage, also where contexts repeat; another rank's positions hold
  None).
- :func:`run` runs ``fn`` once per position of this process, one thread
  a position, with the position's context current.
- The collectives (:func:`psum`, :func:`all_gather`, :func:`psum_scatter`,
  :func:`ppermute`, :func:`all_to_all`, :func:`axis_index`) are
  rendezvous: each position of the process hands in its tensor, and the
  lowest one applies ONE ``torch.autograd.Function`` to all of them and
  hands each its output.  The backward of that node is the collective's
  transpose over all the gradients at once (reduce-scatter for
  all-gather, psum for psum, the inverse permutation for ppermute), so
  the caller sums the positions' losses and calls ``backward`` once,
  from one thread: no collective waits inside the backward for another
  position of the process (on the card torch's autograd engine runs all
  of a device's backward work on one thread).
- :func:`copy_to`, :func:`reduce_from`, :func:`gather_from` and
  :func:`scatter_to` are the tensor-parallel forms, for values that every
  position of the axis holds alike downstream (the positions compute the
  same replicated loss): their backwards are psum, identity, the own
  slice and all-gather, so a gradient that every position computes alike
  is counted once.

Where a collective's groups span ranks (:meth:`Mesh.component`), the
lowest local position stacks this process's tensors into one byte buffer
behind a header (the kind, the axes, the shape and dtype, and the
process's sequence number over that set of ranks) and runs ONE
``all_gather`` of it over the ranks' process subgroup
(:func:`_exchange`); every rank then holds every member's tensor, in
position order, and applies the same arithmetic as a mesh inside one
process, so a rank-spanning mesh computes what the in-process mesh of
the same shape does, bit for bit.  A header that differs between ranks
(collectives issued in different orders) raises, naming both sides.  In
the backward, a rank-spanning mesh's exchanges must run in the same
order on every rank: each differentiable exchange takes the previous
one's token (a 0-d tensor) and hands on its own (:func:`chain`), so
every rank's autograd engine runs them in the reverse of the order the
forward made them, and the last token reaches the loss.

Every output is a new tensor in its position's storage: with repeated
contexts ``t.to(device)`` would otherwise hand two positions one buffer.

A step over the mesh is reproducible from run to run: :func:`shard`
places a tensor that requires grad through ONE autograd node whose
backward adds the positions' gradients in position order, and the
rendezvous' node over the process's positions is always made by its
lowest position's thread (autograd orders ready nodes by a per-thread
sequence number, so a node made by whichever thread came last would
reorder the backward's sums).  Every collective reports its kind and the
bytes one position moves to :data:`COLLECTIVE_HOOKS` (the graph lint's
recorder listens there, as it does to ``kernels.LAUNCH_HOOKS``), in the
forward and in the backward; a cross-rank exchange is also one
``all_gather`` that ``distributed.STATS`` counts and the recorder sees.
Inside a checkpointed segment (the mirror mode) each collective's output
is kept on the segment's :class:`SegmentTape`, and the backward's
recompute, which runs on autograd's thread where no position waits at a
rendezvous, replays it.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["P", "Sharded", "shard", "unshard", "run", "current",
           "axis_index", "axis_size", "psum", "all_gather", "psum_scatter",
           "ppermute", "all_to_all", "copy_to", "reduce_from", "gather_from",
           "scatter_to", "tree_map", "shard_tree", "unshard_tree",
           "psum_positions", "all_gather_positions", "COLLECTIVE_HOOKS",
           "note_collective", "SegmentTape", "segment_tape", "chain",
           "last_token"]

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


# ---------------------------------------------------------------------------
# the cross-rank exchange and the order of a rank-spanning backward
# ---------------------------------------------------------------------------

#: int64 header fields: magic, sequence number, dtype code, member
#: numel, member count, dimension count, the shape (8 slots), a flag
#: (this rank's inputs require grad)
_HEAD_INTS = 16
_KIND_BYTES = 64
_HEAD = _HEAD_INTS * 8 + _KIND_BYTES
_MAGIC = 0x6d78747863686731
_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)
_SEQ = {}       # rank tuple -> exchanges issued over it by this process


def _header(seq, kind, like, count, flag):
    """The header of one rank's segment (uint8, on ``like``'s device)."""
    shape = list(like.shape)
    if len(shape) > 8:
        raise MXNetError("a cross-rank exchange of %d dimensions (at most "
                         "8)" % len(shape))
    ints = [_MAGIC, seq, _DTYPES.index(like.dtype), like.numel(), count,
            len(shape)] + shape
    ints += [0] * (_HEAD_INTS - 2 - len(ints)) + [int(bool(flag)), 0]
    text = kind.encode()[:_KIND_BYTES].ljust(_KIND_BYTES, b"\0")
    head = torch.cat([torch.tensor(ints, dtype=torch.int64).view(torch.uint8),
                      torch.frombuffer(bytearray(text), dtype=torch.uint8)])
    return head.to(like.device)


def _read_header(row):
    ints = np.frombuffer(row[:_HEAD_INTS * 8].tobytes(), dtype=np.int64)
    kind = row[_HEAD_INTS * 8:_HEAD].tobytes().rstrip(b"\0").decode(
        "utf-8", "replace")
    ndim = int(ints[5])
    return {"magic": int(ints[0]), "seq": int(ints[1]),
            "dtype": int(ints[2]), "numel": int(ints[3]),
            "count": int(ints[4]), "shape": tuple(int(d) for d in
                                                  ints[6:6 + ndim]),
            "flag": bool(ints[_HEAD_INTS - 2]), "kind": kind}


def _describe(h):
    dtype = _DTYPES[h["dtype"]] if 0 <= h["dtype"] < len(_DTYPES) else "?"
    return "exchange #%d %s of %d x %s%s" % (
        h["seq"], h["kind"], h["count"], str(dtype).replace("torch.", ""),
        list(h["shape"]))


def _exchange(mesh, axes, kind, tensors, members=None, like=None,
              flag=False):
    """Every member's tensor from the ranks of this rank's component over
    ``axes`` (:meth:`Mesh.component`): ``tensors`` maps this process's
    positions to their tensors (all of one shape and dtype, ``like``'s
    where this rank sends none), ``members`` (default: the component's
    positions) the positions wanted.  Each rank sends its members' bytes
    behind a header, padded to the largest rank's member count, in ONE
    ``all_gather`` over the component's process subgroup; the header is
    checked against every other rank's.  Returns ``({position: tensor}
    for every member, whether any rank set its flag)``: this process's
    tensors as given, the others' as views of the gathered buffer on
    this process's device.  ``distributed.STATS['all_gather']`` counts
    the exchanges, their bytes and their host seconds."""
    from .. import distributed
    ranks, comp = mesh.component(axes)
    want = set(comp if members is None else members) & set(comp)
    if len(ranks) == 1:
        return {i: tensors[i] for i in want if i in tensors}, bool(flag)
    me = distributed.rank()
    sent = {r: [i for i in sorted(want) if mesh.rank_of[i] == r]
            for r in ranks}
    mine = [tensors[i] for i in sent[me]]
    like = mine[0] if mine else like
    if like is None:
        raise MXNetError("%s: this rank sends nothing and has no shape to "
                         "receive by" % kind)
    seq = _SEQ.get(ranks, 0) + 1
    _SEQ[ranks] = seq
    nbytes = like.numel() * like.element_size()
    slots = max(len(v) for v in sent.values())
    pieces = [_header(seq, kind, like, len(mine), flag)]
    pieces += [t.detach().contiguous().reshape(-1).view(torch.uint8)
               for t in mine]
    pad = (slots - len(mine)) * nbytes
    if pad:
        pieces.append(torch.zeros(pad, dtype=torch.uint8,
                                  device=like.device))
    buf = torch.cat([p.to(like.device) for p in pieces])
    group = distributed.subgroup(ranks)
    host = like.is_cuda and \
        distributed.TRANSPORTS.get("all_gather", "native") == "host"
    with distributed.transport_scope():
        if host:
            # gloo on the card: the buffer goes through pinned host
            # memory, where the headers are read; the payload goes back
            staged = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            staged.copy_(buf)
            gathered = distributed._collective("all_gather", staged,
                                               group=group)
        else:
            gathered = distributed._collective("all_gather", buf,
                                               group=group)
        rows = gathered.reshape(len(ranks), -1)
        heads = rows[:, :_HEAD].cpu().numpy()
        if host:
            rows = rows.to(like.device, non_blocking=True)
    ours = _read_header(heads[ranks.index(me)])
    for j, r in enumerate(ranks):
        theirs = _read_header(heads[j])
        same = theirs["magic"] == _MAGIC and all(
            theirs[k] == ours[k] for k in ("seq", "kind", "dtype", "numel",
                                           "shape")) and \
            theirs["count"] == len(sent[r])
        if not same:
            raise MXNetError(
                "mesh ranks diverged: rank %d issued %s where rank %d "
                "issued %s (every rank must issue the mesh's collectives "
                "in the same order)" % (me, _describe(ours), r,
                                        _describe(theirs)))
    anyflag = any(_read_header(h)["flag"] for h in heads)
    out = {i: tensors[i] for i in sent[me]}
    for j, r in enumerate(ranks):
        if r == me:
            continue
        for k, i in enumerate(sent[r]):
            off = _HEAD + k * nbytes
            out[i] = rows[j, off:off + nbytes].view(like.dtype).reshape(
                like.shape)
    return out, anyflag


@contextlib.contextmanager
def chain(mesh):
    """The scope of one rank-spanning computation's differentiable
    exchanges (a step, a ``shard_map`` call): inside it each exchange's
    autograd node takes the previous node's token and hands on its own,
    so every rank's backward runs them in one order; :func:`last_token`
    is the token to give the backward's roots.  A no-op on a mesh inside
    one process, and inside an enclosing scope over the same mesh."""
    if not getattr(mesh, "spans_ranks", False) or \
            getattr(mesh, "_chain", None) is not None:
        yield
        return
    mesh._chain = [None]
    try:
        yield
    finally:
        mesh._chain = None


def last_token(mesh):
    """The last exchange token of ``mesh``'s open :func:`chain` (None
    before the first or outside a scope)."""
    ch = getattr(mesh, "_chain", None)
    return None if ch is None else ch[0]


def _apply_chained(fn, mesh, device, consts, tensors):
    """``fn.apply(*consts, token, *tensors)`` with the open chain's token
    (None outside a :func:`chain` scope); ``fn`` returns its outputs,
    then the next token when it was given one, which becomes the chain's.
    Returns the outputs."""
    ch = getattr(mesh, "_chain", None)
    token = None
    if ch is not None:
        token = ch[0] if ch[0] is not None else torch.zeros(
            (), device=device, requires_grad=True)
    out = fn.apply(*(tuple(consts) + (token,) + tuple(tensors)))
    if token is None:
        return out
    ch[0] = out[-1]
    return out[:-1]


def _with_token(outs, token):
    outs = tuple(outs)
    return outs + (token.new_zeros(()),) if token is not None else outs


def _token_grad(token_given, like):
    return (torch.zeros((), device=like.device),) if token_given \
        else (None,)


class Sharded(object):
    """A tensor laid over a mesh: ``parts[i]`` is position ``i``'s block,
    on that position's device (None for another rank's position);
    ``shape`` is the whole's."""

    def __init__(self, parts, mesh, spec, shape):
        self.parts = list(parts)
        self.mesh = mesh
        self.spec = _spec(spec)
        self.shape = tuple(int(d) for d in shape)
        self.sharding = Sharding(mesh, self.spec)

    def _first(self):
        return next(p for p in self.parts if p is not None)

    @property
    def dtype(self):
        return self._first().dtype

    @property
    def device(self):
        """This process's first position's device."""
        return self._first().device

    def full(self, device=None):
        """The whole tensor (on this process's first position's device
        unless ``device``); on a rank-spanning mesh every rank calls it
        together and gets the whole."""
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
    devs = mesh.torch_devices
    local = set(mesh.local)
    return [_fresh(_block_of(t, mesh, i, spec), devs[i]).contiguous()
            if i in local else None for i in range(mesh.size)]


class _ShardFn(torch.autograd.Function):
    """:func:`shard` of a tensor that requires grad: one node over every
    local position's block, whose backward adds the positions' gradients
    (every rank's, on a rank-spanning mesh) into the whole in position
    order (the same sums, in the same order, on every run)."""

    @staticmethod
    def forward(ctx, mesh, spec, token, t):
        ctx.mesh, ctx.spec, ctx.chained = mesh, spec, token is not None
        ctx.meta = (t.shape, t.dtype, t.device)
        parts = _place_blocks(t, mesh, spec)
        return _with_token([parts[i] for i in mesh.local], token)

    @staticmethod
    def backward(ctx, *gs):
        mesh = ctx.mesh
        if ctx.chained:
            gs = gs[:-1]
        shape, dtype, device = ctx.meta
        grads = dict(zip(mesh.local, gs))
        if mesh.spans_ranks:
            grads = _exchange(mesh, mesh.axis_names, "shard.bwd%r"
                              % (tuple(ctx.spec),), grads, like=gs[0])[0]
        full = torch.zeros(shape, dtype=dtype, device=device)
        for i in range(mesh.size):
            g = grads.get(i)
            if g is not None:
                _block_of(full, mesh, i, ctx.spec).add_(g.to(device))
        return (None, None) + _token_grad(ctx.chained, gs[0]) + (full,)


def shard(t, mesh, spec=None):
    """Place ``t`` (a tensor or numpy array) on ``mesh`` by ``spec``: each
    of this process's positions gets its block, a copy in its own storage
    on its context's device.  Differentiable: the gradient of ``t`` is
    the sum of the positions' gradients (a replicated input's copies
    each contribute; on a rank-spanning mesh every rank's, and every
    rank passes the same ``t``), added in position order by one node."""
    if isinstance(t, Sharded):
        if t.mesh is mesh and t.spec == _spec(spec):
            return t
        t = t.full()
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    spec = _spec(spec)
    _check_spec(t.shape, spec, mesh)
    if torch.is_grad_enabled() and t.requires_grad:
        outs = _apply_chained(_ShardFn, mesh, t.device, (mesh, spec), (t,))
        parts = [None] * mesh.size
        for i, p in zip(mesh.local, outs):
            parts[i] = p
    else:
        parts = _place_blocks(t, mesh, spec)
    return Sharded(parts, mesh, spec, t.shape)


def _unshard_keys(mesh, spec, ndim):
    """``{block key: position}``: the positions whose parts make the
    whole (coordinate 0 of every axis the spec does not name)."""
    named = {a for e in spec for a in _axes_of(e)}
    keys = {}
    for i in range(mesh.size):
        coords = mesh.coords(i)
        if any(coords[a] for a in mesh.axis_names if a not in named):
            continue
        key = tuple(_block(mesh, coords, _axes_of(spec[d]))[0]
                    if d < len(spec) else 0 for d in range(ndim))
        keys[key] = i
    return keys


def _assemble(blocks, mesh, spec, ndim, dev):
    def build(prefix, d):
        if d == ndim:
            return blocks[prefix].to(dev)
        n = _block(mesh, mesh.coords(0), _axes_of(spec[d]))[1] \
            if d < len(spec) else 1
        pieces = [build(prefix + (k,), d + 1) for k in range(n)]
        return pieces[0] if n == 1 else torch.cat(pieces, d)
    return build((), 0)


class _UnshardFn(torch.autograd.Function):
    """:func:`unshard` on a rank-spanning mesh where some rank's parts
    require grad: the forward hands on the whole gathered from every
    rank; the backward hands each of this process's parts its block of
    the whole's gradient (none leaves the process)."""

    @staticmethod
    def forward(ctx, mesh, spec, gathered, token, *parts):
        whole, keys = gathered
        ctx.mesh, ctx.spec, ctx.chained = mesh, spec, token is not None
        ctx.meta = [(p.shape, p.dtype, p.device) for p in parts]
        ctx.key_of = {i: k for k, i in keys.items()}
        return _with_token([whole], token)

    @staticmethod
    def backward(ctx, *gs):
        mesh, spec, g = ctx.mesh, ctx.spec, gs[0]
        grads = []
        for i, (shape, dtype, device) in zip(mesh.local, ctx.meta):
            key = ctx.key_of.get(i)
            if key is None:
                grads.append(torch.zeros(shape, dtype=dtype, device=device))
                continue
            blk = g
            for d in range(g.dim()):
                size = shape[d]
                blk = blk.narrow(d, key[d] * size, size)
            grads.append(blk.to(device).contiguous())
        return (None, None, None) + _token_grad(ctx.chained, g) + \
            tuple(grads)


def _gather_whole(mesh, spec, parts, dev, grad):
    """The whole from this process's ``parts`` ({position: tensor}),
    gathered from every rank (``grad``: this rank's parts require grad);
    returns ``(whole, {block key: position}, any rank's grad)``."""
    first = next(iter(parts.values()))
    ndim = first.dim()
    keys = _unshard_keys(mesh, spec, ndim)
    got, grad = _exchange(mesh, mesh.axis_names, "unshard%r"
                          % (tuple(spec),), parts, members=keys.values(),
                          like=first, flag=grad)
    blocks = {k: got[i].detach() for k, i in keys.items()}
    return _assemble(blocks, mesh, spec, ndim,
                     dev if dev is not None else first.device), keys, grad


def unshard(parts, mesh, spec=None, device=None):
    """The whole tensor from the positions' ``parts`` laid out by
    ``spec``: replicated axes take coordinate 0's copy, sharded ones are
    concatenated.  On a rank-spanning mesh the parts come from every
    rank (every rank calls this together and gets the whole).
    Differentiable (the gradient reaches the copies it read)."""
    spec = _spec(spec)
    local = {i: parts[i] for i in mesh.local if parts[i] is not None}
    first = next(iter(local.values()))
    dev = device if device is not None else first.device
    if not mesh.spans_ranks:
        ndim = first.dim()
        keys = _unshard_keys(mesh, spec, ndim)
        return _assemble({k: parts[i] for k, i in keys.items()}, mesh,
                         spec, ndim, dev)
    grad = torch.is_grad_enabled() and any(p.requires_grad
                                           for p in local.values())
    whole, keys, grad = _gather_whole(mesh, spec, local, dev, grad)
    if not grad or not torch.is_grad_enabled():
        return whole
    return _apply_chained(_UnshardFn, mesh, first.device,
                          (mesh, spec, (whole, keys)),
                          [local[i] for i in mesh.local])[0]


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
    """The whole trees from the positions' output trees by ``specs``
    (another rank's positions hold None)."""
    def sub(trees, k):
        return [None if t is None else t[k] for t in trees]

    def go(trees, spec):
        first = next(t for t in trees if t is not None)
        if spec is not None and not isinstance(spec, P):
            if isinstance(spec, dict):
                return {k: go(sub(trees, k), spec[k]) for k in first}
            out = [go(sub(trees, i), s) for i, s in enumerate(spec)]
            return type(first)(out) if isinstance(first, tuple) else out
        if _is_node(first):
            if isinstance(first, dict):
                return {k: go(sub(trees, k), spec) for k in first}
            out = [go(sub(trees, i), spec) for i in range(len(first))]
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
    """All N positions of this process hand in one item; once all have
    arrived the lowest position (slot 0) computes every position's result
    from all the items (always the same thread, so the autograd node it
    makes takes its place in the backward's order from that thread's
    sequence), and each takes its own."""

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
    __slots__ = ("mesh", "index", "slot", "coords", "rendezvous")

    def __init__(self, mesh, index, slot, rendezvous):
        self.mesh = mesh
        self.index = index
        self.slot = slot
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
    """``fn(*per_position_args[i])`` for every position ``i`` of this
    process (``mesh.local``), each call in a thread of its own with
    position ``i``'s context (and its CUDA device) current, the caller's
    grad mode and the caller's ``TorchDispatchMode`` stack (a recorder
    sees every position's ops); the collectives inside ``fn`` join the
    threads, and the ranks where the mesh spans ranks.  Returns one
    result a position (None for another rank's).  The first failure is
    raised after every thread has ended."""
    from torch.utils._python_dispatch import \
        _get_current_dispatch_mode_stack
    local = list(mesh.local)
    n = mesh.size
    rv = _Rendezvous(len(local))
    results = [None] * n
    errors = [None] * n
    grad = torch.is_grad_enabled()
    modes = list(_get_current_dispatch_mode_stack())
    contexts = mesh.contexts

    def body(slot, i):
        ctx = contexts[i]
        _LOCAL.frame = _Frame(mesh, i, slot, rv)
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

    with chain(mesh):
        threads = [threading.Thread(target=body, args=(slot, i),
                                    name="mesh-position-%d" % i, daemon=True)
                   for slot, i in enumerate(local)]
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
    """One autograd node over every local position's tensor (on a
    rank-spanning mesh: the chain's token in and out, and ``full`` every
    position's input, already exchanged)."""

    @staticmethod
    def forward(ctx, op, full, token, *xs):
        ctx.op, ctx.chained = op, token is not None
        if full is None:
            out = op.run_fwd(op.spread(xs))
        else:
            out = op.run_fwd(full, exchanged=True)
        return _with_token(op.local_of(out), token)

    @staticmethod
    def backward(ctx, *gs):
        op = ctx.op
        if ctx.chained:
            gs = gs[:-1]
        out = op.local_of(op.run_bwd(op.spread(gs)))
        return (None, None) + _token_grad(ctx.chained, gs[0]) + tuple(out)


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
    list of every position's tensor to this process's positions' outputs
    (None elsewhere); ``kinds`` names what each direction moves (None: a
    local copy or slice), which ``run_fwd``/``run_bwd`` report.  Where
    the groups span ranks, ``run_fwd``/``run_bwd`` first fill in the
    other ranks' tensors (:func:`_exchange`)."""

    kinds = (None, None)

    def __init__(self, mesh, axes=(), **kw):
        self.mesh = mesh
        self.groups = mesh.groups(axes)
        self.devices = mesh.torch_devices
        self.axes = tuple(axes)
        self.local = set(mesh.local)
        self.kw = kw

    @property
    def crosses_ranks(self):
        return len(self.mesh.component(self.axes)[0]) > 1

    def spread(self, xs):
        """This process's tensors (in ``mesh.local`` order) as a
        position-indexed list."""
        full = [None] * self.mesh.size
        for i, x in zip(self.mesh.local, xs):
            full[i] = x
        return full

    def local_of(self, out):
        return [out[i] for i in self.mesh.local]

    def _complete(self, xs, direction, flag=False):
        """``(xs with the other ranks' tensors filled in, whether any
        rank set its flag)``."""
        if not self.crosses_ranks:
            return xs, flag
        got, flag = _exchange(self.mesh, self.axes, "%s.%s%r%s" % (
            type(self).__name__.strip("_"), direction, self.axes,
            "".join(",%s=%s" % kv for kv in sorted(self.kw.items()))),
            {i: xs[i] for i in self.mesh.local}, flag=flag)
        return [got.get(i) for i in range(self.mesh.size)], flag

    def run_fwd(self, xs, exchanged=False):
        out = self.fwd(list(xs) if exchanged else
                       self._complete(list(xs), "fwd")[0])
        note_collective(self.kinds[0], out, self.axes)
        return out

    def run_bwd(self, gs):
        out = self.bwd(self._complete(list(gs), "bwd")[0])
        note_collective(self.kinds[1], out, self.axes)
        return out

    def _each(self, xs, per_group):
        out = [None] * len(xs)
        for g in self.groups:
            want = [m in self.local for m in g]
            if not any(want):
                continue
            for pos, t in zip(g, per_group([xs[m] for m in g], g, want)):
                if t is not None:
                    out[pos] = t
        return out

    def _hand(self, value, g, want):
        """``value`` to each wanted member of ``g``: the first on its
        device takes it, every other a copy on its own device."""
        out, taken = [], False
        for m, w in zip(g, want):
            if not w:
                out.append(None)
            elif not taken and value.device == self.devices[m]:
                out.append(value)
                taken = True
            else:
                out.append(_fresh(value, self.devices[m]))
        return out

    # the building blocks, each one group at a time
    def _psum(self, xs):
        def go(ts, g, want):
            return self._hand(_sum_to(ts, self.devices[g[0]]), g, want)
        return self._each(xs, go)

    def _gather(self, xs, dim, tiled=True):
        def go(ts, g, want):
            dev = self.devices[g[0]]
            ts = [t.to(dev) for t in ts]
            whole = torch.cat(ts, dim) if tiled else torch.stack(ts, dim)
            return self._hand(whole, g, want)
        return self._each(xs, go)

    def _scatter_sum(self, xs, dim, tiled=True):
        def go(ts, g, want):
            total = _sum_to(ts, self.devices[g[0]])
            if tiled:
                parts = _chunks(total, len(g), dim)
            else:
                parts = list(total.unbind(dim))
            return [_fresh(p, self.devices[m]).contiguous() if w else None
                    for p, m, w in zip(parts, g, want)]
        return self._each(xs, go)

    def _own_slice(self, xs, dim):
        def go(ts, g, want):
            return [_fresh(_chunks(t, len(g), dim)[k],
                           self.devices[m]).contiguous() if w else None
                    for k, (t, m, w) in enumerate(zip(ts, g, want))]
        return self._each(xs, go)

    def _copy(self, xs):
        return [_fresh(t, self.devices[i]) if i in self.local else None
                for i, t in enumerate(xs)]


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
                if g[dst] in self.local:
                    out[g[dst]] = _fresh(xs[g[src]], self.devices[g[dst]])
        return [o if o is not None or i not in self.local
                else torch.zeros_like(xs[i]) for i, o in enumerate(out)]

    def fwd(self, xs):
        return self._move(xs, self.kw["perm"])

    def bwd(self, gs):
        return self._move(gs, [(d, s) for s, d in self.kw["perm"]])


class _AllToAll(_Op):
    kinds = ("all-to-all", "all-to-all")

    def _swap(self, xs, split, concat):
        def go(ts, g, want):
            n = len(g)
            pieces = [_chunks(t, n, split) for t in ts]
            return [torch.cat([pieces[k][j].to(self.devices[m])
                               for k in range(n)], concat).contiguous()
                    if w else None
                    for j, (m, w) in enumerate(zip(g, want))]
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
        op = cls(mesh, axes, **kw)
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in xs)
        full = None
        if op.crosses_ranks and torch.is_grad_enabled():
            # whether to differentiate is every rank's call: a rank whose
            # inputs need no grad still makes the node its peers make
            full, grad = op._complete(op.spread([x.detach() for x in xs]),
                                      "fwd", flag=grad)
        if grad:
            return list(_apply_chained(_CollectiveFn, mesh, xs[0].device,
                                       (op, full), xs))
        with torch.no_grad():
            return op.local_of(op.run_fwd(
                op.spread(xs) if full is None else full,
                exchanged=full is not None))
    out = frame.rendezvous.exchange(frame.slot, key, x, combine)
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
    every position's tensor of this process (``xs``, in position order,
    None for another rank's): every local position's sum over ``axis``,
    in storage of its own (every rank calls it together where the axis
    spans ranks)."""
    return _PSum(mesh, _axes_of(axis)).run_fwd(list(xs))


def all_gather_positions(xs, mesh, axis, dim=0):
    """:func:`all_gather` from outside :func:`run` (``xs`` every
    position's block, in position order, None for another rank's):
    every local position's gathered
    whole, in storage of its own, as one collective and no rendezvous
    (the backward re-gather of ``parallel/zero3.py``)."""
    return _AllGather(mesh, _axes_of(axis), dim=int(dim),
                      tiled=True).run_fwd(list(xs))


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
