"""Meshes with named axes (port of ``mxnet_tpu/parallel/mesh.py``).

A mesh position is a ``(rank, Context)`` pair: a device of one process
of the process group.  ``build_mesh`` takes its devices in three forms:

- **ranks** (ints): one position a rank, on that rank's device (the
  JAX package's one-device-a-process layout);
- **contexts**: every position in this process (a mesh inside one
  process; contexts may repeat, ``[gpu(0)] * 8`` on one card,
  ``[cpu()] * 8`` in tests);
- **(rank, Context) pairs**: several positions a rank over several
  ranks, the JAX package's processes x local devices
  (``distributed.global_devices`` lists them rank-major).

Any of ``dp``, ``tp``, ``sp``, ``pp`` and ``ep`` may have a size above 1
in every form.  Each position holds its own shards in its own storage;
a process runs only its own positions, one thread a position
(``parallel/collectives.py``), and the collectives join the positions
inside the process and across ranks.  A mesh that spans ranks makes one
process subgroup for each set of ranks its collectives join, when it is
built; every rank must build it with the same device list.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..base import MXNetError

__all__ = ["Mesh", "build_mesh", "default_mesh", "local_mesh", "AXIS_DP",
           "AXIS_TP", "AXIS_SP", "AXIS_PP", "AXIS_EP"]

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_PP = "pp"
AXIS_EP = "ep"


def _my_rank():
    from .. import distributed
    return distributed.rank()


def _rank_context():
    """This rank's device as a context (what a rank position runs on)."""
    from .. import distributed
    from ..context import Context, current_context
    dev = distributed.device()
    if dev is None:
        return current_context()
    return Context("cpu", 0) if dev.type == "cpu" else \
        Context("gpu", dev.index)


class Mesh(object):
    """Named axes over devices.

    ``shape`` maps axis name -> size (insertion order), ``axis_names``
    is the name tuple, ``devices`` the device array shaped by the axis
    sizes (``devices.flat`` walks the positions in row-major order), and
    ``size`` the position count.  ``rank_of[i]`` is position ``i``'s
    rank and ``local`` the positions of this process, in order;
    :attr:`spans_ranks` is true when the positions lie on more than one
    rank, :attr:`over_ranks` when the devices were given as ranks (one
    position a rank), and :attr:`in_process` when every position is this
    process's and the devices were contexts."""

    def __init__(self, axis_sizes, devices):
        from ..context import Context
        self.shape = OrderedDict((str(k), int(v))
                                 for k, v in axis_sizes.items())
        self.axis_names = tuple(self.shape)
        devices = list(devices)
        me = _my_rank()
        self.over_ranks = bool(devices) and all(
            isinstance(d, (int, np.integer)) for d in devices)
        ranks, ctxs = [], []
        for d in devices:
            if isinstance(d, Context):
                ranks.append(me)
                ctxs.append(d)
            elif isinstance(d, (int, np.integer)):
                ranks.append(int(d))
                ctxs.append(_rank_context())
            else:
                r, c = d
                ranks.append(int(r))
                ctxs.append(Context(c))
        self.rank_of = ranks
        self.ranks = sorted(set(ranks))
        self.spans_ranks = len(self.ranks) > 1
        self.local = [i for i, r in enumerate(ranks) if r == me]
        self.in_process = bool(devices) and not self.spans_ranks and \
            not self.over_ranks
        arr = np.empty(len(devices), dtype=object)
        arr[:] = devices
        self.devices = arr.reshape(tuple(self.shape.values()) or (1,))
        self._contexts = ctxs
        self.size = int(self.devices.size)
        self._groups = {}
        self._components = {}
        self._torch_devices = None

    @property
    def contexts(self):
        """The positions' contexts in row-major order (another rank's
        positions report this rank's device)."""
        return list(self._contexts)

    @property
    def torch_devices(self):
        """The positions' ``torch.device``s in row-major order."""
        if self._torch_devices is None:
            self._torch_devices = [c.torch_device for c in self._contexts]
        return self._torch_devices

    def coords(self, index):
        """``{axis: coordinate}`` of the flat position ``index``."""
        sizes = tuple(self.shape.values())
        idx = np.unravel_index(int(index), sizes) if sizes else ()
        return OrderedDict((a, int(i)) for a, i in zip(self.axis_names, idx))

    def groups(self, axes):
        """The positions that share every coordinate but ``axes`` (a name
        or a tuple of names), each group ordered by its coordinate along
        ``axes`` (row-major over them)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes in self._groups:
            return self._groups[axes]
        for a in axes:
            if a not in self.shape:
                raise MXNetError("mesh %s has no axis %r"
                                 % (dict(self.shape), a))
        names = self.axis_names
        flat = np.arange(self.size).reshape(tuple(self.shape.values())
                                            or (1,))
        order = [names.index(a) for a in names if a not in axes] + \
            [names.index(a) for a in axes]
        moved = flat.transpose(order) if names else flat
        n = int(np.prod([self.shape[a] for a in axes])) if axes else 1
        self._groups[axes] = [list(map(int, g)) for g in
                              moved.reshape(-1, n)]
        return self._groups[axes]

    def component(self, axes):
        """``(ranks, positions)``: the ranks this process exchanges with
        for a collective over ``axes`` (the connected set of ranks that
        the axes' groups join, this rank's included) and the positions
        they hold, in order.  One rank: the collective stays inside this
        process."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes not in self._components:
            self._components[axes] = self._partition(axes)
        return self._components[axes][_my_rank()]

    def _partition(self, axes):
        """{rank: (its component's ranks, their positions)} for ``axes``."""
        parent = {r: r for r in self.ranks}

        def find(r):
            while parent[r] != r:
                parent[r] = parent[parent[r]]
                r = parent[r]
            return r
        for g in self.groups(axes) if axes else [list(range(self.size))]:
            rs = [self.rank_of[m] for m in g]
            for r in rs[1:]:
                parent[find(r)] = find(rs[0])
        comps = {}
        for r in self.ranks:
            comps.setdefault(find(r), []).append(r)
        out = {}
        for rs in comps.values():
            pos = [i for i in range(self.size) if self.rank_of[i] in rs]
            for r in rs:
                out[r] = (tuple(rs), pos)
        return out

    def rank_sets(self):
        """Every set of ranks some collective over some axes of this mesh
        joins (the process subgroups the mesh needs)."""
        import itertools
        names = self.axis_names
        out = set()
        for k in range(len(names) + 1):
            for axes in itertools.combinations(names, k):
                for rs, _ in self._partition(axes).values():
                    if len(rs) > 1:
                        out.add(rs)
        return sorted(out)

    def __repr__(self):
        where = ", in-process" if self.in_process else (
            ", %d ranks" % len(self.ranks) if self.spans_ranks else "")
        return "Mesh(%s%s)" % (dict(self.shape), where)


def _world_ranks():
    from .. import distributed
    return list(range(distributed.num_workers()))


def build_mesh(axis_sizes, devices=None):
    """A mesh from ``{'dp': 4, 'tp': 2, ...}`` over ``devices``: a list of
    contexts (a mesh inside this process, repeats allowed), a list of
    ranks (one position a rank), a list of ``(rank, Context)`` pairs, or
    None for the process group's ranks.  Sizes must multiply to the
    device count.  A mesh over more than one rank needs the process
    group, every rank must pass the same devices (checked here, one
    host exchange) and its subgroups are made here."""
    if devices is None:
        devices = _world_ranks()
    devices = list(devices)
    names = tuple(axis_sizes.keys())
    sizes = tuple(int(s) for s in axis_sizes.values())
    n = int(np.prod(sizes))
    if n != len(devices):
        raise MXNetError(
            "mesh axes %s multiply to %d but %d devices are available"
            % (dict(axis_sizes), n, len(devices)))
    mesh = Mesh(OrderedDict(zip(names, sizes)), devices)
    if mesh.spans_ranks:
        _join_ranks(mesh)
    return mesh


def _join_ranks(mesh):
    """Check that every rank built ``mesh`` alike and make its
    subgroups."""
    from .. import distributed
    world = distributed.num_workers()
    if not distributed.is_initialized() or world < 2:
        raise MXNetError(
            "a mesh over ranks %s needs the process group (launch with "
            "tools/launch.py)" % (mesh.ranks,))
    bad = [r for r in mesh.ranks if not 0 <= r < world]
    if bad:
        raise MXNetError("mesh ranks %s lie outside the process group of "
                         "%d" % (bad, world))
    mine = (list(mesh.shape.items()),
            [(r, c.device_type, c.device_id) if not mesh.over_ranks else r
             for r, c in zip(mesh.rank_of, mesh._contexts)])
    every = distributed.all_gather_object(mine)
    for r, theirs in enumerate(every):
        if theirs != mine:
            raise MXNetError(
                "build_mesh: rank %d built %s over %s, rank %d %s over %s "
                "(every rank passes the same axes and devices)"
                % (distributed.rank(), mine[0], mine[1], r, theirs[0],
                   theirs[1]))
    distributed.make_subgroups(mesh.rank_sets())


def default_mesh(data_parallel=None, tensor_parallel=1, sequence_parallel=1,
                 devices=None):
    """Everything not claimed by tp/sp goes to dp."""
    if devices is None:
        devices = _world_ranks()
    n = len(devices)
    if data_parallel is None:
        data_parallel = n // (tensor_parallel * sequence_parallel)
    axes = OrderedDict([(AXIS_DP, data_parallel)])
    if sequence_parallel > 1:
        axes[AXIS_SP] = sequence_parallel
    if tensor_parallel > 1:
        axes[AXIS_TP] = tensor_parallel
    return build_mesh(axes, devices)


def local_mesh(axis_name=AXIS_DP, devices=None):
    """1-D mesh over every rank, or over ``devices`` (the kvstore='tpu'
    default)."""
    if devices is None:
        devices = _world_ranks()
    return build_mesh({axis_name: len(devices)}, devices)
