"""Meshes with named axes (port of ``mxnet_tpu/parallel/mesh.py``).

A mesh has two forms in the port:

- **over the process group**: one rank a device, ranks laid out in
  row-major order over the axis sizes (later axes innermost, as in the
  JAX package).  It carries the data axis ``dp`` only; a model-parallel
  axis over ranks raises, naming the item of ROADMAP.md that brings it.
- **inside one process, over a list of contexts**: every position of the
  mesh is a :class:`~mxnet_tpu_torch.context.Context` and holds its own
  shards in its own storage; ``parallel/collectives.py`` runs one thread
  per position and joins them by explicit collectives.  Contexts may
  repeat (``[gpu(0)] * 8`` on one card, ``[cpu()] * 8`` in tests), and any
  of ``dp``, ``tp``, ``sp``, ``pp`` and ``ep`` may have a size above 1.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..base import MXNetError

__all__ = ["Mesh", "build_mesh", "default_mesh", "local_mesh", "AXIS_DP",
           "AXIS_TP", "AXIS_SP", "AXIS_PP", "AXIS_EP", "NEXT_ITEM",
           "is_in_process"]

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_PP = "pp"
AXIS_EP = "ep"

#: where the model-parallel axes across processes are queued
NEXT_ITEM = ("the model-parallel axes across processes (ROADMAP.md queue "
             "1, item 4, sub-item 9)")


def model_parallel_error(what, item=NEXT_ITEM):
    return MXNetError("%s is not ported yet: it comes with %s"
                      % (what, item))


class Mesh(object):
    """Named axes over devices.

    ``shape`` maps axis name -> size (insertion order), ``axis_names``
    is the name tuple, ``devices`` the device array shaped by the axis
    sizes (``devices.flat`` walks the positions in row-major order), and
    ``size`` the position count.  The devices are ranks of the process
    group, or :class:`Context` objects for a mesh inside one process
    (:attr:`in_process`)."""

    def __init__(self, axis_sizes, devices):
        from ..context import Context
        self.shape = OrderedDict((str(k), int(v))
                                 for k, v in axis_sizes.items())
        self.axis_names = tuple(self.shape)
        devices = list(devices)
        self.in_process = bool(devices) and all(
            isinstance(d, Context) for d in devices)
        arr = np.empty(len(devices), dtype=object)
        arr[:] = devices
        self.devices = arr.reshape(tuple(self.shape.values()) or (1,))
        self.size = int(self.devices.size)
        self._groups = {}
        self._torch_devices = None

    @property
    def contexts(self):
        """The positions' contexts in row-major order (in-process)."""
        return list(self.devices.flat)

    @property
    def torch_devices(self):
        """The positions' ``torch.device``s in row-major order."""
        if self._torch_devices is None:
            self._torch_devices = [c.torch_device for c in self.contexts]
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

    def __repr__(self):
        return "Mesh(%s%s)" % (dict(self.shape),
                               ", in-process" if self.in_process else "")


def is_in_process(mesh):
    """True for a mesh over a context list (positions in this process)."""
    return bool(getattr(mesh, "in_process", False))


def _world_ranks():
    from .. import distributed
    return list(range(distributed.num_workers()))


def build_mesh(axis_sizes, devices=None):
    """A mesh from ``{'dp': 4, 'tp': 2, ...}`` over ``devices``: a list of
    contexts (a mesh inside this process, repeats allowed), a list of
    ranks, or None for the process group's ranks.  Sizes must multiply
    to the device count.  Over ranks any axis but ``dp`` with a size
    above 1 raises (the model-parallel axes across processes come with
    a later item)."""
    from ..context import Context
    if devices is None:
        devices = _world_ranks()
    devices = list(devices)
    in_process = bool(devices) and all(isinstance(d, Context)
                                       for d in devices)
    names = tuple(axis_sizes.keys())
    sizes = tuple(int(s) for s in axis_sizes.values())
    n = int(np.prod(sizes))
    if n != len(devices):
        raise MXNetError(
            "mesh axes %s multiply to %d but %d devices are available"
            % (dict(axis_sizes), n, len(devices)))
    if not in_process:
        for name, size in zip(names, sizes):
            if name != AXIS_DP and size > 1:
                raise model_parallel_error(
                    "mesh axis %r (size %d) over the process group's ranks"
                    % (name, size))
    return Mesh(OrderedDict(zip(names, sizes)), devices)


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
