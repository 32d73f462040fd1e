"""Meshes over the process group (port of ``mxnet_tpu/parallel/mesh.py``).

A mesh in the port is the ``torch.distributed`` process group with named
axes: one rank a device, ranks laid out in row-major order over the axis
sizes (later axes innermost, as in the JAX package).  The data axis
``dp`` is the one this slice runs; the model-parallel axes (``tp``,
``sp``, ``pp``, ``ep``) and meshes inside one process over a context list
raise, naming the item of ROADMAP.md that brings them.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..base import MXNetError

__all__ = ["Mesh", "build_mesh", "default_mesh", "local_mesh", "AXIS_DP",
           "AXIS_TP", "AXIS_SP", "AXIS_PP", "AXIS_EP", "NEXT_ITEM"]

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_PP = "pp"
AXIS_EP = "ep"

#: where the model-parallel half of the multi-GPU work is queued
NEXT_ITEM = ("the model-parallel axes of mxnet_tpu_torch (ROADMAP.md "
             "queue 1, item 4: tp/sp/pp/ep and in-process meshes)")


def model_parallel_error(what):
    return MXNetError("%s is not ported yet: it comes with %s"
                      % (what, NEXT_ITEM))


class Mesh(object):
    """Named axes over the ranks of the process group.

    ``shape`` maps axis name -> size (insertion order), ``axis_names``
    is the name tuple, ``devices`` the rank array shaped by the axis
    sizes (``devices.flat`` walks the ranks), ``size`` the rank count."""

    def __init__(self, axis_sizes, ranks):
        self.shape = OrderedDict((str(k), int(v))
                                 for k, v in axis_sizes.items())
        self.axis_names = tuple(self.shape)
        self.devices = np.asarray(ranks).reshape(
            tuple(self.shape.values()) or (1,))
        self.size = int(self.devices.size)

    def __repr__(self):
        return "Mesh(%s)" % dict(self.shape)


def _world_ranks():
    from .. import distributed
    return list(range(distributed.num_workers()))


def build_mesh(axis_sizes, devices=None):
    """A mesh from ``{'dp': 4, ...}`` over the process group's ranks (or
    over ``devices``, a list of ranks).  Sizes must multiply to the rank
    count; any axis but ``dp`` with a size above 1 raises (the
    model-parallel axes come with the next item), and so does a list of
    several contexts in one process."""
    from ..context import Context
    if devices is None:
        devices = _world_ranks()
    devices = list(devices)
    if len(devices) > 1 and all(isinstance(d, Context) for d in devices):
        raise model_parallel_error(
            "a mesh inside one process over the contexts %s" % devices)
    names = tuple(axis_sizes.keys())
    sizes = tuple(int(s) for s in axis_sizes.values())
    n = int(np.prod(sizes))
    if n != len(devices):
        raise MXNetError(
            "mesh axes %s multiply to %d but %d devices are available"
            % (dict(axis_sizes), n, len(devices)))
    for name, size in zip(names, sizes):
        if name != AXIS_DP and size > 1:
            raise model_parallel_error("mesh axis %r (size %d)"
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
    """1-D mesh over every rank (the kvstore='tpu' default)."""
    if devices is None:
        devices = _world_ranks()
    return build_mesh({axis_name: len(devices)}, devices)
