"""Data descriptions (port of ``mxnet_tpu/io.py:29-46``, ``DataDesc``
only: what ``SPMDTrainer.bind`` takes).  The iterators come with the
input-pipeline slice."""
from __future__ import annotations

from collections import namedtuple

import numpy as np

__all__ = ["DataDesc"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """Data description with layout (reference io.py DataDesc)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types=None):
        if types is not None:
            return [DataDesc(n, s, t) for (n, s), (_, t) in zip(shapes, types)]
        return [DataDesc(n, s) for n, s in shapes]
