"""Batch slicing (port of ``mxnet_tpu/executor_manager.py:15``,
``_split_input_slice`` only; the legacy ``DataParallelExecutorManager``
comes with ``FeedForward``)."""
from __future__ import annotations

from .base import MXNetError

__all__ = ["_split_input_slice"]


def _split_input_slice(batch_size, work_load_list):
    """Split a batch into per-device slices proportional to workload
    (reference executor_manager.py:15)."""
    total = sum(work_load_list)
    if batch_size < len(work_load_list):
        raise MXNetError("batch size smaller than number of devices")
    slices = []
    start = 0
    for i, load in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            end = batch_size
        else:
            end = start + int(round(batch_size * load / float(total)))
        slices.append(slice(start, end))
        start = end
    return slices
