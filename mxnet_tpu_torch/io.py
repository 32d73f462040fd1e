"""Data descriptions and in-memory iterators (port of
``mxnet_tpu/io.py:29-233``: ``DataDesc``, ``DataBatch``, ``DataIter``,
``_init_data`` and ``NDArrayIter`` with every ``last_batch_handle``).

``NDArrayIter`` yields host arrays (``cpu()`` context), as the reference's
iterators do: the consumer (a Module, a trainer) places each batch on its
device.  ``StagedBatch``, ``PrefetchingIter``, ``ResizeIter``, the RecordIO
and CSV iterators come with the input-pipeline slice."""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array as nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


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


class DataBatch(object):
    """One mini-batch (reference io.py DataBatch)."""

    def __init__(self, data, label=None, pad=0, index=None, bucket_key=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter(object):
    """Iterator protocol: reset/next/iter + provide_data/provide_label."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        # dynamic dispatch, not `__next__ = next`: subclasses override
        # next() and the for-loop protocol must reach the override
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _init_data(data, allow_empty, default_name):
    """Normalize data into a list of (name, numpy array) — reference
    io.py _init_data."""
    if data is None:
        if not allow_empty:
            raise ValueError("data must not be None")
        return []
    if isinstance(data, (NDArray, np.ndarray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise ValueError("empty data list")
        data = {(default_name if len(data) == 1
                 else "_%d_%s" % (i, default_name)): d
                for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("invalid data type %s" % type(data))
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, np.asarray(v)))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference io.py NDArrayIter):
    shuffle, last_batch_handle in {'pad', 'discard', 'roll_over'}.
    Batches are float32 host NDArrays, as ``mx.nd.array`` makes them."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        if shuffle:
            idx = np.random.permutation(self.num_data)
            self.data = [(k, v[idx]) for k, v in self.data]
            self.label = [(k, v[idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            new_n = self.num_data - self.num_data % batch_size
            self.data = [(k, v[:new_n]) for k, v in self.data]
            self.label = [(k, v[:new_n]) for k, v in self.label]
            self.num_data = new_n
        if self.num_data < batch_size:
            raise MXNetError("batch_size %d > data size %d"
                             % (batch_size, self.num_data))
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, source):
        host = cpu()
        if self.cursor + self.batch_size <= self.num_data:
            return [nd_array(v[self.cursor:self.cursor + self.batch_size],
                             ctx=host) for _, v in source]
        # pad with wrapped-around samples
        pad = self.batch_size - (self.num_data - self.cursor)
        return [nd_array(np.concatenate([v[self.cursor:], v[:pad]], axis=0),
                         ctx=host) for _, v in source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0
