"""Data descriptions and iterators (port of ``mxnet_tpu/io.py``:
``DataDesc``, ``DataBatch``, ``StagedBatch``, ``DataIter``, ``NDArrayIter``
with every ``last_batch_handle``, ``ResizeIter``, ``PrefetchingIter``,
``MNISTIter`` and ``CSVIter``).

``NDArrayIter`` (and so ``MNISTIter`` and ``CSVIter``) yields host arrays
(``cpu()`` context), as the reference's iterators do: the consumer (a
Module, a trainer) places each batch on its device.  The RecordIO image
iterators live in ``image.py`` and ``image_det.py`` (``mx.io`` names
them too); ``dataflow.DevicePrefetchIter`` stages batches on the device
ahead of the step."""
from __future__ import annotations

import logging
import struct
import threading
from collections import namedtuple

import numpy as np

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array as nd_array

__all__ = [
    "DataDesc", "DataBatch", "StagedBatch", "DataIter", "NDArrayIter",
    "ResizeIter", "PrefetchingIter", "MNISTIter", "CSVIter",
]


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

    def release(self):
        """Hand transport-owned buffers back to the producer.  A no-op for
        ordinary batches; slot-backed batches (the shared-memory data
        service) override it per instance, and consumers done with the
        arrays (or that copied them) call it to recycle the slot early.
        Must be idempotent."""


class StagedBatch(DataBatch):
    """A DataBatch whose inputs are already on the trainer's device.

    ``staged`` maps input name -> device tensor, cast exactly as
    ``SPMDTrainer.step`` would place it (see ``SPMDTrainer.stage_batch``);
    a trainer handed a StagedBatch skips the per-step host->device copy,
    which is how ``dataflow.DevicePrefetchIter`` overlaps the upload of
    batch N+1 with the execution of batch N.  The host-side
    ``data``/``label`` are kept (the source iterator's arrays, no copy) so
    host consumers (metrics, the executor-group route) still see a plain
    DataBatch."""

    def __init__(self, staged, data=None, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None):
        super().__init__(data, label=label, pad=pad, index=index,
                         provide_data=provide_data,
                         provide_label=provide_label)
        self.staged = dict(staged)
        self.event = getattr(staged, "event", None)


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

    def close(self):
        """Release background resources (threads, worker processes, pinned
        buffers).  A no-op for in-memory iterators; iterators owning a
        pipeline (``ImageRecordIter``, ``DevicePrefetchIter``) override
        it, so generic consumers can always call ``it.close()``."""


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


class ResizeIter(DataIter):
    """Resize an iterator to ``size`` batches per epoch, optionally resetting
    the inner iterator on exhaustion (reference io.py ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Background-thread double-buffering over one or more iterators (the
    reference's dmlc ThreadedIter prefetcher, src/io/iter_prefetcher.h).
    Each source is pulled through ``resilience.retrying_next``; an error
    that survives the retries is raised from ``next()`` on the consuming
    thread."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.n_iter = len(iters)
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = None
        self.next_batch = [None] * self.n_iter
        self._errors = [None] * self.n_iter

        def prefetch_func(self, i):
            # slot i is a strict handshake: data_taken[i] / data_ready[i]
            # give exactly one side the slot at any moment
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self._next_with_retry(i)
                except StopIteration:
                    self.next_batch[i] = None
                except Exception as e:  # noqa: BLE001 — surfaced to consumer
                    self._errors[i] = e
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=(self, i),
                             daemon=True)
            for i in range(self.n_iter)]
        for t in self.prefetch_threads:
            t.start()

    def __del__(self):
        self.close()

    def close(self):
        """Stop the prefetch threads (they exit at their next hand-off)."""
        self.started = False
        for e in self.data_taken:
            e.set()

    def _next_with_retry(self, i):
        from .resilience import retrying_next
        return retrying_next(self.iters[i], name="prefetch[%d].next" % i)

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r.get(d.name, d.name), d.shape, d.dtype)
                     for d in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r.get(d.name, d.name), d.shape, d.dtype)
                     for d in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        for e in self.data_ready:
            e.wait()
        self._errors = [None] * self.n_iter
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        for i, err in enumerate(self._errors):
            if err is not None:
                # the prefetch thread is parked (data_ready set, taken
                # clear): the consumer owns the slot.  Release only the
                # failed iterator's thread to refetch; healthy ones keep
                # their in-flight batches
                self._errors[i] = None
                self.data_ready[i].clear()
                self.data_taken[i].set()
                raise err
        if self.next_batch[0] is None:
            return False
        self.current_batch = DataBatch(
            sum([b.data for b in self.next_batch], []),
            sum([(b.label or []) for b in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad


def _read_idx_images(path):
    with open(path, "rb") as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise MXNetError("bad MNIST image file %s" % path)
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(num, rows,
                                                               cols)


def _read_idx_labels(path):
    with open(path, "rb") as f:
        magic, num = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise MXNetError("bad MNIST label file %s" % path)
        return np.frombuffer(f.read(), dtype=np.uint8)


class MNISTIter(NDArrayIter):
    """MNIST idx-format iterator (reference src/io/iter_mnist.cc).  Reads
    the standard ubyte files; ``flat`` selects (N,784) vs (N,1,28,28);
    ``shuffle`` permutes once with ``seed``."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 data_name="data", label_name="softmax_label", **kwargs):
        imgs = _read_idx_images(image).astype(np.float32) / 255.0
        lbls = _read_idx_labels(label).astype(np.float32)
        imgs = imgs.reshape(len(imgs), -1) if flat else \
            imgs.reshape(len(imgs), 1, imgs.shape[1], imgs.shape[2])
        if shuffle:
            perm = np.random.RandomState(seed).permutation(len(imgs))
            imgs, lbls = imgs[perm], lbls[perm]
        if not silent:
            logging.info("MNISTIter: load %d images, shuffle=%s", len(imgs),
                         bool(shuffle))
        super().__init__(imgs, lbls, batch_size=batch_size, shuffle=False,
                         data_name=data_name, label_name=label_name)


class CSVIter(NDArrayIter):
    """CSV iterator (reference src/io/iter_csv.cc)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[1:] == (1,):
                label = label[:, 0]
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle="pad" if round_batch
                         else "discard", **kwargs)
