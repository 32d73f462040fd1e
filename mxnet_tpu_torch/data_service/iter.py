"""``DataIter`` facade over a data service, local or network tier (port of
``mxnet_tpu/data_service/iter.py``).

Split out of :mod:`.service` so the coordinator stays torch-free (the
server entry point runs it under the stub package); this module pulls in
:mod:`..io`, which imports torch.

The facade works over anything with the collector surface
(``next_batch``/``reset``/``seek``/``stats``/``close`` and the
``_bs``/``_lw``/``_dtype``/``_ring_shape`` layout attributes):
:class:`.service.DataService` (shared-memory rings on this host) and
:class:`.net.NetDataService` (TCP frames from a server fleet).
"""
from __future__ import annotations

import numpy as np
import torch

from ..io import DataBatch, DataDesc, DataIter

__all__ = ["DataServiceIter"]


def host_tensor(view, dtype):
    """A numpy view of a slot or receive buffer as a torch tensor over the
    same bytes; bfloat16 slots hold ``uint16`` bits."""
    t = torch.from_numpy(view)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class DataServiceIter(DataIter):
    """`DataIter` over :class:`.service.DataService` (or
    :class:`.net.NetDataService`): host batches as torch tensors.

    ``copy=True`` (the default) hands each consumer a private tensor.
    ``copy=False`` hands a tensor over the transport-owned buffer itself
    (a shared-memory ring slot locally, a receive buffer on the network
    tier): fastest, but only for strictly serial consumers, since it is
    valid until ``batch.release()`` or the next pull, and anything that
    uploads it must finish reading it first.  ``ImageRecordIter``'s
    service routes use ``copy=False``; wrapping either flavor in
    ``dataflow.DevicePrefetchIter`` is safe, since the prefetcher
    snapshots slot-backed batches on its thread and releases the slot
    before running ahead."""

    def __init__(self, service=None, data_name="data",
                 label_name="softmax_label", copy=True, **kwargs):
        if service is None:
            from .service import DataService
            service = DataService(**kwargs)
        self._service = service
        super().__init__(self._service._bs)
        self._copy = bool(copy)
        self.data_name = data_name
        self.label_name = label_name
        self.current_batch = None

    @property
    def provide_data(self):
        svc = self._service
        dt = np.dtype("float32" if svc._dtype == "bfloat16" else svc._dtype)
        return [DataDesc(self.data_name, (svc._bs,) + svc._ring_shape,
                         dtype=dt)]

    @property
    def provide_label(self):
        svc = self._service
        shape = (svc._bs, svc._lw) if svc._lw > 1 else (svc._bs,)
        return [DataDesc(self.label_name, shape)]

    def next(self):
        data, labels, pad, release = self._service.next_batch()
        data = host_tensor(data, self._service._dtype)
        batch = DataBatch([data], [torch.from_numpy(labels)], pad=pad,
                          provide_data=self.provide_data,
                          provide_label=self.provide_label)
        # on-device augmentation reads these: the batch's chunk seed (the
        # same for any worker or server count)
        batch.aug_seed = self._service.last_aug_seed
        if self._copy:
            # private now: copy, recycle the slot, and attach no
            # instance-level release (its presence is the "transport-owned
            # buffer" signal DevicePrefetchIter snapshots on)
            batch.data = [data.clone()]
            release()
        else:
            batch.release = release
        self.current_batch = batch
        return batch

    def iter_next(self):
        try:
            self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad

    def reset(self):
        self._service.reset()

    def stats(self):
        return self._service.stats()

    def close(self):
        self.current_batch = None   # drop the last zero-copy view
        self._service.close()
