"""Device-side input pipelining (port of ``mxnet_tpu/dataflow.py``) and the
host-to-device copy every port input path shares.

:class:`Uploader` is that copy.  A host tensor goes to the card through
pinned memory (``torch.empty(..., pin_memory=True)``, PyTorch's caching
host allocator: a block is handed out again only after the copies that
read it have completed) and ``copy_(non_blocking=True)`` on one side
stream; the stream's event travels with the result, and the consumer's
stream waits on it (:func:`wait`), marking the tensors with
``record_stream`` so their memory outlives the consumer's use.  A tensor
already on the device passes through; on the CPU nothing is copied.

:class:`DevicePrefetchIter` stages the next batch while the current step
runs: a background thread pulls batches from any ``DataIter`` through
:func:`resilience.retrying_next` and hands them to ``stage`` (normally
``SPMDTrainer.stage_batch``), so the consumer feeds
:class:`~mxnet_tpu_torch.io.StagedBatch` objects straight into
``SPMDTrainer.step`` / ``Module.forward``, which skip the copy.  Errors
surface on the consuming thread, and ``reset()``/``close()`` stop the
worker cleanly mid-epoch.  The staging thread carries the fault points
``stage_batch`` (raises, surfaced to the consumer) and ``hang_stage``
(stalls it, as a wedged copy would: what ``fit``'s watchdog window
catches).
"""
from __future__ import annotations

import logging
import queue
import threading

import torch

from .base import MXNetError
from .io import DataBatch, DataIter, StagedBatch

__all__ = ["DevicePrefetchIter", "Uploader", "Staged", "wait"]

_LOG = logging.getLogger(__name__)

#: queue sentinel: the source raised StopIteration (epoch end)
_END = object()


class Staged(dict):
    """``{name: device tensor}`` whose copies were enqueued on a side
    stream; ``event`` (None on the CPU) marks their end."""

    event = None


class Uploader(object):
    """Host -> ``device`` copies through pinned memory on one side stream."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def host_buffer(self, shape, dtype, zero=False):
        """A host tensor to fill and then upload: pinned for a card."""
        fn = torch.zeros if zero else torch.empty
        return fn(tuple(shape), dtype=dtype, pin_memory=self.cuda)

    def upload(self, tensors, transform=None):
        """``(device tensors, event)``: each host tensor copied to the
        device on the side stream (through a pinned buffer when it is not
        pinned), then ``transform(tensor)`` (on the side stream, where
        given) applied to each one copied; tensors already on the device
        are returned as they are.  ``event`` is None when nothing was
        enqueued on the side stream."""
        if not self.cuda:
            out = [t.to(self.device) for t in tensors]
            return ([transform(t) for t in out] if transform else out), None
        out = list(tensors)
        todo = [i for i, t in enumerate(out) if not t.is_cuda]
        if not todo:
            return out, None
        with torch.cuda.stream(self.stream):
            for i in todo:
                t = out[i]
                if not t.is_pinned():
                    p = self.host_buffer(t.shape, t.dtype)
                    p.copy_(t)
                    t = p
                dev = t.to(self.device, non_blocking=True)
                out[i] = transform(dev) if transform else dev
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event


def wait(tensors, event):
    """Make the calling thread's current stream wait for ``event`` and mark
    the device tensors as used there (``record_stream``)."""
    if event is None:
        return
    cuda = [t for t in tensors if isinstance(t, torch.Tensor) and t.is_cuda]
    if not cuda:
        return
    stream = torch.cuda.current_stream(cuda[0].device)
    stream.wait_event(event)
    for t in cuda:
        t.record_stream(stream)


class _WorkerError(object):
    def __init__(self, exc):
        self.exc = exc


def _resolve_stage(stage):
    """Accept a callable, an SPMDTrainer, or a Module-like object owning a
    trainer; None means 'prefetch only, no device staging'."""
    if stage is None or callable(stage):
        return stage
    fn = getattr(stage, "stage_batch", None)
    if callable(fn):
        return fn
    for attr in ("_fused", "_trainer"):
        owner = getattr(stage, attr, None)
        fn = getattr(owner, "stage_batch", None)
        if callable(fn):
            return fn
    raise MXNetError(
        "DevicePrefetchIter: stage must be a callable, an SPMDTrainer, or "
        "a module with a fused trainer (got %r)" % (stage,))


class DevicePrefetchIter(DataIter):
    """Stage the NEXT batch onto the device while the current step runs.

    Parameters
    ----------
    data_iter : DataIter
        Source iterator (wrap a ``PrefetchingIter`` to also overlap the
        decode side).
    stage : callable | SPMDTrainer | Module, optional
        ``stage(*arrays) -> {name: device tensor}``, normally
        ``SPMDTrainer.stage_batch`` (pass the trainer or a module bound
        with ``kvstore='tpu'`` and it is resolved).  None yields
        un-staged batches (pure prefetch).
    depth : int
        Number of batches staged ahead (default 2).  ``depth=0`` stages
        synchronously on the consuming thread: same batches, no overlap.

    Batches come out identical and in order; a source error (after the
    retry ladder) is raised from ``next()`` on the consuming thread, after
    which ``reset()`` realigns and restarts the worker.
    """

    def __init__(self, data_iter, stage=None, depth=2):
        super().__init__(getattr(data_iter, "batch_size", 0))
        self._iter = data_iter
        self._stage = _resolve_stage(stage)
        self.depth = max(0, int(depth))
        self._gen = 0
        self._done = False
        self._stop = threading.Event()
        self._thread = None
        if self.depth > 0:
            self._queue = queue.Queue(maxsize=self.depth)
            self._start()
        else:
            self._queue = None
        self.current_batch = None

    # -- worker ------------------------------------------------------------
    def _start(self):
        # each worker owns its stop event: a worker that outlives its
        # join timeout exits when its blocked source call returns and
        # never races its successor for the source
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(self._gen, self._stop),
            name="DevicePrefetchIter", daemon=True)
        self._thread.start()

    def _worker(self, gen, stop):
        from .resilience import retrying_next
        while not stop.is_set():
            try:
                batch = retrying_next(self._iter, name="device_prefetch.next")
            except StopIteration:
                self._put(gen, _END, stop)
                return
            except Exception as e:  # noqa: BLE001 — surfaced to consumer
                self._put(gen, _WorkerError(e), stop)
                return
            try:
                item = self._stage_one(batch)
            except Exception as e:  # noqa: BLE001 — surfaced to consumer
                self._put(gen, _WorkerError(e), stop)
                return
            self._put(gen, item, stop)

    def _put(self, gen, item, stop):
        """Bounded put that aborts promptly on shutdown."""
        while not stop.is_set():
            try:
                self._queue.put((gen, item), timeout=0.05)
                return
            except queue.Full:
                continue

    def _stage_one(self, batch):
        from .resilience import faults
        faults.maybe_hang("hang_stage")
        faults.maybe_fail("stage_batch")
        # transport-owned buffers (slot-backed batches override release()
        # per instance) may be recycled before a queued batch is consumed:
        # snapshot on this thread and hand the slot back at once
        release = batch.__dict__.get("release")
        if release is not None:
            batch = DataBatch(
                [d.clone() if isinstance(d, torch.Tensor) else d.copy()
                 for d in batch.data],
                [l.clone() if isinstance(l, torch.Tensor) else l.copy()
                 for l in batch.label] if batch.label is not None else None,
                pad=batch.pad, index=batch.index,
                provide_data=batch.provide_data,
                provide_label=batch.provide_label)
            release()
        if self._stage is None:
            return batch
        arrays = list(batch.data) + list(batch.label or [])
        staged = self._stage(*arrays)
        return StagedBatch(staged, data=batch.data, label=batch.label,
                           pad=batch.pad, index=batch.index,
                           provide_data=batch.provide_data,
                           provide_label=batch.provide_label)

    # -- DataIter protocol -------------------------------------------------
    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        """Realign with the source: stop the worker (dropping in-flight
        staged batches), reset the source, and restart — safe mid-epoch
        and after a surfaced error."""
        self._shutdown()
        self._gen += 1
        self._done = False
        self._iter.reset()
        if self.depth > 0:
            self._queue = queue.Queue(maxsize=self.depth)
            self._start()

    def next(self):
        if self._done:
            raise StopIteration
        if self.depth == 0:
            from .resilience import retrying_next
            try:
                batch = retrying_next(self._iter,
                                      name="device_prefetch.next")
            except StopIteration:
                self._done = True
                raise
            self.current_batch = self._stage_one(batch)
            return self.current_batch
        while True:
            try:
                gen, item = self._queue.get(timeout=1.0)
            except queue.Empty:
                if self._thread is not None and not self._thread.is_alive():
                    raise MXNetError(
                        "DevicePrefetchIter: worker thread died without "
                        "reporting a result")
                continue
            if gen != self._gen:
                continue  # stale item from before a reset()
            if item is _END:
                self._done = True
                raise StopIteration
            if isinstance(item, _WorkerError):
                # the worker stopped after the error; reset() restarts it
                self._done = True
                raise item.exc
            self.current_batch = item
            return item

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

    # -- lifecycle ---------------------------------------------------------
    def _shutdown(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            # unblock a worker stuck in put(): drain the queue
            try:
                while True:
                    self._queue.get_nowait()
            except (queue.Empty, AttributeError):
                pass
            t.join(timeout=5.0)
            if t.is_alive():  # pragma: no cover — diagnostics only
                _LOG.warning("DevicePrefetchIter: worker did not stop "
                             "within 5s")

    def close(self):
        """Stop the background worker and drop queued device batches.  Safe
        to call twice; the iterator raises StopIteration afterwards until
        reset()."""
        self._shutdown()
        self._done = True
        self._queue = queue.Queue(maxsize=max(1, self.depth)) \
            if self.depth > 0 else None

    def __del__(self):
        try:
            self._stop.set()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
