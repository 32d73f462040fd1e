"""Single-producer / single-consumer shared-memory batch ring (port of
``mxnet_tpu/data_service/ring.py``).

One ring per decode worker: the worker process decodes straight into a
slot's data region (no intermediate buffer, no pickling, no pipe), and the
collector in the trainer process reads the slot as a zero-copy numpy view.
Stays stdlib + numpy only: worker processes load it without importing the
package's ``__init__`` (see ``_worker_main.py``).

Layout and the seqlock publication protocol are defined in :mod:`.common`
(the producer and consumer must agree byte for byte).  Cross-process
memory ordering: both sides run CPython (one bytecode at a time, no
compiler reordering), and the consumer also validates the per-slot SEQ
word against the exact global batch index and epoch it expects, so a torn
or stale slot reads as "not ready", never as data.
"""
from __future__ import annotations

import time

import numpy as np
from multiprocessing import shared_memory as _shm

from . import common as C

__all__ = ["Ring"]

#: segments whose mmap could not be closed because a delivered zero-copy
#: view still references it — kept alive (preventing SharedMemory.__del__
#: from raising BufferError at gc) and reclaimed by the OS at process
#: exit; the NAME is unlinked immediately either way
_leaked_segments = []


def _now_ms():
    # CLOCK_MONOTONIC is one system-wide clock on Linux (and QPC on
    # Windows), so producer stamps compare cleanly against consumer
    # reads — and unlike wall time it cannot step forward under NTP and
    # make every worker look hung at once
    return int(time.monotonic() * 1000.0)


class Ring(object):
    """The shared segment + typed views.  ``create=True`` on the
    consumer side allocates; workers attach by name."""

    def __init__(self, name, slots, batch_size, data_shape, label_width,
                 itemsize, slot_bytes=None, create=False):
        self.slots = int(slots)
        self.batch_size = int(batch_size)
        self.data_shape = tuple(int(d) for d in data_shape)
        self.label_width = int(label_width)
        self.itemsize = int(itemsize)
        self.label_bytes, self.data_bytes, self.stride = C.slot_layout(
            batch_size, data_shape, label_width, itemsize, slot_bytes)
        total = C.CTRL_WORDS * 8 + self.slots * self.stride
        if create:
            self._shm = _shm.SharedMemory(name=name, create=True, size=total)
            self._shm.buf[:total] = b"\x00" * total
        else:
            self._shm = _shm.SharedMemory(name=name)
            # the creator owns the segment's lifetime.  Python's
            # per-process resource tracker registers every attach, and
            # when an attached process dies (a SIGKILLed worker) its
            # tracker "cleans up" by unlinking the live segment out from
            # under the coordinator and every respawned worker:
            # deregister the attach-side bookkeeping.
            try:
                from multiprocessing import resource_tracker
                resource_tracker.unregister(self._shm._name,
                                            "shared_memory")
            except Exception:  # noqa: BLE001 — tracker internals vary
                pass
        self.name = self._shm.name
        self._owner = bool(create)
        self.ctrl = np.frombuffer(self._shm.buf, dtype=np.int64,
                                  count=C.CTRL_WORDS)
        self._hdrs = []
        base = C.CTRL_WORDS * 8
        for s in range(self.slots):
            off = base + s * self.stride
            self._hdrs.append(np.frombuffer(
                self._shm.buf, dtype=np.int64, count=C.SLOT_HDR_WORDS,
                offset=off))
        self._label_views = [None] * self.slots
        self._data_views = [None] * self.slots

    # -- views --------------------------------------------------------------
    def _slot_off(self, s):
        return C.CTRL_WORDS * 8 + s * self.stride

    def label_view(self, s):
        cached = self._label_views[s]
        if cached is not None:
            return cached
        off = self._slot_off(s) + C.SLOT_HDR_WORDS * 8
        v = np.frombuffer(self._shm.buf, dtype=np.float32,
                          count=self.batch_size * self.label_width,
                          offset=off).reshape(self.batch_size,
                                              self.label_width)
        self._label_views[s] = v
        return v

    def data_view(self, s, dtype):
        cached = self._data_views[s]
        if cached is not None and cached.dtype == dtype:
            return cached
        off = self._slot_off(s) + C.SLOT_HDR_WORDS * 8 + self.label_bytes
        n = self.batch_size * int(np.prod(self.data_shape))
        v = np.frombuffer(self._shm.buf, dtype=dtype, count=n,
                          offset=off).reshape(
                              (self.batch_size,) + self.data_shape)
        self._data_views[s] = v
        return v

    # -- producer side ------------------------------------------------------
    def heartbeat(self):
        self.ctrl[C.CTRL_HB_MS] = _now_ms()

    def stopped(self):
        return bool(self.ctrl[C.CTRL_STOP])

    def abort_epoch(self):
        return int(self.ctrl[C.CTRL_ABORT_EPOCH])

    def acquire(self, poll_s=0.005, on_wait=None):
        """Block until a slot is free (or stop/abort is flagged, or the
        optional ``on_wait()`` callback returns True); returns the slot
        index or None.  Accumulates the wait into the producer stall
        counter and keeps the heartbeat fresh while waiting."""
        waited = False
        t0 = time.monotonic()
        while True:
            self.heartbeat()
            if self.stopped() or (on_wait is not None and on_wait()):
                slot = None
                break
            head = int(self.ctrl[C.CTRL_HEAD])
            if head - int(self.ctrl[C.CTRL_TAIL]) < self.slots:
                slot = head % self.slots
                break
            waited = True
            time.sleep(poll_s)
        if waited:
            self.ctrl[C.CTRL_STALL_MS] += int(
                (time.monotonic() - t0) * 1000.0)
        return slot

    def begin_write(self, slot, batch_idx):
        self._hdrs[slot][C.HDR_SEQ] = 2 * int(batch_idx) + 1

    def commit(self, slot, batch_idx, nvalid, epoch):
        h = self._hdrs[slot]
        h[C.HDR_BATCH_IDX] = int(batch_idx)
        h[C.HDR_NVALID] = int(nvalid)
        h[C.HDR_EPOCH] = int(epoch)
        h[C.HDR_SEQ] = 2 * int(batch_idx) + 2   # even: published
        self.ctrl[C.CTRL_HEAD] += 1
        self.ctrl[C.CTRL_BATCHES] += 1
        self.heartbeat()

    def announce_decoder(self, decoder):
        """Stamp the producer's decoder (an index into
        ``common.DECODERS``) into every slot header, before any batch."""
        for h in self._hdrs:
            h[C.HDR_DECODER] = int(decoder)

    def decoder(self):
        """The decoder the producer announced (0: not yet)."""
        return int(self._hdrs[0][C.HDR_DECODER])

    def ack_epoch(self, epoch):
        self.ctrl[C.CTRL_ACK_EPOCH] = int(epoch)
        self.heartbeat()

    # -- consumer side ------------------------------------------------------
    def ready(self, batch_idx, epoch=None):
        """True when the next unreleased slot holds ``batch_idx`` (of
        ``epoch``, when given — batch indices repeat across epochs, so
        the epoch check is what keeps a stale-epoch slot from a
        straggler producer invisible), fully published."""
        head = int(self.ctrl[C.CTRL_HEAD])
        tail = int(self.ctrl[C.CTRL_TAIL])
        if head <= tail:
            return False
        h = self._hdrs[tail % self.slots]
        if int(h[C.HDR_SEQ]) != 2 * int(batch_idx) + 2:
            return False
        return epoch is None or int(h[C.HDR_EPOCH]) == int(epoch)

    def published_mismatch(self, batch_idx, epoch):
        """True when the next unreleased slot is fully PUBLISHED (even
        SEQ) but holds the wrong batch/epoch — production is
        deterministic, so a healthy producer can never do this; it
        means a stale/straggler process wrote into the ring and the
        worker must be respawned rather than waited on."""
        if int(self.ctrl[C.CTRL_HEAD]) <= int(self.ctrl[C.CTRL_TAIL]):
            return False
        h = self._hdrs[int(self.ctrl[C.CTRL_TAIL]) % self.slots]
        seq = int(h[C.HDR_SEQ])
        if seq == 0 or seq % 2:   # empty or mid-write: keep waiting
            return False
        return (seq != 2 * int(batch_idx) + 2
                or int(h[C.HDR_EPOCH]) != int(epoch))

    def peek(self, dtype):
        """Views of the next unreleased slot: ``(hdr, label, data)``.
        Only valid after :meth:`ready` returned True."""
        s = int(self.ctrl[C.CTRL_TAIL]) % self.slots
        return self._hdrs[s], self.label_view(s), self.data_view(s, dtype)

    def release(self):
        self.ctrl[C.CTRL_TAIL] += 1

    def occupancy(self):
        return int(self.ctrl[C.CTRL_HEAD]) - int(self.ctrl[C.CTRL_TAIL])

    def heartbeat_age_s(self):
        hb = int(self.ctrl[C.CTRL_HB_MS])
        if hb == 0:
            return 0.0
        return max(0.0, (_now_ms() - hb) / 1000.0)

    def producer_stall_s(self):
        return int(self.ctrl[C.CTRL_STALL_MS]) / 1000.0

    def batches_produced(self):
        return int(self.ctrl[C.CTRL_BATCHES])

    def acked_epoch(self):
        return int(self.ctrl[C.CTRL_ACK_EPOCH])

    def request_abort(self, epoch):
        self.ctrl[C.CTRL_ABORT_EPOCH] = int(epoch)

    def request_stop(self):
        self.ctrl[C.CTRL_STOP] = 1

    def reset_counters(self):
        """Consumer-side reset before a (re)spawned producer reuses the
        segment: positions zeroed, stop/abort cleared, stats kept."""
        self.ctrl[C.CTRL_HEAD] = 0
        self.ctrl[C.CTRL_TAIL] = 0
        self.ctrl[C.CTRL_ABORT_EPOCH] = 0
        self.ctrl[C.CTRL_STOP] = 0
        self.ctrl[C.CTRL_HB_MS] = 0
        for h in self._hdrs:
            h[C.HDR_SEQ] = 0

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        # drop our own views first, then close the mmap; a consumer still
        # holding a delivered zero-copy view makes close() raise
        # BufferError — park the segment in _leaked_segments (freed at
        # process exit) instead of letting gc retry and warn forever
        self.ctrl = None
        self._hdrs = None
        self._label_views = None
        self._data_views = None
        try:
            self._shm.close()
        except BufferError:
            # a consumer still holds a delivered view: the OS frees the
            # mapping at process exit; neuter close() so gc at
            # interpreter shutdown cannot raise through __del__
            self._shm.close = lambda: None
            _leaked_segments.append(self._shm)
        except OSError:
            pass
        if self._owner:
            try:
                self._shm.unlink()
            except OSError:
                pass

    def __del__(self):
        try:
            if self.ctrl is not None:
                self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
