"""The trainer-process side of the data service (port of
``mxnet_tpu/data_service/service.py``).

``DataService`` owns N decode worker processes (``_worker_main.py``, each
with its own recordio handle, its own decoder and its own shared-memory
ring: no shared GIL, no shared pipe lock) and a collector that delivers
batches in global order: batch ``i`` comes from worker ``i % N``'s ring as
a zero-copy numpy view.  The delivered stream is a pure function of (seed,
epoch): the same records, the same augmentation, the same bytes for any
worker count (``common.epoch_order`` / ``common.worker_batches``).

Robustness:

- workers heartbeat through their ring control words; a dead worker
  (crash, SIGKILL) is seen by ``Popen.poll`` at once, a hung one
  (SIGSTOP, a wedged decode) by heartbeat age (``MXTPU_DATA_HEARTBEAT_S``);
- either way the worker is respawned and its shard resumes at the last
  consumed record (production is deterministic, so re-decoded batches
  are bit-identical: no duplicated or dropped records), with the
  ``data_worker``/``hang_data_worker`` fault points stripped from the
  child's ``MXTPU_FAULTS`` as the JAX package strips them;
- a worker that keeps dying (``MAX_RESPAWNS`` consecutive respawns with
  no batch delivered in between) surfaces as an ``MXNetError`` carrying
  its stderr tail.

:meth:`DataService.stats` reports ring occupancy, producer and consumer
stall, batches, respawns and the decoder (``"native"`` or ``"python"``) of
each worker.

Slot lifetime: the data view a delivered batch holds aliases the ring
slot; the slot is recycled when the batch's ``release()`` is called, or
when the next batch is pulled.  Zero-copy views are for strictly serial
consumers; anything that runs ahead must snapshot first
(``dataflow.DevicePrefetchIter`` does, and ``DataServiceIter``'s default
``copy=True`` hands out private arrays).

This module stays torch-free (stdlib + numpy + the package's torch-free
leaves): the server entry point (``server_main.py``) runs a DataService
under the stub package, where a torch import would load torch into every
decode host.  The ``DataIter`` facade lives in :mod:`.iter`.
"""
from __future__ import annotations

import atexit
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
import weakref

import numpy as np

from ..base import MXNetError, get_env
from ..resilience import strip_faults_env
from . import ENV_DATA_HEARTBEAT, ENV_DATA_RING_SLOTS, ENV_DATA_SLOT_BYTES
from . import common as C
from .ring import Ring

__all__ = ["DataService"]

_LOG = logging.getLogger(__name__)

_WORKER_MAIN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "_worker_main.py")

#: CONSECUTIVE respawns (no batch delivered in between) per worker
#: before the service gives up — a worker that dies on every attempt is
#: a bug or a broken dataset, not a flaky host.  The streak resets the
#: moment a respawned worker delivers a consumed batch, so transient
#: deaths spread over a long run never accumulate into an abort
#: (wk.respawns stays a lifetime counter for stats())
MAX_RESPAWNS = 5

#: fault points stripped from a respawned worker's environment (an
#: injected fault must not fire again on every respawn)
_WORKER_FAULT_POINTS = ("data_worker", "hang_data_worker")

_live_services = None


def _register_service(svc):
    global _live_services
    if _live_services is None:
        _live_services = weakref.WeakSet()

        def _stop_all():
            for s in list(_live_services):
                s.close()
        atexit.register(_stop_all)
    _live_services.add(svc)


_DTYPE_CODES = C.DTYPE_CODES


class _Worker(object):
    def __init__(self, rank):
        self.rank = rank
        self.proc = None
        self.ring = None
        self.consumed = 0      # shard batches consumed this epoch
        self.respawns = 0        # lifetime (stats)
        self.respawn_streak = 0  # consecutive, reset on delivery (budget)
        self.stderr_path = None
        self.consumer_stall_s = 0.0
        self.occupancy_sum = 0
        self.occupancy_n = 0

    def stderr_tail(self, nbytes=2000):
        if self.stderr_path is None:
            return ""
        try:
            with open(self.stderr_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - nbytes))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return ""


class DataService(object):
    """See the module docstring.  ``aug`` takes the native pipeline's
    knob subset (resize, rand_crop, rand_mirror, mean, std)."""

    def __init__(self, path_imgrec, path_imgidx, data_shape, batch_size,
                 label_width=1, shuffle=False, seed=0, part_index=0,
                 num_parts=1, num_workers=None, dtype="float32",
                 layout="NCHW", aug=None, slots=None, slot_bytes=None,
                 heartbeat_s=None, fast_dct=True, stream_offset=0,
                 stream_stride=1, start_epoch=1, start_batch=0):
        from .. import recordio
        if dtype not in _DTYPE_CODES:
            raise MXNetError("data_service: unsupported dtype %r" % (dtype,))
        if layout not in ("NCHW", "NHWC"):
            raise MXNetError("layout must be NCHW or NHWC")
        self._rec = os.path.abspath(path_imgrec)
        self._idx = os.path.abspath(path_imgidx)
        self._shape = tuple(int(d) for d in data_shape)   # canonical (c,h,w)
        if len(self._shape) != 3 or self._shape[0] != 3:
            raise MXNetError("data_shape must be (3, height, width), got %s"
                             % (self._shape,))
        c, h, w = self._shape
        self._ring_shape = (c, h, w) if layout == "NCHW" else (h, w, c)
        self._bs = int(batch_size)
        self._lw = int(label_width)
        self._dtype = dtype
        self._np_dtype = C.np_dtype(dtype)
        self._layout = layout
        self._seed = int(seed)
        self._shuffle = bool(shuffle)
        self._aug = dict(aug or {})
        self._fast_dct = bool(fast_dct)
        self.num_workers = max(1, int(num_workers or 1))
        self._slots = max(2, int(slots if slots is not None
                                 else get_env(ENV_DATA_RING_SLOTS, 4)))
        self._slot_bytes = int(slot_bytes if slot_bytes is not None
                               else get_env(ENV_DATA_SLOT_BYTES, 0))
        self._hb_timeout = float(heartbeat_s if heartbeat_s is not None
                                 else get_env(ENV_DATA_HEARTBEAT, 30.0))
        keys = [k for k, _ in recordio.read_index(self._idx)]
        if not keys:
            raise MXNetError("data_service: empty index %s" % self._idx)
        self._part_index = int(part_index)
        self._num_parts = int(num_parts)
        # the outer stream shard (the network tier): this service owns
        # global batches g = offset + j*stride only — offset 0 stride 1
        # (the local default) is the whole epoch
        self._stream_offset = int(stream_offset)
        self._stream_stride = max(1, int(stream_stride))
        if not (0 <= self._stream_offset < self._stream_stride):
            raise MXNetError(
                "data_service: stream_offset %d out of range for "
                "stream_stride %d" % (stream_offset, stream_stride))
        self._order = C.EpochOrder(keys, self._seed, self._shuffle,
                                   self._part_index, self._num_parts)
        self.epoch = max(1, int(start_epoch))
        self._order.seek(self.epoch)
        self._nbatches = C.num_batches(len(self._order.order), self._bs)
        self._stream_batches = C.stream_batches(
            self._nbatches, self._stream_offset, self._stream_stride)
        self._next_j = min(max(0, int(start_batch)), self._stream_batches)
        self.last_aug_seed = None             # chunk seed of the last batch
        self.last_batch_idx = None            # its global batch index
        self._pending = None                  # worker with an unreleased slot
        self._closed = False
        self._uid = "%d-%x" % (os.getpid(), id(self) & 0xffffff)
        self._workers = [_Worker(r) for r in range(self.num_workers)]
        try:
            for wk in self._workers:
                wk.ring = Ring("mxds-%s-r%d" % (self._uid, wk.rank),
                               self._slots, self._bs, self._ring_shape,
                               self._lw, self._np_dtype.itemsize,
                               slot_bytes=self._slot_bytes, create=True)
                wk.consumed = self._worker_consumed(wk.rank, self._next_j)
                self._spawn(wk)
                self._command(wk, self.epoch, wk.consumed)
        except BaseException:
            self.close()
            raise
        _register_service(self)

    def _worker_consumed(self, rank, next_j):
        """How many of its shard batches worker ``rank`` has already had
        consumed when the service's local batch cursor is ``next_j``
        (batch j belongs to worker j % N)."""
        return len(range(int(rank), int(next_j), self.num_workers))

    # -- workers ------------------------------------------------------------
    def _config(self, rank):
        return {
            "rec": self._rec, "idx": self._idx,
            "shm_name": self._workers[rank].ring.name,
            "slots": self._slots, "batch_size": self._bs,
            "data_shape": list(self._shape),
            "ring_shape": list(self._ring_shape),
            "label_width": self._lw, "dtype": self._dtype,
            "dtype_code": _DTYPE_CODES[self._dtype],
            "layout": self._layout, "aug": C.jsonable_aug(self._aug),
            "fast_dct": self._fast_dct, "seed": self._seed,
            "shuffle": self._shuffle,
            "part_index": self._part_index,
            "num_parts": self._num_parts,
            "rank": rank, "num_workers": self.num_workers,
            "stream_offset": self._stream_offset,
            "stream_stride": self._stream_stride,
            "slot_bytes": self._slot_bytes,
            "coordinator_pid": os.getpid(),
        }

    def _spawn(self, wk, strip_faults=False):
        if wk.stderr_path is None:
            fd, wk.stderr_path = tempfile.mkstemp(
                prefix="mxds-w%d-" % wk.rank, suffix=".err")
            os.close(fd)
        env = dict(os.environ)
        if strip_faults:
            stripped = strip_faults_env(env.get("MXTPU_FAULTS"),
                                        _WORKER_FAULT_POINTS)
            if stripped:
                env["MXTPU_FAULTS"] = stripped
            else:
                env.pop("MXTPU_FAULTS", None)
        # the CONSUMER stamps the first heartbeat: a worker that wedges
        # during bootstrap (before its own first stamp) must still age
        # out against MXTPU_DATA_HEARTBEAT_S — with hb=0 meaning "no
        # age" it would never be declared hung
        wk.ring.heartbeat()
        if wk.proc is not None:
            # the replaced worker's command pipe: each respawn would leak
            # its file descriptor
            try:
                wk.proc.stdin.close()
            except OSError:
                pass
        stderr_f = open(wk.stderr_path, "ab")
        try:
            wk.proc = subprocess.Popen(
                [sys.executable, _WORKER_MAIN, json.dumps(self._config(
                    wk.rank))],
                stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                stderr=stderr_f, env=env)
        finally:
            stderr_f.close()

    def _command(self, wk, epoch, skip):
        try:
            wk.proc.stdin.write(("E %d %d\n" % (epoch, skip)).encode())
            wk.proc.stdin.flush()
        except (BrokenPipeError, OSError) as e:
            raise MXNetError(
                "data_service: worker %d rejected a command (%s); stderr: %s"
                % (wk.rank, e, wk.stderr_tail())) from e

    def _respawn(self, wk, reason):
        wk.respawns += 1
        wk.respawn_streak += 1
        tail = wk.stderr_tail()
        if wk.respawn_streak > MAX_RESPAWNS:
            raise MXNetError(
                "data_service: worker %d exceeded its respawn budget "
                "(%d consecutive) — last failure: %s; stderr: %s"
                % (wk.rank, MAX_RESPAWNS, reason, tail))
        _LOG.warning(
            "data_service: worker %d %s (respawn %d/%d, resuming shard at "
            "batch %d)%s", wk.rank, reason, wk.respawn_streak, MAX_RESPAWNS,
            wk.consumed,
            ("; stderr tail: %s" % tail.strip()[-300:]) if tail.strip()
            else "")
        if wk.proc is not None and wk.proc.poll() is None:
            wk.proc.kill()
            try:
                wk.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        wk.ring.reset_counters()
        self._spawn(wk, strip_faults=True)
        self._command(wk, self.epoch, wk.consumed)

    # -- collector ----------------------------------------------------------
    def next_batch(self, timeout=None):
        """``(data_view, labels, pad, release)`` for the next batch of
        this service's stream, in order; raises StopIteration at epoch
        end.  ``labels`` is a fresh (tiny) copy; ``data_view`` aliases
        the ring slot — see the module docstring for the lifetime
        contract.  With ``timeout`` (seconds), returns ``None`` when no
        batch became ready in time — the network server uses this to
        keep heartbeats flowing while a legitimately slow worker
        decodes (None consumes nothing; call again)."""
        if self._closed:
            raise MXNetError("data_service: closed")
        self._release_pending()
        if self._next_j >= self._stream_batches:
            raise StopIteration
        j = self._next_j
        g = self._stream_offset + j * self._stream_stride
        wk = self._workers[j % self.num_workers]
        deadline_poll = 0.0
        t0 = time.monotonic()
        give_up = None if timeout is None else t0 + float(timeout)
        waited = False
        while not wk.ring.ready(g, self.epoch):
            waited = True
            now = time.monotonic()
            if give_up is not None and now >= give_up:
                wk.consumer_stall_s += now - t0
                return None
            if now >= deadline_poll:
                deadline_poll = now + 0.2
                if wk.proc.poll() is not None:
                    self._respawn(wk, "died (rc=%s)" % wk.proc.returncode)
                elif wk.ring.published_mismatch(g, self.epoch):
                    # a published slot with the wrong batch/epoch can
                    # only come from a straggler that missed an abort
                    # (e.g. thawed after the reset handshake timed out)
                    self._respawn(wk, "produced a stale slot")
                elif wk.ring.heartbeat_age_s() > self._hb_timeout:
                    self._respawn(
                        wk, "hung (no heartbeat for %.1fs)"
                        % wk.ring.heartbeat_age_s())
            time.sleep(0.0005)
        if waited:
            wk.consumer_stall_s += time.monotonic() - t0
        wk.occupancy_sum += wk.ring.occupancy()
        wk.occupancy_n += 1
        hdr, labv, datav = wk.ring.peek(self._np_dtype)
        nvalid = int(hdr[C.HDR_NVALID])
        labels = np.array(labv[:, 0] if self._lw == 1 else labv)
        self._next_j += 1
        wk.consumed += 1
        wk.respawn_streak = 0   # delivered: not a crash loop
        # on-device augmentation (kernels/augment.py) draws each image's
        # crop and mirror from this: the per-(seed, global batch, epoch)
        # value the host decoders mix, so device-augmented output is a
        # pure function of (seed, epoch, batch) whichever process decoded
        # the bytes
        self.last_aug_seed = C.chunk_seed(self._seed, g, epoch=self.epoch)
        self.last_batch_idx = g
        released = [False]

        def release(_wk=wk, _released=released):
            if not _released[0]:
                _released[0] = True
                _wk.ring.release()
        self._pending = release
        return datav, labels, self._bs - nvalid, release

    def _release_pending(self):
        if self._pending is not None:
            self._pending()
            self._pending = None

    def at_epoch_end(self):
        return self._next_j >= self._stream_batches

    def reset(self):
        """Advance to the next epoch (abandoning the current one if it
        was not fully consumed), like ``DataIter.reset``."""
        self.seek(self.epoch + 1, 0)

    def seek(self, epoch, consumed=0):
        """Land the service at ``epoch`` (1-based) with the first
        ``consumed`` stream batches already delivered — the network
        tier's reconnect resume (a fresh connection re-requests the
        tail of a partially consumed epoch; deterministic production
        makes the re-decoded stream bit-identical).  ``reset()`` is
        ``seek(epoch + 1, 0)``."""
        if self._closed:
            raise MXNetError("data_service: closed")
        epoch = max(1, int(epoch))
        self._release_pending()
        mid_epoch = self._next_j < self._stream_batches
        for wk in self._workers:
            if mid_epoch:
                wk.ring.request_abort(self.epoch)
            # wait for the producer to leave the epoch loop before the
            # ring counters are reset under it
            deadline = time.monotonic() + max(5.0, self._hb_timeout)
            while (wk.proc.poll() is None
                    and wk.ring.acked_epoch() < self.epoch):
                if time.monotonic() > deadline:
                    # unresponsive to the abort (frozen/SIGSTOPped): it
                    # must NOT thaw later and write the old epoch into
                    # the reset ring — kill it and respawn below
                    wk.proc.kill()
                    try:
                        wk.proc.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        pass
                    break
                time.sleep(0.001)
            wk.ring.reset_counters()
            if wk.proc.poll() is not None:
                # dead between epochs (or killed above): bring it back
                wk.respawns += 1
                wk.respawn_streak += 1
                if wk.respawn_streak > MAX_RESPAWNS:
                    raise MXNetError(
                        "data_service: worker %d exceeded its respawn "
                        "budget (%d consecutive); stderr: %s"
                        % (wk.rank, MAX_RESPAWNS, wk.stderr_tail()))
                self._spawn(wk, strip_faults=True)
            else:
                # alive and idle until the next epoch command: stamp
                # the heartbeat so a worker that wedges between epochs
                # still ages out (reset_counters zeroed the stamp)
                wk.ring.heartbeat()
        self.epoch = epoch
        self._order.seek(epoch)
        self._next_j = min(max(0, int(consumed)), self._stream_batches)
        for wk in self._workers:
            wk.consumed = self._worker_consumed(wk.rank, self._next_j)
            self._command(wk, self.epoch, wk.consumed)

    # -- observability ------------------------------------------------------
    def stats(self):
        """Per-stage counters since construction.  After close() the
        final pre-teardown snapshot is returned (monitoring hooks poll
        stats at shutdown)."""
        if self._closed:
            return self._final_stats
        per = {}
        prod_stall = cons_stall = occ_sum = occ_n = batches = 0.0
        for wk in self._workers:
            ring = wk.ring
            per[wk.rank] = {
                "batches": ring.batches_produced(),
                "respawns": wk.respawns,
                "producer_stall_s": round(ring.producer_stall_s(), 3),
                "consumer_stall_s": round(wk.consumer_stall_s, 3),
                "ring_occupancy": round(
                    wk.occupancy_sum / max(1, wk.occupancy_n), 2),
                "alive": wk.proc is not None and wk.proc.poll() is None,
                "decoder": C.DECODERS[ring.decoder()]
                if 0 <= ring.decoder() < len(C.DECODERS) else "unknown",
            }
            prod_stall += ring.producer_stall_s()
            cons_stall += wk.consumer_stall_s
            occ_sum += wk.occupancy_sum
            occ_n += wk.occupancy_n
            batches += ring.batches_produced()
        return {
            "num_workers": self.num_workers,
            "epoch": self.epoch,
            "batches_produced": int(batches),
            "producer_stall_s": round(prod_stall, 3),
            "consumer_stall_s": round(cons_stall, 3),
            "ring_occupancy": round(occ_sum / max(1, occ_n), 2),
            "ring_slots": self._slots,
            "decoders": sorted({w["decoder"] for w in per.values()}),
            "workers": per,
        }

    def worker_pids(self):
        """Live worker pids (chaos drills kill these)."""
        return [wk.proc.pid for wk in self._workers
                if wk.proc is not None and wk.proc.poll() is None]

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        if self._closed:
            return
        try:
            self._final_stats = self.stats()
        except Exception:  # noqa: BLE001 — mid-construction close
            self._final_stats = None
        self._closed = True
        self._pending = None
        for wk in getattr(self, "_workers", []):
            if wk.ring is not None:
                try:
                    wk.ring.request_stop()
                except TypeError:  # ring already torn down
                    pass
            if wk.proc is not None:
                try:
                    wk.proc.stdin.write(b"Q\n")
                    wk.proc.stdin.flush()
                except (BrokenPipeError, OSError, ValueError):
                    pass
                try:
                    wk.proc.stdin.close()
                except (OSError, ValueError):
                    pass
        for wk in getattr(self, "_workers", []):
            if wk.proc is not None:
                try:
                    wk.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    wk.proc.kill()
                    try:
                        wk.proc.wait(timeout=5)
                    except subprocess.TimeoutExpired:
                        pass
            if wk.ring is not None:
                wk.ring.close()
                wk.ring = None
            if wk.stderr_path is not None:
                try:
                    os.remove(wk.stderr_path)
                except OSError:
                    pass

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
