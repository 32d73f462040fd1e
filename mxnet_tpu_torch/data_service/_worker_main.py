"""Decode-worker entry point: ``python _worker_main.py '<config json>'``
(port of ``mxnet_tpu/data_service/_worker_main.py``).

One OS process per worker, launched by ``service.DataService`` with a plain
``subprocess.Popen`` (not multiprocessing: no pickling, no ``__main__``
re-import, and a pid that can be SIGKILLed like a real crash).  The worker
never executes ``mxnet_tpu_torch/__init__.py``: that file imports torch,
which would cost each of N workers seconds and hundreds of MB, and any
CUDA touch in a child would compete with the trainer for the card.
Instead it installs a stub ``mxnet_tpu_torch`` package whose ``__path__``
points at the real package directory, then imports only the torch-free
leaves: ``base`` (env registry), ``native`` (ctypes loader), ``recordio``,
``resilience`` (the fault points) and ``data_service.{common,ring}``.

Per epoch the worker derives its shard from (seed, epoch, rank,
num_workers) with the coordinator's own arithmetic
(``common.worker_batches``), reads its records through its own
``MXIndexedRecordIO`` handle and decodes each batch straight into a
shared-memory ring slot.  The decoder is the native libjpeg pipe
(``MXTImgPipe*``, one GIL-released call a batch) where the native library
has it, else the cv2/PIL decoder below; the worker stamps which one into
its slot headers at start (``common.HDR_DECODER``), and
``DataService.stats()`` reports it.
Augmentation is seeded per global batch index, so the output bytes are a
pure function of (seed, epoch, batch), independent of worker count,
respawns and scheduling.

Protocol: commands on stdin (``E <epoch> <skip>`` = produce the epoch,
skipping the first <skip> already-consumed shard batches; ``Q`` = quit);
flow control, abort, stop and heartbeats through the ring's control
words; errors on stderr and a nonzero exit code (the coordinator respawns
the worker and resumes its shard).  Fault points (``MXTPU_FAULTS``):
``hang_data_worker`` stalls the worker before a batch (its heartbeat goes
stale and the coordinator kills and respawns it), ``data_worker`` raises
(the worker exits nonzero and is respawned); the coordinator strips both
from a respawned worker's environment.
"""
from __future__ import annotations

import importlib.machinery
import json
import os
import sys
import types

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG_DIR = os.path.dirname(_HERE)


def bootstrap():
    """Install the package-path stub (unless the real package is already
    imported) and return the torch-free leaves."""
    if "mxnet_tpu_torch" not in sys.modules:
        pkg = types.ModuleType("mxnet_tpu_torch")
        pkg.__path__ = [_PKG_DIR]
        pkg.__spec__ = importlib.machinery.ModuleSpec(
            "mxnet_tpu_torch", None, is_package=True)
        pkg.__spec__.submodule_search_locations = [_PKG_DIR]
        sys.modules["mxnet_tpu_torch"] = pkg
    from mxnet_tpu_torch import native, recordio, resilience
    from mxnet_tpu_torch.data_service import common, ring
    return recordio, resilience, common, ring, native


class _NativeDecoder(object):
    """The native libjpeg pipe (imagedec.cc): decode, augment, normalize and
    pack a whole batch in one GIL-released C++ call, straight into the ring
    slot's data region."""

    code = 1

    def __init__(self, native, common, cfg):
        import ctypes
        try:
            lib = native.get_lib()
        except Exception as e:  # noqa: BLE001 — a failed build: fall back
            raise RuntimeError("native library unavailable: %s" % e)
        if lib is None or not getattr(lib, "_has_imagedec", False):
            raise RuntimeError("native image pipeline unavailable")
        self._ct = ctypes
        self._lib = lib
        aug = cfg["aug"]
        c, h, w = cfg["data_shape"]   # canonical (c, h, w)
        self._pipe, self._keepalive = common.open_native_pipe(
            lib, h, w, aug.get("resize"), aug.get("rand_crop"),
            aug.get("rand_mirror"), cfg["dtype_code"],
            0 if cfg["layout"] == "NCHW" else 1,
            aug.get("mean"), aug.get("std"),
            cfg.get("fast_dct", True), cfg.get("decode_threads", 1))
        if not self._pipe:
            raise RuntimeError("MXTImgPipeCreate failed")

    def decode(self, raws, out, valid, cseed, heartbeat=None):
        """Decode ``raws`` into ``out`` (a (bs, ...) view); returns the
        count of valid images."""
        ct = self._ct
        n = len(raws)
        bufs = (ct.c_void_p * n)(
            *[ct.cast(ct.c_char_p(r), ct.c_void_p) for r in raws])
        lens = (ct.c_uint64 * n)(*[len(r) for r in raws])
        return self._lib.MXTImgPipeDecodeBatch(
            self._pipe, bufs, lens, n, out.ctypes.data_as(ct.c_void_p),
            valid.ctypes.data_as(ct.POINTER(ct.c_uint8)), cseed)

    def close(self):
        if self._pipe:
            self._lib.MXTImgPipeDestroy(self._pipe)
            self._pipe = None


class _PythonDecoder(object):
    """The cv2/PIL decoder for hosts whose native library has no libjpeg.
    Deterministic per (cseed, image index) like the native pipe, but not
    bit-identical to it (another JPEG decoder).  bfloat16 output is
    rounded to nearest even (``common.float_to_bf16_bits``)."""

    code = 2

    def __init__(self, common, cfg):
        self._C = common
        self._cfg = cfg
        try:
            import cv2
            self._cv2 = cv2
        except ImportError:
            self._cv2 = None
            from PIL import Image  # noqa: F401 — fail now, not per image
        aug = cfg["aug"]
        self._resize = int(aug.get("resize", 0) or 0)
        self._rand_crop = bool(aug.get("rand_crop"))
        self._rand_mirror = bool(aug.get("rand_mirror"))
        self._mean = (np.asarray(aug["mean"], np.float32)
                      if aug.get("mean") is not None else None)
        self._std = (np.asarray(aug["std"], np.float32)
                     if aug.get("std") is not None else None)

    def _imdecode(self, raw):
        if self._cv2 is not None:
            img = self._cv2.imdecode(np.frombuffer(raw, np.uint8), 1)
            if img is None:
                return None
            return img[..., ::-1]  # BGR -> RGB (the native pipe emits RGB)
        import io as _io

        from PIL import Image
        try:
            return np.asarray(Image.open(_io.BytesIO(raw)).convert("RGB"))
        except Exception:  # noqa: BLE001 — per-image tolerance
            return None

    def _one(self, raw, rng, th, tw):
        img = self._imdecode(raw)
        if img is None:
            return None
        h, w = img.shape[:2]
        if self._resize:
            if h > w:
                nh, nw = self._resize * h // w, self._resize
            else:
                nh, nw = self._resize, self._resize * w // h
            if self._cv2 is not None:
                img = self._cv2.resize(img, (nw, nh))
            else:
                from PIL import Image
                img = np.asarray(Image.fromarray(img).resize((nw, nh)))
            h, w = nh, nw
        cw, ch = min(tw, w), min(th, h)
        if self._rand_crop:
            x0 = int(rng.randint(0, w - cw + 1))
            y0 = int(rng.randint(0, h - ch + 1))
        else:
            x0, y0 = (w - cw) // 2, (h - ch) // 2
        img = img[y0:y0 + ch, x0:x0 + cw]
        if (ch, cw) != (th, tw):
            if self._cv2 is not None:
                img = self._cv2.resize(img, (tw, th))
            else:
                from PIL import Image
                img = np.asarray(Image.fromarray(img).resize((tw, th)))
        if self._rand_mirror and rng.randint(0, 2):
            img = img[:, ::-1]
        img = img.astype(np.float32)
        if self._mean is not None:
            img -= self._mean
        if self._std is not None:
            img /= self._std
        return img

    def decode(self, raws, out, valid, cseed, heartbeat=None):
        cfg = self._cfg
        c, th, tw = cfg["data_shape"]   # canonical (c, h, w)
        nv = 0
        for i, raw in enumerate(raws):
            if heartbeat is not None:
                heartbeat()   # the python decode is slow: stay visibly alive
            rng = np.random.RandomState(
                self._C.chunk_seed(cseed, i) % (2 ** 31))
            img = self._one(raw, rng, th, tw)
            if img is None:
                continue
            if cfg["layout"] == "NCHW":
                img = img.transpose(2, 0, 1)
            if cfg["dtype"] == "uint8":
                img = np.clip(img, 0, 255)
            if cfg["dtype"] == "bfloat16":
                out[i] = self._C.float_to_bf16_bits(img)
            else:
                out[i] = img.astype(out.dtype, copy=False)
            valid[i] = 1
            nv += 1
        return nv

    def close(self):
        pass


def _run_epoch(cfg, ring_, reader, decoder, faults, common, unpack, epoch,
               skip):
    bs = int(cfg["batch_size"])
    lw = int(cfg["label_width"])
    dtype = common.np_dtype(cfg["dtype"])
    order = cfg["_order"].seek(epoch)
    shard = common.worker_batches(order, bs, int(cfg["rank"]),
                                  int(cfg["num_workers"]),
                                  int(cfg.get("stream_offset", 0)),
                                  int(cfg.get("stream_stride", 1)))
    valid = np.empty(bs, np.uint8)
    coord_pid = int(cfg["coordinator_pid"])
    # posix_fadvise readahead keyed off the epoch order: declare the exact
    # record sequence this epoch's (resumed) shard reads
    reader.set_read_plan(
        k for j, (_g, keys) in enumerate(shard) if j >= int(skip)
        for k in keys)

    def abandoned():
        # the coordinator is gone (we were reparented away from its pid,
        # which may itself be 1 in a container) or asked this epoch to be
        # abandoned (a mid-epoch reset)
        return os.getppid() != coord_pid or ring_.abort_epoch() >= epoch

    for j, (gidx, keys) in enumerate(shard):
        if j < int(skip):
            continue
        if ring_.stopped() or abandoned():
            break
        # fault points: a hang ages the heartbeat out (killed and
        # respawned), a raise exits the worker (respawned); either way the
        # shard resumes at the last consumed record
        faults.maybe_hang("hang_data_worker")
        faults.maybe_fail("data_worker")
        slot = ring_.acquire(on_wait=abandoned)
        if slot is None:
            break
        raws, labs = [], []
        for k in keys:
            hdr, img = unpack(reader.read_idx(k))
            raws.append(img)
            labs.append(hdr.label)
            # stamp during the batch too: a legitimately slow batch (cold
            # storage, the python decoder) must not age past
            # MXTPU_DATA_HEARTBEAT_S and be respawned into the same batch
            ring_.heartbeat()
        n = len(raws)
        ring_.begin_write(slot, gidx)
        labv = ring_.label_view(slot)
        datav = ring_.data_view(slot, dtype)
        if n < bs:
            datav[:] = 0
        valid[:] = 0
        cseed = common.chunk_seed(int(cfg["seed"]), gidx, epoch=epoch)
        nv = decoder.decode(raws, datav, valid, cseed,
                            heartbeat=ring_.heartbeat)
        if nv == 0:
            raise RuntimeError(
                "data_service worker %d: every record in batch %d failed "
                "to decode: is this a non-JPEG .rec?"
                % (int(cfg["rank"]), gidx))
        keep = np.flatnonzero(valid[:n])
        labv[:] = 0
        labv[:nv] = np.asarray(labs, np.float32).reshape(n, -1)[keep][:, :lw]
        if nv < n:
            datav[:nv] = datav[keep]
            datav[nv:] = 0
        ring_.commit(slot, gidx, nv, epoch)
    ring_.ack_epoch(epoch)


def main():
    cfg = json.loads(sys.argv[1])
    recordio, resilience, common, ring_mod, native = bootstrap()
    ring_ = ring_mod.Ring(
        cfg["shm_name"], cfg["slots"], cfg["batch_size"],
        cfg["ring_shape"], cfg["label_width"],
        common.np_dtype(cfg["dtype"]).itemsize,
        slot_bytes=cfg.get("slot_bytes"), create=False)
    ring_.heartbeat()
    reader = recordio.MXIndexedRecordIO(cfg["idx"], cfg["rec"], "r")
    cfg["_order"] = common.EpochOrder(
        reader.keys, cfg["seed"], cfg["shuffle"], cfg["part_index"],
        cfg["num_parts"])
    try:
        decoder = _NativeDecoder(native, common, cfg)
    except RuntimeError:
        decoder = _PythonDecoder(common, cfg)
    ring_.announce_decoder(decoder.code)
    try:
        for line in sys.stdin:
            parts = line.split()
            if not parts or parts[0] == "Q":
                break
            if parts[0] == "E":
                _run_epoch(cfg, ring_, reader, decoder, resilience.faults,
                           common, recordio.unpack, int(parts[1]),
                           int(parts[2]))
    finally:
        decoder.close()
        reader.close()
        ring_.close()


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        sys.exit(130)
    except Exception:  # noqa: BLE001 — exit code + stderr is the contract
        import traceback
        traceback.print_exc()
        sys.exit(3)
