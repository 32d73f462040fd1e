"""Shared, dependency-free pieces of the data service (port of
``mxnet_tpu/data_service/common.py``).

This module is imported both by the trainer process (through the package)
and by decode worker and server processes (under a stub package, see
``_worker_main.py``), so it stays stdlib + numpy only: no torch, no
package-relative imports.

It owns the contracts the service's determinism rests on, equal to the
JAX package's element for element:

- :func:`chunk_seed`: the per-(seed, chunk, epoch) augmentation seed
  shared with ``image.py``'s in-process pipelines and the native decoder
  (imagedec.cc ``MixSeed`` mixes it further per image), so a sample's
  augmentation is a pure function of (seed, global batch, epoch) no matter
  which process decodes it;
- :func:`epoch_order`: the per-epoch record permutation of ``ImageIter``
  (partition slice first, then a stateful ``random.Random(seed)`` shuffle
  once per epoch), so the service delivers the in-process pipe's record
  stream for any worker count;
- the shard assignment (:func:`worker_batches`): global batch ``i``
  (records ``order[i*B:(i+1)*B]``) belongs to worker ``i % num_workers``,
  and the collector delivers batches in global order;
- the shared-memory ring layout (:func:`slot_layout` and the control-word
  and slot-header constants) that ``ring.py`` and the worker agree on.
"""
from __future__ import annotations

import random as _pyrandom

#: the reference's default ImageNet channel normalization (image.py's
#: ``mean=True`` / ``std=True``)
IMAGENET_MEAN = (123.68, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)

__all__ = [
    "chunk_seed", "epoch_order", "EpochOrder", "worker_batches",
    "num_batches", "stream_batches", "jsonable_aug",
    "IMAGENET_MEAN", "IMAGENET_STD", "np_dtype", "open_native_pipe",
    "DTYPE_CODES", "float_to_bf16_bits",
    "CTRL_WORDS", "CTRL_HEAD", "CTRL_TAIL", "CTRL_HB_MS", "CTRL_ACK_EPOCH",
    "CTRL_STALL_MS", "CTRL_ABORT_EPOCH", "CTRL_STOP", "CTRL_BATCHES",
    "SLOT_HDR_WORDS", "HDR_SEQ", "HDR_BATCH_IDX", "HDR_NVALID", "HDR_EPOCH",
    "HDR_DECODER", "DECODERS", "align64", "slot_layout",
]

#: the native pipe's output dtype codes (imagedec.cc: kU8, kF32, kBf16)
DTYPE_CODES = {"uint8": 0, "float32": 1, "bfloat16": 2}


def chunk_seed(seed, chunk_idx, epoch=0):
    """Deterministic per-chunk seed (splitmix64-style mix keeps successive
    chunks decorrelated even for seed=0).  epoch and chunk mix through
    separate 64-bit odd multipliers.  The native decoder mixes the result
    further per image (imagedec.cc:MixSeed)."""
    m = (1 << 64) - 1
    x = (int(seed) * 0x9e3779b97f4a7c15
         + int(chunk_idx) * 0xbf58476d1ce4e5b9
         + int(epoch) * 0x2545f4914f6cdd1d) & m
    x ^= x >> 30
    x = (x * 0x94d049bb133111eb) & m
    x ^= x >> 31
    return x % (2 ** 31)


def epoch_order(keys, seed, epoch, shuffle, part_index=0, num_parts=1):
    """The record-key order for ``epoch`` (1-based), as ``ImageIter`` has
    it: the partition slice is taken once, then a stateful
    ``random.Random(seed)`` shuffles the slice once per epoch, orders
    accumulating across epochs.  O(epoch * len): callers that advance one
    epoch at a time use :class:`EpochOrder`."""
    o = EpochOrder(keys, seed, shuffle, part_index, num_parts)
    for _ in range(max(1, int(epoch))):
        o.advance()
    return o.order


class EpochOrder(object):
    """Stateful epoch-order generator: ``advance()`` moves to the next
    epoch's order (epoch 1 after the first call); ``seek(epoch)`` replays
    from scratch when the target is not ahead (respawned workers land
    mid-run with it)."""

    def __init__(self, keys, seed, shuffle, part_index=0, num_parts=1):
        keys = list(keys)
        if num_parts > 1:
            chunk = len(keys) // num_parts
            keys = keys[part_index * chunk:(part_index + 1) * chunk]
        self._keys = keys
        self._seed = int(seed)
        self._shuffle = bool(shuffle)
        self._rng = _pyrandom.Random(self._seed)
        self.order = list(keys)
        self.epoch = 0

    def advance(self):
        if self._shuffle:
            self._rng.shuffle(self.order)
        self.epoch += 1
        return self.order

    def seek(self, epoch):
        epoch = int(epoch)
        if epoch < self.epoch + 1:
            self._rng = _pyrandom.Random(self._seed)
            self.order = list(self._keys)
            self.epoch = 0
        while self.epoch < epoch:
            self.advance()
        return self.order


def num_batches(n_records, batch_size):
    """Batches per epoch: every record is delivered; the final partial
    batch is padded (as the in-process native pipe pads it)."""
    return (int(n_records) + int(batch_size) - 1) // int(batch_size)


def worker_batches(order, batch_size, rank, num_workers,
                   stream_offset=0, stream_stride=1):
    """This worker's shard for one epoch: ``[(global_batch_idx, [keys...]),
    ...]``.  Batch ``i`` holds records ``order[i*B:(i+1)*B]``.

    ``stream_offset``/``stream_stride`` carve an outer shard first (the
    network tier: server ``s`` of ``S`` owns global batches ``i`` with
    ``i % S == s``); the worker then owns the rank-th residue of the
    server's local batch sequence ``j = 0, 1, ...`` where ``g = offset +
    j*stride``.  With the defaults this is the single-host assignment, so
    both tiers share one partition function."""
    out = []
    nb = num_batches(len(order), batch_size)
    j = int(rank)
    while True:
        g = int(stream_offset) + j * int(stream_stride)
        if g >= nb:
            break
        out.append((g, order[g * batch_size:(g + 1) * batch_size]))
        j += int(num_workers)
    return out


def stream_batches(n_batches, stream_offset=0, stream_stride=1):
    """How many of the epoch's ``n_batches`` global batches belong to the
    stream ``(offset, stride)``."""
    return len(range(int(stream_offset), int(n_batches),
                     int(stream_stride)))


# ---------------------------------------------------------------------------
# shared-memory ring layout (one segment per worker).
#
#   [ctrl: CTRL_WORDS x int64]
#   [slot 0: hdr(SLOT_HDR_WORDS x int64) | label bytes | data bytes]
#   [slot 1: ...] ...
#
# Single producer (the worker) / single consumer (the collector): the
# producer writes HEAD, slot headers and payloads; the consumer writes
# TAIL, ABORT_EPOCH and STOP.  Publication is seqlock-style: the slot
# header SEQ goes odd (2*batch_idx+1) before the payload is written and
# even (2*batch_idx+2) after, and HEAD is bumped last; the consumer
# accepts a slot only when HEAD covers it and SEQ equals the even value of
# the exact global batch it expects, so a torn write (a worker SIGKILLed
# mid-slot) is never consumed as data.
# ---------------------------------------------------------------------------

CTRL_WORDS = 8
CTRL_HEAD = 0         # batches produced (producer-owned)
CTRL_TAIL = 1         # batches released (consumer-owned)
CTRL_HB_MS = 2        # producer heartbeat, int milliseconds (monotonic)
CTRL_ACK_EPOCH = 3    # last epoch the producer finished or abandoned
CTRL_STALL_MS = 4     # accumulated producer ring-full wait (stats)
CTRL_ABORT_EPOCH = 5  # consumer: abandon this epoch (reset mid-epoch)
CTRL_STOP = 6         # consumer: shut down
CTRL_BATCHES = 7      # total batches produced across epochs (stats)

SLOT_HDR_WORDS = 8
HDR_SEQ = 0
HDR_BATCH_IDX = 1
HDR_NVALID = 2
HDR_EPOCH = 3
#: the producer's decoder (an index into DECODERS), stamped into every slot
#: header when the worker starts (a word the JAX package leaves zero)
HDR_DECODER = 4
DECODERS = ("unknown", "native", "python")


def jsonable_aug(aug):
    """Normalize an augmentation dict for a worker or server config: numpy
    arrays become lists, ``mean=True``/``std=True`` resolve to the
    IMAGENET_* defaults.  The local service's worker configs and the
    network tier's handshake share it."""
    import numpy as _np
    out = {}
    for k, v in dict(aug or {}).items():
        if isinstance(v, _np.ndarray):
            v = [float(x) for x in v.reshape(-1)]
        elif v is True and k in ("mean", "std"):
            v = list(IMAGENET_MEAN if k == "mean" else IMAGENET_STD)
        out[k] = v
    return out


def np_dtype(name):
    """The numpy dtype for a dtype name.  numpy has no bfloat16 and the
    port does not use ``ml_dtypes``: a bfloat16 host buffer is held as its
    bits, ``uint16`` (``torch.bfloat16`` tensors view the same bytes)."""
    import numpy as _np
    if name == "bfloat16":
        return _np.dtype(_np.uint16)
    return _np.dtype(name)


def float_to_bf16_bits(x):
    """float32 values -> their bfloat16 bits (``uint16``), rounded to
    nearest even as ``ml_dtypes`` and torch round; NaN stays a quiet
    NaN."""
    import numpy as _np
    f = _np.ascontiguousarray(x, dtype=_np.float32)
    u = f.view(_np.uint32)
    rounded = (u + (_np.uint32(0x7fff) + ((u >> 16) & _np.uint32(1)))) >> 16
    nan = _np.isnan(f)
    out = rounded.astype(_np.uint16)
    if nan.any():
        out[nan] = ((u[nan] >> 16) | _np.uint32(0x40)).astype(_np.uint16)
    return out


def open_native_pipe(lib, out_h, out_w, resize, rand_crop, rand_mirror,
                     dtype_code, layout_code, mean, std, fast_dct,
                     nthreads):
    """Construct a native image pipe (``MXTImgPipeCreate``): the one place
    the ctypes argument marshaling lives, shared by the in-process
    ``_NativePipeline`` and the data-service worker.  ``mean``/``std`` are
    1- or 3-value float sequences or None (resolve ``True`` to the
    IMAGENET_* defaults before calling).  Returns ``(pipe_handle_or_None,
    keepalive)``: hold ``keepalive`` for the pipe's lifetime."""
    import ctypes
    import numpy as _np
    fp = ctypes.POINTER(ctypes.c_float)

    def _c3(v):
        if v is None:
            return None
        a = _np.asarray(v, dtype=_np.float32).reshape(-1)
        if a.size == 1:
            a = _np.repeat(a, 3)
        return (ctypes.c_float * 3)(*a[:3])

    mean_c, std_c = _c3(mean), _c3(std)
    pipe = lib.MXTImgPipeCreate(
        int(nthreads), int(out_h), int(out_w), int(resize or 0),
        1 if rand_crop else 0, 1 if rand_mirror else 0,
        int(dtype_code), int(layout_code),
        ctypes.cast(mean_c, fp) if mean_c else None,
        ctypes.cast(std_c, fp) if std_c else None,
        1 if fast_dct else 0)
    return pipe, (mean_c, std_c)


def align64(n):
    return (int(n) + 63) & ~63


def slot_layout(batch_size, data_shape, label_width, itemsize,
                slot_bytes=None):
    """Byte layout of one ring slot: ``(label_bytes, data_bytes,
    slot_stride)``.  ``slot_bytes`` (MXTPU_DATA_SLOT_BYTES) can only grow
    the data region: a padded batch must always fit."""
    import numpy as _np
    need = int(batch_size) * int(_np.prod(data_shape)) * int(itemsize)
    data_bytes = align64(max(need, int(slot_bytes or 0)))
    label_bytes = align64(int(batch_size) * int(label_width) * 4)
    stride = SLOT_HDR_WORDS * 8 + label_bytes + data_bytes
    return label_bytes, data_bytes, stride
