"""TensorBoard logging (port of ``mxnet_tpu/contrib/tensorboard.py``;
reference python/mxnet/contrib/tensorboard.py).  Stdlib only: the event
bytes equal the JAX package's for the same scalars and clock.

`LogMetricsCallback` mirrors the reference API (a batch/epoch-end callback
writing each metric as a scalar summary).  The event writer is
self-contained — TF-record framing (length + masked CRC32C) around
hand-encoded Event/Summary protobufs — so it works with no tensorboard /
torch dependency; files load in any standard TensorBoard.
"""
from __future__ import annotations

import os
import struct
import threading
import time

__all__ = ["SummaryWriter", "LogMetricsCallback"]


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — software table, as used by the TFRecord framing.
# ---------------------------------------------------------------------------

def _make_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _make_table()


def _crc32c(data):
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf encoding for Event{wall_time=1, step=2, file_version=3,
# summary=5} / Summary{value=1} / Summary.Value{tag=1, simple_value=2}
# ---------------------------------------------------------------------------

def _varint(n):
    # protobuf encodes negative int64 as 10-byte two's complement; without
    # the mask a negative Python int never reaches 0 and the loop spins
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num, wire, payload):
    return _varint((num << 3) | wire) + payload


def _scalar_event(tag, value, step, wall_time):
    val = (_field(1, 2, _varint(len(tag.encode())) + tag.encode())
           + _field(2, 5, struct.pack("<f", float(value))))
    summary = _field(1, 2, _varint(len(val)) + val)
    ev = (_field(1, 1, struct.pack("<d", wall_time))
          + _field(2, 0, _varint(int(step)))
          + _field(5, 2, _varint(len(summary)) + summary))
    return ev


def _version_event(wall_time):
    v = b"brain.Event:2"
    return (_field(1, 1, struct.pack("<d", wall_time))
            + _field(3, 2, _varint(len(v)) + v))


class SummaryWriter(object):
    """Append scalar summaries to a TensorBoard event file."""

    def __init__(self, logging_dir):
        os.makedirs(logging_dir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s.%d" % (
            time.time(), os.uname().nodename if hasattr(os, "uname")
            else "host", os.getpid())
        self._path = os.path.join(logging_dir, fname)
        self._f = open(self._path, "wb")
        self._lock = threading.Lock()
        self._step = 0
        self._write(_version_event(time.time()))
        self.flush()

    def _write(self, record):
        hdr = struct.pack("<Q", len(record))
        with self._lock:
            self._f.write(hdr)
            self._f.write(struct.pack("<I", _masked_crc(hdr)))
            self._f.write(record)
            self._f.write(struct.pack("<I", _masked_crc(record)))

    def add_scalar(self, tag, value, global_step=None):
        if global_step is None:
            self._step += 1
            global_step = self._step
        else:
            self._step = int(global_step)
        self._write(_scalar_event(tag, value, global_step, time.time()))

    def flush(self):
        with self._lock:
            self._f.flush()

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class LogMetricsCallback(object):
    """Log metrics to TensorBoard (reference contrib/tensorboard.py
    LogMetricsCallback) — use as batch_end_callback / eval_end_callback /
    epoch-end callback in Module.fit.

    Parameters
    ----------
    logging_dir : str
        Event-file directory (`tensorboard --logdir=...` to view).
    prefix : str, optional
        Prepended as "<prefix>-<metric>" so train/eval curves with the
        same metric name separate.
    """

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        self.summary_writer = SummaryWriter(logging_dir)

    def __call__(self, param):
        if getattr(param, "eval_metric", None) is None:
            return
        step = getattr(param, "nbatch", None)
        epoch = getattr(param, "epoch", 0) or 0
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = "%s-%s" % (self.prefix, name)
            if step is None:
                self.summary_writer.add_scalar(name, value, epoch)
            else:
                self.summary_writer.add_scalar(name, value)
        self.summary_writer.flush()
