"""RecordIO: sequential + indexed binary record files (port of
``mxnet_tpu/recordio.py``, the same code).

API parity with the reference's python/mxnet/recordio.py (MXRecordIO,
MXIndexedRecordIO, IRHeader, pack/unpack, pack_img/unpack_img); the on-disk
format is byte-compatible with the reference's dmlc recordio framing
(magic 0xced7230a, (cflag<<29)|len lrecords, 4-byte alignment, magic-elision
record splitting), so .rec/.idx files move between both packages and the
reference unmodified.

Two backends: the native codec (``native/recordio.cc``) via ctypes, or a
pure-Python implementation under ``MXNET_NO_NATIVE=1``.  ``pack_img`` and
``unpack_img`` encode and decode with ``cv2`` (PIL where it is missing),
imported where they run.
"""
from __future__ import annotations

import ctypes
import numbers
import os
import struct
from collections import namedtuple

import numpy as np

from . import native
from .base import MXNetError, get_env, register_env

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "read_index",
           "pack", "unpack", "pack_img", "unpack_img"]

#: io_uring-style readahead for indexed readers that follow a known
#: order (the data-service workers set their epoch-order plan): keep
#: the OS page cache this many RECORDS ahead of the read cursor via
#: posix_fadvise(WILLNEED) — sequential-speed reads out of a
#: random-access (shuffled) plan.  Registered here (the owner module)
#: per the eager-registration lesson.
ENV_DATA_READAHEAD = register_env(
    "MXTPU_DATA_READAHEAD", default=64,
    doc="Readahead window (records) for planned indexed reads "
        "(MXIndexedRecordIO.set_read_plan; the data-service workers "
        "plan each epoch's shard): byte ranges of the next N planned "
        "records are posix_fadvise(WILLNEED)d ahead of the cursor; "
        "0 disables")


def read_index(idx_path, key_type=int):
    """Parse a ``.idx`` file into an ordered ``[(key, position), ...]``
    without opening the ``.rec`` it indexes — sharded readers (the data
    service coordinator) plan shard assignments from the index alone."""
    out = []
    with open(idx_path) as fin:
        for line in fin:
            line = line.strip()
            if not line:
                continue
            fields = line.split("\t")
            # tolerate trailing extra columns (some external im2rec
            # variants append a size field) like the historical parser
            out.append((key_type(fields[0]), int(fields[1])))
    return out

_MAGIC = 0xced7230a
_LEN_MASK = (1 << 29) - 1
_MAGIC_BYTES = struct.pack("<I", _MAGIC)


class _PyRecordWriter(object):
    def __init__(self, path):
        self._f = open(path, "wb")

    def write(self, data):
        if len(data) >= (1 << 29):
            raise MXNetError("record too large")
        n = len(data)
        lower = (n >> 2) << 2
        upper = ((n + 3) >> 2) << 2
        out = bytearray()
        dptr = 0
        for i in range(0, lower, 4):
            if data[i:i + 4] == _MAGIC_BYTES:
                out += _MAGIC_BYTES
                out += struct.pack("<I", ((1 if dptr == 0 else 2) << 29)
                                   | (i - dptr))
                out += data[dptr:i]
                dptr = i + 4
        out += _MAGIC_BYTES
        out += struct.pack("<I", ((3 if dptr else 0) << 29) | (n - dptr))
        out += data[dptr:n]
        out += b"\x00" * (upper - n)
        self._f.write(out)

    def tell(self):
        return self._f.tell()

    def close(self):
        self._f.close()


class _PyRecordReader(object):
    def __init__(self, path):
        self._f = open(path, "rb")

    def read(self):
        """Returns record bytes or None at EOF."""
        out = bytearray()
        multipart = False
        while True:
            head = self._f.read(4)
            if not head and not multipart:
                return None
            if len(head) != 4 or struct.unpack("<I", head)[0] != _MAGIC:
                raise MXNetError("invalid record stream")
            lrec = struct.unpack("<I", self._f.read(4))[0]
            cflag, n = lrec >> 29, lrec & _LEN_MASK
            upper = ((n + 3) >> 2) << 2
            if multipart:
                out += _MAGIC_BYTES
            chunk = self._f.read(upper)
            if len(chunk) != upper:
                raise MXNetError("truncated record")
            out += chunk[:n]
            if cflag == 0:
                return bytes(out)
            if cflag == 3:
                # 'last part' is only valid inside a multipart record
                # (same strictness as the native reader).
                if not multipart:
                    raise MXNetError("invalid record stream")
                return bytes(out)
            if cflag == 1 and multipart:
                raise MXNetError("invalid record stream")
            multipart = True

    def seek(self, pos):
        self._f.seek(pos)

    def tell(self):
        return self._f.tell()

    def close(self):
        self._f.close()


class _NativeRecordWriter(object):
    def __init__(self, path):
        self._lib = native.get_lib()
        self._h = self._lib.MXTRecordIOWriterCreate(path.encode())
        if not self._h:
            raise MXNetError("cannot open %s for writing" % path)

    def write(self, data):
        if self._lib.MXTRecordIOWriterWrite(self._h, data, len(data)) != 0:
            raise MXNetError("record write failed")

    def tell(self):
        return self._lib.MXTRecordIOWriterTell(self._h)

    def close(self):
        if self._h:
            self._lib.MXTRecordIOWriterClose(self._h)
            self._h = None


class _NativeRecordReader(object):
    def __init__(self, path):
        self._lib = native.get_lib()
        self._h = self._lib.MXTRecordIOReaderCreate(path.encode())
        if not self._h:
            raise MXNetError("cannot open %s for reading" % path)

    def read(self):
        out = ctypes.c_void_p()
        out_len = ctypes.c_uint64()
        ret = self._lib.MXTRecordIOReaderRead(
            self._h, ctypes.byref(out), ctypes.byref(out_len))
        if ret == 0:
            return None
        if ret < 0:
            raise MXNetError("invalid record stream")
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._lib.MXTFree(out)

    def seek(self, pos):
        self._lib.MXTRecordIOReaderSeek(self._h, pos)

    def tell(self):
        return self._lib.MXTRecordIOReaderTell(self._h)

    def close(self):
        if self._h:
            self._lib.MXTRecordIOReaderClose(self._h)
            self._h = None


class MXRecordIO(object):
    """Sequential RecordIO reader/writer (reference
    python/mxnet/recordio.py:MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.is_open = False
        self.open()

    def _make(self):
        use_native = native.get_lib() is not None
        if self.flag == "w":
            return (_NativeRecordWriter if use_native
                    else _PyRecordWriter)(self.uri)
        elif self.flag == "r":
            return (_NativeRecordReader if use_native
                    else _PyRecordReader)(self.uri)
        raise MXNetError("invalid flag %r (use 'r' or 'w')" % self.flag)

    def open(self):
        self.record = self._make()
        self.is_open = True

    def close(self):
        if self.is_open:
            self.record.close()
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.flag == "w"
        self.record.write(buf)

    def read(self):
        assert self.flag == "r"
        return self.record.read()

    def tell(self):
        return self.record.tell()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MXIndexedRecordIO(MXRecordIO):
    """Indexed RecordIO with keyed random access (reference
    python/mxnet/recordio.py:MXIndexedRecordIO; .idx = "key\\tpos" lines)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        self._ra_fd = None          # readahead-advice fd (any fd works)
        self._ra_plan = None        # deque of upcoming keys
        self._ra_window = 0
        self._ra_ahead = 0          # plan entries already advised
        self._ra_lens = None        # key -> approx record byte length
        self.readahead_advised = 0  # records advised (observability)
        super(MXIndexedRecordIO, self).__init__(uri, flag)

    def open(self):
        super(MXIndexedRecordIO, self).open()
        self.idx = {}
        self.keys = []
        self.fidx = open(self.idx_path, self.flag)
        if self.flag == "r":
            for key, pos in read_index(self.idx_path, self.key_type):
                self.idx[key] = pos
                self.keys.append(key)

    def close(self):
        if self.is_open:
            super(MXIndexedRecordIO, self).close()
            self.fidx.close()
        # the readahead plan dies with the fd: a reset() (close+open)
        # must not leave a live plan advising through a closed fd
        self._ra_plan = None
        self._ra_ahead = 0
        if self._ra_fd is not None:
            try:
                os.close(self._ra_fd)
            except OSError:
                pass
            self._ra_fd = None

    def seek(self, idx):
        assert self.flag == "r"
        self.record.seek(self.idx[idx])

    # -- planned readahead ---------------------------------------------------
    def set_read_plan(self, keys, window=None):
        """Declare the order upcoming ``read_idx`` calls will follow
        (e.g. the data service's per-epoch shard) so the reader can
        keep the OS page cache ``window`` records ahead of the cursor
        (``MXTPU_DATA_READAHEAD``; ``posix_fadvise(WILLNEED)`` — the
        io_uring-style prefetch a shuffled epoch order defeats the
        kernel's own sequential readahead on).  Reads that deviate
        from the plan resynchronize or quietly fall off it; no plan,
        window 0, or a platform without ``posix_fadvise`` means plain
        reads."""
        from collections import deque
        if window is None:
            window = int(get_env(ENV_DATA_READAHEAD, 64))
        self._ra_window = max(0, int(window))
        self._ra_plan = deque(keys)
        self._ra_ahead = 0
        if (self._ra_window <= 0 or not hasattr(os, "posix_fadvise")
                or self.flag != "r"):
            self._ra_plan = None
            return
        if self._ra_fd is None:
            try:
                self._ra_fd = os.open(self.uri, os.O_RDONLY)
            except OSError:
                self._ra_plan = None
                return
        if self._ra_lens is None:
            # record length ≈ gap to the next start position (.idx
            # positions are monotonic); the final record runs to EOF
            pairs = sorted(self.idx.items(), key=lambda kv: kv[1])
            try:
                end = os.fstat(self._ra_fd).st_size
            except OSError:
                end = 0
            lens = {}
            for (k, pos), nxt in zip(
                    pairs, [p for _, p in pairs[1:]] + [end]):
                lens[k] = max(0, nxt - pos)
            self._ra_lens = lens

    def _maybe_readahead(self, idx):
        plan = self._ra_plan
        if plan is None or self._ra_fd is None:
            return
        if not plan or plan[0] != idx:
            # off-plan read (respawn resume, random access): drop plan
            # entries until the cursor matches again, else give up on
            # this plan — correctness never depends on the advice
            while plan and plan[0] != idx:
                plan.popleft()
                self._ra_ahead = max(0, self._ra_ahead - 1)
            if not plan:
                self._ra_plan = None
                return
        plan.popleft()
        self._ra_ahead = max(0, self._ra_ahead - 1)
        if self._ra_ahead <= self._ra_window // 2:
            from itertools import islice
            # islice, not list(plan)[...]: copying the whole remaining
            # deque every window/2 reads would make a large shard's
            # epoch O(N^2/window) in the decode hot path
            for k in islice(plan, self._ra_ahead, self._ra_window):
                pos = self.idx.get(k)
                if pos is None:
                    continue
                try:
                    os.posix_fadvise(self._ra_fd, pos,
                                     self._ra_lens.get(k, 1 << 16),
                                     os.POSIX_FADV_WILLNEED)
                except OSError:
                    self._ra_plan = None
                    return
                self.readahead_advised += 1
            self._ra_ahead = min(len(plan), self._ra_window)

    def read_idx(self, idx):
        self._maybe_readahead(idx)
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack an IRHeader + payload into a record string (reference
    recordio.py:pack).  ``flag``>0 means ``label`` is an array of ``flag``
    float32s stored after the fixed header."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(label=float(header.label))
        s = struct.pack(_IR_FORMAT, *header) + s
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0.0)
        s = struct.pack(_IR_FORMAT, *header) + label.tobytes() + s
    return s


def unpack(s):
    """Unpack a record into (IRHeader, payload) (reference recordio.py:unpack)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack a header + image array into a record (reference
    recordio.py:pack_img).  Uses cv2 when available, else PIL."""
    encoded = _imencode(img, quality, img_fmt)
    return pack(header, encoded)


def unpack_img(s, iscolor=-1):
    """Unpack a record into (IRHeader, image ndarray) (reference
    recordio.py:unpack_img)."""
    header, s = unpack(s)
    img = _imdecode(s, iscolor)
    return header, img


def _imencode(img, quality=95, img_fmt=".jpg"):
    try:
        import cv2
        fmt = img_fmt.lower()
        if fmt in (".jpg", ".jpeg"):
            params = [cv2.IMWRITE_JPEG_QUALITY, quality]
        elif fmt == ".png":
            params = [cv2.IMWRITE_PNG_COMPRESSION, quality // 10]
        else:
            params = []
        ret, buf = cv2.imencode(img_fmt, img, params)
        if not ret:
            raise MXNetError("failed to encode image")
        return buf.tobytes()
    except ImportError:
        import io as _io
        from PIL import Image
        arr = np.asarray(img)
        if arr.ndim == 3 and arr.shape[-1] == 3:
            arr = arr[..., ::-1]  # BGR -> RGB (channel axis only)
        pimg = Image.fromarray(arr)
        bio = _io.BytesIO()
        fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
        pimg.save(bio, format=fmt, quality=quality)
        return bio.getvalue()


def _imdecode(buf, iscolor=-1):
    try:
        import cv2
        return cv2.imdecode(np.frombuffer(buf, dtype=np.uint8), iscolor)
    except ImportError:
        import io as _io
        from PIL import Image
        pimg = Image.open(_io.BytesIO(buf))
        if iscolor == 0:
            return np.asarray(pimg.convert("L"))
        img = np.asarray(pimg.convert("RGB"))
        return img[..., ::-1]  # RGB -> BGR to match cv2 convention
