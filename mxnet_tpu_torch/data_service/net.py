"""The network tier of the data service (port of
``mxnet_tpu/data_service/net.py``).

Decode hosts run ``server_main.py`` (the counterpart of the JAX package's
``tools/data_server.py``), a torch-free process that accepts one consumer
connection per stream, builds the same sharded-reader / decode-worker
:class:`.service.DataService` on its own cores, and streams the published
ring slots over TCP as length-prefixed, crc-checked frames.  The consumer's
:class:`NetDataService` has the ``DataService`` collector surface (and is
wrapped by the same ``DataServiceIter``): it connects to N servers, hands
server ``s`` of ``S`` the outer stream shard ``offset=s, stride=S``
(global batch ``i`` belongs to server ``i % S``), and delivers frames in
global order as zero-copy numpy views over reusable receive buffers.

The wire is a contract shared with the JAX package: the same frame header
(``<IBIqiQI``: magic "MXDF", type, epoch, global batch, nvalid, payload
bytes, crc32), the same JSON handshake and control lines, so a port
consumer reads a JAX-package server and the reverse.

- **Determinism**: the epoch permutation is ``common.EpochOrder`` and the
  per-batch augmentation seed ``common.chunk_seed(seed, global batch,
  epoch)`` on every host, so the stream is bit-identical to the local
  service's for any server count and any per-server worker count.
- **Exactly-once**: every frame carries (epoch, global batch, nvalid,
  payload length, crc32).  A torn frame (short read, bad magic,
  implausible length, crc mismatch) is never consumed: the connection is
  dropped and re-established, and the handshake re-requests the stream at
  the last consumed batch.  A SIGKILLed server is a torn frame plus
  refused reconnects until its supervisor respawns it.
- **Liveness**: servers send heartbeat frames whenever no batch flows
  (also while a slow worker decodes).  A connection with no frames for
  ``MXTPU_DATA_NET_TIMEOUT_S`` is evicted and reconnected;
  ``MXTPU_DATA_NET_RETRIES`` consecutive failed reconnects (the streak
  resets on every delivered batch) raise ``MXNetError``.  A connection
  generation keeps a stale reader thread from killing its replacement.
- **Flow control**: the consumer holds a small pool of receive buffers per
  connection and stops reading the socket when they are full: TCP
  backpressure stalls the server's send, its ring fills, its workers
  block in ``acquire``, with no unbounded queue anywhere.

Torch-free on both sides (stdlib + numpy + the package's torch-free
leaves): the server runs under the stub package.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import struct
import threading
import time
import zlib
from collections import deque

import numpy as np

from ..base import MXNetError, get_env
from . import (ENV_DATA_NET_FRAME_BYTES, ENV_DATA_NET_RECONNECT,
               ENV_DATA_NET_RETRIES, ENV_DATA_NET_TIMEOUT)
from . import common as C

__all__ = ["BatchServer", "NetDataService", "parse_servers",
           "FRAME_BATCH", "FRAME_HB", "FRAME_EPOCH_END", "FRAME_ERROR"]

_LOG = logging.getLogger(__name__)

#: frame header: magic, type, epoch, global batch idx, nvalid, payload
#: bytes, crc32(payload).  ``<`` = no padding — both sides agree
#: byte-for-byte like the ring layout in :mod:`.common`.
_HDR = struct.Struct("<IBIqiQI")
_MAGIC = 0x4d584446          # "MXDF"
FRAME_BATCH = 1
FRAME_HB = 2
FRAME_EPOCH_END = 3
FRAME_ERROR = 4

#: config keys a handshake forwards verbatim into the server-side
#: ``DataService`` constructor (ONE list, so consumer and server can
#: never disagree about what a stream's identity includes)
_CFG_KEYS = ("path_imgrec", "path_imgidx", "data_shape", "batch_size",
             "label_width", "shuffle", "seed", "part_index", "num_parts",
             "num_workers", "dtype", "layout", "aug", "fast_dct",
             "slots", "stream_offset", "stream_stride")


def parse_servers(spec):
    """``'host:port,host:port'`` (or an iterable of the same / of
    ``(host, port)`` pairs) -> ``[(host, port), ...]``."""
    if isinstance(spec, str):
        parts = [p.strip() for p in spec.replace(";", ",").split(",")
                 if p.strip()]
    else:
        parts = list(spec or ())
    out = []
    for p in parts:
        if isinstance(p, (tuple, list)):
            host, port = p
        else:
            host, _, port = str(p).rpartition(":")
            if not host:
                raise MXNetError(
                    "data servers must be host:port, got %r" % (p,))
        out.append((str(host), int(port)))
    if not out:
        raise MXNetError("empty data-server list %r" % (spec,))
    return out


def _recv_exact(sock, view, on_progress=None):
    """Fill ``view`` (a writable memoryview) from the socket; returns
    False on a clean EOF at offset 0, raises on a short read anywhere
    else (a torn frame — the consumer never consumes it).
    ``on_progress`` fires after every successful chunk — the consumer's
    liveness clock must count BYTES flowing, not completed frames: a
    multi-MB batch frame on a slow link can legitimately take longer
    than the whole eviction timeout."""
    got = 0
    total = len(view)
    while got < total:
        n = sock.recv_into(view[got:], total - got)
        if n == 0:
            if got == 0:
                return False
            raise ConnectionError("torn frame: EOF after %d/%d bytes"
                                  % (got, total))
        got += n
        if on_progress is not None:
            on_progress()
    return True


def _send_frame(sock, ftype, epoch, batch_idx, nvalid, *payload):
    crc = 0
    total = 0
    for part in payload:
        crc = zlib.crc32(part, crc)
        total += len(memoryview(part).cast("B"))
    sock.sendall(_HDR.pack(_MAGIC, ftype, int(epoch), int(batch_idx),
                           int(nvalid), total, crc & 0xffffffff))
    for part in payload:
        sock.sendall(part)


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

class BatchServer(object):
    """One decode host's server: accepts consumer connections, builds a
    (torch-free) :class:`.service.DataService` per stream from the
    handshake config, and streams published ring slots as frames.

    Runs inside ``server_main.py`` on decode hosts, or in-process for
    loopback tests.  Concurrent connections each get their
    own service (their own worker processes), so one server process can
    feed several consumers — a consumer that disconnects tears its
    service (and decode workers) down.
    """

    def __init__(self, host="127.0.0.1", port=0, log=None):
        self._log = log or (lambda msg: _LOG.info("%s", msg))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()

    def serve_forever(self):
        """Accept loop (blocks); one daemon thread per connection."""
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                break       # shutdown() closed the listener
            t = threading.Thread(target=self._handle, args=(conn, addr),
                                 name="mxds-net-%s:%s" % addr[:2],
                                 daemon=True)
            t.start()
        return 0

    def shutdown(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    # -- one connection = one stream ---------------------------------------
    def _handle(self, conn, addr):
        from .service import DataService
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        rfile = conn.makefile("rb")
        svc = None
        try:
            # the handshake is read under a timeout AND a length cap
            # (mirroring the consumer's _recv_line): a half-open probe
            # must not park this thread+fd forever, and a newline-less
            # byte stream must not buffer without bound
            conn.settimeout(30)
            line = rfile.readline(65537)
            conn.settimeout(None)
            if len(line) > 65536:
                raise MXNetError("oversized handshake")
            hello = json.loads(line or "{}")
            cfg = dict(hello.get("cfg") or {})
            unknown = set(cfg) - set(_CFG_KEYS)
            if unknown:
                raise MXNetError("unknown stream config keys %s"
                                 % sorted(unknown))
            hb_s = max(0.2, float(hello.get("hb_s", 2.0)))
            svc = DataService(start_epoch=int(hello.get("epoch", 1)),
                              start_batch=int(hello.get("skip", 0)),
                              **cfg)
            conn.sendall((json.dumps(
                {"ok": True, "nbatches": svc._nbatches,
                 "stream_batches": svc._stream_batches}) + "\n").encode())
        except Exception as e:  # noqa: BLE001 — reported to the consumer
            self._log("data_server: handshake from %s:%s failed: %s"
                      % (addr[0], addr[1], e))
            try:
                conn.sendall((json.dumps(
                    {"ok": False, "error": str(e)}) + "\n").encode())
            except OSError:
                pass
            conn.close()
            return
        ctrl = _CtrlReader(rfile)
        try:
            self._stream(conn, svc, ctrl, hb_s)
        except (OSError, ValueError) as e:
            self._log("data_server: stream to %s:%s ended: %s"
                      % (addr[0], addr[1], e))
        except MXNetError as e:
            # a worker exhausted its respawn budget (broken dataset):
            # tell the consumer WHY before closing, so its error names
            # the cause instead of "connection reset"
            try:
                msg = str(e).encode("utf-8", "replace")[:2000]
                _send_frame(conn, FRAME_ERROR, svc.epoch, -1, 0, msg)
            except OSError:
                pass
        finally:
            svc.close()
            try:
                conn.close()
            except OSError:
                pass

    def _stream(self, conn, svc, ctrl, hb_s):
        # stage each published slot into a scratch buffer and release it
        # before the (milliseconds-long) crc + send: the decode worker
        # starts the next batch while this thread pushes bytes
        label_n = svc._bs * svc._lw
        label_bytes = label_n * 4
        data_n = svc._bs * int(np.prod(svc._ring_shape))
        staging = bytearray(label_bytes + data_n * svc._np_dtype.itemsize)
        stage_lab = np.frombuffer(staging, np.float32, count=label_n)
        stage_dat = np.frombuffer(staging, svc._np_dtype, count=data_n,
                                  offset=label_bytes).reshape(
                                      (svc._bs,) + svc._ring_shape)
        while True:
            cmd = ctrl.pop()
            if cmd is not None:
                if cmd.get("op") == "quit":
                    return
                if cmd.get("op") == "epoch":
                    svc.seek(int(cmd["epoch"]), int(cmd.get("skip", 0)))
                    continue
            if svc.at_epoch_end():
                _send_frame(conn, FRAME_EPOCH_END, svc.epoch, -1, 0)
                # idle until the next epoch/quit command, visibly alive
                while True:
                    cmd = ctrl.pop(timeout=hb_s)
                    if cmd is not None:
                        break
                    _send_frame(conn, FRAME_HB, svc.epoch, -1, 0)
                if cmd.get("op") == "quit":
                    return
                if cmd.get("op") == "epoch":
                    svc.seek(int(cmd["epoch"]), int(cmd.get("skip", 0)))
                continue
            try:
                nb = svc.next_batch(timeout=hb_s)
            except StopIteration:
                continue    # at_epoch_end handles it next loop
            if nb is None:
                # workers still decoding: the consumer must not read
                # silence as death while real work is in flight
                _send_frame(conn, FRAME_HB, svc.epoch, -1, 0)
                continue
            datav, labels, pad, release = nb
            stage_lab[:] = np.asarray(labels, np.float32).reshape(-1)
            stage_dat[:] = datav
            gidx = svc.last_batch_idx
            epoch = svc.epoch
            nvalid = svc._bs - pad
            release()
            _send_frame(conn, FRAME_BATCH, epoch, gidx, nvalid, staging)


class _CtrlReader(object):
    """Background reader for the consumer->server JSON control lines
    (epoch advance, quit).  EOF or garbage reads as ``quit`` — a
    vanished consumer tears the stream down either way, and the
    handler's ``conn.close()`` is what unblocks the thread at
    teardown (readline returns EOF)."""

    def __init__(self, rfile):
        self._q = deque()
        self._cv = threading.Condition()
        self._t = threading.Thread(target=self._loop, args=(rfile,),
                                   name="mxds-net-ctrl", daemon=True)
        self._t.start()

    def _loop(self, rfile):
        while True:
            try:
                line = rfile.readline()
            except (OSError, ValueError):
                line = b""
            if not line:
                self._push({"op": "quit"})
                return
            try:
                self._push(json.loads(line))
            except ValueError:
                self._push({"op": "quit"})
                return

    def _push(self, cmd):
        with self._cv:
            self._q.append(cmd)
            self._cv.notify_all()

    def pop(self, timeout=0.0):
        with self._cv:
            if not self._q and timeout:
                self._cv.wait(timeout)
            return self._q.popleft() if self._q else None


# ---------------------------------------------------------------------------
# consumer side
# ---------------------------------------------------------------------------

class _Conn(object):
    """One server connection: handshake, a reader thread filling a
    small pool of receive buffers (seqlock analog: a frame is either
    fully validated — length, magic, crc — or never published), and
    the eviction bookkeeping."""

    def __init__(self, index, addr, hello_cfg, payload_bytes, slots,
                 frame_cap, hb_s):
        self.index = index
        self.addr = addr
        self._cfg = hello_cfg       # dict; epoch/skip filled per connect
        self._payload = int(payload_bytes)
        self._cap = int(frame_cap)
        self._hb_s = float(hb_s)
        self._bufs = [bytearray(self._payload) for _ in range(int(slots))]
        self._free = deque(range(int(slots)))
        self._ready = deque()       # (epoch, gidx, nvalid, buf_idx)
        self._lock = threading.Lock()
        self.consumed = 0           # stream batches delivered this epoch
        self.reconnects = 0         # lifetime (stats)
        self.attempts = 0           # consecutive failed connects (budget)
        self.frames = 0
        self.bytes_rx = 0
        self.wait_since = None      # set while the collector waits on us
        self.dead = "never connected"
        self.nbatches = None
        self._sock = None
        self._reader = None
        self._gen = 0               # connection generation (see kill())
        self._stop = threading.Event()
        self._last_rx = time.monotonic()

    # -- lifecycle ----------------------------------------------------------
    def connect(self, epoch, skip):
        self.kill("reconnecting")
        old = self._reader
        if old is not None and old.is_alive():
            # the old reader exits promptly (its socket is closed and
            # its stop event set by kill) — but it must be GONE before
            # the buffer pool is recycled: a reader mid-frame could
            # otherwise publish into, or still hold a buffer of, the
            # new connection's pool, and a crc-valid stale frame that
            # matches the resumed batch index would hand the collector
            # a view another thread is overwriting
            old.join(timeout=10)
            if old.is_alive():
                raise ConnectionError(
                    "previous reader thread did not exit")
        stop = threading.Event()
        with self._lock:
            self._gen += 1
            gen = self._gen
            self._free = deque(range(len(self._bufs)))
            self._ready.clear()
        sock = socket.create_connection(self.addr, timeout=10)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        hello = {"v": 1, "cfg": self._cfg, "epoch": int(epoch),
                 "skip": int(skip), "hb_s": self._hb_s}
        sock.sendall((json.dumps(hello) + "\n").encode())
        sock.settimeout(30)
        reply = json.loads(_recv_line(sock))
        if not reply.get("ok"):
            sock.close()
            raise MXNetError("data server %s:%d rejected the stream: %s"
                             % (self.addr[0], self.addr[1],
                                reply.get("error")))
        self.wait_since = None      # fresh connection: fresh clock
        nbatches = int(reply["nbatches"])
        if self.nbatches is not None and nbatches != self.nbatches:
            # a respawned server over a CHANGED dataset: fatal, not a
            # retry — a smaller epoch would hang the collector behind
            # healthy heartbeats, a larger one would serve wrong bytes
            # under matching (epoch, batch) headers
            sock.close()
            raise MXNetError(
                "data server %s:%d now reports %d batches/epoch "
                "(stream started with %d) — did the dataset change "
                "under a respawn?" % (self.addr[0], self.addr[1],
                                      nbatches, self.nbatches))
        self.nbatches = nbatches
        sock.settimeout(None)
        self.consumed = int(skip)
        self._last_rx = time.monotonic()
        with self._lock:
            self._sock = sock
            self._stop = stop
            self.dead = None
        self._reader = threading.Thread(
            target=self._read_loop, args=(sock, stop, gen),
            name="mxds-net-rx-%d" % self.index, daemon=True)
        self._reader.start()

    def kill(self, reason, gen=None):
        """Evict this connection (dead server, torn frame, stale
        heartbeat).  Validated-but-unconsumed frames are DROPPED — the
        reconnect handshake re-requests from the last consumed batch,
        and deterministic production makes the re-sent tail
        bit-identical (exactly-once at the consumer).

        ``gen`` is a reader thread's connection generation: a STALE
        reader waking up with the OSError from its own already-closed
        socket must not tear down the replacement connection the
        collector just established — once ``connect`` bumps the
        generation, the old reader's kill is a no-op."""
        with self._lock:
            if gen is not None and gen != self._gen:
                return
            if self.dead is None:
                self.dead = str(reason)
            stop = self._stop
            sock, self._sock = self._sock, None
        stop.set()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def send_cmd(self, obj):
        sock = self._sock
        if self.dead is not None or sock is None:
            return False
        try:
            sock.sendall((json.dumps(obj) + "\n").encode())
            return True
        except OSError as e:
            self.kill("command send failed: %s" % e)
            return False

    def _stamp_rx(self):
        self._last_rx = time.monotonic()

    # -- reader thread ------------------------------------------------------
    def _read_loop(self, sock, stop, gen):
        hdr = bytearray(_HDR.size)
        hdrv = memoryview(hdr)
        try:
            while not stop.is_set():
                if not _recv_exact(sock, hdrv):
                    raise ConnectionError("server closed the stream")
                magic, ftype, epoch, gidx, nvalid, nbytes, crc = \
                    _HDR.unpack(hdr)
                if magic != _MAGIC:
                    raise ConnectionError("bad frame magic 0x%x" % magic)
                if nbytes > self._cap:
                    raise ConnectionError(
                        "frame announces %d bytes (cap %d)"
                        % (nbytes, self._cap))
                if ftype == FRAME_BATCH:
                    if nbytes != self._payload:
                        raise ConnectionError(
                            "batch frame payload %d != expected %d"
                            % (nbytes, self._payload))
                    buf_idx = self._take_free(stop)
                    if buf_idx is None:
                        return
                    view = memoryview(self._bufs[buf_idx])
                    if not _recv_exact(sock, view,
                                       on_progress=self._stamp_rx):
                        raise ConnectionError("torn frame: EOF in payload")
                    if zlib.crc32(view) & 0xffffffff != crc:
                        raise ConnectionError(
                            "frame crc mismatch (batch %d)" % gidx)
                    with self._lock:
                        self._ready.append((epoch, gidx, nvalid, buf_idx))
                elif ftype == FRAME_ERROR:
                    msg = bytearray(nbytes)
                    _recv_exact(sock, memoryview(msg))
                    raise ConnectionError(
                        "server error: %s" % msg.decode("utf-8", "replace"))
                elif ftype in (FRAME_HB, FRAME_EPOCH_END):
                    pass
                else:
                    raise ConnectionError("unknown frame type %d" % ftype)
                self._last_rx = time.monotonic()
                self.frames += 1
                self.bytes_rx += _HDR.size + nbytes
        except (OSError, ConnectionError, struct.error) as e:
            self.kill(e, gen=gen)

    def _take_free(self, stop):
        while not stop.is_set():
            with self._lock:
                if self._free:
                    return self._free.popleft()
            # buffers full: stop reading the socket — TCP backpressure
            # IS the cross-host flow control
            time.sleep(0.0005)
        return None

    # -- collector surface --------------------------------------------------
    def pop(self, epoch, gidx):
        """The head frame if it is exactly (epoch, gidx); None when the
        buffer is empty or holds only STALE frames (older epoch, or
        same-epoch batches BEHIND the cursor — a mid-epoch ``seek``
        leaves the pre-seek tail in flight; frames arrive in order per
        connection, so behind-the-cursor is harmless and discarded
        in-band, keeping the server's warm workers).  A frame AHEAD of
        the cursor is a real protocol violation (straggler server) and
        raises."""
        with self._lock:
            while self._ready:
                f_epoch, f_gidx, nvalid, buf_idx = self._ready[0]
                if f_epoch < epoch or (f_epoch == epoch
                                       and f_gidx < gidx):
                    # pre-reset / pre-seek leftovers: recycle and keep
                    # looking
                    self._ready.popleft()
                    self._free.append(buf_idx)
                    continue
                if f_epoch != epoch or f_gidx != gidx:
                    raise ConnectionError(
                        "stale stream: got (epoch %d, batch %d), "
                        "expected (epoch %d, batch %d)"
                        % (f_epoch, f_gidx, epoch, gidx))
                self._ready.popleft()
                return nvalid, buf_idx
            return None

    def release(self, buf_idx):
        with self._lock:
            self._free.append(buf_idx)

    def last_rx_age(self):
        return time.monotonic() - self._last_rx

    def silent_for(self, since):
        """Seconds with no complete frame, measured from
        ``max(last frame, since)`` — eviction must clock silence from
        when the collector STARTED waiting, not from the last frame: a
        consumer that paused past the timeout (checkpoint save, eval
        pass) backpressures both batches AND heartbeats, and absolute
        frame age would evict every healthy connection on resume."""
        return time.monotonic() - max(self._last_rx, since)

    def buffer(self, buf_idx):
        return self._bufs[buf_idx]


def _recv_line(sock, cap=65536):
    out = bytearray()
    while len(out) < cap:
        b = sock.recv(1)
        if not b:
            raise ConnectionError("EOF in handshake reply")
        if b == b"\n":
            return bytes(out)
        out += b
    raise ConnectionError("oversized handshake reply")


class NetDataService(object):
    """Consumer-side collector over N :class:`BatchServer` streams —
    the drop-in ``DataService`` analog for the network tier (same
    ``next_batch``/``reset``/``seek``/``stats``/``close`` surface, same
    zero-copy slot-lifetime contract, wrapped by the same
    ``DataServiceIter``).

    ``servers`` is ``'host:port,host:port'`` or a list; server ``s``
    serves global batches ``i`` with ``i % S == s`` and runs
    ``workers_per_server`` decode worker processes of its own.  The
    dataset paths are the SERVER hosts' paths — the consumer never
    opens them (a training host needs no copy of the .rec).
    """

    def __init__(self, servers, path_imgrec, path_imgidx, data_shape,
                 batch_size, label_width=1, shuffle=False, seed=0,
                 part_index=0, num_parts=1, workers_per_server=1,
                 dtype="float32", layout="NCHW", aug=None, slots=None,
                 fast_dct=True, timeout_s=None, retries=None,
                 reconnect_s=None, buffers=2):
        addrs = parse_servers(servers)
        if dtype not in ("uint8", "float32", "bfloat16"):
            raise MXNetError("data_service: unsupported dtype %r"
                             % (dtype,))
        if layout not in ("NCHW", "NHWC"):
            raise MXNetError("layout must be NCHW or NHWC")
        self._shape = tuple(int(d) for d in data_shape)
        if len(self._shape) != 3 or self._shape[0] != 3:
            raise MXNetError(
                "data_shape must be (3, height, width), got %s"
                % (self._shape,))
        c, h, w = self._shape
        self._ring_shape = (c, h, w) if layout == "NCHW" else (h, w, c)
        self._bs = int(batch_size)
        self._lw = int(label_width)
        self._dtype = dtype
        self._np_dtype = C.np_dtype(dtype)
        self._layout = layout
        self._seed = int(seed)
        self._timeout = float(timeout_s if timeout_s is not None
                              else get_env(ENV_DATA_NET_TIMEOUT, 30.0))
        self._retries = int(retries if retries is not None
                            else get_env(ENV_DATA_NET_RETRIES, 10))
        self._reconnect_s = float(
            reconnect_s if reconnect_s is not None
            else get_env(ENV_DATA_NET_RECONNECT, 0.5))
        frame_cap = int(get_env(ENV_DATA_NET_FRAME_BYTES, 1 << 30))
        hb_s = max(0.2, min(2.0, self._timeout / 4.0))
        self._label_bytes = self._bs * self._lw * 4
        data_bytes = (self._bs * int(np.prod(self._ring_shape))
                      * self._np_dtype.itemsize)
        payload = self._label_bytes + data_bytes
        S = len(addrs)
        self._conns = []
        for s, addr in enumerate(addrs):
            cfg = {
                "path_imgrec": path_imgrec, "path_imgidx": path_imgidx,
                "data_shape": list(self._shape),
                "batch_size": self._bs, "label_width": self._lw,
                "shuffle": bool(shuffle), "seed": self._seed,
                "part_index": int(part_index),
                "num_parts": int(num_parts),
                "num_workers": max(1, int(workers_per_server)),
                "dtype": dtype, "layout": layout,
                "aug": C.jsonable_aug(aug),
                "fast_dct": bool(fast_dct),
                "stream_offset": s, "stream_stride": S,
            }
            if slots is not None:
                cfg["slots"] = int(slots)
            self._conns.append(_Conn(s, addr, cfg, payload,
                                     max(2, int(buffers)), frame_cap,
                                     hb_s))
        self.epoch = 1
        self._next_idx = 0
        self._pending = None
        self._closed = False
        self.last_aug_seed = None
        self.last_batch_idx = None
        self._consumer_stall_s = 0.0
        try:
            for conn in self._conns:
                self._reconnect(conn)
            nbs = {conn.nbatches for conn in self._conns}
            if len(nbs) != 1:
                raise MXNetError(
                    "data servers disagree on the epoch's batch count "
                    "(%s) — are they serving the same dataset?"
                    % sorted(nbs))
            self._nbatches = nbs.pop()
        except BaseException:
            self.close()
            raise

    # -- connection supervision ---------------------------------------------
    def _reconnect(self, conn):
        """(Re)establish one server connection at this consumer's
        current position for that stream, within the consecutive-
        failure budget."""
        last_err = conn.dead
        while True:
            conn.attempts += 1
            if conn.attempts > self._retries:
                raise MXNetError(
                    "data server %s:%d unreachable after %d consecutive "
                    "attempts — last failure: %s"
                    % (conn.addr[0], conn.addr[1], self._retries,
                       last_err))
            try:
                conn.connect(self.epoch, conn.consumed)
                if conn.attempts > 1 or conn.reconnects:
                    _LOG.warning(
                        "data_service: reconnected to server %s:%d "
                        "(epoch %d, resuming at stream batch %d)",
                        conn.addr[0], conn.addr[1], self.epoch,
                        conn.consumed)
                conn.reconnects += 1
                return
            except (OSError, ConnectionError, ValueError) as e:
                last_err = e
                conn.dead = str(e)
                time.sleep(self._reconnect_s)

    # -- collector ----------------------------------------------------------
    def next_batch(self, timeout=None):
        """Same contract as ``DataService.next_batch``: zero-copy data
        view + fresh labels + pad + release, in global batch order."""
        if self._closed:
            raise MXNetError("data_service: closed")
        self._release_pending()
        if self._next_idx >= self._nbatches:
            raise StopIteration
        i = self._next_idx
        conn = self._conns[i % len(self._conns)]
        t0 = time.monotonic()
        give_up = None if timeout is None else t0 + float(timeout)
        waited = False
        while True:
            if conn.dead is not None:
                _LOG.warning(
                    "data_service: server %s:%d connection died (%s) — "
                    "evicting and reconnecting", conn.addr[0],
                    conn.addr[1], conn.dead)
                self._reconnect(conn)
            # the eviction clock persists across timeout-polling calls
            # (conn.wait_since, cleared on delivery and by a fresh
            # connect — stamped AFTER the reconnect above so a new
            # connection starts a fresh clock) — keying it off THIS
            # call's t0 would reset it every poll and a silent
            # connection would never be evicted under a polling
            # consumer
            if conn.wait_since is None:
                conn.wait_since = time.monotonic()
            try:
                item = conn.pop(self.epoch, i)
            except ConnectionError as e:
                conn.kill(e)
                continue
            if item is not None:
                break
            if conn.silent_for(conn.wait_since) > self._timeout:
                conn.kill("no frames for %.1fs (heartbeat timeout)"
                          % conn.silent_for(conn.wait_since))
                continue
            if give_up is not None and time.monotonic() >= give_up:
                self._consumer_stall_s += time.monotonic() - t0
                return None
            waited = True
            time.sleep(0.0005)
        conn.wait_since = None
        if waited:
            self._consumer_stall_s += time.monotonic() - t0
        nvalid, buf_idx = item
        nvalid = max(0, min(self._bs, int(nvalid)))
        buf = conn.buffer(buf_idx)
        labels = np.frombuffer(buf, np.float32,
                               count=self._bs * self._lw).reshape(
                                   self._bs, self._lw)
        labels = np.array(labels[:, 0] if self._lw == 1 else labels)
        datav = np.frombuffer(
            buf, self._np_dtype,
            count=self._bs * int(np.prod(self._ring_shape)),
            offset=self._label_bytes).reshape(
                (self._bs,) + self._ring_shape)
        self._next_idx += 1
        conn.consumed += 1
        conn.attempts = 0    # delivered: not a dead server
        self.last_aug_seed = C.chunk_seed(self._seed, i, epoch=self.epoch)
        self.last_batch_idx = i
        released = [False]

        def release(_conn=conn, _idx=buf_idx, _released=released):
            if not _released[0]:
                _released[0] = True
                _conn.release(_idx)
        self._pending = release
        return datav, labels, self._bs - nvalid, release

    def _release_pending(self):
        if self._pending is not None:
            self._pending()
            self._pending = None

    def at_epoch_end(self):
        return self._next_idx >= self._nbatches

    def reset(self):
        self.seek(self.epoch + 1)

    def seek(self, epoch, consumed=0):
        """Land every stream at ``epoch`` with the first ``consumed``
        GLOBAL batches already delivered (the ``DataService.seek``
        surface; ``reset()`` is ``seek(epoch + 1)``).  Live connections
        get an in-band epoch command (their server aborts the current
        epoch and reuses its warm workers); dead ones resume lazily on
        the next pull.  Stale-epoch frames still in flight are
        discarded by the collector's epoch filter."""
        if self._closed:
            raise MXNetError("data_service: closed")
        self._release_pending()
        self.epoch = max(1, int(epoch))
        self._next_idx = min(max(0, int(consumed)), self._nbatches)
        S = len(self._conns)
        for conn in self._conns:
            # this stream's share of the first `consumed` global
            # batches: global i belongs to server i % S
            conn.consumed = len(range(conn.index, self._next_idx, S))
            conn.send_cmd({"op": "epoch", "epoch": self.epoch,
                           "skip": conn.consumed})

    # -- observability ------------------------------------------------------
    def stats(self):
        if self._closed:
            return self._final_stats
        per = {}
        for conn in self._conns:
            per[conn.index] = {
                "server": "%s:%d" % conn.addr,
                "frames": conn.frames,
                "bytes_rx": conn.bytes_rx,
                "reconnects": max(0, conn.reconnects - 1),
                "alive": conn.dead is None,
                "last_rx_age_s": round(conn.last_rx_age(), 3),
            }
        return {
            "num_servers": len(self._conns),
            "num_workers": len(self._conns),   # stats-surface parity
            "epoch": self.epoch,
            "batches_delivered": self._next_idx,
            "consumer_stall_s": round(self._consumer_stall_s, 3),
            "producer_stall_s": 0.0,
            "ring_occupancy": 0.0,
            "servers": per,
        }

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
        for conn in getattr(self, "_conns", []):
            conn.send_cmd({"op": "quit"})
            conn.kill("closed")

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
