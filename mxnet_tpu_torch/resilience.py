"""Fault-tolerant training runtime (port of ``mxnet_tpu/resilience.py``).

The same names, signatures, file layout, manifest and exit codes as the
JAX package, so ``tools/supervise.py`` and ``tools/ckpt_fsck.py`` (both
stdlib-only) drive and audit the port unchanged, and a checkpoint
directory written by either package restores in the other:

- :func:`atomic_write` / :func:`atomic_path` — write-temp + fsync +
  ``os.replace`` so a crash mid-write can never tear an existing file.
- :class:`CheckpointManager` — a checkpoint directory with a JSON
  manifest (every file's size + checksum), ``keep_last`` retention with
  tombstones, ``latest()``/``restore()`` discovery that verifies before
  deserializing and walks back past damaged epochs, replica shards and
  the sharded-native layout as host file code (``_rank``/``_world`` from
  ``torch.distributed`` when a process group is initialised, else 0/1).
  Saves can be asynchronous (``blocking=False`` / ``MXTPU_CKPT_ASYNC=1``):
  the caller pays for one device-to-host copy per tensor
  (:func:`snapshot_params`), and a :class:`CheckpointWriter` thread,
  which never touches CUDA, serializes, writes and fsyncs.
- :func:`retry` / :func:`retrying_next` — bounded retry with backoff for
  the input pipeline's ``next()``.
- :data:`faults` — deterministic fault-injection points, armed in-process
  or through ``MXTPU_FAULTS``, which the JAX package reads too.
- :class:`StepWatchdog` — a hung step dumps every Python thread's stack
  and the ``torch.cuda`` memory state, then exits
  :data:`WATCHDOG_EXIT_CODE`.
- :class:`PreemptionHandler` — SIGTERM/SIGINT becomes a flag that ``fit``
  consumes at the next step boundary: a mid-epoch checkpoint, then exit
  :data:`PREEMPT_EXIT_CODE`.

This module imports the standard library and ``.base`` only: the data
service's decode worker loads it (for its ``data_worker`` and
``hang_data_worker`` points) without torch.  Every torch import sits in
the function that needs it.
"""
from __future__ import annotations

import json
import logging
import os
import re
import signal
import sys
import threading
import time
import traceback
from contextlib import contextmanager

from .base import (ENV_MAX_BAD_STEPS, ENV_STEP_GUARD, MXNetError,
                   register_env)

__all__ = ["atomic_write", "atomic_path", "retry", "retrying_next",
           "CheckpointManager", "CheckpointWriter", "StepWatchdog",
           "PreemptionHandler", "preempted_exit",
           "checksum_file", "checksum_bytes", "checkpoint_async",
           "snapshot_params", "submit_checkpoint", "wait_checkpoints",
           "verify_promotion", "publish_mark",
           "TransientError", "FaultInjector", "faults", "strip_faults_env",
           "region_faults_env", "FaultEvent", "parse_fault_schedule",
           "SCHEDULE_ACTIONS",
           "WATCHDOG_EXIT_CODE", "PREEMPT_EXIT_CODE",
           "ENV_INIT_RETRIES", "ENV_INIT_TIMEOUT", "ENV_INIT_BACKOFF",
           "ENV_DATA_RETRIES", "ENV_DATA_BACKOFF", "ENV_MAX_BAD_STEPS",
           "ENV_STEP_GUARD", "ENV_FAULTS", "ENV_STEP_TIMEOUT",
           "ENV_ON_PREEMPT", "ENV_DEBUG_DIR", "ENV_RESUME",
           "ENV_CKPT_ASYNC", "ENV_CKPT_REPLICAS", "ENV_CKPT_CHECKSUM"]

_LOG = logging.getLogger(__name__)

ENV_INIT_RETRIES = register_env(
    "MXTPU_INIT_RETRIES", default=3,
    doc="distributed.initialize attempts before giving up")
ENV_INIT_TIMEOUT = register_env(
    "MXTPU_INIT_TIMEOUT",
    doc="Per-attempt coordination-service timeout (seconds) for "
        "distributed.initialize")
ENV_INIT_BACKOFF = register_env(
    "MXTPU_INIT_BACKOFF", default=1.0,
    doc="Initial backoff (seconds, doubles per attempt) between "
        "distributed.initialize retries")
ENV_DATA_RETRIES = register_env(
    "MXTPU_DATA_RETRIES", default=3,
    doc="Attempts per data-iterator next() through the shared retry "
        "ladder (prefetchers)")
ENV_DATA_BACKOFF = register_env(
    "MXTPU_DATA_RETRY_BACKOFF", default=0.05,
    doc="Initial backoff (seconds) between data-iterator retries")
ENV_FAULTS = register_env(
    "MXTPU_FAULTS",
    doc="Deterministic fault arming, point:times[@after] comma-list")
ENV_STEP_TIMEOUT = register_env(
    "MXTPU_STEP_TIMEOUT",
    doc="Hung-step watchdog budget in seconds, or 'auto' to calibrate")
ENV_ON_PREEMPT = register_env(
    "MXTPU_ON_PREEMPT",
    doc="'save' = checkpoint at the next step boundary on SIGTERM/SIGINT "
        "and exit with PREEMPT_EXIT_CODE")
ENV_DEBUG_DIR = register_env(
    "MXTPU_DEBUG_DIR",
    doc="Directory for watchdog hang reports")
ENV_RESUME = register_env(
    "MXTPU_RESUME",
    doc="1 = fit(checkpoint=...) behaves as resume=True (set by "
        "tools/supervise.py relaunches)")
ENV_CKPT_ASYNC = register_env(
    "MXTPU_CKPT_ASYNC", default=0,
    doc="1 = managed checkpoint saves return after the host snapshot; "
        "a background CheckpointWriter does serialize + atomic write + "
        "fsync while training continues")
ENV_CKPT_REPLICAS = register_env(
    "MXTPU_CKPT_REPLICAS", default=0,
    doc="Peer replicas per checkpoint shard in multi-process runs: each "
        "rank also writes its ring neighbors' shards (offsets 1..N) so "
        "restore survives a missing/corrupt primary")
ENV_CKPT_CHECKSUM = register_env(
    "MXTPU_CKPT_CHECKSUM", default="sha256",
    doc="Checksum recorded per checkpoint file in the manifest and "
        "verified on restore: sha256 (default, C-speed), crc32 (zlib), "
        "crc32c (pure-python, TFRecord-style), off")
ENV_CKPT_SHARDED = register_env(
    "MXTPU_CKPT_SHARDED", default=0,
    doc="1 = SPMDTrainer.save_checkpoint writes sharded-native "
        "checkpoints under grad_sync='zero'/'zero3': every dp shard "
        "lands as its own verified blob (params.s{K}-of-{W}), no "
        "host-side gather — peak host bytes O(P/world) instead of O(P)")

#: process exit code of a watchdog abort (hung step): the supervisor
#: relaunches with resume.  Distinct from signal codes (128+N) and from
#: PREEMPT_EXIT_CODE so exit-code-aware restart policies can tell a hang
#: from a graceful preemption.  tools/supervise.py hardcodes the same
#: values; tests/test_torch_chaos.py asserts they match.
WATCHDOG_EXIT_CODE = 87

#: process exit code of a graceful preemption (mid-epoch checkpoint was
#: saved; relaunch with resume to continue)
PREEMPT_EXIT_CODE = 85


def step_timeout_configured():
    """True when ``MXTPU_STEP_TIMEOUT`` asks for a watchdog: ``auto`` or
    a positive number of seconds.  Unset, ``0``, negative or unparseable
    values mean DISABLED — ``MXTPU_STEP_TIMEOUT=0`` is the natural "off"
    spelling and must never arm a zero-second budget."""
    from .base import get_env
    env = get_env(ENV_STEP_TIMEOUT)
    if not env:
        return False
    s = str(env).strip().lower()
    if s == "auto":
        return True
    try:
        return float(s) > 0
    except ValueError:
        _LOG.warning("%s=%r is neither a number nor 'auto' — watchdog "
                     "disabled", ENV_STEP_TIMEOUT, env)
        return False


class TransientError(MXNetError):
    """An error the caller declared retryable (injected faults, flaky
    storage, a coordinator that is still coming up)."""


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

class FaultInjector(object):
    """Named failure points, armed programmatically or via the
    ``MXTPU_FAULTS`` env (``"point:times,point2:times"``; a
    ``times@after`` count delays the first firing until ``after`` hits
    have passed clean, so a fault can strike at exactly step N).

    Production code plants ``faults.maybe_fail("checkpoint_write")``
    (raise), ``if faults.consume("poison_grad")`` (branch) or
    ``faults.maybe_hang("hang_step")`` (stall — watchdog coverage) at the
    spots a real fault would strike; tests arm a point for N firings and
    get the exact failure, deterministically, on the tier-1 CPU suite.
    Unarmed points cost one dict lookup.
    """

    def __init__(self):
        from .base import get_env
        self._armed = {}
        env = get_env(ENV_FAULTS, "")
        for part in filter(None, (p.strip() for p in env.split(","))):
            point, _, times = part.partition(":")
            times, _, after = (times or "1").partition("@")
            self._armed[point] = int(times or 1)
            if after:
                self._armed[point + "/after"] = int(after)

    def arm(self, point, times=1, exc=None, after=0):
        """Make ``point`` fire for the next ``times`` hits (``exc``: the
        exception type ``maybe_fail`` raises; default TransientError).
        ``after`` lets the first ``after`` hits pass clean — "fail at
        exactly the Nth step" determinism for preemption/hang drills."""
        self._armed[point] = int(times)
        if exc is not None:
            self._armed[point + "/exc"] = exc
        else:
            # re-arming resets to the default exception; never inherit a
            # previous arm()'s custom type
            self._armed.pop(point + "/exc", None)
        if after:
            self._armed[point + "/after"] = int(after)
        else:
            self._armed.pop(point + "/after", None)
        # a leftover hang duration must not survive a plain re-arm, or
        # maybe_trip would stall where the new arming expects a raise
        # (arm_hang re-adds it after delegating here)
        self._armed.pop(point + "/secs", None)
        return self

    def arm_hang(self, point, seconds, times=1, after=0):
        """Arm ``point`` as a stall of ``seconds`` for ``maybe_hang``
        sites (deliberately-hung-step coverage for the watchdog)."""
        self.arm(point, times=times, after=after)
        self._armed[point + "/secs"] = float(seconds)
        return self

    def disarm(self, point=None):
        """Disarm one point, or everything when called with no argument."""
        if point is None:
            self._armed.clear()
        else:
            for k in (point, point + "/exc", point + "/after",
                      point + "/secs"):
                self._armed.pop(k, None)

    def is_armed(self, point):
        return self._armed.get(point, 0) > 0

    def consume(self, point):
        """True (and decrement) if ``point`` is armed — for fault sites
        that branch rather than raise.  A pending ``after`` delay is
        consumed first (those hits return False)."""
        left = self._armed.get(point, 0)
        if left <= 0:
            return False
        delay = self._armed.get(point + "/after", 0)
        if delay > 0:
            self._armed[point + "/after"] = delay - 1
            return False
        self._armed[point] = left - 1
        return True

    def maybe_fail(self, point, message=None):
        """Raise the armed exception at ``point`` (no-op when unarmed)."""
        if self.consume(point):
            exc = self._armed.get(point + "/exc", TransientError)
            raise exc(message or "injected fault at %r" % point)

    def maybe_trip(self, point, message=None):
        """Hang (when armed via :meth:`arm_hang`) or raise (any other
        arming) at ``point`` — one name for sites where a drill needs
        either flavor, e.g. the checkpoint writer's ``ckpt_write`` point
        (a raise = failing disk; a hang = the SIGKILL-mid-save window)."""
        if self._armed.get(point + "/secs") is not None:
            self.maybe_hang(point)
        else:
            self.maybe_fail(point, message)

    #: default stall length of an armed hang point — far beyond any step
    #: budget, so the watchdog (or the supervisor's own timeout) is what
    #: ends the process, exactly like a wedged collective would
    HANG_SECONDS = 3600.0

    def hang_seconds(self, point, default=None):
        """The stall duration armed at ``point`` via :meth:`arm_hang`,
        else ``default`` (else :data:`HANG_SECONDS`).  For fault sites
        that sleep on their OWN terms after a ``consume`` — e.g. the
        serving front end's ``slow_replica`` latency injection, which
        must stay a bounded per-request delay even when armed through
        the plain ``MXTPU_FAULTS`` env (which cannot carry a duration
        the way ``arm_hang`` does)."""
        secs = self._armed.get(point + "/secs")
        if secs is not None:
            return float(secs)
        return self.HANG_SECONDS if default is None else float(default)

    def maybe_hang(self, point):
        """Stall the calling thread for the armed duration at ``point``
        (no-op when unarmed) — the deterministic stand-in for a hung
        collective/transfer.  Sleeps in short slices so an in-process
        test that injected a small ``seconds`` via :meth:`arm_hang`
        regains control promptly."""
        if not self.consume(point):
            return
        seconds = self._armed.get(point + "/secs", self.HANG_SECONDS)
        _LOG.warning("fault injection: hanging %.1fs at %r", seconds, point)
        deadline = time.monotonic() + seconds
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                return
            time.sleep(min(0.05, left))


faults = FaultInjector()


def strip_faults_env(value, points):
    """Drop the given fault points from an ``MXTPU_FAULTS`` env value
    (``"point:times[@after],..."``), keeping everything else — the
    respawn discipline the data service applies to its workers (and
    chaos-drill wrapper scripts apply around relaunches): an injected
    fault fires once per drill, never again on the respawned process
    (or it would crash-loop the respawn budget away)."""
    points = set(points)
    keep = [part for part in
            filter(None, (p.strip() for p in (value or "").split(",")))
            if part.partition(":")[0] not in points]
    return ",".join(keep)


def region_faults_env(env, arm=()):
    """A copy of ``env`` with :data:`ENV_FAULTS` scoped to ONE region
    role's spawn: the orchestrator's own ``MXTPU_FAULTS`` (whatever the
    operator armed around the whole process tree) is removed, and only
    ``arm`` — this role's scheduled ``point:times[@after]`` entries —
    is set.  This is the leak barrier the composed drill needs: without
    it, a fault armed for one role rides ``os.environ`` into every
    sibling the supervisor respawns later, and a fire-once chaos event
    becomes a crash loop somewhere else (docs/how_to/region.md)."""
    env = dict(env)
    env.pop(ENV_FAULTS, None)
    spec = ",".join(arm) if not isinstance(arm, str) else arm
    if spec:
        env[ENV_FAULTS] = spec
    return env


# ---------------------------------------------------------------------------
# STORM fault schedules (the composed region drill's chaos script)
# ---------------------------------------------------------------------------

#: actions a region supervisor knows how to drive (tools/region.py):
#: ``kill`` = SIGKILL the role's process (its supervisor respawns it),
#: ``resize`` = SIGKILL + respawn the trainer at a different world size,
#: ``arm`` = arm a :data:`faults` point inside the running role,
#: ``rot`` = damage ONE sharded-checkpoint blob post-publish (arg
#: ``shard#k`` — sugar for arming ``rot_shard:1@k`` inside the role)
SCHEDULE_ACTIONS = ("kill", "resize", "arm", "rot")


class FaultEvent(object):
    """One scheduled chaos event: ``<at_s> <action> <target> [<arg>]``."""

    __slots__ = ("at_s", "action", "target", "arg")

    def __init__(self, at_s, action, target, arg=None):
        self.at_s = float(at_s)
        self.action = action
        self.target = target
        self.arg = arg

    @property
    def label(self):
        """Stable event name ``/region/stats`` counts this under —
        ``kill:data#0``, ``resize:trainer``, ``arm:trainer:rot_checkpoint``."""
        base = "%s:%s" % (self.action, self.target)
        if self.action == "arm" and self.arg:
            return base + ":" + self.arg.partition(":")[0]
        if self.action == "rot" and self.arg:
            return base + ":" + self.arg
        return base

    def __repr__(self):
        return "FaultEvent(%.3g %s %s%s)" % (
            self.at_s, self.action, self.target,
            " " + self.arg if self.arg else "")


def parse_fault_schedule(text):
    """Parse a STORM chaos schedule into time-ordered
    :class:`FaultEvent` s (docs/how_to/region.md "STORM schedule
    grammar").

    One event per line or comma-separated entry::

        <at_s> kill <role>            # SIGKILL; the supervisor respawns
        <at_s> resize <role> <n>      # SIGKILL + respawn at world size n
        <at_s> arm <role> <point:times[@after]>   # arm a fault point
        <at_s> rot <role> shard#<k>   # rot sharded-ckpt blob k post-publish

    ``at_s`` is seconds after the storm window opens.  A ``#`` at the
    start of a line or after whitespace starts a comment (role names
    like ``replica#1`` keep their ``#``); blank entries are ignored.
    Raises :class:`MXNetError` on
    an unknown action or a malformed entry — a storm that silently
    skipped a misspelled event would pass its drill without testing
    anything."""
    events = []
    for raw_line in (text or "").splitlines():
        # comments: '#' at line start or after whitespace ONLY — a '#'
        # glued to a token is part of a role name (replica#1)
        line = re.split(r"(?:^|(?<=\s))#", raw_line, maxsplit=1)[0]
        for entry in filter(None, (p.strip() for p in line.split(","))):
            parts = entry.split()
            if len(parts) < 3:
                raise MXNetError(
                    "fault schedule entry %r: want '<at_s> <action> "
                    "<target> [<arg>]'" % entry)
            at_s, action, target = parts[0], parts[1], parts[2]
            arg = parts[3] if len(parts) > 3 else None
            if len(parts) > 4:
                raise MXNetError("fault schedule entry %r: trailing "
                                 "tokens %s" % (entry, parts[4:]))
            try:
                at_s = float(at_s)
            except ValueError:
                raise MXNetError("fault schedule entry %r: %r is not a "
                                 "time in seconds" % (entry, parts[0]))
            if action not in SCHEDULE_ACTIONS:
                raise MXNetError(
                    "fault schedule entry %r: unknown action %r (know: "
                    "%s)" % (entry, action, ", ".join(SCHEDULE_ACTIONS)))
            if action == "resize":
                if arg is None or not arg.isdigit() or int(arg) < 1:
                    raise MXNetError(
                        "fault schedule entry %r: resize needs a world "
                        "size >= 1" % entry)
            elif action == "arm":
                point, _, times = (arg or "").partition(":")
                times, _, after = (times or "1").partition("@")
                if not point or not (times or "1").isdigit() or \
                        (after and not after.isdigit()):
                    raise MXNetError(
                        "fault schedule entry %r: arm needs "
                        "'point:times[@after]'" % entry)
            elif action == "rot":
                if arg is None or not re.fullmatch(r"shard#\d+", arg):
                    raise MXNetError(
                        "fault schedule entry %r: rot needs 'shard#<k>' "
                        "(which sharded-checkpoint blob to damage)"
                        % entry)
            elif arg is not None:
                raise MXNetError("fault schedule entry %r: kill takes "
                                 "no argument" % entry)
            events.append(FaultEvent(at_s, action, target, arg))
    events.sort(key=lambda e: e.at_s)
    return events


# ---------------------------------------------------------------------------
# atomic writes
# ---------------------------------------------------------------------------

def _fsync_path(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path):
    """Flush a rename's directory entry (without this, a power loss after
    ``os.replace`` can roll the publish back even though the data blocks
    are on disk)."""
    try:
        fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    except OSError:
        return  # platform/fs without directory fds: best effort
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextmanager
def atomic_path(path, fault_point="checkpoint_write"):
    """Yield a temp path in ``path``'s directory; on clean exit fsync it
    and ``os.replace`` onto ``path``.  A crash (or injected fault) at any
    point leaves the existing ``path`` byte-for-byte intact — the file is
    either the complete old version or the complete new one, never torn.
    The temp name is the writer's process and thread, so two threads
    publishing one path (a periodic dump and an explicit one) never
    share a temp file.
    """
    path = os.fspath(path)
    tmp = "%s.tmp.%d.%d" % (path, os.getpid(), threading.get_ident())
    try:
        yield tmp
        _fsync_path(tmp)
        faults.maybe_fail(fault_point,
                          "injected crash before publishing %r" % path)
        os.replace(tmp, path)
        _fsync_dir(path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def atomic_write(path, data, fault_point="checkpoint_write"):
    """Atomically replace ``path`` with ``data`` (bytes or str)."""
    mode = "wb" if isinstance(data, (bytes, bytearray)) else "w"
    with atomic_path(path, fault_point=fault_point) as tmp:
        with open(tmp, mode) as f:
            f.write(data)


# ---------------------------------------------------------------------------
# checksums (end-to-end checkpoint integrity)
# ---------------------------------------------------------------------------

#: algorithms the manifest may record.  ``sha256``/``crc32`` run at C
#: speed (hashlib/zlib); ``crc32c`` (Castagnoli, the TFRecord/GCS
#: polynomial) is a pure-python table implementation — correct anywhere,
#: but ~MB/ms, so prefer it only where CRC32C compatibility matters.
CHECKSUM_ALGOS = ("sha256", "crc32", "crc32c", "off")

_CRC32C_POLY = 0x82F63B78
_CRC32C_TABLE = None


def _crc32c_table():
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    return _CRC32C_TABLE


def _crc32c_update(crc, data):
    table = _crc32c_table()
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


class _ChecksumStream(object):
    """Incremental digest over one of :data:`CHECKSUM_ALGOS`."""

    def __init__(self, algo):
        if algo not in CHECKSUM_ALGOS:
            raise MXNetError("unknown checksum algo %r (one of %s)"
                             % (algo, ", ".join(CHECKSUM_ALGOS)))
        self.algo = algo
        self.size = 0
        if algo == "sha256":
            import hashlib
            self._h = hashlib.sha256()
        elif algo == "crc32":
            self._crc = 0
        elif algo == "crc32c":
            self._crc = 0xFFFFFFFF

    def update(self, data):
        self.size += len(data)
        if self.algo == "sha256":
            self._h.update(data)
        elif self.algo == "crc32":
            import zlib
            self._crc = zlib.crc32(data, self._crc)
        elif self.algo == "crc32c":
            self._crc = _crc32c_update(self._crc, data)

    def hexdigest(self):
        if self.algo == "off":
            return None
        if self.algo == "sha256":
            return self._h.hexdigest()
        crc = self._crc ^ (0xFFFFFFFF if self.algo == "crc32c" else 0)
        return "%08x" % (crc & 0xFFFFFFFF)


def checksum_bytes(data, algo="sha256"):
    """(size, hexdigest) of ``data``; digest is None under ``off``."""
    s = _ChecksumStream(algo)
    s.update(data)
    return s.size, s.hexdigest()


def checksum_file(path, algo="sha256", chunk=1 << 20):
    """(size, hexdigest) of the file at ``path``, streamed."""
    s = _ChecksumStream(algo)
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            s.update(block)
    return s.size, s.hexdigest()


def _checksum_algo():
    """The configured manifest checksum algorithm (MXTPU_CKPT_CHECKSUM);
    unknown values warn once and fall back to sha256 — an operator typo
    must degrade to the safe default, not disable integrity."""
    from .base import get_env
    algo = str(get_env(ENV_CKPT_CHECKSUM, "sha256") or "sha256").lower()
    if algo in ("0", "none", "disabled"):
        algo = "off"
    if algo not in CHECKSUM_ALGOS:
        _LOG.warning("%s=%r is not one of %s — using sha256",
                     ENV_CKPT_CHECKSUM, algo, ", ".join(CHECKSUM_ALGOS))
        algo = "sha256"
    return algo


# ---------------------------------------------------------------------------
# the background checkpoint writer (async saves)
# ---------------------------------------------------------------------------

def checkpoint_async():
    """True when MXTPU_CKPT_ASYNC asks managed saves to go through the
    background writer."""
    from .base import get_env
    return str(get_env(ENV_CKPT_ASYNC, "0")).strip().lower() in \
        ("1", "true", "yes", "on")


class _HostSnapshot(object):
    """A frozen host copy duck-typed as an NDArray for serialization
    (``nd.save`` reads ``shape`` and the host tensor ``_data``).  The copy
    lives on the host on purpose: the writer thread never touches CUDA, so
    a wedged device cannot block checkpoint IO, and the training step
    makes new parameter tensors (and in-place NDArray ops swap handles)
    while the write is in flight."""

    __slots__ = ("_data",)

    def __init__(self, tensor):
        self._data = tensor

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return self.asnumpy().dtype

    def asnumpy(self):
        t = self._data
        if str(t.dtype) == "torch.bfloat16":
            t = t.float()
        return t.numpy()


def _host_value(v):
    """The host numpy value of an NDArray, a snapshot, a torch tensor or a
    numpy array."""
    import numpy as np
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    if hasattr(v, "detach"):          # a torch tensor
        return _HostSnapshot(v.detach().to("cpu", copy=True)).asnumpy()
    return np.asarray(v)


def _host_copy(v):
    """One host tensor copy of ``v`` (a single device-to-host copy for a
    tensor on the card; a private copy for a host tensor or numpy)."""
    import torch
    if hasattr(v, "_data") and isinstance(v._data, torch.Tensor):
        v = v._data
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    from .ndarray import tensor_from_numpy
    return tensor_from_numpy(v)


def snapshot_params(params):
    """Host copies of a ``{name: array-like}`` dict, wrapped for the writer
    thread: one device-to-host copy per tensor.  This copy is the only
    part of an async save the step loop pays for: the values handed to
    the writer stay frozen while training replaces the device tensors and
    mutates host NDArrays.

    Values that already are ``_HostSnapshot``s (``SPMDTrainer.
    snapshot_params`` copies each parameter once into them) are adopted
    as they are: they are private copies by construction."""
    return {k: v if isinstance(v, _HostSnapshot)
            else _HostSnapshot(_host_copy(v))
            for k, v in (params or {}).items()}


class CheckpointWriter(object):
    """Single-slot background writer: at most one checkpoint write in
    flight (double-buffered — the snapshot being written plus the one
    the caller is preparing).  ``submit`` blocks only while a previous
    write is still running; a failed background write is re-raised at
    the NEXT ``submit``/``wait`` so a dying disk surfaces one save late
    instead of silently dropping every epoch."""

    def __init__(self, name="mxtpu-ckpt-writer"):
        self._name = name
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._job = None        # pending (fn, label)
        self._busy = False      # a job is executing right now
        self._error = None      # first unreported failure
        self._last = None       # {"label","error","elapsed_s"} of last job
        self._thread = None

    # -- worker ------------------------------------------------------------
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run,
                                            name=self._name, daemon=True)
            self._thread.start()

    def _run(self):
        while True:
            with self._lock:
                while self._job is None:
                    self._cv.wait()
                fn, label = self._job
                self._job = None
                self._busy = True
            t0 = time.monotonic()
            error = None
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — reported via wait()
                error = e
                _LOG.warning("CheckpointWriter: background write %r "
                             "failed: %s: %s", label, type(e).__name__, e)
            with self._lock:
                self._busy = False
                self._last = {"label": label, "error": error,
                              "elapsed_s": time.monotonic() - t0}
                if error is not None:
                    self._error = error
                self._cv.notify_all()

    # -- caller surface ----------------------------------------------------
    def submit(self, fn, label="checkpoint"):
        """Queue ``fn`` on the writer; blocks only while the previous
        write is in flight.  Raises the previous write's error, if any
        (the new job is then NOT queued — the caller sees the failure at
        the same point a blocking save would have raised)."""
        with self._lock:
            self._ensure_thread()
            while self._busy or self._job is not None:
                self._cv.wait()
            err, self._error = self._error, None
            if err is None:
                self._job = (fn, label)
                self._cv.notify_all()
        if err is not None:
            raise MXNetError("CheckpointWriter: a previous background "
                             "write failed: %s: %s"
                             % (type(err).__name__, err)) from err
        return self

    def idle(self):
        with self._lock:
            return not self._busy and self._job is None

    def wait(self, timeout=None):
        """Drain: block until no write is queued or running, then raise
        any unreported failure.  Returns :meth:`last_result`."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._busy or self._job is not None:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise MXNetError(
                        "CheckpointWriter: write still in flight after "
                        "%.1fs" % timeout)
                self._cv.wait(left)
            err, self._error = self._error, None
            last = dict(self._last) if self._last is not None else None
        if err is not None:
            raise MXNetError("CheckpointWriter: background write failed: "
                             "%s: %s" % (type(err).__name__, err)) from err
        return last

    def last_result(self):
        """{"label", "error", "elapsed_s"} of the most recently finished
        write, or None (does not block, does not clear pending errors)."""
        with self._lock:
            return dict(self._last) if self._last is not None else None


_DEFAULT_WRITER = None


def _default_writer():
    """The shared writer behind prefix-based (manager-less) async saves:
    ``model.save_checkpoint`` and ``Module.save_checkpoint`` under
    MXTPU_CKPT_ASYNC=1."""
    global _DEFAULT_WRITER
    if _DEFAULT_WRITER is None:
        _DEFAULT_WRITER = CheckpointWriter()
    return _DEFAULT_WRITER


def submit_checkpoint(fn, label="checkpoint"):
    """Queue one checkpoint-write closure on the shared default writer."""
    return _default_writer().submit(fn, label)


def wait_checkpoints(timeout=None):
    """Drain the shared default writer (prefix-based async saves); no-op
    when nothing was ever submitted.  Re-raises a failed write."""
    if _DEFAULT_WRITER is None:
        return None
    return _DEFAULT_WRITER.wait(timeout)


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------

def retry(fn, attempts=3, backoff=0.1, max_backoff=30.0, timeout=None,
          retry_on=(TransientError,), name=None, logger=None,
          sleep=time.sleep, clock=time.monotonic):
    """Call ``fn()`` up to ``attempts`` times with exponential backoff.

    Only exceptions in ``retry_on`` are retried; anything else propagates
    immediately (StopIteration, programming errors).  ``timeout`` bounds
    the TOTAL wall time across attempts.  Each failed attempt is logged
    with attempt number, delay and error so preemption recoveries are
    visible in run logs.  ``sleep``/``clock`` are injectable so tests run
    the full retry ladder against a fake clock with zero real sleeping.
    """
    name = name or getattr(fn, "__name__", "call")
    logger = logger or _LOG
    attempts = max(1, int(attempts))
    deadline = None if timeout is None else clock() + float(timeout)
    delay = float(backoff)
    last = None
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — the ladder IS the point
            last = e
            if attempt >= attempts:
                break
            if deadline is not None and clock() >= deadline:
                logger.warning("retry[%s]: attempt %d/%d failed (%s); "
                               "timeout %.1fs exhausted", name, attempt,
                               attempts, e, timeout)
                break
            wait = delay
            if deadline is not None:
                wait = min(wait, max(0.0, deadline - clock()))
            logger.warning("retry[%s]: attempt %d/%d failed (%s: %s); "
                           "retrying in %.2fs", name, attempt, attempts,
                           type(e).__name__, e, wait)
            sleep(wait)
            delay = min(delay * 2.0, float(max_backoff))
    raise MXNetError("retry[%s]: all %d attempts failed (last: %s: %s)"
                     % (name, attempts, type(last).__name__, last)) from last


def retrying_next(data_iter, name="next"):
    """Pull ``data_iter.next()`` once, retrying transient source errors
    (flaky network storage, an injected ``iter_next`` fault) with backoff;
    StopIteration and real bugs pass straight through.  The shared fetch
    discipline of every background prefetcher (io.PrefetchingIter,
    dataflow.DevicePrefetchIter).  Tunables: MXTPU_DATA_RETRIES /
    MXTPU_DATA_RETRY_BACKOFF.

    CONTRACT: a retried source must not have advanced its cursor on the
    failed call (true of read-then-decode iterators, where the fetch fails
    before the position moves).  A source that consumes the record before
    failing would resume one record later — set MXTPU_DATA_RETRIES=1 for
    such sources and handle the surfaced error with ``reset()``."""
    from .base import get_env

    def _one():
        faults.maybe_fail("iter_next")
        return data_iter.next()

    return retry(
        _one,
        attempts=int(get_env(ENV_DATA_RETRIES, "3")),
        backoff=float(get_env(ENV_DATA_BACKOFF, "0.05")),
        retry_on=(IOError, OSError, TransientError),
        name=name)


# ---------------------------------------------------------------------------
# hung-step watchdog
# ---------------------------------------------------------------------------

def _dump_thread_stacks(out):
    """Write every Python thread's current stack to ``out`` (the hang
    post-mortem: which thread is wedged inside which call)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sorted(sys._current_frames().items()):
        out.write("\n--- thread %s (ident %d) ---\n"
                  % (names.get(ident, "?"), ident))
        out.write("".join(traceback.format_stack(frame)))


def _dump_device_state(out):
    """Best-effort process and ``torch.cuda`` memory state for the hang
    report.  Must never raise (a wedged device is exactly when this runs)
    and must not touch the device: it reads the caching allocator's host
    bookkeeping only, and nothing when this process never imported torch
    or never initialised CUDA."""
    torch = sys.modules.get("torch")
    if torch is None:
        out.write("\ntorch not imported, process %d/%d\n"
                  % (_rank(), _world()))
        return
    try:
        out.write("\ntorch %s, process %d/%d\n"
                  % (torch.__version__, _rank(), _world()))
        if not torch.cuda.is_initialized():
            out.write("torch.cuda: not initialised\n")
            return
        for i in range(torch.cuda.device_count()):
            out.write(
                "torch.cuda device %d (%s): allocated %d bytes, reserved "
                "%d, peak allocated %d\n" % (
                    i, torch.cuda.get_device_name(i),
                    torch.cuda.memory_allocated(i),
                    torch.cuda.memory_reserved(i),
                    torch.cuda.max_memory_allocated(i)))
        out.write("current device: %d\n" % torch.cuda.current_device())
    except Exception as e:  # noqa: BLE001 — diagnostics only
        out.write("\n(device state unavailable: %s)\n" % (e,))


class StepWatchdog(object):
    """Abort-and-dump monitor for hung training steps.

    A wedged collective, transfer or kernel hangs a training process
    silently forever.  The watchdog is armed around each step
    (``with watchdog.armed("step 12"): ...``); a step that overruns its
    budget gets every Python thread's stack plus the ``torch.cuda``
    memory state dumped to
    stderr (and to a timestamped file under ``MXTPU_DEBUG_DIR`` when
    set), then the process aborts with :data:`WATCHDOG_EXIT_CODE` via
    ``os._exit`` — a wedged device thread cannot block the exit — so a
    supervisor (``tools/supervise.py``) can relaunch with resume.

    The budget: ``MXTPU_STEP_TIMEOUT`` seconds when set; otherwise
    auto-calibrated as ``multiplier`` x the median of the first
    ``calibrate_steps`` completed steps (never below ``min_timeout``).
    Until calibration completes no deadline is enforced — the first
    steps include kernel loading and cuDNN's algorithm search and are
    far slower than steady state, and any fixed guess would either fire
    on them or be useless afterwards.  Set ``MXTPU_STEP_TIMEOUT``
    explicitly to also cover bring-up.

    ``clock``/``abort`` are injectable so tests drive the full
    fire path with a fake clock and no real process death; the monitor
    thread just calls :meth:`poll` every ``check_interval``.
    """

    def __init__(self, timeout=None, calibrate_steps=5, multiplier=20.0,
                 min_timeout=10.0, check_interval=0.25, debug_dir=None,
                 exit_code=WATCHDOG_EXIT_CODE, clock=time.monotonic,
                 abort=None, logger=None):
        from .base import get_env
        if timeout is None:
            # MXTPU_STEP_TIMEOUT: seconds, or "auto" (calibrate from the
            # first steps' median; also what fit() treats as opt-in).
            # Nonpositive/garbage values mean "no fixed budget" — never a
            # zero-second budget that would abort every first step.
            env = get_env(ENV_STEP_TIMEOUT)
            if env and str(env).strip().lower() != "auto":
                try:
                    timeout = float(env)
                except ValueError:
                    timeout = None
                if timeout is not None and timeout <= 0:
                    timeout = None
        self.timeout = timeout                # None => auto-calibrate
        self.calibrate_steps = max(1, int(calibrate_steps))
        self.multiplier = float(multiplier)
        self.min_timeout = float(min_timeout)
        self.check_interval = float(check_interval)
        self.debug_dir = debug_dir if debug_dir is not None \
            else get_env(ENV_DEBUG_DIR)
        self.exit_code = int(exit_code)
        self.clock = clock
        self.abort = abort or (lambda code: os._exit(code))
        self.logger = logger or _LOG
        self.fired = False
        self.info = None          # optional () -> str extra context
        self._durations = []      # calibration window
        self._lock = threading.Lock()
        self._label = None
        self._armed_at = None
        self._depth = 0           # re-entrant arming: outer arm wins
        self._stop = threading.Event()
        self._thread = None

    # -- arming ------------------------------------------------------------
    @contextmanager
    def armed(self, label="step"):
        """Arm around one step.  Re-entrant: a nested arm (fit() wraps the
        batch, trainer.step wraps the dispatch) keeps the OUTER deadline
        so the budget covers the whole host-visible step."""
        with self._lock:
            self._depth += 1
            outer = self._depth == 1
            if outer:
                self._label = label
                self._armed_at = self.clock()
        try:
            yield self
        finally:
            with self._lock:
                self._depth -= 1
                if outer and self._armed_at is not None:
                    self._observe(self.clock() - self._armed_at)
                    self._armed_at = None
                    self._label = None

    def _observe(self, duration):
        """Record one completed step for auto-calibration."""
        if self.timeout is not None or \
                len(self._durations) >= self.calibrate_steps:
            return
        self._durations.append(float(duration))
        if len(self._durations) >= self.calibrate_steps:
            med = sorted(self._durations)[len(self._durations) // 2]
            self.timeout = max(self.min_timeout, self.multiplier * med)
            self.logger.info(
                "StepWatchdog: calibrated step budget %.1fs "
                "(%.0fx median %.3fs of first %d steps)", self.timeout,
                self.multiplier, med, len(self._durations))

    @property
    def calibrated_timeout(self):
        """The active budget in seconds, or None while still
        calibrating."""
        return self.timeout

    # -- monitor -----------------------------------------------------------
    def start(self):
        """Start the monitor thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._monitor,
                                        name="StepWatchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop the monitor thread (the armed() bookkeeping still works,
        e.g. to keep calibrating a paused watchdog)."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def _monitor(self):
        while not self._stop.wait(self.check_interval):
            self.poll()

    def poll(self, now=None):
        """One deadline check (what the monitor thread runs; tests call
        it directly with a fake clock).  Returns True when it fired."""
        with self._lock:
            armed_at, label = self._armed_at, self._label
        if armed_at is None or self.timeout is None or self.fired:
            return False
        now = self.clock() if now is None else now
        overrun = now - armed_at
        if overrun <= self.timeout:
            return False
        self.fired = True
        self._fire(label, overrun)
        return True

    def _fire(self, label, overrun):
        import io as _io
        buf = _io.StringIO()
        buf.write("=" * 70 + "\n")
        buf.write("StepWatchdog: %r exceeded its %.1fs budget "
                  "(%.1fs elapsed) — dumping state and aborting with "
                  "exit code %d\n" % (label, self.timeout, overrun,
                                      self.exit_code))
        if self.info is not None:
            try:
                buf.write(str(self.info()) + "\n")
            except Exception as e:  # noqa: BLE001 — diagnostics only
                buf.write("(info hook failed: %s)\n" % (e,))
        _dump_device_state(buf)
        _dump_thread_stacks(buf)
        buf.write("=" * 70 + "\n")
        report = buf.getvalue()
        sys.stderr.write(report)
        sys.stderr.flush()
        if self.debug_dir:
            try:
                os.makedirs(self.debug_dir, exist_ok=True)
                path = os.path.join(
                    self.debug_dir,
                    "watchdog-%d-%d.txt" % (os.getpid(), int(time.time())))
                with open(path, "w") as f:
                    f.write(report)
                sys.stderr.write("StepWatchdog: report written to %s\n"
                                 % path)
                sys.stderr.flush()
            except OSError as e:
                sys.stderr.write("StepWatchdog: could not write report "
                                 "(%s)\n" % (e,))
        self.abort(self.exit_code)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        return False


# ---------------------------------------------------------------------------
# graceful preemption
# ---------------------------------------------------------------------------

def preempted_exit():
    """Terminate with :data:`PREEMPT_EXIT_CODE` (SystemExit — finally
    blocks and atexit run; the checkpoint is already on disk)."""
    raise SystemExit(PREEMPT_EXIT_CODE)


class PreemptionHandler(object):
    """SIGTERM/SIGINT -> a flag consumed at the next step boundary.

    Cloud schedulers deliver preemption as SIGTERM with a grace window;
    killing mid-step loses up to an epoch of work when checkpoints land
    only at epoch end.  Installing this handler makes the signal
    set :attr:`triggered`; ``fit(preemption_safe=True)`` checks it after
    every batch, saves a mid-epoch checkpoint (step + RNG state in the
    manifest) and exits cleanly with :data:`PREEMPT_EXIT_CODE`.

    A second signal restores the original disposition and re-raises it —
    an operator's double Ctrl-C still kills a wedged run immediately.
    Signal handlers can only be installed on the main thread; elsewhere
    ``install`` is a no-op that logs (the flag can still be set
    programmatically via :meth:`trigger`, which tests and in-band fault
    injection use).
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 logger=None):
        self.signals = tuple(signals)
        self.logger = logger or _LOG
        self.triggered = False
        self._previous = {}
        self._installed = False

    def _handle(self, signum, frame):
        if self.triggered:
            # second signal: the operator means it — restore and re-raise
            self.uninstall()
            os.kill(os.getpid(), signum)
            return
        self.triggered = True
        self.logger.warning(
            "PreemptionHandler: received signal %d — will checkpoint and "
            "exit (code %d) at the next step boundary; send again to kill "
            "immediately", signum, PREEMPT_EXIT_CODE)

    def trigger(self):
        """Set the flag programmatically (in-band preemption drills)."""
        self.triggered = True
        return self

    def install(self):
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            self.logger.warning(
                "PreemptionHandler: not on the main thread — signal "
                "handlers not installed (programmatic trigger() still "
                "works)")
            return self
        for sig in self.signals:
            try:
                self._previous[sig] = signal.signal(sig, self._handle)
            except (ValueError, OSError):  # pragma: no cover — platform
                self.logger.warning(
                    "PreemptionHandler: could not install handler for "
                    "signal %s", sig)
        self._installed = True
        return self

    def uninstall(self):
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # pragma: no cover — platform
                pass
        self._previous = {}
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.uninstall()
        return False


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

def _process_group():
    """``torch.distributed`` when this process joined a process group,
    else None (never imports torch: a process that did not import it
    cannot have joined one)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    dist = getattr(torch, "distributed", None)
    if dist is None or not dist.is_available() or not dist.is_initialized():
        return None
    return dist


def _rank():
    """This process's rank: 0 unless a process group was joined."""
    dist = _process_group()
    return 0 if dist is None else dist.get_rank()


def _world():
    """Process count: 1 unless a process group was joined."""
    dist = _process_group()
    return 1 if dist is None else dist.get_world_size()


class CheckpointManager(object):
    """Atomic, discoverable, verified, retention-managed checkpoints.

    Layout (``prefix`` defaults to "checkpoint")::

        dir/prefix-symbol.json        the network (written once per save)
        dir/prefix-0007.params        epoch 7 parameters (reference format)
        dir/prefix-0007.states        epoch 7 optimizer state (optional)
        dir/prefix-0007.shard002      key-partition shard 2 (replication)
        dir/prefix-0007.shard002.rep1 shard 2's ring-offset-1 peer replica
        dir/prefix-0007.params.s002-of-004  sharded-native blob 2 of 4
        dir/prefix-0007.pruning       retention tombstone (transient)
        dir/manifest.json             {"checkpoints": [...], "prefix": ...}

    Every file lands via temp + fsync + ``os.replace``; the manifest is
    updated LAST, so a checkpoint only becomes visible to ``latest()``
    once all of its files are complete.  A crash mid-save leaves the
    previous checkpoint untouched and discoverable.

    INTEGRITY: each manifest entry records every file's size + checksum
    (``MXTPU_CKPT_CHECKSUM``: sha256 default).  ``restore()`` verifies
    before deserializing, so bit rot that still unpickles cleanly is
    caught, and the default restore walks back to the previous intact
    epoch.  ``tools/ckpt_fsck.py`` runs the same audit offline.

    ASYNC: ``save(..., blocking=False)`` (or ``MXTPU_CKPT_ASYNC=1``)
    returns after taking a host snapshot; a per-manager
    :class:`CheckpointWriter` thread does serialize + atomic write +
    fsync + manifest while training continues.  ``wait()`` drains;
    a failed background write re-raises at the next save/wait.

    REPLICATION (``MXTPU_CKPT_REPLICAS=N`` in multi-process runs): the
    gathered state is partitioned into ``world`` key-range shards, and
    rank r writes shard r plus replicas of its ring neighbors' shards
    (offsets 1..N) — so when the primary params file or a shard is
    missing/corrupt, ``restore()`` rebuilds the state from peer-written
    replicas before falling back an epoch.  Shard bytes are a
    deterministic function of the (replicated) gathered state, so rank 0
    records every shard's digest in the manifest without reading the
    peers' disks.

    Multi-process: only rank 0 writes the full checkpoint + manifest
    (callers must gather params on ALL ranks first when they are sharded
    — see SPMDTrainer.get_params's collective note); other ranks write
    only their replica shards (nothing at all when replication is off)
    and return the same epoch.

    SHARDED-NATIVE (:meth:`save_sharded`, ``MXTPU_CKPT_SHARDED=1``
    through ``SPMDTrainer.save_checkpoint``): under zero/zero3 every
    dp shard of the master params + optimizer state lands as its OWN
    blob (``prefix-0007.params.s002-of-004``) with a per-shard size +
    digest in a format-2 manifest entry — no host-side gather; peak
    host bytes are one shard's, O(P/world).  ``restore()`` verifies the
    complete shard set BEFORE deserializing a byte and assembles the
    full arrays on the host, so the restoring trainer's ``set_params``
    re-shards them onto WHATEVER mesh it binds (elastic resume at any
    world, matching the blob count or not); a missing/rotted/truncated
    blob fails the epoch atomically and the walk-back lands on the last
    COMPLETE verified epoch, never a mixed-epoch assembly.
    """

    MANIFEST = "manifest.json"

    #: manifest-entry format of a sharded-native checkpoint (legacy
    #: gathered entries carry no "format" key and imply format 1)
    SHARDED_FORMAT = 2

    #: bound on draining an in-flight async write before a blocking save
    #: (or the preemption path) proceeds anyway — wedged storage must
    #: not turn a durable save into an indefinite hang
    DRAIN_TIMEOUT = 60.0

    def __init__(self, directory, prefix="checkpoint", keep_last=5):
        self.directory = os.fspath(directory)
        self.prefix = prefix
        self.keep_last = None if keep_last is None else max(1, int(keep_last))
        self._writer = None
        #: {"peak_blob_bytes", "total_blob_bytes", ...} of the most
        #: recent save_sharded on this manager, or None
        self.last_save_stats = None
        # every rank may write (replica shards), so every rank needs the
        # directory — on per-host disks each rank creates its own
        os.makedirs(self.directory, exist_ok=True)

    # -- paths ------------------------------------------------------------
    def _path(self, name):
        return os.path.join(self.directory, name)

    def symbol_path(self):
        return self._path("%s-symbol.json" % self.prefix)

    def params_path(self, epoch):
        return self._path("%s-%04d.params" % (self.prefix, epoch))

    def states_path(self, epoch):
        return self._path("%s-%04d.states" % (self.prefix, epoch))

    def shard_name(self, epoch, part, offset=0):
        """Basename of shard ``part``'s file for ``epoch`` — the primary
        (offset 0, written by rank ``part``) or the ring-offset replica
        (written by rank ``(part - offset) % world``)."""
        name = "%s-%04d.shard%03d" % (self.prefix, epoch, part)
        return name if offset == 0 else "%s.rep%d" % (name, offset)

    def shard_blob_name(self, epoch, shard, world):
        """Basename of sharded-native blob ``shard`` (of ``world``) for
        ``epoch`` — the ``params.s{K}-of-{W}`` layout."""
        return "%s-%04d.params.s%03d-of-%03d" % (
            self.prefix, int(epoch), int(shard), int(world))

    def shard_blob_path(self, epoch, shard, world):
        return self._path(self.shard_blob_name(epoch, shard, world))

    def _tombstone_path(self, epoch):
        return self._path("%s-%04d.pruning" % (self.prefix, int(epoch)))

    # -- manifest ---------------------------------------------------------
    def _scan_directory(self):
        """Rebuild a manifest by scanning the directory for this prefix's
        params files — the recovery path when ``manifest.json`` itself is
        corrupt (torn by a dying disk, truncated by an operator cp).  The
        params files are each atomic, so whatever the scan finds is
        individually complete; only step_state (mid-epoch metadata) and
        the per-file checksums are unrecoverable this way.  Epochs with a
        ``.pruning`` tombstone are IGNORED: retention had already
        committed to deleting them (the pruned manifest was written
        first), so a crash mid-prune must not resurrect them here.

        Sharded-native blobs (``params.s{K}-of-{W}``) are recognized
        too: a COMPLETE shard set (all W blobs) rebuilds a format-2
        entry — with no per-file digests, so the epoch is restorable
        but NOT promotable (``verify_promotion`` rejects unverifiable
        bytes); an incomplete set is skipped with a warning."""
        import re as _re
        pat = _re.compile(_re.escape(self.prefix) + r"-(\d{4,})\.params$")
        bpat = _re.compile(_re.escape(self.prefix) +
                           r"-(\d{4,})\.params\.s(\d{3})-of-(\d{3})$")
        entries = []
        blob_sets = {}  # (epoch, world) -> {shard: basename}
        try:
            names = os.listdir(self.directory)
        except OSError:
            names = []
        seen_epochs = set()
        for name in sorted(names):
            bm = bpat.match(name)
            if bm:
                blob_sets.setdefault(
                    (int(bm.group(1)), int(bm.group(3))),
                    {})[int(bm.group(2))] = name
                continue
            m = pat.match(name)
            if not m:
                continue
            epoch = int(m.group(1))
            if os.path.exists(self._tombstone_path(epoch)):
                _LOG.warning(
                    "CheckpointManager: directory scan ignoring epoch %d "
                    "— a retention tombstone marks it half-deleted", epoch)
                continue
            states = os.path.basename(self.states_path(epoch))
            entries.append({"epoch": epoch, "params": name,
                            "states": states if os.path.exists(
                                self._path(states)) else None})
            seen_epochs.add(epoch)
        for (epoch, world), shards in sorted(blob_sets.items()):
            if epoch in seen_epochs:
                continue  # a gathered params file already covers it
            if os.path.exists(self._tombstone_path(epoch)):
                _LOG.warning(
                    "CheckpointManager: directory scan ignoring sharded "
                    "epoch %d — a retention tombstone marks it "
                    "half-deleted", epoch)
                continue
            missing = [k for k in range(world) if k not in shards]
            if missing:
                _LOG.warning(
                    "CheckpointManager: directory scan skipping sharded "
                    "epoch %d — shard set incomplete (missing %s of %d)",
                    epoch, missing, world)
                continue
            entries.append({
                "epoch": epoch, "params": None, "states": None,
                "format": self.SHARDED_FORMAT,
                "shard_set": {"world": world,
                              "files": [{"shard": k, "file": shards[k]}
                                        for k in range(world)]}})
            seen_epochs.add(epoch)
        entries.sort(key=lambda e: int(e["epoch"]))
        return {"prefix": self.prefix, "checkpoints": entries}

    def _read_manifest(self):
        path = self._path(self.MANIFEST)
        try:
            with open(path) as f:
                return json.load(f)
        except ValueError:
            # corrupt manifest: fall back to the (atomic, individually
            # complete) params files on disk instead of reporting an
            # empty checkpoint directory
            _LOG.warning("CheckpointManager: manifest %r is corrupt — "
                         "recovering checkpoint list from a directory "
                         "scan", path)
            manifest = self._scan_directory()
            # repair in place (rank 0, best-effort) so a restore-only run
            # doesn't rescan + re-warn on every read and the next reader
            # finds a healthy manifest
            if _rank() == 0:
                try:
                    self._write_manifest(manifest)
                except OSError:  # pragma: no cover — read-only dir
                    pass
            return manifest
        except OSError:
            return {"prefix": self.prefix, "checkpoints": []}

    def _write_manifest(self, manifest):
        atomic_write(self._path(self.MANIFEST),
                     json.dumps(manifest, indent=2, sort_keys=True),
                     fault_point="manifest_write")

    def checkpoints(self):
        """Epochs recorded in the manifest whose params file exists (or
        that carry shard records — replication OR a sharded-native
        shard set — so a missing primary can still be rebuilt),
        ascending."""
        out = []
        for entry in self._read_manifest().get("checkpoints", []):
            epoch = int(entry["epoch"])
            if os.path.exists(self.params_path(epoch)) or \
                    entry.get("shards") or entry.get("shard_set"):
                out.append(epoch)
        return sorted(out)

    def latest(self):
        """The newest complete checkpoint's epoch, or None."""
        epochs = self.checkpoints()
        return epochs[-1] if epochs else None

    def entry(self, epoch):
        """The manifest entry (dict) for ``epoch``, or None.  Mid-epoch
        (preemption) checkpoints carry a ``step_state`` key: epoch index,
        batches consumed, and the RNG state to resume from."""
        for e in self._read_manifest().get("checkpoints", []):
            if int(e["epoch"]) == int(epoch):
                return e
        return None

    def latest_entry(self):
        """The newest complete checkpoint's manifest entry, or None."""
        epoch = self.latest()
        return None if epoch is None else self.entry(epoch)

    def plan(self, epoch=None):
        """The sharding-plan doc persisted with ``epoch`` (default: the
        newest checkpoint), or None — what mesh/strategy wrote the
        bytes (``parallel/planner.py``; ``SPMDTrainer.restore`` reads
        it for its elastic-resume logging, ``tools/plan_explain.py``
        and ``ckpt_fsck --devices`` gate on it)."""
        if epoch is None:
            epoch = self.latest()
            if epoch is None:
                return None
        entry = self.entry(epoch)
        return None if entry is None else entry.get("plan")

    # -- save -------------------------------------------------------------
    def save(self, epoch, symbol=None, arg_params=None, aux_params=None,
             optimizer_states=None, step_state=None, blocking=None,
             rank=None, world=None, plan=None):
        """Write one checkpoint atomically; returns the epoch.

        ``plan`` (JSON-serializable dict) is a sharding-plan doc
        (``parallel/planner.py``) persisted verbatim in the manifest
        entry — the elastic-resume record of what mesh/strategy wrote
        these bytes; read back with :meth:`plan`,
        ``tools/plan_explain.py`` and ``tools/ckpt_fsck.py --devices``.

        ``optimizer_states`` is the serialized blob (bytes) from
        ``Module.get_optimizer_states()`` / ``Updater.get_states()``.
        ``step_state`` (JSON-serializable dict) marks a MID-EPOCH
        checkpoint: ``fit`` stores ``{"epoch": epoch_index, "step":
        batches_consumed, "rng": random.get_state()}`` so a resumed run
        can fast-forward the iterator and continue the RNG stream; the
        epoch-end save of the same epoch number later replaces the entry
        (and clears the flag) — partial checkpoints never outlive the
        complete epoch they belong to.

        ``blocking=False`` (default: ``MXTPU_CKPT_ASYNC``) returns after
        snapshotting the values to host numpy copies; this manager's
        :class:`CheckpointWriter` then serializes, writes atomically and
        updates the manifest in the background — call :meth:`wait` to
        drain (``fit`` drains at the end of training and before a
        preemption exit).

        On ranks != 0 this writes only replica shards (nothing when
        ``MXTPU_CKPT_REPLICAS`` is 0) — gather on every rank before
        calling (see class docstring).  ``rank``/``world`` are
        injectable for single-process replication tests.
        """
        from .base import get_env
        epoch = int(epoch)
        rank = _rank() if rank is None else int(rank)
        world = _world() if world is None else int(world)
        raw_replicas = get_env(ENV_CKPT_REPLICAS, "0")
        try:
            replicas = int(raw_replicas or 0)
        except (TypeError, ValueError):
            # an operator typo must degrade (like MXTPU_CKPT_CHECKSUM's
            # fallback), not crash every epoch-end save
            _LOG.warning("%s=%r is not an integer — replication disabled",
                         ENV_CKPT_REPLICAS, raw_replicas)
            replicas = 0
        replicas = min(max(0, replicas), max(0, world - 1))
        if rank != 0 and replicas <= 0:
            return epoch
        if blocking is None:
            blocking = not checkpoint_async()
        sym_json = symbol if isinstance(symbol, str) or symbol is None \
            else symbol.tojson()
        if not blocking:
            # the ONLY synchronous cost of an async save: freeze the
            # values while training keeps mutating device/host params
            arg_params = snapshot_params(arg_params)
            aux_params = snapshot_params(aux_params)
        step_state = dict(step_state) if step_state is not None else None
        plan = dict(plan) if plan is not None else None

        def job():
            self._write_checkpoint(epoch, sym_json, arg_params or {},
                                   aux_params or {}, optimizer_states,
                                   step_state, rank, world, replicas,
                                   plan=plan)

        if blocking:
            if self._writer is not None:
                # an in-flight async write and this caller-thread write
                # would both read-modify-write manifest.json (one
                # epoch's entry silently lost, and racing prunes could
                # delete files the other just recorded) — drain first.
                # Bounded: on wedged storage a durable save degrades to
                # the pre-drain behavior instead of hanging forever
                # (the wedged writer is stalled pre-manifest anyway).
                try:
                    self._writer.wait(timeout=self.DRAIN_TIMEOUT)
                except MXNetError as e:
                    _LOG.warning(
                        "CheckpointManager: draining the async writer "
                        "before a blocking save: %s — proceeding (this "
                        "blocking save supersedes it)", e)
            job()
        else:
            if self._writer is None:
                self._writer = CheckpointWriter(
                    name="mxtpu-ckpt-writer[%s]" % self.prefix)
            self._writer.submit(job, "epoch %d" % epoch)
        return epoch

    def save_sharded(self, epoch, symbol=None, shard_payloads=None,
                     world=None, step_state=None, plan=None, rank=None):
        """Sharded-native save: write one verified blob PER SHARD, no
        host-side gather; returns the epoch.

        ``shard_payloads(k)`` -> the serialized bytes of shard ``k``
        (or None when this rank does not hold it).  It is called one
        shard at a time and each blob is released before the next is
        built, so peak host bytes stay O(P/world)
        (:attr:`last_save_stats` records the peaks).

        The manifest entry is format 2: ``shard_set`` lists every
        blob's shard index, size and digest (the same records also land
        in ``files`` so the generic verification paths cover them), and
        ``params``/``states`` are None — parameters AND optimizer
        state live inside the blobs.  ``restore()`` verifies shard-set
        completeness + every digest BEFORE deserializing and assembles
        the full arrays; any damaged blob fails the whole epoch (walk
        back, never a mixed-epoch assembly).

        Sharded saves are BLOCKING by design: the payload callable
        reads live device tensors lazily, which the background writer
        must never race against a training step.

        Multi-process: every rank writes the blobs it holds; rank != 0
        returns without publishing.  Publishing rank 0 digests blobs
        from the (shared) filesystem, so callers must barrier between
        the peer writes and rank 0's ``save_sharded`` — single-process
        multi-device runs (one rank holds every shard) need none."""
        epoch = int(epoch)
        world = int(world or 0)
        rank = _rank() if rank is None else int(rank)
        if world < 1 or shard_payloads is None:
            raise MXNetError(
                "save_sharded needs world >= 1 and a shard_payloads "
                "callable (got world=%r)" % world)
        sym_json = symbol if isinstance(symbol, str) or symbol is None \
            else symbol.tojson()
        if self._writer is not None:
            # same manifest read-modify-write hazard as a blocking
            # save(): drain any in-flight async write first (bounded)
            try:
                self._writer.wait(timeout=self.DRAIN_TIMEOUT)
            except MXNetError as e:
                _LOG.warning(
                    "CheckpointManager: draining the async writer before "
                    "a sharded save: %s — proceeding", e)
        algo = _checksum_algo()
        try:
            os.remove(self._tombstone_path(epoch))
        except OSError:
            pass
        peak = total = 0
        for k in range(world):
            blob = shard_payloads(k)
            if blob is None:
                continue  # a peer rank holds (and writes) this shard
            # the SIGKILL-mid-shard-write window: earlier blobs are on
            # disk, the manifest is not — the chaos drill wedges here
            # (arm_hang) and kills the trainer with a partial shard set
            faults.maybe_trip(
                "shard_write",
                "injected failure before writing shard %d/%d of epoch "
                "%d" % (k, world, epoch))
            atomic_write(self.shard_blob_path(epoch, k, world), blob,
                         fault_point="shard_write")
            peak = max(peak, len(blob))
            total += len(blob)
            del blob  # one shard resident at a time: peak host O(P/w)
        self.last_save_stats = {"epoch": epoch, "world": world,
                                "peak_blob_bytes": peak,
                                "total_blob_bytes": total}
        if rank != 0:
            return epoch
        files = {}
        shard_files = []
        for k in range(world):
            path = self.shard_blob_path(epoch, k, world)
            name = os.path.basename(path)
            if not os.path.exists(path):
                raise MXNetError(
                    "save_sharded: shard %d/%d of epoch %d is not on "
                    "disk — every shard must be written (and peer "
                    "writes barriered) before rank 0 publishes"
                    % (k, world, epoch))
            rec = self._file_record(path, algo)
            files[name] = rec
            shard_files.append({"shard": k, "file": name,
                                "size": rec["size"],
                                "digest": rec["digest"]})
        if sym_json is not None:
            atomic_write(self.symbol_path(), sym_json)
            sym_name = os.path.basename(self.symbol_path())
            files[sym_name] = self._file_record(self.symbol_path(), algo)
        # the classic SIGKILL-mid-save window: all blobs on disk, the
        # manifest not — same point name as the gathered pipeline so
        # existing drills/docs cover both
        faults.maybe_trip("ckpt_write",
                          "injected checkpoint-writer failure before "
                          "publishing epoch %d" % epoch)
        entry = {"epoch": epoch,
                 "format": self.SHARDED_FORMAT,
                 "params": None,
                 "states": None,
                 "time": time.time(),
                 "checksum": algo,
                 "files": files,
                 "shard_set": {"world": world, "files": shard_files}}
        if step_state is not None:
            entry["step_state"] = dict(step_state)
        if plan is not None:
            entry["plan"] = dict(plan)
        # the generic promote-drill points stay meaningful under the
        # sharded layout: "the params artifact" of a format-2 entry is
        # its blob set, so rot/truncate_checkpoint damage blob 0
        if faults.consume("rot_checkpoint"):
            _damage_file(self.shard_blob_path(epoch, 0, world),
                         truncate=False)
        if faults.consume("truncate_checkpoint"):
            _damage_file(self.shard_blob_path(epoch, 0, world),
                         truncate=True)
        # promote-path chaos points, one consume PER SHARD in index
        # order — arm(point, times=1, after=k) targets exactly blob k.
        # The manifest vouches for the intact bytes: the verification
        # layer, not the filesystem, must catch it.  As above, the damage
        # lands before the entry is published.
        for k in range(world):
            path = self.shard_blob_path(epoch, k, world)
            if faults.consume("rot_shard"):
                _damage_file(path, truncate=False)
            if faults.consume("truncate_shard"):
                _damage_file(path, truncate=True)
            if faults.consume("drop_shard"):
                try:
                    os.remove(path)
                    _LOG.warning(
                        "fault injection: deleted shard blob %r under "
                        "its manifest entry", path)
                except OSError:  # pragma: no cover — injection only
                    pass
        self._update_manifest(entry)
        _LOG.info("CheckpointManager: saved epoch %d as %d sharded "
                  "blob(s) (peak host %d bytes of %d total)",
                  epoch, world, peak, total)
        return epoch

    def wait(self, timeout=None):
        """Drain this manager's background writer (no-op when every save
        so far was blocking).  Re-raises a failed background write."""
        if self._writer is None:
            return None
        return self._writer.wait(timeout)

    def last_result(self):
        """{"label", "error", "elapsed_s"} of the most recently finished
        background write, or None."""
        if self._writer is None:
            return None
        return self._writer.last_result()

    def _write_checkpoint(self, epoch, sym_json, arg_params, aux_params,
                          optimizer_states, step_state, rank, world,
                          replicas, plan=None):
        """The write pipeline (caller thread when blocking, writer thread
        when async): files -> ``ckpt_write`` fault point -> manifest."""
        algo = _checksum_algo()
        # a stale tombstone from an interrupted prune must not hide the
        # epoch this save is about to (re)write
        try:
            os.remove(self._tombstone_path(epoch))
        except OSError:
            pass
        parts = None
        if world > 1 and replicas > 0:
            need = None if rank == 0 else \
                {(rank + o) % world for o in range(replicas + 1)}
            parts = self._shard_parts(epoch, arg_params, aux_params,
                                      optimizer_states, world, need=need)
        if rank != 0:
            self._write_shards(epoch, parts, rank, world, replicas)
            # rank 0's manifest-driven retention never touches THIS
            # host's directory on per-host disks, so every shard writer
            # prunes its own view (harmless on a shared disk: it
            # removes the same files rank 0 would)
            self._prune_local_shards()
            return
        files = {}
        # one serialization contract: the classic prefix-based writer (made
        # atomic in this same subsystem) produces exactly this manager's
        # params/symbol layout, so files stay loadable by load_checkpoint
        from .model import save_checkpoint as _save_checkpoint
        _save_checkpoint(os.path.join(self.directory, self.prefix), epoch,
                         sym_json, arg_params, aux_params, blocking=True)
        params_name = os.path.basename(self.params_path(epoch))
        files[params_name] = self._file_record(self.params_path(epoch),
                                               algo)
        if sym_json is not None:
            sym_name = os.path.basename(self.symbol_path())
            files[sym_name] = self._file_record(self.symbol_path(), algo)
        has_states = optimizer_states is not None
        if has_states:
            atomic_write(self.states_path(epoch), optimizer_states)
            states_name = os.path.basename(self.states_path(epoch))
            files[states_name] = self._file_record(self.states_path(epoch),
                                                   algo)
        shard_meta = None
        if parts is not None:
            self._write_shards(epoch, parts, 0, world, replicas)
            shard_meta = {"world": world, "replicas": replicas,
                          "parts": []}
            for p in range(world):
                size, digest = checksum_bytes(parts[p], algo)
                shard_meta["parts"].append({
                    "shard": p,
                    "file": self.shard_name(epoch, p),
                    "size": size, "digest": digest,
                    "replicas": [self.shard_name(epoch, p, o)
                                 for o in range(1, replicas + 1)]})
        # the SIGKILL-mid-save window: all data files are on disk, the
        # manifest is not — a kill here must leave the previous epoch as
        # the newest RESTORABLE checkpoint (chaos drill)
        faults.maybe_trip("ckpt_write",
                          "injected checkpoint-writer failure before "
                          "publishing epoch %d" % epoch)
        entry = {"epoch": epoch,
                 "params": params_name,
                 "states": (os.path.basename(self.states_path(epoch))
                            if has_states else None),
                 "time": time.time(),
                 "checksum": algo,
                 "files": files}
        if shard_meta is not None:
            entry["shards"] = shard_meta
        if step_state is not None:
            entry["step_state"] = step_state
        if plan is not None:
            entry["plan"] = plan
        # promote-path chaos points: the manifest vouches for bytes the
        # params file no longer holds — exactly the bit-rot / torn-copy
        # shape the digest verification (verify_promotion, restore)
        # exists to catch.  A consumer that trusts the manifest entry
        # without re-verifying the bytes would walk straight onto them.
        # The damage lands before the entry is published (it records the
        # intact bytes), so no reader sees the publish undamaged: a
        # watcher verifying between the two would pass it, and its
        # replicas would then refuse it
        if faults.consume("rot_checkpoint"):
            _damage_file(self.params_path(epoch), truncate=False)
        if faults.consume("truncate_checkpoint"):
            _damage_file(self.params_path(epoch), truncate=True)
        self._update_manifest(entry)
        _LOG.info("CheckpointManager: saved epoch %d to %s", epoch,
                  self.params_path(epoch))

    @staticmethod
    def _file_record(path, algo):
        size, digest = checksum_file(path, algo)
        return {"size": size, "digest": digest}

    def _update_manifest(self, entry):
        """Publish ``entry`` and apply ``keep_last`` retention, hardened
        against a crash mid-prune: tombstones mark the condemned epochs,
        the PRUNED manifest is written before any file is deleted, and
        the directory entry is fsynced after the deletes — so no crash
        window can resurrect a pruned epoch (via the manifest, which no
        longer lists it, or via the corrupt-manifest directory scan,
        which skips tombstoned epochs)."""
        manifest = self._read_manifest()
        entries = [e for e in manifest.get("checkpoints", [])
                   if int(e["epoch"]) != int(entry["epoch"])]
        sym_name = os.path.basename(self.symbol_path())
        if sym_name in (entry.get("files") or {}):
            # the symbol file is SHARED and rewritten by every save —
            # this save's record is the only one that describes the
            # bytes now on disk, so older entries must stop vouching
            # for it (an equivalent re-created Symbol can serialize
            # with different auto-generated names)
            for e in entries:
                (e.get("files") or {}).pop(sym_name, None)
        entries.append(entry)
        entries.sort(key=lambda e: int(e["epoch"]))
        stale = []
        if self.keep_last is not None and len(entries) > self.keep_last:
            stale = entries[:-self.keep_last]
            entries = entries[-self.keep_last:]
        for e in stale:
            atomic_write(self._tombstone_path(e["epoch"]),
                         json.dumps({"epoch": int(e["epoch"])}),
                         fault_point="tombstone_write")
        manifest["prefix"] = self.prefix
        manifest["checkpoints"] = entries
        self._write_manifest(manifest)
        # crash window for the retention regression test: manifest is
        # already pruned, tombstones exist, files not yet deleted
        faults.maybe_fail("ckpt_prune",
                          "injected crash between manifest prune and "
                          "file deletion")
        for e in stale:
            self._delete_entry_files(e)
        self._finish_pending_prunes({int(e["epoch"]) for e in entries})
        _fsync_dir(self._path(self.MANIFEST))

    def _delete_entry_files(self, entry):
        """Remove one pruned epoch's files, then its tombstone."""
        epoch = int(entry["epoch"])
        paths = [self.params_path(epoch), self.states_path(epoch)]
        shards = entry.get("shards") or {}
        for part in shards.get("parts", []):
            paths.append(self._path(part["file"]))
            paths.extend(self._path(f) for f in part.get("replicas", []))
        for rec in (entry.get("shard_set") or {}).get("files", []):
            paths.append(self._path(rec["file"]))
        for path in paths:
            try:
                os.remove(path)
            except OSError:
                pass
        try:
            os.remove(self._tombstone_path(epoch))
        except OSError:
            pass

    def _finish_pending_prunes(self, live_epochs):
        """Complete prunes an earlier crash interrupted: any lingering
        tombstone for a non-live epoch gets its files deleted now; a
        tombstone for a live epoch (a prune that never committed its
        manifest) is simply cleared."""
        import re as _re
        pat = _re.compile(_re.escape(self.prefix) + r"-(\d{4,})\.pruning$")
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            m = pat.match(name)
            if not m:
                continue
            epoch = int(m.group(1))
            if epoch in live_epochs:
                try:
                    os.remove(self._path(name))
                except OSError:
                    pass
                continue
            _LOG.info("CheckpointManager: completing interrupted prune of "
                      "epoch %d", epoch)
            entry = self.entry(epoch) or {"epoch": epoch}
            self._delete_entry_files(entry)
            # shard files an old manifest no longer names (replication
            # shards and sharded-native blobs alike)
            stems = ("%s-%04d.shard" % (self.prefix, epoch),
                     "%s-%04d.params.s" % (self.prefix, epoch))
            for other in names:
                if other.startswith(stems):
                    try:
                        os.remove(self._path(other))
                    except OSError:
                        pass

    def _prune_local_shards(self):
        """``keep_last`` retention over the shard files in THIS host's
        directory — the counterpart of rank 0's manifest-driven pruning
        for ranks that write only replica shards: keep the newest
        ``keep_last`` shard-bearing epochs, delete everything older."""
        if self.keep_last is None:
            return
        import re as _re
        pat = _re.compile(_re.escape(self.prefix) +
                          r"-(\d{4,})\.shard\d{3}(\.rep\d+)?$")
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        by_epoch = {}
        for name in names:
            m = pat.match(name)
            if m:
                by_epoch.setdefault(int(m.group(1)), []).append(name)
        live = set(sorted(by_epoch)[-self.keep_last:])
        for ep, files in by_epoch.items():
            if ep in live:
                continue
            for name in files:
                try:
                    os.remove(self._path(name))
                except OSError:
                    pass

    # -- replication shards ------------------------------------------------
    def _shard_parts(self, epoch, arg_params, aux_params, states, world,
                     need=None):
        """Serialize the gathered state into deterministic key-partition
        shards (round-robin over sorted names; the states blob is split
        into contiguous byte ranges) -> ``{part_index: bytes}``.
        Deterministic by construction — every rank computes
        byte-identical parts from its replicated copy, so rank 0 can
        record all digests without reading peer disks.  ``need`` limits
        which partitions are built (a non-zero rank writes only its own
        shard + ``replicas`` neighbors; pickling all ``world`` parts
        there would be O(world) redundant CPU per save); None = all."""
        import pickle
        import numpy as np
        merged = {}
        for k, v in (arg_params or {}).items():
            merged["arg:%s" % k] = np.ascontiguousarray(_host_value(v))
        for k, v in (aux_params or {}).items():
            merged["aux:%s" % k] = np.ascontiguousarray(_host_value(v))
        keys = sorted(merged)
        parts = {}
        for p in range(world) if need is None else sorted(need):
            part_keys = {k: merged[k] for i, k in enumerate(keys)
                         if i % world == p}
            chunk = None
            if states is not None:
                n = len(states)
                chunk = states[p * n // world:(p + 1) * n // world]
            parts[p] = pickle.dumps(
                {"epoch": int(epoch), "shard": p, "world": world,
                 "keys": part_keys, "states_chunk": chunk},
                protocol=4)
        return parts

    def _write_shards(self, epoch, parts, rank, world, replicas):
        """Rank ``rank``'s shard writes: its own partition (offset 0)
        plus its ring neighbors' partitions at offsets 1..replicas —
        shard p's offset-o replica is written by rank (p - o) % world,
        so losing any one rank's disk leaves every partition
        recoverable."""
        for o in range(0, replicas + 1):
            p = (rank + o) % world
            atomic_write(self._path(self.shard_name(epoch, p, o)),
                         parts[p], fault_point="shard_write")

    # -- restore -----------------------------------------------------------
    def restore(self, epoch=None):
        """Load (symbol, arg_params, aux_params, optimizer_states, epoch)
        for ``epoch`` (default: latest).  ``symbol`` is None when no
        symbol file was saved; ``optimizer_states`` is the bytes blob or
        None.  With no explicit epoch, a checkpoint whose files turn out
        corrupt (bit rot, torn by a non-atomic copy) is skipped with a
        warning and the previous intact one loads instead — a damaged
        newest checkpoint must degrade the resume by one epoch, not kill
        it.  Raises MXNetError when nothing restorable exists."""
        if epoch is not None:
            return self._restore_epoch(int(epoch))
        epochs = self.checkpoints()
        if not epochs:
            raise MXNetError("CheckpointManager: no checkpoint in %r"
                             % self.directory)
        last_err = None
        for e in reversed(epochs):
            try:
                return self._restore_epoch(e)
            except Exception as err:  # noqa: BLE001 — walk back past rot
                last_err = err
                _LOG.warning(
                    "CheckpointManager: checkpoint epoch %d is unreadable "
                    "(%s: %s) — falling back to the previous one",
                    e, type(err).__name__, err)
        raise MXNetError("CheckpointManager: every checkpoint in %r is "
                         "unreadable (last: %s)"
                         % (self.directory, last_err)) from last_err

    def _verify_files(self, entry, names):
        """Check size + checksum of ``names`` (basenames with records in
        the entry) BEFORE any deserialization — bit rot that would still
        unpickle cleanly must be caught here, not restored silently.
        Raises MXNetError naming the first damaged file."""
        algo = entry.get("checksum")
        files = entry.get("files") or {}
        for name in names:
            rec = files.get(name)
            if rec is None:
                continue  # legacy entry without integrity records
            path = self._path(name)
            if not os.path.exists(path):
                raise MXNetError("checkpoint file %r is missing" % name)
            if not algo or algo == "off" or not rec.get("digest"):
                if os.path.getsize(path) != rec["size"]:
                    raise MXNetError(
                        "checkpoint file %r is %d bytes, manifest "
                        "recorded %d" % (name, os.path.getsize(path),
                                         rec["size"]))
                continue
            size, digest = checksum_file(path, algo)
            if size != rec["size"] or digest != rec["digest"]:
                raise MXNetError(
                    "checkpoint file %r fails verification (%s: got "
                    "%s/%d bytes, manifest recorded %s/%d bytes)"
                    % (name, algo, digest, size, rec["digest"],
                       rec["size"]))

    def _restore_from_shards(self, epoch, entry):
        """Rebuild (arg_params, aux_params, states) from the replicated
        key-partition shards — each partition from its primary file, or
        from the first intact peer replica when the primary is missing
        or fails its checksum.  Raises when any partition has no intact
        copy (the walk-back then degrades to the previous epoch)."""
        import pickle
        algo = entry.get("checksum")
        shards = entry["shards"]
        merged, chunks = {}, {}
        for part in shards.get("parts", []):
            payload = None
            for fname in [part["file"]] + list(part.get("replicas", [])):
                path = self._path(fname)
                if not os.path.exists(path):
                    continue
                if algo and algo != "off" and part.get("digest"):
                    size, digest = checksum_file(path, algo)
                    if size != part["size"] or digest != part["digest"]:
                        _LOG.warning(
                            "CheckpointManager: shard copy %r fails "
                            "verification — trying the next replica",
                            fname)
                        continue
                # deserialization must also fall through to the next
                # replica: with checksums off (or a legacy record with
                # no digest) a truncated/corrupt copy surfaces HERE,
                # and an intact peer replica may still hold the shard
                try:
                    with open(path, "rb") as f:
                        candidate = pickle.loads(f.read())
                    if not isinstance(candidate.get("keys"), dict):
                        raise ValueError("not a shard payload")
                except Exception as e:  # noqa: BLE001 — any rot flavor
                    _LOG.warning(
                        "CheckpointManager: shard copy %r is unreadable "
                        "(%s: %s) — trying the next replica",
                        fname, type(e).__name__, e)
                    continue
                payload = candidate
                if fname != part["file"]:
                    _LOG.warning(
                        "CheckpointManager: shard %d of epoch %d "
                        "recovered from peer replica %r",
                        part["shard"], epoch, fname)
                break
            if payload is None:
                raise MXNetError(
                    "shard %d of epoch %d has no intact copy (primary "
                    "or replica)" % (part["shard"], epoch))
            merged.update(payload["keys"])
            if payload.get("states_chunk") is not None:
                chunks[payload["shard"]] = payload["states_chunk"]
        arg_params, aux_params = {}, {}
        for k, v in merged.items():
            tp, name = k.split(":", 1)
            if tp == "arg":
                arg_params[name] = _host_nd(v)
            elif tp == "aux":
                aux_params[name] = _host_nd(v)
        states = b"".join(chunks[i] for i in sorted(chunks)) \
            if chunks else None
        return arg_params, aux_params, states

    def _restore_sharded(self, epoch, entry):
        """Assemble a format-2 (sharded-native) checkpoint: verify the
        COMPLETE shard set (every blob present, every recorded digest
        intact) BEFORE a byte deserializes, then concatenate each
        parameter's per-shard slices along its recorded dim.  Any
        problem raises — ``restore()``'s walk-back then lands on the
        last complete verified epoch.  Blobs additionally self-identify
        (epoch/shard/world inside the payload), so even a scan-rebuilt
        entry with no digests can never assemble a mixed-epoch
        Frankenstein."""
        import pickle
        import numpy as np
        ss = entry["shard_set"]
        world = int(ss.get("world", 0))
        recs = {}
        for rec in ss.get("files", []):
            recs[int(rec.get("shard", -1))] = rec
        missing = [k for k in range(world) if k not in recs]
        if world < 1 or missing:
            raise MXNetError(
                "epoch %d shard set is incomplete (world=%d, missing "
                "shard record(s) %s)" % (epoch, world, missing or "all"))
        names = [recs[k]["file"] for k in range(world)]
        for name in names:
            if not os.path.exists(self._path(name)):
                raise MXNetError("checkpoint shard %r is missing" % name)
        # digest/size verification for every blob with a record (a
        # scan-rebuilt entry has none — existence checked above, and
        # the payload identity check below still refuses mixed epochs)
        self._verify_files(entry, names)
        dims, aux, parts_a, parts_o = {}, {}, {}, {}
        num_update = None
        for k in range(world):
            with open(self._path(recs[k]["file"]), "rb") as f:
                try:
                    payload = pickle.loads(f.read())
                except Exception as e:  # noqa: BLE001 — any rot flavor
                    raise MXNetError(
                        "checkpoint shard %r is unreadable (%s: %s)"
                        % (recs[k]["file"], type(e).__name__, e))
            if not isinstance(payload, dict) or \
                    int(payload.get("epoch", -1)) != int(epoch) or \
                    int(payload.get("world", -1)) != world or \
                    int(payload.get("shard", -1)) != k:
                raise MXNetError(
                    "shard blob %r does not belong to epoch %d shard "
                    "%d-of-%d (payload says epoch=%s shard=%s-of-%s) — "
                    "refusing a mixed-epoch assembly"
                    % (recs[k]["file"], epoch, k, world,
                       payload.get("epoch"), payload.get("shard"),
                       payload.get("world")))
            dims.update(payload.get("dims") or {})
            for n, v in (payload.get("args") or {}).items():
                parts_a.setdefault(n, {})[k] = v
            for n, s in (payload.get("opt") or {}).items():
                parts_o.setdefault(n, {})[k] = tuple(s)
            if k == 0:
                aux = dict(payload.get("aux") or {})
                num_update = payload.get("num_update")

        def _assemble(name, by_shard):
            d = dims.get(name)
            if d is None:
                return np.asarray(by_shard[0])
            absent = sorted(set(range(world)) - set(by_shard))
            if absent:
                raise MXNetError(
                    "parameter %r of epoch %d is missing shard "
                    "slice(s) %s" % (name, epoch, absent))
            return np.concatenate(
                [np.asarray(by_shard[k]) for k in range(world)], axis=d)

        arg_params = {n: _host_nd(_assemble(n, by))
                      for n, by in parts_a.items()}
        aux_params = {n: _host_nd(v) for n, v in aux.items()}
        states = None
        if parts_o or num_update is not None:
            opt = {}
            for n, by in parts_o.items():
                nslots = len(by[min(by)])
                opt[n] = tuple(
                    _assemble(n, {k: s[i] for k, s in by.items()})
                    for i in range(nslots))
            states = pickle.dumps(
                {"num_update": int(num_update or 0), "states": opt})
        return arg_params, aux_params, states

    def _symbol_entry(self):
        """The newest manifest entry carrying the shared symbol file's
        integrity record — the only entry that describes the bytes now
        on disk (every save rewrites the file, and _update_manifest
        moves the record to the writing entry)."""
        sym_name = os.path.basename(self.symbol_path())
        for e in reversed(self._read_manifest().get("checkpoints", [])):
            if sym_name in (e.get("files") or {}):
                return e
        return None

    def _restore_epoch(self, epoch):
        from . import ndarray as nd
        from . import symbol as sym_mod
        entry = self.entry(epoch) or {}
        # the symbol file is SHARED and has no shard redundancy, so it
        # is verified against the newest record REGARDLESS of which
        # epoch is being restored (older entries stopped vouching for
        # it) — a damaged symbol must fail every epoch and surface,
        # never ride a walk-back into an epoch with no record
        if os.path.exists(self.symbol_path()):
            sym_entry = self._symbol_entry()
            if sym_entry is not None:
                self._verify_files(
                    sym_entry, [os.path.basename(self.symbol_path())])
        symbol = None
        if os.path.exists(self.symbol_path()):
            symbol = sym_mod.load(self.symbol_path())
        if entry.get("shard_set"):
            arg_params, aux_params, states = \
                self._restore_sharded(epoch, entry)
            return symbol, arg_params, aux_params, states, epoch
        params_file = self.params_path(epoch)
        use_shards = False
        try:
            if not os.path.exists(params_file):
                raise MXNetError("CheckpointManager: epoch %d has no "
                                 "params file %r" % (epoch, params_file))
            self._verify_files(
                entry, [os.path.basename(params_file),
                        os.path.basename(self.states_path(epoch))])
        except MXNetError as e:
            if not entry.get("shards"):
                raise
            _LOG.warning(
                "CheckpointManager: epoch %d primary files failed "
                "verification (%s) — rebuilding from shard replicas",
                epoch, e)
            use_shards = True
        if use_shards:
            arg_params, aux_params, states = \
                self._restore_from_shards(epoch, entry)
            return symbol, arg_params, aux_params, states, epoch
        arg_params, aux_params = {}, {}
        for k, v in nd.load(params_file).items():
            tp, name = k.split(":", 1)
            if tp == "arg":
                arg_params[name] = v
            elif tp == "aux":
                aux_params[name] = v
        states = None
        if os.path.exists(self.states_path(epoch)):
            with open(self.states_path(epoch), "rb") as f:
                states = f.read()
        return symbol, arg_params, aux_params, states, epoch


def _host_nd(value):
    """A host NDArray holding a copy of the numpy ``value``, its dtype
    kept (restored checkpoints land on the host, as ``nd.load`` puts
    them)."""
    import numpy as np
    from .context import cpu
    from .ndarray import NDArray, tensor_from_numpy
    return NDArray._from_torch(tensor_from_numpy(np.asarray(value)), cpu())


def _damage_file(path, truncate):
    """Deterministically damage an on-disk file (the ``rot_checkpoint``
    / ``truncate_checkpoint`` fault points): flip one mid-file byte, or
    cut the file to half its length, before the manifest entry that
    records its intact bytes is published.  Both leave that record
    stale — the verification layer, not the filesystem, must catch it."""
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            if truncate:
                f.truncate(max(0, size // 2))
            else:
                f.seek(size // 2)
                b = f.read(1) or b"\x00"
                f.seek(size // 2)
                f.write(bytes([b[0] ^ 0xFF]))
        _LOG.warning("fault injection: %s %r under its manifest entry",
                     "truncated" if truncate else "rotted one byte of",
                     path)
    except OSError as e:  # pragma: no cover — injection plumbing only
        _LOG.warning("fault injection: could not damage %r (%s)", path, e)


# ---------------------------------------------------------------------------
# the promote gate (shared by serving/deploy.py and tools/ckpt_fsck.py)
# ---------------------------------------------------------------------------

def verify_promotion(directory, epoch=None, prefix="checkpoint"):
    """THE promote-path health check: verify every file ``epoch`` needs
    (params, optimizer states, the shared symbol file) against the
    manifest's recorded size + digest BEFORE anything deserializes a
    byte.  Returns ``(epoch, problems)`` — an empty ``problems`` list
    means the epoch is safe to load; anything else means KEEP SERVING
    THE CURRENT EPOCH (this check never walks back: a damaged newest
    epoch is a rejection, not an invitation to guess).

    This is the ONE definition of "healthy enough to promote":
    ``serving.deploy.CheckpointWatcher`` gates every hot swap on it,
    ``fleet.deploy.RollingSwap`` gates every rollout on it, and
    ``tools/ckpt_fsck.py --watch/--promote-gate`` reports with it — the
    three must never drift on what they accept.

    ``epoch=None`` checks the manifest's newest checkpoint.  An entry
    with no integrity records (pre-integrity-layer, or a manifest
    rebuilt by the corrupt-manifest directory scan) is REJECTED:
    unverifiable bytes must not ride a promote path, even though
    ``restore()`` would tolerantly load them.

    Sharded-native (format-2) entries verify their SHARD SET instead
    of a params file: every shard index 0..world-1 must carry a record,
    and every blob must match its size + digest — a half-written
    publish or a single rotted shard rejects the whole epoch before
    anything deserializes."""
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return None, ["not a checkpoint directory: %r" % directory]
    man = CheckpointManager(directory, prefix=prefix, keep_last=None)
    if epoch is None:
        epoch = man.latest()
        if epoch is None:
            return None, ["no checkpoint in %r" % directory]
    epoch = int(epoch)
    entry = man.entry(epoch)
    if entry is None:
        return epoch, ["epoch %d is not in the manifest" % epoch]
    problems = []
    files = entry.get("files") or {}
    shard_set = entry.get("shard_set")
    if shard_set:
        world = int(shard_set.get("world", 0))
        recs = {}
        for rec in shard_set.get("files", []):
            recs[int(rec.get("shard", -1))] = rec
        missing = [k for k in range(world) if k not in recs]
        if world < 1 or missing:
            problems.append(
                "epoch %d shard set is incomplete (world=%d, missing "
                "shard record(s) %s) — not promotable"
                % (epoch, world, missing or "all"))
        names = [recs[k]["file"] for k in sorted(recs)]
    else:
        names = [os.path.basename(man.params_path(epoch))]
        if entry.get("states"):
            names.append(os.path.basename(man.states_path(epoch)))
    for name in names:
        if name not in files:
            problems.append("%s: no integrity record in the manifest "
                            "(unverifiable — not promotable)" % name)
            continue
        try:
            man._verify_files(entry, [name])
        except MXNetError as e:
            problems.append(str(e))
    # the symbol file is shared and vouched for by the NEWEST entry
    # that rewrote it (see CheckpointManager._update_manifest)
    if os.path.exists(man.symbol_path()):
        sym_entry = man._symbol_entry()
        if sym_entry is not None:
            try:
                man._verify_files(
                    sym_entry, [os.path.basename(man.symbol_path())])
            except MXNetError as e:
                problems.append(str(e))
    return epoch, problems


def publish_mark(directory, epoch, prefix="checkpoint"):
    """Identity of ONE manifest publish of ``epoch``: (save time,
    sorted (file, digest, size) records), or None when the entry is
    absent/unreadable.  The promote watchers (serving/deploy.py's
    CheckpointWatcher, fleet/deploy.py's RollingSwap) key their
    one-rejection-per-publish dedup on it — a REWRITTEN epoch gets a
    new mark and re-enters verification; defining it once here keeps
    the two watchers (and any manifest schema change) in lockstep."""
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return None
    entry = CheckpointManager(directory, prefix=prefix,
                              keep_last=None).entry(int(epoch))
    if entry is None:
        return None
    return (entry.get("time"),
            tuple(sorted((name, rec.get("digest"), rec.get("size"))
                         for name, rec in
                         (entry.get("files") or {}).items())))
