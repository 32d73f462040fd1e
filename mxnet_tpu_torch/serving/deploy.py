"""Train-to-serve hot swap: continuous deployment for a live pool (port
of ``mxnet_tpu/serving/deploy.py`` over the port's ``resilience``).

A trainer's ``CheckpointManager`` directory is a stream of epochs; a
serving daemon pointed at it should FOLLOW that stream — without a
restart, without dropping a request, and without ever trusting bytes
the manifest's digests don't vouch for.  :class:`CheckpointWatcher` is
that seam, one model per watcher:

1. **Tail** the manifest (monotonic-clock poll; errors back the poll
   off exponentially) for an epoch newer than the one being served.
2. **Verify before reading** — :func:`~..resilience.verify_promotion`
   checks every file's size + digest against the manifest BEFORE any
   deserialization.  A damaged epoch is REJECTED (counted on
   ``/stats``) and the pool keeps serving the current epoch: the
   promote path never walks forward onto bad bytes, and never walks
   back either — rejection is not an invitation to guess.
3. **Stage + validate off the serving path** — the new params are
   loaded into a throwaway staged model, its shape/dtype/param-set
   digest must MATCH the serving model's (the ``serving/aot.py``
   meta-verify discipline: same program, new weights — anything else
   is a restart, not a swap), and one validation forward must produce
   finite outputs.
4. **Swap at the dispatch boundary** —
   :meth:`~.batcher.BucketBatcher.run_exclusive` parks the dispatcher
   between batches: the in-flight batch finishes on the old weights,
   the next batch sees the new ones, queued requests just wait out the
   milliseconds-long critical section.  ZERO requests are dropped or
   errored by a swap.
5. **Probe, then commit** — post-swap forwards through the REAL
   serving executors must come back finite; a failed probe rolls the
   previous weights back (``MXTPU_SWAP_ROLLBACK``) before any client
   request can reach them.

Bit-exactness contract (pinned in tests/test_torch_serving.py): a model
whose weights did NOT change serves bitwise-identical outputs across
another model's swap, and a swapped model serves outputs bitwise equal
to a fresh pool loaded directly from the new checkpoint — the swap
installs the new epoch's exact bytes, not an approximation of them.

The fleet tier (``fleet/deploy.py``, :class:`~..fleet.RollingSwap`)
rolls a verified epoch across a fleet one replica at a time, through
each replica's ``POST /swap/<model>`` into this same swap path;
``tools/ckpt_fsck.py --watch/--promote-gate`` reports with the same
verifier, so fsck and deploy can never drift on what "healthy" means.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..base import MXNetError, get_env, register_env
from ..resilience import CheckpointManager, faults, verify_promotion

__all__ = ["CheckpointWatcher", "SWAP_PROBE_FAULT",
           "ENV_SWAP_POLL_S", "ENV_SWAP_PROBES", "ENV_SWAP_ROLLBACK"]

ENV_SWAP_POLL_S = register_env(
    "MXTPU_SWAP_POLL_S", default=0.5,
    doc="CheckpointWatcher manifest-poll interval in seconds "
        "(monotonic clock; poll errors back off exponentially up to "
        "32x and reset on the next clean poll)")
ENV_SWAP_PROBES = register_env(
    "MXTPU_SWAP_PROBES", default=1,
    doc="Post-swap validation forwards through the serving executors "
        "before a hot swap commits; a non-finite (or failed) probe "
        "rolls the previous weights back")
ENV_SWAP_ROLLBACK = register_env(
    "MXTPU_SWAP_ROLLBACK", default=1,
    doc="0 disables automatic rollback on a failed post-swap probe "
        "(the swap then fails loudly and the model serves the new "
        "weights as-is — only for debugging a rollback itself)")

#: fault point on the post-swap probe (``faults.maybe_fail``): the
#: deterministic stand-in for weights that pass off-path validation but
#: break on the serving executors — the rollback drill's trigger
SWAP_PROBE_FAULT = "swap_probe"


def _log():
    import logging
    return logging.getLogger(__name__)


def _finite(outputs):
    return all(np.isfinite(np.asarray(o)).all() for o in outputs)


class CheckpointWatcher(object):
    """Tail one model's checkpoint directory and hot-swap verified new
    epochs into the live pool (see the module docstring for the
    promote pipeline).

    ``frontend`` (a :class:`~.frontend.ServingFrontend`) supplies the
    model's batcher so the swap lands at the dispatch boundary under
    real traffic; without one (bare-pool tests, offline promotion) the
    swap runs directly — the caller then owns the forward path.

    Thread-safe: the poll thread and the ``/swap`` admin endpoint both
    funnel through one lock, so at most one promotion is in flight per
    model.
    """

    #: error-poll backoff cap, in multiples of ``poll_s``
    MAX_BACKOFF_X = 32.0

    def __init__(self, pool, model, directory=None, prefix=None,
                 frontend=None, poll_s=None, probes=None, rollback=None):
        entry = pool.get(model)
        self.pool = pool
        self.model = model
        self.frontend = frontend
        self.directory = directory or entry.source_dir
        if not self.directory:
            raise MXNetError(
                "model %r was not loaded from a checkpoint directory — "
                "nothing to watch (load it with ModelPool.load_dir, or "
                "pass directory=)" % model)
        self.prefix = prefix or entry.source_prefix or "checkpoint"
        self.poll_s = float(get_env(ENV_SWAP_POLL_S)
                            if poll_s is None else poll_s)
        self.probes = max(1, int(get_env(ENV_SWAP_PROBES)
                                 if probes is None else probes))
        self.rollback = bool(int(get_env(ENV_SWAP_ROLLBACK))
                             if rollback is None else rollback)
        self._man = CheckpointManager(self.directory, prefix=self.prefix,
                                      keep_last=None)
        self.counters = {"polls": 0, "promoted": 0, "rejected": 0,
                         "validation_failures": 0, "rolled_back": 0,
                         "swap_errors": 0}
        self.last_swap_ms = None
        #: publish->served latency of the LAST promote: wall-clock span
        #: from the manifest entry's publish timestamp (written by the
        #: trainer's CheckpointManager.save) to the moment the epoch
        #: went live here — the region drill's end-to-end freshness
        #: metric
        self.last_freshness_ms = None
        self.last_outcome = None
        #: bad publishes already counted: epoch -> manifest-entry mark,
        #: so one rotted epoch is one ``rejected``, not one per poll —
        #: a REWRITTEN epoch (new entry) is re-verified
        self._rejected_marks = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    # -- observation -------------------------------------------------------
    def watching(self):
        return self._thread is not None and self._thread.is_alive()

    def stats(self):
        """The ``/stats`` deploy block for this model.  Deliberately
        LOCK-FREE: ``check_once`` holds the promote lock for a whole
        promotion (staging binds a fresh executor), and a /stats
        poll that blocked on it would make the fleet router's probe
        time out and count the replica as down mid-promotion.  The
        counters are GIL-atomic dict reads — a snapshot taken mid-swap
        may be one increment stale, never torn."""
        out = {"model": self.model, "directory": self.directory,
               "epoch": self.pool.get(self.model).loaded_epoch,
               "watching": self.watching(), "poll_s": self.poll_s,
               "last_swap_ms": self.last_swap_ms,
               "last_freshness_ms": self.last_freshness_ms,
               "last_outcome": self.last_outcome}
        out.update(self.counters)
        return out

    # -- the promote pipeline ----------------------------------------------
    def check_once(self, epoch=None, force=False):
        """One poll: verify the newest (or the given) epoch and promote
        it when it is newer than the served one and fully healthy.
        ``force=True`` (what an explicit ``/swap`` sends) re-attempts a
        publish the poll loop is holding after an earlier failure.
        Returns the outcome dict (``ok``, ``action``, ``epoch`` —
        JSON-safe; also stored as ``last_outcome``)."""
        with self._lock:
            return self._check_locked(epoch, force=force)

    def _entry_mark(self, epoch):
        """Identity of one manifest publish (resilience.publish_mark —
        shared with the fleet rollout): a rewritten epoch gets
        re-verified, an unchanged bad one is not re-counted per poll."""
        from ..resilience import publish_mark
        return publish_mark(self.directory, epoch, prefix=self.prefix)

    def _outcome(self, ok, action, **extra):
        out = {"ok": bool(ok), "action": action, "model": self.model}
        out.update(extra)
        self.last_outcome = out
        return out

    def _check_locked(self, target, force=False):
        self.counters["polls"] += 1
        entry = self.pool.get(self.model)
        current = entry.loaded_epoch
        epoch, problems = verify_promotion(self.directory, epoch=target,
                                           prefix=self.prefix)
        if epoch is None:
            return self._outcome(False, "no_checkpoint",
                                 problems=problems, epoch=current)
        if target is None and current is not None and epoch <= current:
            return self._outcome(True, "current", epoch=current)
        if problems:
            mark = self._entry_mark(epoch)
            if target is None and not force and \
                    self._rejected_marks.get(epoch) == mark:
                # this exact bad publish was already counted — stay
                # quiet until it changes or a newer epoch appears
                return self._outcome(False, "rejected", epoch=current,
                                     target=epoch, problems=problems,
                                     already_counted=True)
            self._rejected_marks[epoch] = mark
            self.counters["rejected"] += 1
            _log().warning(
                "CheckpointWatcher[%s]: REJECTING epoch %d — verification "
                "failed, keeping epoch %s live: %s", self.model, epoch,
                current, "; ".join(problems))
            return self._outcome(False, "rejected", epoch=current,
                                 target=epoch, problems=problems)
        mark = self._entry_mark(epoch)
        if target is None and not force and \
                self._rejected_marks.get(epoch) == mark:
            # this publish already failed validation/probe: do not
            # re-stage (and re-pause dispatch) every poll — hold until
            # the epoch is rewritten, a newer one appears, or an
            # explicit /swap (force=True) retries it
            return self._outcome(False, "held", epoch=current,
                                 target=epoch, already_counted=True)
        return self._promote(entry, epoch, current, mark)

    def _load_raw(self, epoch):
        """The new epoch's RAW param bytes (digest-verified upstream),
        split into (arg_params, aux_params)."""
        from .. import ndarray as nd
        entry = self._man.entry(epoch) or {}
        if entry.get("shard_set"):
            # sharded-native publish: assemble from the per-shard blobs
            # (shard-set completeness + every digest re-verified before
            # a byte deserializes — same walk-back-grade guarantees)
            args, auxs, _states = self._man._restore_sharded(epoch,
                                                             entry)
            return args, auxs
        raw = nd.load(self._man.params_path(epoch))
        args = {k[4:]: v for k, v in raw.items() if k.startswith("arg:")}
        auxs = {k[4:]: v for k, v in raw.items() if k.startswith("aux:")}
        return args, auxs

    def _probe_inputs(self, entry):
        rs = np.random.RandomState(0)
        return {k: rs.rand(1, *s).astype(np.float32)
                for k, s in entry.sample_shapes.items()}

    def _serving_probe_inputs(self, entry):
        """Post-swap probe inputs at the LAST-SERVED signature when one
        exists: that program is already compiled, so the probe can
        never drag an executor bind into the paused-dispatcher critical
        section (the milliseconds-scale contract).  A never-served
        model probes at bucket 1 — there is no traffic to stall."""
        shapes = entry._cur_shapes
        if not shapes:
            return self._probe_inputs(entry)
        rs = np.random.RandomState(0)
        return {k: rs.rand(*s).astype(np.float32)
                for k, s in shapes.items()}

    def _promote(self, entry, epoch, current, mark=None):
        from . import aot
        from .pool import PooledModel
        if mark is not None:
            # any failure below marks this publish as tried — the poll
            # loop holds instead of re-staging it forever; a success
            # clears the mark
            self._rejected_marks[epoch] = mark
        if entry.sample_shapes is None:
            self.counters["validation_failures"] += 1
            return self._outcome(
                False, "validation_failed", epoch=current, target=epoch,
                problems=["model %r has no declared sample_shapes — the "
                          "pre-swap validation forward needs them"
                          % self.model])
        # -- stage + validate OFF the serving path -------------------------
        try:
            # inside the guard: between verification and this read the
            # trainer may have re-written (or retention pruned) the
            # epoch — that is a rejection, not a watcher crash
            args, auxs = self._load_raw(epoch)
            staged = PooledModel(entry.name, entry.symbol, args, auxs,
                                 dtype=entry.dtype, ctx=entry.ctx,
                                 sample_shapes=entry.sample_shapes)
            if aot.entry_meta(staged) != aot.entry_meta(entry):
                raise MXNetError(
                    "epoch %d's parameter set/shapes/dtype do not match "
                    "the serving program — a graph change needs a "
                    "restart, not a swap" % epoch)
            outs = staged.forward(self._probe_inputs(entry))
            if not _finite(outs):
                raise MXNetError("epoch %d's validation forward produced "
                                 "non-finite outputs" % epoch)
        except Exception as e:  # noqa: BLE001 — any staging failure
            self.counters["validation_failures"] += 1
            _log().warning(
                "CheckpointWatcher[%s]: epoch %d failed staged "
                "validation (%s: %s) — keeping epoch %s live",
                self.model, epoch, type(e).__name__, e, current)
            return self._outcome(False, "validation_failed",
                                 epoch=current, target=epoch,
                                 problems=["%s: %s"
                                           % (type(e).__name__, e)])
        # -- swap at the dispatch boundary, probe, commit ------------------
        probe_x = self._serving_probe_inputs(entry)

        def _swap_and_probe():
            snap = entry.swap_params(args, auxs)
            try:
                for _ in range(self.probes):
                    faults.maybe_fail(SWAP_PROBE_FAULT)
                    if not _finite(entry.forward(dict(probe_x))):
                        raise MXNetError("non-finite post-swap probe "
                                         "output")
            except Exception:
                if self.rollback:
                    entry.restore_params(snap)
                raise
            return snap

        batcher = None
        if self.frontend is not None:
            batcher = self.frontend.batcher(self.model, entry=entry)
        tic = time.monotonic()
        try:
            if batcher is not None:
                batcher.run_exclusive(_swap_and_probe)
            else:
                _swap_and_probe()
        except Exception as e:  # noqa: BLE001 — probe/boundary failure
            if self.rollback:
                self.counters["rolled_back"] += 1
                action = "rolled_back"
            else:
                self.counters["swap_errors"] += 1
                action = "swap_failed"
            _log().warning(
                "CheckpointWatcher[%s]: swap to epoch %d failed (%s: "
                "%s)%s", self.model, epoch, type(e).__name__, e,
                " — previous weights restored" if self.rollback else "")
            return self._outcome(False, action, epoch=current,
                                 target=epoch,
                                 problems=["%s: %s"
                                           % (type(e).__name__, e)])
        swap_ms = (time.monotonic() - tic) * 1e3
        entry.loaded_epoch = epoch
        self._rejected_marks.pop(epoch, None)
        self.counters["promoted"] += 1
        self.last_swap_ms = round(swap_ms, 3)
        try:
            published = (self._man.entry(epoch) or {}).get("time")
        except Exception:  # noqa: BLE001 — provenance is best-effort
            published = None
        if published is not None:
            # wall clock on both sides (publisher + server): the two
            # processes may be different hosts, and time.time() is the
            # only shared clock the manifest can carry
            self.last_freshness_ms = round(
                max(0.0, time.time() - float(published)) * 1e3, 3)
        _log().info("CheckpointWatcher[%s]: hot-swapped epoch %s -> %d "
                    "in %.1fms", self.model, current, epoch, swap_ms)
        return self._outcome(True, "promoted", epoch=epoch,
                             from_epoch=current,
                             swap_ms=self.last_swap_ms,
                             freshness_ms=self.last_freshness_ms)

    # -- the poll thread ---------------------------------------------------
    def start(self):
        """Start tailing the directory (idempotent); returns self."""
        if self.watching():
            return self
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="mxswap-%s" % self.model, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _loop(self):
        delay = self.poll_s
        while not self._stop.wait(delay):
            try:
                self.check_once()
                delay = self.poll_s
            except Exception as e:  # noqa: BLE001 — the tail must live
                # an unreadable directory (NFS blip, mid-copy manifest)
                # must not spin the poll hot OR kill the watcher: back
                # off on the monotonic clock, reset on the next clean
                # poll
                delay = min(delay * 2.0,
                            self.poll_s * self.MAX_BACKOFF_X)
                _log().warning(
                    "CheckpointWatcher[%s]: poll failed (%s: %s) — "
                    "backing off to %.1fs", self.model,
                    type(e).__name__, e, delay)
