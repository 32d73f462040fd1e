"""Retries for the input pipeline (port of ``mxnet_tpu/resilience.py``'s
``TransientError``, ``retry`` and ``retrying_next``, ``:171``, ``:813-879``)
and ``strip_faults_env`` (``:315``), which the data service applies to the
environment of a respawned decode worker.

The rest of the JAX module (``CheckpointManager``, ``StepWatchdog``,
``PreemptionHandler``) and its fault injection (``faults.maybe_fail`` /
``maybe_hang``, the ``MXTPU_FAULTS`` points such as ``iter_next``) come
with the resilience slice of the port; until then no fault point is
armed here.
"""
from __future__ import annotations

import logging
import time

from .base import MXNetError, get_env, register_env

__all__ = ["TransientError", "retry", "retrying_next", "strip_faults_env",
           "ENV_DATA_RETRIES", "ENV_DATA_BACKOFF"]

_LOG = logging.getLogger(__name__)

ENV_DATA_RETRIES = register_env(
    "MXTPU_DATA_RETRIES", default=3,
    doc="Attempts per data-iterator next() through the shared retry "
        "ladder (prefetchers)")
ENV_DATA_BACKOFF = register_env(
    "MXTPU_DATA_RETRY_BACKOFF", default=0.05,
    doc="Initial backoff (seconds) between data-iterator retries")


class TransientError(MXNetError):
    """An error the caller declared retryable (flaky storage, a source
    that is still coming up)."""


def retry(fn, attempts=3, backoff=0.1, max_backoff=30.0, timeout=None,
          retry_on=(TransientError,), name=None, logger=None,
          sleep=time.sleep, clock=time.monotonic):
    """Call ``fn()`` up to ``attempts`` times with exponential backoff.

    Only exceptions in ``retry_on`` are retried; anything else propagates
    at once (StopIteration, programming errors).  ``timeout`` bounds the
    total wall time across attempts.  ``sleep``/``clock`` are injectable
    so tests run the ladder against a fake clock."""
    name = name or getattr(fn, "__name__", "call")
    logger = logger or _LOG
    attempts = max(1, int(attempts))
    deadline = None if timeout is None else clock() + float(timeout)
    delay = float(backoff)
    last = None
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — the ladder is the point
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
    (``IOError``/``OSError``/``TransientError``) with backoff;
    StopIteration and real bugs pass straight through.  The shared fetch
    discipline of the background prefetchers (``io.PrefetchingIter``,
    ``dataflow.DevicePrefetchIter``).  Tunables: MXTPU_DATA_RETRIES /
    MXTPU_DATA_RETRY_BACKOFF.

    Contract: a retried source must not have advanced its cursor on the
    failed call.  A source that consumes the record before failing would
    resume one record later: set MXTPU_DATA_RETRIES=1 for such sources and
    handle the surfaced error with ``reset()``."""
    return retry(
        data_iter.next,
        attempts=int(get_env(ENV_DATA_RETRIES, "3")),
        backoff=float(get_env(ENV_DATA_BACKOFF, "0.05")),
        retry_on=(IOError, OSError, TransientError),
        name=name)


def strip_faults_env(value, points):
    """Drop the given fault points from an ``MXTPU_FAULTS`` value
    (``"point:times[@after],..."``), keeping everything else: an injected
    fault fires once per drill, never again on a respawned process (or it
    would crash-loop the respawn budget away)."""
    points = set(points)
    keep = [part for part in
            filter(None, (p.strip() for p in (value or "").split(",")))
            if part.partition(":")[0] not in points]
    return ",".join(keep)
