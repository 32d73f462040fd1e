"""Port of ``mxnet_tpu/serving/frontend.py`` (host code).

Admission-control HTTP front end: ``/predict/<model>``, ``/healthz``,
``/stats`` — bounded queues, load shedding, graceful SIGTERM drain.

Admission (Clipper-style SLO-aware control): a request is REFUSED with
429 before it ever queues when the model's queue depth is at
``MXTPU_SERVE_MAX_QUEUE`` (``shed_queue``) or the estimated queue wait
exceeds the ``MXTPU_SERVE_SLO_MS`` latency objective (``shed_slo``) —
under overload a serving system must answer *some* requests inside the
SLO rather than all of them late.  Shed counters and per-stage metrics
(queue depth, batch fill ratio, p50/p99 latency) are live on ``/stats``.

Shutdown composes with ``tools/supervise.py``: SIGTERM flips the daemon
to draining (new predicts get 503, ``/healthz`` reports ``draining``),
every ACCEPTED request finishes and gets its 200, then the process
exits 0.  A wedged forward is the StepWatchdog's job — armed around
each batch dispatch, it dumps stacks and aborts with exit 87 so the
supervisor relaunches the daemon.
"""
from __future__ import annotations

import json
import signal
import socket
import threading
import time
import uuid
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..base import MXNetError, get_env, register_env
from ..resilience import faults
from .batcher import (BucketBatcher, DeadlineExpired, Draining, QueueFull,
                      TenantQuotaExceeded, parse_buckets)

__all__ = ["ServingFrontend", "ServeClient", "Stats",
           "ENV_SERVE_MAX_QUEUE", "ENV_SERVE_SLO_MS",
           "ENV_SERVE_DEDUP_CAP", "ENV_SERVE_DEDUP_TTL_S"]

ENV_SERVE_MAX_QUEUE = register_env(
    "MXTPU_SERVE_MAX_QUEUE", default=256,
    doc="Per-model queue-depth bound; requests beyond it are shed with "
        "HTTP 429 (`shed_queue` on /stats)")
ENV_SERVE_SLO_MS = register_env(
    "MXTPU_SERVE_SLO_MS", default=0.0,
    doc="Latency SLO: shed (429, `shed_slo`) when the estimated queue "
        "wait exceeds this many ms; 0 disables the estimator")
ENV_SERVE_DEDUP_CAP = register_env(
    "MXTPU_SERVE_DEDUP_CAP", default=1024,
    doc="Idempotency dedup cache: completed 200 responses kept per "
        "daemon for request-id replay (exactly-once serving); the "
        "oldest entry is evicted past the cap (`dedup_evicted_size`); "
        "0 disables replay caching (in-flight dedup still applies)")
ENV_SERVE_DEDUP_TTL_S = register_env(
    "MXTPU_SERVE_DEDUP_TTL_S", default=30.0,
    doc="Idempotency dedup cache entry lifetime: a cached response "
        "older than this is dropped (`dedup_evicted_ttl`) — bounds how "
        "long a request id stays replayable")

#: fault point: armable per-request latency injection in the replica
#: front end — the deterministic stand-in for a gray-failing (slow but
#: alive) replica.  ``arm_hang`` sets the delay; plain ``MXTPU_FAULTS``
#: env arming delays each armed hit by SLOW_REPLICA_DEFAULT_S.
SLOW_REPLICA_FAULT = "slow_replica"
SLOW_REPLICA_DEFAULT_S = 0.25


def _percentile(sorted_vals, q):
    """Nearest-rank percentile of an ascending list (no numpy interp —
    the stats path must stay allocation-light)."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class Stats(object):
    """Thread-safe serving metrics: monotonically increasing counters, a
    bounded latency window for percentiles, and batch-fill accounting.
    ``record_latency(ms, tenant=...)`` additionally feeds a bounded
    per-tenant window (at most :data:`MAX_TENANTS` distinct tenants —
    past the cap new tenants fold into the shared window only, so a
    tenant-id flood cannot grow the stats dict without bound)."""

    #: distinct tenants tracked with their own latency window
    MAX_TENANTS = 64

    def __init__(self, window=4096):
        self._lock = threading.Lock()
        self._counters = {"accepted": 0, "completed": 0, "errors": 0,
                          "shed_queue": 0, "shed_slo": 0,
                          "shed_deadline": 0, "rejected": 0}
        self._latencies = deque(maxlen=window)
        self._tenant_lat = {}
        self._batches = 0
        self._rows = 0
        self._bucket_rows = 0
        self._batch_time = 0.0

    def inc(self, key, n=1):
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def record_latency(self, ms, tenant=None):
        with self._lock:
            self._latencies.append(float(ms))
            if tenant:
                win = self._tenant_lat.get(tenant)
                if win is None:
                    if len(self._tenant_lat) >= self.MAX_TENANTS:
                        return
                    win = self._tenant_lat[tenant] = deque(maxlen=512)
                win.append(float(ms))

    def record_batch(self, n, bucket, seconds):
        with self._lock:
            self._batches += 1
            self._rows += int(n)
            self._bucket_rows += int(bucket)
            self._batch_time += float(seconds)

    #: samples feeding the RECENT percentile (``p99_recent``): small on
    #: purpose, so a replica that recovers from a slow spell washes the
    #: spell out of its reported tail within ~this many requests (the
    #: gray-failure detector's re-admission signal — a 4096-sample p99
    #: would pin an ejected replica slow for thousands of requests)
    RECENT_WINDOW = 64

    def latency_percentile(self, q, recent=256, min_count=16):
        """Percentile of the last ``recent`` latency samples, or None
        below ``min_count`` samples — the adaptive hedge trigger
        (fleet/router.py) reads this instead of the full window so the
        threshold tracks what latency looks like NOW."""
        with self._lock:
            tail = list(self._latencies)[-int(recent):]
        if len(tail) < int(min_count):
            return None
        return _percentile(sorted(tail), q)

    def snapshot(self):
        with self._lock:
            raw = list(self._latencies)
            counters = dict(self._counters)
            tenant_lat = {t: sorted(w)
                          for t, w in self._tenant_lat.items()}
            batches, rows = self._batches, self._rows
            bucket_rows, batch_time = self._bucket_rows, self._batch_time
        lat = sorted(raw)
        recent = sorted(raw[-self.RECENT_WINDOW:])
        out = {"counters": counters,
               "latency_ms": {"count": len(lat),
                              "p50": _percentile(lat, 50),
                              "p99": _percentile(lat, 99),
                              "p99_recent": _percentile(recent, 99)},
               "batches": {"count": batches, "rows": rows,
                           "fill_ratio": round(rows / bucket_rows, 4)
                           if bucket_rows else None,
                           "avg_ms": round(batch_time / batches * 1000.0, 3)
                           if batches else None}}
        if tenant_lat:
            out["tenant_latency_ms"] = {
                t: {"count": len(w), "p50": _percentile(w, 50),
                    "p99": _percentile(w, 99)}
                for t, w in tenant_lat.items()}
        return out

    # -- multi-process merge (the sharded fleet front end) -----------------
    def export(self, window_cap=1024):
        """Serializable raw state for cross-process merging: counters,
        the latency window tail, batch accounting.  What each router
        worker dumps; :meth:`merged_snapshot` recombines."""
        with self._lock:
            return {"counters": dict(self._counters),
                    "window": list(self._latencies)[-int(window_cap):],
                    "batches": [self._batches, self._rows,
                                self._bucket_rows, self._batch_time]}

    @classmethod
    def merged_snapshot(cls, exports):
        """Combine :meth:`export` dicts from N processes into one
        ``snapshot()``-shaped payload: counters summed, percentiles over
        the concatenated windows (each window is a bounded tail, so the
        merged p50/p99 reflects recent traffic across the shard)."""
        counters = {}
        window = []
        batches = rows = bucket_rows = 0
        batch_time = 0.0
        for exp in exports:
            for k, v in (exp.get("counters") or {}).items():
                counters[k] = counters.get(k, 0) + v
            window.extend(exp.get("window") or ())
            b = exp.get("batches") or (0, 0, 0, 0.0)
            batches += int(b[0])
            rows += int(b[1])
            bucket_rows += int(b[2])
            batch_time += float(b[3])
        lat = sorted(window)
        recent = sorted(window[-cls.RECENT_WINDOW:])
        return {"counters": counters,
                "latency_ms": {"count": len(lat),
                               "p50": _percentile(lat, 50),
                               "p99": _percentile(lat, 99),
                               "p99_recent": _percentile(recent, 99)},
                "batches": {"count": batches, "rows": rows,
                            "fill_ratio": round(rows / bucket_rows, 4)
                            if bucket_rows else None,
                            "avg_ms": round(batch_time / batches
                                            * 1000.0, 3)
                            if batches else None},
                "merged_from": len(exports)}


class _Pending(object):
    """One in-flight keyed request: duplicates park on ``event`` and
    read the original's outcome instead of executing again."""

    __slots__ = ("event", "status", "body")

    def __init__(self):
        self.event = threading.Event()
        self.status = None
        self.body = None


class _DedupCache(object):
    """The replica-side half of exactly-once serving: a bounded
    idempotency cache keyed ``(model, tenant, request id)``.

    - a duplicate of a COMPLETED request replays the cached response
      bytes without re-entering the batcher (``dedup_hits``);
    - a duplicate of an IN-FLIGHT request waits on the original's
      completion and shares its one execution (``dedup_joined``);
    - only 200s are cached (a shed/error answer must not mask a later
      retry that would have succeeded), bounded by entry count
      (``dedup_evicted_size``) and TTL (``dedup_evicted_ttl``).

    Correctness does NOT rest on this cache: the batcher's bit-exactness
    contract (serving/batcher.py) makes a cross-replica re-execution of
    the same bytes bit-identical, so a dedup MISS on a retried request
    is still the right answer — the cache removes the double execution,
    not a wrong one."""

    def __init__(self, cap=None, ttl_s=None, stats=None):
        self.cap = int(get_env(ENV_SERVE_DEDUP_CAP)
                       if cap is None else cap)
        self.ttl_s = float(get_env(ENV_SERVE_DEDUP_TTL_S)
                           if ttl_s is None else ttl_s)
        self.stats = stats
        self._lock = threading.Lock()
        self._done = OrderedDict()      # key -> (expires_at, status, body)
        self._inflight = {}             # key -> _Pending

    def _inc(self, key):
        if self.stats is not None:
            self.stats.inc(key)

    def _purge(self, now):
        # lazy TTL sweep from the insertion-order front (uniform TTL:
        # the front is the stalest); claim() re-checks per entry anyway
        while self._done:
            key = next(iter(self._done))
            if self._done[key][0] > now:
                break
            del self._done[key]
            self._inc("dedup_evicted_ttl")

    def claim(self, key):
        """``("replay", (status, body))`` for a completed duplicate,
        ``("join", pending)`` for an in-flight duplicate, or
        ``("run", pending)`` — the caller owns the execution and must
        :meth:`complete` the pending slot."""
        now = time.monotonic()
        with self._lock:
            self._purge(now)
            ent = self._done.get(key)
            if ent is not None:
                if ent[0] <= now:
                    del self._done[key]
                    self._inc("dedup_evicted_ttl")
                else:
                    self._done.move_to_end(key)
                    self._inc("dedup_hits")
                    return "replay", (ent[1], ent[2])
            p = self._inflight.get(key)
            if p is not None:
                self._inc("dedup_joined")
                return "join", p
            p = self._inflight[key] = _Pending()
            return "run", p

    def complete(self, key, pending, status, body):
        """Publish the original's outcome: waiters wake with exactly
        these bytes; a 200 additionally becomes replayable until
        TTL/size eviction."""
        with self._lock:
            self._inflight.pop(key, None)
            if status == 200 and self.cap > 0:
                self._done[key] = (time.monotonic() + self.ttl_s,
                                   status, body)
                self._done.move_to_end(key)
                while len(self._done) > self.cap:
                    self._done.popitem(last=False)
                    self._inc("dedup_evicted_size")
        pending.status, pending.body = status, body
        pending.event.set()

    def export(self):
        with self._lock:
            return {"entries": len(self._done),
                    "inflight": len(self._inflight),
                    "cap": self.cap, "ttl_s": self.ttl_s}


class ServeHTTPServer(ThreadingHTTPServer):
    """The daemon's HTTP server (and the fleet router's): a
    ``ThreadingHTTPServer`` that listens with a backlog of
    ``socket.SOMAXCONN`` (the kernel caps it at ``net.core.somaxconn``)
    instead of socketserver's 5.  The accept loop waits for the GIL
    behind handler and dispatcher threads, so a burst of new connections
    (a load's 32 clients starting at once) overflowed 5 pending accepts,
    and the kernel reset some of them mid-request."""

    request_queue_size = socket.SOMAXCONN


class ServingFrontend(object):
    """The daemon: a :class:`ModelPool` behind per-model batchers and a
    stdlib threading HTTP server.

    HTTP surface::

        POST /predict/<model>   body: {"inputs": {name: nested-list}}
                                 (or {"data": [...]} shorthand, or a raw
                                 .npy body with Content-Type
                                 application/x-npy for the sole input)
        POST /predict_seq/<model>  body: {"tokens": [...]} — one
                                 variable-length token sequence, length-
                                 bucketed + trimmed (serving/sequence.py)
        GET  /healthz           {"status": "ok"|"draining", ...}
        GET  /stats             counters + queue depth + fill + p50/p99

    Responses: 200 result, 400 malformed, 404 unknown model, 429 shed
    (queue bound / SLO), 503 draining.  Accepted work is never answered
    5xx by a drain — that is the SIGTERM contract.
    """

    def __init__(self, pool, host="127.0.0.1", port=0, buckets=None,
                 max_wait_ms=None, max_queue=None, slo_ms=None,
                 watchdog=None, request_timeout=60.0,
                 tenant_weights=None, tenant_quota=None,
                 seq_buckets=None):
        self.pool = pool
        self.host, self.port = host, int(port)
        self.buckets = parse_buckets(buckets)
        #: sequence-LENGTH buckets for /predict_seq (spec string/ints;
        #: None = the MXTPU_SERVE_SEQ_BUCKETS default, parsed lazily so
        #: fixed-shape-only daemons never read the knob)
        self.seq_buckets = seq_buckets
        self._seq_buckets = None
        self.max_wait_ms = max_wait_ms
        #: weighted-fair tenant config, passed to every batcher (None =
        #: the MXTPU_SERVE_TENANT_* env defaults)
        self.tenant_weights = tenant_weights
        self.tenant_quota = tenant_quota
        self.max_queue = int(get_env(ENV_SERVE_MAX_QUEUE)) \
            if max_queue is None else int(max_queue)
        self.slo_ms = float(get_env(ENV_SERVE_SLO_MS)) \
            if slo_ms is None else float(slo_ms)
        #: a StepWatchdog instance (or a zero-arg factory) ENABLING
        #: watchdog coverage.  Each model's batcher gets its OWN
        #: watchdog: armed()'s nesting bookkeeping is single-thread,
        #: and every batcher dispatches on its own thread — one shared
        #: watchdog across models would mis-track overlapping arms (a
        #: wedged forward could go unmonitored, and a depth that never
        #: returns to zero would disarm the watchdog for good)
        self.watchdog = watchdog
        self._watchdogs = []
        self._given_watchdog_used = False
        self.request_timeout = float(request_timeout)
        self.stats = Stats()
        #: the exactly-once layer: request-id dedup for /predict
        self.dedup = _DedupCache(stats=self.stats)
        self.draining = False
        self._batchers = {}
        #: model -> CheckpointWatcher (serving/deploy.py): created by
        #: serve.py --watch or lazily by the /swap admin endpoint
        self.watchers = {}
        self._lock = threading.Lock()
        self._server = None
        self._stopped = threading.Event()

    # -- batching ----------------------------------------------------------
    def _new_watchdog(self):
        """One watchdog per batcher (call with ``_lock`` held).  The
        given instance covers the first model; later models get a fresh
        instance — same class, env-configured budget — or the factory's
        product when ``watchdog`` is callable."""
        if callable(self.watchdog):
            wd = self.watchdog()
        elif not self._given_watchdog_used:
            self._given_watchdog_used = True
            wd = self.watchdog
        else:
            wd = type(self.watchdog)()
        self._watchdogs.append(wd)
        wd.start()
        return wd

    def batcher(self, model, entry=None):
        if entry is None:
            entry = self.pool.get(model)  # raises on unknown model
        with self._lock:
            b = self._batchers.get(model)
            if b is None:
                wd = None if self.watchdog is None else \
                    self._new_watchdog()
                b = BucketBatcher(
                    entry.forward, buckets=self.buckets,
                    max_wait_ms=self.max_wait_ms,
                    max_queue=self.max_queue, name=model,
                    watchdog=wd, stats=self.stats,
                    tenant_weights=self.tenant_weights,
                    tenant_quota=self.tenant_quota)
                self._batchers[model] = b
        return b

    def queue_depths(self):
        with self._lock:
            batchers = dict(self._batchers)
        return {name: b.depth for name, b in batchers.items()}

    # -- continuous deployment (serving/deploy.py) -------------------------
    def watcher(self, model, start=False, **kw):
        """The model's :class:`~.deploy.CheckpointWatcher` (created on
        first use; raises when the model was not loaded from a
        checkpoint directory).  ``start=True`` begins tailing."""
        with self._lock:
            w = self.watchers.get(model)
        if w is None:
            from .deploy import CheckpointWatcher
            w = CheckpointWatcher(self.pool, model, frontend=self, **kw)
            with self._lock:
                w = self.watchers.setdefault(model, w)
        if start:
            w.start()
        return w

    def handle_swap(self, model, epoch=None):
        """The ``POST /swap/<model>`` admin surface: one synchronous
        verify -> stage -> swap -> probe pass (``epoch=None`` promotes
        the newest verified epoch).  Returns ``(status, outcome)`` —
        200 when the model is now serving the requested/newest epoch,
        409 when the promotion was refused (verification, validation or
        probe), 404/503 for unknown model / draining."""
        try:
            self.pool.get(model)
        except MXNetError as e:
            return 404, {"error": str(e), "model": model}
        if self.draining:
            return 503, {"error": "draining", "model": model}
        try:
            w = self.watcher(model)
        except MXNetError as e:   # not a checkpoint-directory model
            return 409, {"error": str(e), "model": model}
        # an explicit swap is an operator/rollout decision: it retries
        # a publish the poll loop is holding after an earlier failure
        outcome = w.check_once(epoch=epoch, force=True)
        return (200 if outcome.get("ok") else 409), outcome

    def epochs(self):
        """{model: served epoch or None} — the rollout-progress signal
        (/healthz + /stats; the fleet router shows it per replica)."""
        return {name: self.pool.get(name).loaded_epoch
                for name in self.pool.names()}

    # -- admission ---------------------------------------------------------
    def admit(self, model):
        """(accepted, http_status, reason) — the load-shedding decision,
        taken BEFORE the request queues."""
        return self._admit(self.batcher(model))

    def _admit(self, b):
        if self.draining:
            return False, 503, "draining"
        if b.depth >= self.max_queue:
            self.stats.inc("shed_queue")
            return False, 429, "queue depth %d at bound %d" % (
                b.depth, self.max_queue)
        if self.slo_ms > 0:
            est = b.estimate_wait_ms()
            if est > self.slo_ms:
                self.stats.inc("shed_slo")
                return False, 429, ("estimated wait %.1fms exceeds SLO "
                                    "%.0fms" % (est, self.slo_ms))
        return True, 200, None

    def handle_predict(self, model, inputs, entry=None, priority=0,
                       deadline_ms=None, tenant=None, request_id=None):
        """Admission + batch + wait; returns ``(status, payload_dict)``.
        Usable without the HTTP layer (tests, in-process serving).
        ``entry`` skips the pool lookup when the caller (the HTTP
        handler's 404 check) already resolved it.  ``priority``,
        ``deadline_ms`` and ``tenant`` pass through to
        :meth:`BucketBatcher.submit` (deadline expiry answers 429
        ``shed_deadline``; a tenant at its queued quota answers 429
        ``shed_tenant``).

        ``request_id`` (the ``X-MXTPU-Request-Id`` header / body
        ``request_id`` field) engages the exactly-once layer: a
        duplicate of a completed request replays the cached response
        bytes without touching admission or the batcher (the
        ``accepted`` counter does not move), a duplicate of an
        in-flight request waits for the original instead of executing
        twice."""
        # gray-failure stand-in: an armed `slow_replica` delays the
        # whole request path (admission included), exactly like a
        # replica whose host is sick — probes stay fast, serving slows
        if faults.consume(SLOW_REPLICA_FAULT):
            slept = faults.hang_seconds(SLOW_REPLICA_FAULT,
                                        SLOW_REPLICA_DEFAULT_S)
            time.sleep(slept)
            # the injected stall must show up in the replica's
            # REPORTED latency window (latency_ms.p99_recent) — the
            # batcher only times queue+exec, and that window is what
            # the controller's outlier detector watches
            self.stats.record_latency(slept * 1000.0)
        if not request_id:
            return self._predict_core(model, inputs, entry, priority,
                                      deadline_ms, tenant)
        key = (model, tenant or "", str(request_id))
        kind, val = self.dedup.claim(key)
        if kind == "replay":
            status, body = val
            return status, json.loads(body.decode("utf-8"))
        if kind == "join":
            if not val.event.wait(timeout=self.request_timeout):
                self.stats.inc("errors")
                return 504, {"error": "duplicate of request %r timed "
                             "out waiting for the original"
                             % (request_id,), "model": model}
            return val.status, json.loads(val.body.decode("utf-8"))
        try:
            status, payload = self._predict_core(
                model, inputs, entry, priority, deadline_ms, tenant)
        except BaseException:
            # never strand duplicates parked on the pending slot; the
            # synthesized 500 is NOT cached (only 200s replay), so a
            # later client retry of this id re-executes cleanly
            self.dedup.complete(key, val, 500, json.dumps(
                {"error": "original execution of request %r failed"
                 % (request_id,), "model": model}).encode("utf-8"))
            raise
        self.dedup.complete(key, val, status,
                            json.dumps(payload).encode("utf-8"))
        return status, payload

    def _predict_core(self, model, inputs, entry, priority, deadline_ms,
                      tenant):
        if entry is None:
            entry = self.pool.get(model)
        if entry.sample_shapes is not None:
            # a client error must be a 400, not a 500 from deep inside
            # the batch forward — and a WRONG first request must never
            # pin the model's per-sample shapes
            got = {k: tuple(np.shape(v)) for k, v in inputs.items()}
            want = {k: tuple(s) for k, s in entry.sample_shapes.items()}
            if got != want:
                return 400, {"error": "input shapes %s != model's %s"
                             % (got, want), "model": model}
        b = self.batcher(model, entry=entry)
        status, err, outs, ms = self._submit_wait(
            b, model, inputs, priority, deadline_ms, tenant)
        if err is not None:
            return status, err
        return 200, {"model": model,
                     "outputs": [np.asarray(o).tolist() for o in outs],
                     "ms": ms}

    def _submit_wait(self, b, model, inputs, priority, deadline_ms,
                     tenant):
        """Admission + queue + wait on ONE batcher — the shared tail of
        :meth:`handle_predict` and :meth:`handle_predict_seq`.  Returns
        ``(status, error_payload_or_None, outputs, ms)``."""
        ok, status, reason = self._admit(b)
        if not ok:
            return status, {"error": reason, "model": model}, None, None
        tic = time.monotonic()
        try:
            fut = b.submit(inputs, priority=priority,
                           deadline_ms=deadline_ms, tenant=tenant)
            # counted only once the request actually entered the queue
            # — a submit-time shed (spent deadline, drain/bound race)
            # must not inflate `accepted` the way shed_queue/shed_slo
            # don't (the accepted-vs-completed ledger on /stats)
            self.stats.inc("accepted")
            outs = fut.result(timeout=self.request_timeout)
        except TenantQuotaExceeded as e:
            # shed, not failed: the batcher already counted shed_tenant
            return 429, {"error": str(e), "model": model,
                         "reason": "shed_tenant"}, None, None
        except DeadlineExpired as e:
            # shed, not failed: the batcher already counted
            # shed_deadline — same 429 contract as shed_queue/shed_slo
            return 429, {"error": str(e), "model": model,
                         "reason": "shed_deadline"}, None, None
        except (Draining, QueueFull) as e:
            # lost the race with a drain/bound between admit and submit
            self.stats.inc("rejected")
            return (429 if isinstance(e, QueueFull) else 503,
                    {"error": str(e), "model": model}, None, None)
        except TimeoutError as e:
            self.stats.inc("errors")
            return 504, {"error": str(e), "model": model}, None, None
        except Exception as e:  # noqa: BLE001 — the model failed, not us
            self.stats.inc("errors")
            return 500, {"error": "%s: %s" % (type(e).__name__, e),
                         "model": model}, None, None
        self.stats.inc("completed")
        return 200, None, outs, \
            round((time.monotonic() - tic) * 1000.0, 3)

    # -- bucketed sequence serving (serving/sequence.py) -------------------
    def seq_batcher(self, model, seq_len, entry=None):
        """The (model, length-bucket) batcher, created on first use
        under the key ``model@seq<L>`` (its own /stats row)."""
        from .sequence import SequenceEntry, seq_batcher_name
        key = seq_batcher_name(model, seq_len)
        with self._lock:
            b = self._batchers.get(key)
        if b is not None:
            return b
        if entry is None:
            entry = self.pool.get(model)
        return self.batcher(key, entry=SequenceEntry(entry, seq_len))

    def handle_predict_seq(self, model, tokens, entry=None, priority=0,
                           deadline_ms=None, tenant=None):
        """One variable-length token sequence in, its per-step outputs
        (trimmed back to the TRUE length) out — the bucketed sequence
        path (serving/sequence.py).  Same status contract as
        :meth:`handle_predict`, plus 400 for a sequence longer than the
        largest configured bucket."""
        from .sequence import parse_seq_buckets, pick_seq_bucket
        if entry is None:
            entry = self.pool.get(model)
        try:
            if self._seq_buckets is None:
                self._seq_buckets = parse_seq_buckets(self.seq_buckets)
            arr = np.asarray(tokens, dtype=np.float32)
            if arr.ndim != 1 or not arr.size:
                raise MXNetError("tokens must be a non-empty flat list, "
                                 "got shape %s" % (arr.shape,))
            bucket = pick_seq_bucket(arr.shape[0], self._seq_buckets)
        except MXNetError as e:
            return 400, {"error": str(e), "model": model}
        n = int(arr.shape[0])
        if n < bucket:
            # edge-pad with the LAST real token (the pad_to_bucket
            # rule): the causal scan never lets pad steps reach the
            # real ones, and repeating a real id can't leave the
            # embedding table the way an invalid filler id could
            arr = np.concatenate([arr, np.repeat(arr[-1:], bucket - n)])
        names = getattr(entry, "input_names", None) or ["data"]
        data_name = "data" if "data" in names else names[0]
        b = self.seq_batcher(model, bucket, entry=entry)
        status, err, outs, ms = self._submit_wait(
            b, model, {data_name: arr}, priority, deadline_ms, tenant)
        if err is not None:
            return status, err
        trimmed = []
        for o in outs:
            o = np.asarray(o)
            if o.ndim and o.shape[0] == bucket:
                o = o[:n]
            trimmed.append(o.tolist())
        return 200, {"model": model, "bucket": bucket, "len": n,
                     "outputs": trimmed, "ms": ms}

    def stats_payload(self):
        payload = self.stats.snapshot()
        payload["models"] = self.pool.names()
        payload["queue_depth"] = self.queue_depths()
        with self._lock:
            batchers = dict(self._batchers)
        # the routing signal a fleet front end spills on: per-model
        # estimated queue wait
        payload["est_wait_ms"] = {
            name: round(b.estimate_wait_ms(), 3)
            for name, b in batchers.items()}
        # per-tenant queued depth (the fairness surface): only models
        # with tenant-labeled work show up, so the single-tenant
        # payload is byte-identical to before
        tenants = {name: depths for name, b in batchers.items()
                   for depths in [b.tenant_depths()] if depths}
        if tenants:
            payload["tenants"] = tenants
        # the exactly-once surface: live dedup-cache occupancy (hit/
        # eviction counters ride the shared counters block)
        payload["dedup"] = self.dedup.export()
        payload["draining"] = self.draining
        payload["buckets"] = list(self.buckets)
        payload["epochs"] = self.epochs()
        with self._lock:
            watchers = dict(self.watchers)
        if watchers:
            payload["deploy"] = {name: w.stats()
                                 for name, w in watchers.items()}
        return payload

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Bind the server + start the watchdog monitor; returns self.
        ``self.port`` holds the real port (use port=0 for ephemeral)."""
        if self._server is not None:
            return self
        frontend = self

        class Handler(_Handler):
            fe = frontend

        self._server = ServeHTTPServer((self.host, self.port), Handler)
        # handler threads must outlive shutdown() so drained requests
        # still get their responses written
        self._server.daemon_threads = False
        self._server.block_on_close = True
        self.port = self._server.server_address[1]
        return self

    def serve_forever(self):
        """Blocking accept loop (the daemon's main thread); returns
        after :meth:`drain_and_stop` completes."""
        self.start()
        try:
            self._server.serve_forever(poll_interval=0.1)
        finally:
            self._server.server_close()
            self._stopped.set()

    def serve_in_background(self):
        """start() + serve_forever on a helper thread (tests)."""
        self.start()
        t = threading.Thread(target=self.serve_forever,
                             name="mxserve-http", daemon=True)
        t.start()
        return self

    def drain_and_stop(self, timeout=30.0):
        """The SIGTERM path: stop admitting, finish every accepted
        request, then stop the server.  Idempotent."""
        self.draining = True
        with self._lock:
            watchers = list(self.watchers.values())
            batchers = list(self._batchers.values())
        for w in watchers:
            # no swap may hold the dispatch boundary while the drain
            # waits on those same batchers
            w.stop()
        for b in batchers:
            b.close(drain=True, timeout=timeout)
        with self._lock:
            watchdogs, self._watchdogs = self._watchdogs, []
        for wd in watchdogs:
            wd.stop()
        if self._server is not None:
            self._server.shutdown()

    def install_signal_handlers(self, signals=(signal.SIGTERM,
                                               signal.SIGINT)):
        """SIGTERM/SIGINT -> graceful drain (handler returns immediately;
        a helper thread does the drain so the accept loop isn't blocked
        inside the signal frame)."""
        def _on_signal(signum, frame):
            threading.Thread(target=self.drain_and_stop,
                             name="mxserve-drain", daemon=True).start()
        for sig in signals:
            signal.signal(sig, _on_signal)
        return self

    def wait_stopped(self, timeout=None):
        return self._stopped.wait(timeout)


class _Handler(BaseHTTPRequestHandler):
    """Routes onto the owning :class:`ServingFrontend` (``fe`` class
    attr, set by ``start()``)."""

    fe = None
    protocol_version = "HTTP/1.1"
    #: TCP_NODELAY on each connection: a reply goes out as a header write
    #: and a body write, and with Nagle on the body waits for the
    #: client's delayed ACK of the headers (about 40 ms a request on
    #: Linux loopback) — a floor under every keep-alive request's latency
    disable_nagle_algorithm = True
    #: socket timeout: an IDLE keep-alive connection parks its handler
    #: thread in readline() — with block_on_close joining handler
    #: threads at shutdown, a single idle client (a monitoring poller,
    #: an unclosed ServeClient) would otherwise wedge the SIGTERM drain
    #: forever.  On timeout http.server closes the connection, so the
    #: drain's thread joins are bounded by ~this many seconds.  (It
    #: does NOT bound an in-flight predict — that blocks in do_POST,
    #: not in a socket read.)
    timeout = 10.0

    def log_message(self, fmt, *args):  # per-request stderr spam off
        pass

    def _reply(self, status, payload):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, {
                "status": "draining" if self.fe.draining else "ok",
                "models": self.fe.pool.names(),
                "epochs": self.fe.epochs()})
        elif self.path == "/stats":
            self._reply(200, self.fe.stats_payload())
        else:
            self._reply(404, {"error": "unknown path %r" % self.path})

    def _qos(self, payload=None):
        """(priority, deadline_ms, tenant, request_id) from the
        ``X-MXTPU-Priority`` / ``X-MXTPU-Deadline-Ms`` /
        ``X-MXTPU-Tenant`` / ``X-MXTPU-Request-Id`` headers, overridden
        by same-named JSON body fields (``priority`` / ``deadline_ms``
        / ``tenant`` / ``request_id``) when present."""
        priority = self.headers.get("X-MXTPU-Priority")
        deadline = self.headers.get("X-MXTPU-Deadline-Ms")
        tenant = self.headers.get("X-MXTPU-Tenant")
        request_id = self.headers.get("X-MXTPU-Request-Id")
        if payload is not None and isinstance(payload, dict):
            priority = payload.get("priority", priority)
            deadline = payload.get("deadline_ms", deadline)
            tenant = payload.get("tenant", tenant)
            request_id = payload.get("request_id", request_id)
        return (int(priority) if priority is not None else 0,
                float(deadline) if deadline is not None else None,
                str(tenant) if tenant is not None else None,
                str(request_id) if request_id is not None else None)

    def _parse_inputs(self, entry):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        ctype = (self.headers.get("Content-Type") or "").split(";")[0]
        if ctype == "application/x-npy":
            import io as _pyio
            arr = np.load(_pyio.BytesIO(body), allow_pickle=False)
            return {entry.input_names[0]:
                    np.ascontiguousarray(arr, dtype=np.float32)}, \
                self._qos()
        payload = json.loads(body.decode("utf-8"))
        raw = payload.get("inputs", payload)
        inputs = {}
        for k, v in raw.items():
            if k in entry.input_names:
                inputs[k] = np.asarray(v, dtype=np.float32)
        if set(inputs) != set(entry.input_names):
            raise ValueError("need inputs %s, got %s"
                             % (entry.input_names, sorted(raw)))
        return inputs, self._qos(payload)

    def do_POST(self):
        if self.path.startswith("/swap/"):
            # the continuous-deployment admin surface: promote the
            # newest verified epoch (or body {"epoch": N}) for a model
            model = self.path[len("/swap/"):].strip("/")
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                payload = json.loads(body.decode("utf-8")) if body else {}
                epoch = payload.get("epoch")
            except Exception as e:  # noqa: BLE001 — malformed body
                self._reply(400, {"error": "bad request body: %s" % (e,)})
                return
            status, out = self.fe.handle_swap(model, epoch=epoch)
            self._reply(status, out)
            return
        if self.path.startswith("/predict_seq/"):
            # the bucketed-sequence path: body {"tokens": [...ids...]}
            model = self.path[len("/predict_seq/"):].strip("/")
            try:
                entry = self.fe.pool.get(model)
            except MXNetError as e:
                self._reply(404, {"error": str(e)})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length)
                                     .decode("utf-8"))
                tokens = payload["tokens"]
                # dedup is scoped to /predict — the request id (if any)
                # is ignored on the sequence path
                priority, deadline_ms, tenant, _ = self._qos(payload)
            except Exception as e:  # noqa: BLE001 — malformed body
                self._reply(400, {"error": "bad request body: %s" % (e,)})
                return
            status, out = self.fe.handle_predict_seq(
                model, tokens, entry=entry, priority=priority,
                deadline_ms=deadline_ms, tenant=tenant)
            self._reply(status, out)
            return
        if not self.path.startswith("/predict/"):
            self._reply(404, {"error": "unknown path %r" % self.path})
            return
        model = self.path[len("/predict/"):].strip("/")
        try:
            entry = self.fe.pool.get(model)
        except MXNetError as e:
            self._reply(404, {"error": str(e)})
            return
        try:
            inputs, (priority, deadline_ms, tenant, request_id) = \
                self._parse_inputs(entry)
        except Exception as e:  # noqa: BLE001 — malformed client body
            self._reply(400, {"error": "bad request body: %s" % (e,)})
            return
        status, payload = self.fe.handle_predict(
            model, inputs, entry=entry, priority=priority,
            deadline_ms=deadline_ms, tenant=tenant,
            request_id=request_id)
        self._reply(status, payload)


class ServeClient(object):
    """Minimal keep-alive client for the daemon (tests, bench, drills).
    One instance per thread — ``http.client`` connections are not
    thread-safe."""

    #: retire an idle keep-alive connection before the server side can:
    #: the daemon handler's 10s socket timeout closes ITS end of an
    #: idle connection, and the next request written onto that socket
    #: surfaces as a spurious transport error — load-bearing now that
    #: client retries ride the exactly-once path and must not be minted
    #: by the client's own stale socket
    CONN_IDLE_S = 5.0

    def __init__(self, host, port, timeout=60.0):
        self.host, self.port, self.timeout = host, int(port), timeout
        self._conn = None
        self._last_use = 0.0

    def _connection(self):
        import http.client
        now = time.monotonic()
        if self._conn is not None and \
                now - self._last_use > self.CONN_IDLE_S:
            self.close()
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
        self._last_use = now
        return self._conn

    def close(self):
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _request(self, method, path, body=None, headers=None):
        # Retry ONLY send-phase failures (a keep-alive socket that died
        # across a server restart surfaces in conn.request).  Once the
        # request is on the wire, a response-phase failure must raise:
        # blindly re-sending a non-idempotent POST /predict would
        # execute it twice (double-counted stats, two queue slots).
        try:
            conn = self._connection()
            conn.request(method, path, body=body, headers=headers or {})
        except Exception:
            self.close()
            conn = self._connection()
            conn.request(method, path, body=body, headers=headers or {})
        try:
            resp = conn.getresponse()
            data = resp.read()
        except Exception:
            self.close()       # the connection is in an unknown state
            if method not in ("GET", "HEAD"):
                raise
            # idempotent request on a keep-alive socket the server shut
            # between requests (RemoteDisconnected): one clean retry
            conn = self._connection()
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            data = resp.read()
        try:
            payload = json.loads(data.decode("utf-8")) if data else {}
        except ValueError:
            payload = {"raw": data.decode("utf-8", "replace")}
        return resp.status, payload

    def predict(self, model, inputs, npy=False, priority=None,
                deadline_ms=None, tenant=None, request_id=None):
        """``inputs``: {name: per-sample array} (or a bare array for the
        single-input case).  ``priority``/``deadline_ms``/``tenant``
        ride as ``X-MXTPU-*`` headers (work on both body formats).
        Returns ``(status, payload)``.

        Every predict is stamped with an idempotency key
        (``X-MXTPU-Request-Id``, auto-generated unless ``request_id``
        is given) — resending with the SAME id is exactly-once: the
        daemon replays/shares the original execution instead of
        running it twice."""
        if not isinstance(inputs, dict):
            inputs = {"data": inputs}
        qos = {"X-MXTPU-Request-Id":
               str(request_id) if request_id is not None
               else uuid.uuid4().hex}
        if priority is not None:
            qos["X-MXTPU-Priority"] = str(int(priority))
        if deadline_ms is not None:
            qos["X-MXTPU-Deadline-Ms"] = str(float(deadline_ms))
        if tenant is not None:
            qos["X-MXTPU-Tenant"] = str(tenant)
        if npy:
            import io as _pyio
            (name, arr), = inputs.items()
            buf = _pyio.BytesIO()
            np.save(buf, np.asarray(arr, dtype=np.float32))
            return self._request(
                "POST", "/predict/%s" % model, body=buf.getvalue(),
                headers={"Content-Type": "application/x-npy", **qos})
        body = json.dumps(
            {"inputs": {k: np.asarray(v).tolist()
                        for k, v in inputs.items()}}).encode("utf-8")
        return self._request(
            "POST", "/predict/%s" % model, body=body,
            headers={"Content-Type": "application/json", **qos})

    def predict_seq(self, model, tokens, priority=None,
                    deadline_ms=None, tenant=None):
        """POST /predict_seq/<model>: one variable-length token list;
        the daemon buckets, batches, and trims (serving/sequence.py).
        Returns ``(status, payload)`` with per-step ``outputs`` cut to
        the true length."""
        qos = {}
        if priority is not None:
            qos["X-MXTPU-Priority"] = str(int(priority))
        if deadline_ms is not None:
            qos["X-MXTPU-Deadline-Ms"] = str(float(deadline_ms))
        if tenant is not None:
            qos["X-MXTPU-Tenant"] = str(tenant)
        body = json.dumps(
            {"tokens": [int(t) for t in np.asarray(tokens).ravel()]}
        ).encode("utf-8")
        return self._request(
            "POST", "/predict_seq/%s" % model, body=body,
            headers={"Content-Type": "application/json", **qos})

    def swap(self, model, epoch=None):
        """POST /swap/<model>: promote the newest verified epoch (or a
        specific one).  NOT idempotent-retried (it is a POST)."""
        body = json.dumps({} if epoch is None
                          else {"epoch": int(epoch)}).encode("utf-8")
        return self._request(
            "POST", "/swap/%s" % model, body=body,
            headers={"Content-Type": "application/json"})

    def healthz(self):
        return self._request("GET", "/healthz")

    def stats(self):
        return self._request("GET", "/stats")

    def wait_ready(self, deadline_s=60.0):
        """Poll /healthz until the daemon answers; raises on timeout."""
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            try:
                status, payload = self.healthz()
                if status == 200:
                    return payload
            except Exception:  # noqa: BLE001 — not accepting yet
                self.close()
            time.sleep(0.05)
        raise TimeoutError("daemon at %s:%d never became healthy"
                           % (self.host, self.port))
