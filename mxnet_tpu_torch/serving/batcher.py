"""Request batcher: single requests in, padded bucket-shaped batches out.

Port of ``mxnet_tpu/serving/batcher.py`` (host code: the same queues,
policy and fault points, over the port's ``base`` and ``resilience``).
Every dispatched batch has one of a fixed set of power-of-two **bucket**
sizes, so each bucket runs ONE cached executor
(``predict.Predictor``'s per-shape executor cache) instead of binding one
per arrival count.

Dispatch policy (continuous batching): the dispatcher takes everything
queued the moment the previous forward finishes — under load the
in-flight batch IS the wait window, so throughput needs no added
latency.  Only when the queue is smaller than the largest bucket does a
max-wait timer (``MXTPU_SERVE_MAX_WAIT_MS``, measured from the OLDEST
queued request) hold the batch open for stragglers.

PRIORITY + DEADLINES (the anti-starvation half of the SLO story): a
request may carry ``priority`` (higher dispatches first; default 0) and
``deadline_ms`` (a per-request latency budget).  The dispatcher fills
each bucket highest-priority-first — FIFO *within* a priority level, so
equal-priority traffic keeps the exact historical order — and a queued
request whose deadline passes before dispatch is EXPIRED with
:class:`DeadlineExpired` (HTTP 429, ``shed_deadline`` on ``/stats``)
instead of being served as dead work the client already gave up on.
Strictly-FIFO dispatch let one slow tenant hold every later request's
latency hostage; priority ordering bounds that blast radius without
touching the bit-exactness contract (a request's result never depends
on its co-batched rows — only WHEN it runs changes).

TENANT FAIRNESS (weighted-fair queueing): a request may also carry a
``tenant`` label.  Each tenant gets its own queue and a **stride
scheduler** picks which tenant fills the next bucket slot: every pop
charges the tenant's virtual *pass* by ``1/weight``
(``MXTPU_SERVE_TENANT_WEIGHTS``, e.g. ``gold:4,free:1``; unlisted
tenants weigh 1) and the lowest pass goes next — so over any window,
service converges to the weight ratio NO MATTER how hard one tenant
floods.  A tenant reactivating after idling is clamped to the current
virtual time (no banked credit), a per-tenant queued-request quota
(``MXTPU_SERVE_TENANT_QUOTA``) sheds a flooder at admission with
:class:`TenantQuotaExceeded` (HTTP 429, ``shed_tenant``) before it
occupies the shared queue bound, and the existing semantics survive
inside each tenant untouched: priority desc / FIFO within a level per
tenant, deadline expiry everywhere, and the global anti-starvation
floor rides the ELDEST queued request across all tenants.  Requests
that never set a tenant share one default bucket — single-tenant
traffic dispatches in the exact historical order.

BIT-EXACTNESS CONTRACT: a request's result depends only on its own
bytes and the bucket shape it ran at — never on batch fill, its row
position, or co-batched requests.  (cuDNN and cuBLAS pick their
algorithms per shape, so results ARE shape-dependent, which is why
buckets exist: one canonical executor per bucket.  Within a fixed shape
the port keeps the algorithm fixed — ``cudnn.benchmark`` stays off — so
rows of row-independent inference graphs are bit-stable;
``tests/test_torch_serving.py`` and ``chip_smoke.py`` check it.)  Padding
replicates the last real row rather than injecting zeros, so padding can
never create NaN/Inf paths the real rows didn't have.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time

import numpy as np

from ..base import MXNetError, get_env, register_env
from ..resilience import faults

__all__ = ["BucketBatcher", "QueueFull", "Draining", "DeadlineExpired",
           "TenantQuotaExceeded", "parse_buckets", "pick_bucket",
           "pad_to_bucket", "parse_tenant_weights", "DEFAULT_TENANT",
           "ENV_SERVE_BUCKETS", "ENV_SERVE_MAX_WAIT_MS",
           "ENV_SERVE_TENANT_WEIGHTS", "ENV_SERVE_TENANT_QUOTA"]

ENV_SERVE_BUCKETS = register_env(
    "MXTPU_SERVE_BUCKETS", default="1,2,4,8,16,32",
    doc="Comma-separated ascending batch-size buckets for the serving "
        "batcher; each bucket is one cached compiled forward")
ENV_SERVE_MAX_WAIT_MS = register_env(
    "MXTPU_SERVE_MAX_WAIT_MS", default=2.0,
    doc="How long a dispatching batch may hold the queue open for "
        "stragglers, measured from the oldest queued request (ms)")
ENV_SERVE_TENANT_WEIGHTS = register_env(
    "MXTPU_SERVE_TENANT_WEIGHTS", default="",
    doc="Weighted-fair tenant shares for the serving batcher, e.g. "
        "'gold:4,free:1'; unlisted tenants (and requests with no "
        "tenant) weigh 1; empty = all tenants equal")
ENV_SERVE_TENANT_QUOTA = register_env(
    "MXTPU_SERVE_TENANT_QUOTA", default=0,
    doc="Per-tenant queued-request bound in the serving batcher: a "
        "tenant at its quota is shed with HTTP 429 (shed_tenant) while "
        "everyone else keeps queueing; 0 = unbounded")

#: the tenant label for requests that never set one — single-tenant
#: traffic all lands here and dispatches in the exact pre-WFQ order
DEFAULT_TENANT = ""

#: fault points on the batch forward: ``serve_forward`` (arm = failing
#: model, arm_hang = a timed stall) and ``hang_serve_forward`` (a
#: maybe_hang site, so ``MXTPU_FAULTS=hang_serve_forward:1`` wedges the
#: dispatch for the default 3600s from the ENV alone — the watchdog
#: drill's wedged-forward window, same plumbing as ``hang_step``)
SERVE_FORWARD_FAULT = "serve_forward"
SERVE_FORWARD_HANG = "hang_serve_forward"


class QueueFull(MXNetError):
    """Admission refused: the request queue is at its bound."""


class Draining(MXNetError):
    """Admission refused: the daemon is draining for shutdown."""


class DeadlineExpired(MXNetError):
    """The request's deadline passed before its batch dispatched (HTTP
    429, ``shed_deadline``) — the client has already given up, so
    serving it would burn a bucket slot on dead work."""


class TenantQuotaExceeded(MXNetError):
    """The request's tenant already has ``MXTPU_SERVE_TENANT_QUOTA``
    requests queued (HTTP 429, ``shed_tenant``) — the flood is shed at
    admission, before it can occupy the shared queue bound and starve
    every other tenant's admission too."""


def parse_buckets(spec=None):
    """``"1,2,4,8"`` (or an int list) -> validated ascending tuple."""
    if spec is None:
        spec = get_env(ENV_SERVE_BUCKETS)
    if isinstance(spec, str):
        try:
            buckets = tuple(int(p) for p in spec.replace(" ", "").split(",")
                            if p)
        except ValueError:
            raise MXNetError("bad bucket spec %r (want e.g. '1,2,4,8')"
                             % (spec,))
    else:
        buckets = tuple(int(b) for b in spec)
    if not buckets or any(b <= 0 for b in buckets) or \
            list(buckets) != sorted(set(buckets)):
        raise MXNetError("buckets must be positive, ascending, unique: %r"
                         % (buckets,))
    return buckets


def parse_tenant_weights(spec=None):
    """``"gold:4,free:1"`` (or a dict) -> ``{tenant: weight}``; empty
    means every tenant weighs 1.  Weights must be > 0 — a zero share is
    a ban, and bans belong at admission (the quota), not in the
    scheduler where they would starve silently."""
    if spec is None:
        spec = get_env(ENV_SERVE_TENANT_WEIGHTS)
    if isinstance(spec, dict):
        pairs = list(spec.items())
    else:
        spec = (spec or "").strip()
        if not spec:
            return {}
        pairs = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if ":" not in part:
                raise MXNetError("bad tenant weight %r (want "
                                 "'tenant:share')" % (part,))
            name, share = part.rsplit(":", 1)
            pairs.append((name.strip(), share))
    out = {}
    for name, share in pairs:
        try:
            w = float(share)
        except (TypeError, ValueError):
            raise MXNetError("bad tenant weight share %r for %r"
                             % (share, name))
        if w <= 0:
            raise MXNetError(
                "tenant %r weight must be > 0 (got %r) — to ban a "
                "tenant use the quota, not a zero share" % (name, w))
        out[name] = w
    return out


def pick_bucket(n, buckets):
    """Smallest bucket >= ``n`` — NEVER a truncating one.  ``n`` above
    the largest bucket is a caller error (the batcher caps batches at
    the largest bucket before picking)."""
    for b in buckets:
        if b >= n:
            return b
    raise MXNetError("request count %d exceeds the largest bucket %d"
                     % (n, buckets[-1]))


def pad_to_bucket(rows, bucket):
    """Stack per-sample rows and edge-pad (repeat the last real row) to
    ``bucket``.  Returns the (bucket, \\*sample) array."""
    stacked = np.stack(rows)
    n = stacked.shape[0]
    if n == bucket:
        return stacked
    pad = np.repeat(stacked[-1:], bucket - n, axis=0)
    return np.concatenate([stacked, pad], axis=0)


class _Future(object):
    """Single-consumer result slot for one queued request."""

    __slots__ = ("_event", "_result", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error = None

    def set_result(self, value):
        self._result = value
        self._event.set()

    def set_error(self, exc):
        self._error = exc
        self._event.set()

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("request did not complete within %ss"
                               % timeout)
        if self._error is not None:
            raise self._error
        return self._result


class _Request(object):
    __slots__ = ("inputs", "future", "enqueued_at", "priority",
                 "deadline", "seq", "tenant")

    def __init__(self, inputs, priority=0, deadline=None, seq=0,
                 tenant=DEFAULT_TENANT):
        self.inputs = inputs
        self.future = _Future()
        self.enqueued_at = time.monotonic()
        self.priority = int(priority)
        self.deadline = deadline            # absolute monotonic, or None
        self.seq = seq
        self.tenant = tenant

    def heap_key(self):
        """Dispatch order WITHIN a tenant: highest priority first, FIFO
        (arrival seq) within a priority level — the historical
        strict-FIFO order is the seq tiebreak, so equal-priority
        traffic is untouched."""
        return (-self.priority, self.seq)


class BucketBatcher(object):
    """One model's queues + dispatcher thread.

    ``runner(inputs, n_valid)`` receives ``{input_name: (bucket, *sample)
    float32 array}`` and returns a list of per-output ``(bucket, ...)``
    arrays; the batcher splits rows back out to the waiting futures.
    All forwards for the model happen on this one dispatcher thread, so
    the underlying ``Predictor`` needs no locking.
    """

    #: bound on DISTINCT tenant queues (the fairness table must stay a
    #: scan-able dict, not an unbounded attacker-controlled map):
    #: tenant number MAX_TENANTS+1 folds into the default bucket — it
    #: still gets served, it just shares the default tenant's turn
    MAX_TENANTS = 64

    def __init__(self, runner, buckets=None, max_wait_ms=None,
                 max_queue=None, name="model", watchdog=None, stats=None,
                 tenant_weights=None, tenant_quota=None):
        self.runner = runner
        self.name = name
        self.buckets = parse_buckets(buckets)
        if max_wait_ms is None:
            max_wait_ms = float(get_env(ENV_SERVE_MAX_WAIT_MS))
        self.max_wait = max(0.0, float(max_wait_ms)) / 1000.0
        self.max_queue = max_queue          # None = unbounded (frontend
        self.watchdog = watchdog            # owns admission control)
        self.stats = stats
        self.tenant_weights = parse_tenant_weights(tenant_weights)
        self.tenant_quota = int(get_env(ENV_SERVE_TENANT_QUOTA)
                                if tenant_quota is None else tenant_quota)
        self._cv = threading.Condition()
        #: {tenant: heap of (heap_key, _Request)} — per-tenant queues;
        #: single-tenant traffic all lives under DEFAULT_TENANT and
        #: dispatches in the exact pre-WFQ heap order
        self._queues = {}
        #: {tenant: virtual pass} — the stride scheduler state: every
        #: pop charges 1/weight; lowest pass fills the next slot
        self._passes = {}
        #: current virtual time = the pass of the last tenant chosen
        #: (pre-charge); a reactivating tenant is clamped up to it so
        #: idling never banks credit
        self._vtime = 0.0
        self._seq = itertools.count()
        #: queued requests carrying a deadline — the common
        #: deadline-less workload keeps the dispatcher's expiry check
        #: O(1) instead of scanning the heaps every wake
        self._deadlines = 0
        self._inflight = 0
        self._draining = False
        self._closing = False
        #: run_exclusive() gate: while set, the dispatcher takes no new
        #: batch (queued requests WAIT, they are never dropped) — the
        #: hot-swap dispatch boundary (serving/deploy.py)
        self._paused = False
        self._ema_batch_s = None            # EMA of batch service time
        self._sample_shapes = None          # fixed by the first request
        self._thread = threading.Thread(
            target=self._loop, name="mxserve-batch-%s" % name, daemon=True)
        self._thread.start()

    # -- WFQ internals (call with _cv held) --------------------------------
    def _qtotal_locked(self):
        return sum(len(q) for q in self._queues.values())

    def _weight(self, tenant):
        return float(self.tenant_weights.get(tenant, 1.0))

    def _charge_locked(self, tenant):
        self._passes[tenant] = self._passes.get(tenant, 0.0) \
            + 1.0 / self._weight(tenant)

    def _pop_next_locked(self):
        """One stride-scheduler step: lowest-pass tenant with queued
        work pops ITS best request (priority desc, FIFO within) and
        pays 1/weight.  Name tiebreak keeps ties deterministic."""
        tenant = min((t for t, q in self._queues.items() if q),
                     key=lambda t: (self._passes.get(t, 0.0), t))
        self._vtime = self._passes.get(tenant, 0.0)
        req = heapq.heappop(self._queues[tenant])[1]
        self._charge_locked(tenant)
        return req

    def _all_queued_locked(self):
        for q in self._queues.values():
            for entry in q:
                yield entry[1]

    def tenant_depths(self):
        """{tenant: queued count} for every tenant with queued work
        (the /stats fairness surface; the default tenant shows as
        ``""``)."""
        with self._cv:
            return {t: len(q) for t, q in self._queues.items() if q}

    # -- producer side -----------------------------------------------------
    @property
    def depth(self):
        """Queued + in-flight request count (the admission gauge)."""
        with self._cv:
            return self._qtotal_locked() + self._inflight

    def estimate_wait_ms(self):
        """Rough time a NEW request would spend queued: the work ahead
        of it (queued + in-flight rows, in units of largest-bucket
        batches) x the EMA batch service time.  0 for an empty queue or
        until the first batch has been timed (admit optimistically)."""
        with self._cv:
            depth = self._qtotal_locked() + self._inflight
            ema = self._ema_batch_s
        if not ema or not depth:
            return 0.0
        return depth / float(self.buckets[-1]) * ema * 1000.0

    def submit(self, inputs, priority=0, deadline_ms=None, tenant=None):
        """Queue one request (``{input_name: per-sample float32 array}``,
        NO batch dimension) -> future.  ``priority``: higher dispatches
        first (default 0 — all-equal keeps strict FIFO).  ``deadline_ms``:
        latency budget; a request still queued when it runs out is shed
        with :class:`DeadlineExpired` (a non-positive budget sheds
        immediately).  ``tenant``: the fairness label (None = the
        shared default bucket); a tenant at its queued quota is shed
        with :class:`TenantQuotaExceeded`.  Raises :class:`Draining`
        during shutdown and :class:`QueueFull` at the queue bound."""
        tenant = DEFAULT_TENANT if tenant is None else str(tenant)
        deadline = None
        if deadline_ms is not None:
            if float(deadline_ms) <= 0:
                if self.stats is not None:
                    self.stats.inc("shed_deadline")
                raise DeadlineExpired(
                    "model %r: deadline budget %.1fms already spent"
                    % (self.name, float(deadline_ms)))
            deadline = time.monotonic() + float(deadline_ms) / 1000.0
        shapes = {k: tuple(np.shape(v)) for k, v in inputs.items()}
        with self._cv:
            if self._draining:
                raise Draining("model %r is draining" % self.name)
            if self.max_queue is not None and \
                    self._qtotal_locked() >= self.max_queue:
                raise QueueFull("model %r queue is at its bound (%d)"
                                % (self.name, self.max_queue))
            if tenant != DEFAULT_TENANT and tenant not in self._queues \
                    and len(self._queues) >= self.MAX_TENANTS:
                tenant = DEFAULT_TENANT     # see MAX_TENANTS
            q = self._queues.get(tenant)
            if self.tenant_quota > 0 and q is not None and \
                    len(q) >= self.tenant_quota:
                if self.stats is not None:
                    self.stats.inc("shed_tenant")
                raise TenantQuotaExceeded(
                    "model %r: tenant %r is at its queued quota (%d) — "
                    "shed, not queued" % (self.name, tenant,
                                          self.tenant_quota))
            if self._sample_shapes is None:
                self._sample_shapes = shapes
            elif shapes != self._sample_shapes:
                raise MXNetError(
                    "request shapes %s do not match the model's %s"
                    % (shapes, self._sample_shapes))
            if q is None:
                q = self._queues[tenant] = []
            if not q:
                # (re)activation: no banked credit from idling — the
                # tenant joins at the CURRENT virtual time, it does not
                # cash in every turn it skipped
                self._passes[tenant] = max(
                    self._passes.get(tenant, 0.0), self._vtime)
            req = _Request(inputs, priority=priority, deadline=deadline,
                           seq=next(self._seq), tenant=tenant)
            heapq.heappush(q, (req.heap_key(), req))
            if deadline is not None:
                self._deadlines += 1
            self._cv.notify_all()
        return req.future

    # -- dispatcher --------------------------------------------------------
    def _loop(self):
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            try:
                self._run_batch(batch)
            finally:
                with self._cv:
                    self._inflight = 0
                    self._cv.notify_all()

    def _expire_locked(self):
        """Drop queued requests whose deadline has passed (call with
        ``_cv`` held): their futures raise :class:`DeadlineExpired` and
        ``shed_deadline`` counts them — dispatching them would spend a
        bucket slot on work the client has already abandoned."""
        if not self._deadlines:
            return                  # O(1) for deadline-less traffic
        now = time.monotonic()
        if not any(r.deadline is not None and r.deadline <= now
                   for r in self._all_queued_locked()):
            return
        dead = []
        for tenant, q in self._queues.items():
            live, mine = [], []
            for entry in q:
                req = entry[1]
                if req.deadline is not None and req.deadline <= now:
                    mine.append(req)
                else:
                    live.append(entry)
            if mine:
                heapq.heapify(live)
                self._queues[tenant] = live
                dead.extend(mine)
        self._deadlines -= len(dead)
        for req in dead:
            req.future.set_error(DeadlineExpired(
                "model %r: deadline passed after %.1fms queued"
                % (self.name, (now - req.enqueued_at) * 1000.0)))
            if self.stats is not None:
                self.stats.inc("shed_deadline")

    #: anti-starvation floor: a queued request older than
    #: ``max(8 x max_wait, STARVATION_S)`` seconds claims one slot of
    #: the next batch UNCONDITIONALLY, priority and tenant passes
    #: notwithstanding.  Without it, sustained higher-priority arrivals
    #: at >= service rate could hold a low-priority request in the
    #: queue forever (the max-wait timer forces *a* dispatch, not *its*
    #: dispatch) — priorities delay work, they must never starve it.
    #: The floor rides the GLOBAL eldest across all tenants (and still
    #: charges its tenant's pass: guaranteed progress, not free
    #: service).  One slot per batch gives the aged head-of-line
    #: guaranteed progress while the rest of the bucket still fills by
    #: the fair-share order.
    STARVATION_S = 0.25

    def _next_batch(self):
        """Block for the first request, then hold the batch open until
        the largest bucket fills or the oldest request ages past
        max_wait (draining skips the wait — flush what is queued).
        Slot-fill order is the stride scheduler's (lowest tenant pass;
        priority desc / FIFO within the tenant) — except that a request
        past the starvation bound rides first (see
        :data:`STARVATION_S`); past-deadline entries are expired, never
        dispatched."""
        cap = self.buckets[-1]
        with self._cv:
            while True:
                self._expire_locked()
                if self._paused and not self._closing:
                    # a hot swap holds the dispatch boundary: requests
                    # keep queueing, the next batch waits for the new
                    # weights (a close() overrides — shutdown wins)
                    self._cv.wait(0.05)
                    continue
                total = self._qtotal_locked()
                if not total:
                    if self._closing:
                        return None
                    self._cv.wait(0.1)
                    continue
                # max-wait is measured from the OLDEST queued request
                # regardless of priority or tenant — a low-priority
                # straggler cannot be deferred past the wait bound
                oldest = min(r.enqueued_at
                             for r in self._all_queued_locked())
                left = self.max_wait - (time.monotonic() - oldest)
                if total >= cap or self._draining or left <= 0:
                    break
                self._cv.wait(min(left, 0.02))
            take = min(self._qtotal_locked(), cap)
            batch = []
            eldest = min(self._all_queued_locked(),
                         key=lambda r: r.enqueued_at)
            bound = max(8.0 * self.max_wait, self.STARVATION_S)
            if time.monotonic() - eldest.enqueued_at > bound:
                q = self._queues[eldest.tenant]
                q.remove((eldest.heap_key(), eldest))
                heapq.heapify(q)
                self._charge_locked(eldest.tenant)
                batch.append(eldest)
            while len(batch) < take:
                batch.append(self._pop_next_locked())
            self._deadlines -= sum(1 for r in batch
                                   if r.deadline is not None)
            self._inflight = len(batch)
        return batch

    def _run_batch(self, batch):
        n = len(batch)
        try:
            bucket = pick_bucket(n, self.buckets)
            inputs = {k: pad_to_bucket([r.inputs[k] for r in batch], bucket)
                      for k in batch[0].inputs}
            label = "serve %s batch n=%d bucket=%d" % (self.name, n, bucket)
            tic = time.monotonic()
            if self.watchdog is not None:
                with self.watchdog.armed(label):
                    faults.maybe_trip(SERVE_FORWARD_FAULT)
                    faults.maybe_hang(SERVE_FORWARD_HANG)
                    outs = self.runner(inputs, n)
            else:
                faults.maybe_trip(SERVE_FORWARD_FAULT)
                faults.maybe_hang(SERVE_FORWARD_HANG)
                outs = self.runner(inputs, n)
            dt = time.monotonic() - tic
        except Exception as e:  # noqa: BLE001 — every waiter must wake
            for r in batch:
                r.future.set_error(e)
            with self._cv:
                if not self._qtotal_locked():
                    # the pinned shapes may be the very thing that made
                    # this batch fail (a malformed first request) — let
                    # the next request after a drained queue re-pin
                    # rather than rejecting correct traffic forever
                    self._sample_shapes = None
            return
        self._ema_batch_s = dt if self._ema_batch_s is None \
            else 0.8 * self._ema_batch_s + 0.2 * dt
        if self.stats is not None:
            self.stats.record_batch(n, bucket, dt)
        now = time.monotonic()
        for i, r in enumerate(batch):
            r.future.set_result(
                [o[i] if np.ndim(o) and np.shape(o)[0] == bucket else o
                 for o in outs])
            if self.stats is not None:
                self.stats.record_latency(
                    (now - r.enqueued_at) * 1000.0,
                    tenant=r.tenant if r.tenant != DEFAULT_TENANT
                    else None)

    def run_exclusive(self, fn, timeout=30.0):
        """Run ``fn()`` at the DISPATCH BOUNDARY: wait for the in-flight
        batch to finish, keep the dispatcher from taking the next one
        while ``fn`` runs, then resume.  This is the serving hot-swap
        point (serving/deploy.py): the in-flight batch completes on the
        old weights, the batch after ``fn`` sees the new ones, and no
        queued request is dropped or errored — they just wait out
        ``fn``'s (milliseconds-scale) critical section.

        Raises :class:`MXNetError` when the in-flight batch does not
        finish within ``timeout`` (a wedged forward is the watchdog's
        job — the swap must not pile onto it)."""
        deadline = time.monotonic() + float(timeout)
        with self._cv:
            while self._paused:     # one exclusive section at a time
                if time.monotonic() >= deadline:
                    raise MXNetError(
                        "model %r: another exclusive section held the "
                        "dispatch boundary for %.1fs" % (self.name,
                                                         timeout))
                self._cv.wait(0.05)
            self._paused = True
            self._cv.notify_all()
            while self._inflight:
                if time.monotonic() >= deadline:
                    self._paused = False
                    self._cv.notify_all()
                    raise MXNetError(
                        "model %r: in-flight batch did not finish "
                        "within %.1fs — not swapping onto a wedged "
                        "forward" % (self.name, timeout))
                self._cv.wait(0.05)
        try:
            return fn()
        finally:
            with self._cv:
                self._paused = False
                self._cv.notify_all()

    # -- lifecycle ---------------------------------------------------------
    def close(self, drain=True, timeout=30.0):
        """Stop the dispatcher.  ``drain=True`` refuses new submissions
        but finishes everything already queued/in flight first (the
        SIGTERM contract: no accepted request is dropped)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            self._draining = True
            if not drain:
                dropped = list(self._all_queued_locked())
                self._queues = {}
                self._deadlines = 0
            else:
                dropped = []
            self._cv.notify_all()
        for r in dropped:
            r.future.set_error(Draining("dropped: close(drain=False)"))
        with self._cv:
            while self._qtotal_locked() or self._inflight:
                if time.monotonic() >= deadline:
                    break
                self._cv.wait(0.1)
            self._closing = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)
