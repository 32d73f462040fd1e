"""Routing front end: ONE public HTTP port in front of N replica
daemons (port of ``mxnet_tpu/fleet/router.py``).

The Clipper split, scaled out: the router owns admission and placement,
the replicas own weights and batching.  Policy per request:

- **route by model**: each model's HOME replica (a stable function of
  the manifest — ``FleetManifest.home``) takes its traffic by default,
  concentrating a model's buckets where they stay hot.
- **spill**: when the home's reported queue depth for the model (the
  ``/stats`` surface mxserve already exposes, plus the router's own
  in-flight count toward that replica) reaches
  ``MXTPU_FLEET_SPILL_QUEUE``, or its estimated wait crosses the SLO
  bar, the request goes to the least-loaded healthy replica instead —
  every replica holds the whole warm pool, so spilling needs no model
  load.
- **health**: a poll thread GETs ``/healthz`` + ``/stats`` from every
  replica each ``MXTPU_FLEET_HEARTBEAT_S``; a replica whose last
  successful heartbeat is older than ``MXTPU_FLEET_EVICT_S`` is EVICTED
  from routing until it answers again (a respawned replica rejoins the
  moment its new port file appears and a probe succeeds).

EXACTLY-ONCE STANCE: a predict
in flight to a replica that dies is resent ONCE to a different healthy
replica with the SAME idempotency key (``X-MXTPU-Request-Id``) — safe
because (a) each replica's dedup cache collapses a duplicate onto the
original execution, and (b) even on a dedup miss the batcher's
bit-exactness contract makes re-execution of the same bytes
bit-identical (serving/batcher.py; on a card both replicas must pick
the same convolution algorithms for a bucket shape, which is why
``cudnn.benchmark`` stays off in the daemon).  A retried success carries
``"retried": true``; only when NO other healthy replica exists (or the
resend also dies) does the client see a 502.  Tail defense rides the
same key: a request older than an adaptive latency percentile is
HEDGED to the next-least-loaded replica (MXTPU_FLEET_HEDGE_PCT), first
answer wins, and under brownout (aggregate est_wait past
MXTPU_FLEET_BROWNOUT_MS) the router sheds low-priority/over-quota
work with Retry-After 429s before queues build.  ``POST /swap`` keeps
the never-retried stance — a swap is not keyed and genuinely not
idempotent (fleet/deploy.py).

Shutdown: SIGTERM fences new work (503 on the public port), waits for
the router's in-flight forwards, then forwards the drain to every
replica through the controller (each drains to rc 0 — the mxserve
contract), then stops.  ``/stats`` aggregates the per-replica counters
plus the router-measured fleet-level p50/p99.
"""
from __future__ import annotations

import glob
import json
import os
import queue
import signal
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler

from ..base import MXNetError, get_env, register_env
from ..resilience import faults
from ..serving.frontend import ServeHTTPServer, Stats
from .view import FleetViewReader, OutlierDetector, worker_stats_path

__all__ = ["FleetRouter", "NoHealthyReplica", "ReplicaDead",
           "ENV_FLEET_SPILL_QUEUE", "ENV_FLEET_HEARTBEAT_S",
           "ENV_FLEET_EVICT_S", "ENV_FLEET_HEDGE_PCT",
           "ENV_FLEET_HEDGE_MIN_MS", "ENV_FLEET_BROWNOUT_MS"]

ENV_FLEET_SPILL_QUEUE = register_env(
    "MXTPU_FLEET_SPILL_QUEUE", default=8,
    doc="Queue depth (replica-reported + router in-flight) at a model's "
        "home replica beyond which the router spills the request to the "
        "least-loaded healthy replica")
ENV_FLEET_HEARTBEAT_S = register_env(
    "MXTPU_FLEET_HEARTBEAT_S", default=1.0,
    doc="Router health-poll period: every replica's /healthz + /stats "
        "are probed this often (also the staleness bound on the routing "
        "signal)")
ENV_FLEET_EVICT_S = register_env(
    "MXTPU_FLEET_EVICT_S", default=5.0,
    doc="Heartbeat age beyond which a replica is evicted from routing "
        "(it rejoins on the next successful probe — e.g. after the "
        "controller respawned it)")
ENV_FLEET_HEDGE_PCT = register_env(
    "MXTPU_FLEET_HEDGE_PCT", default=0.0,
    doc="Hedged requests: a forward older than this percentile of "
        "recent router-observed latency gets a backup sent to the "
        "next-least-loaded replica with the same idempotency key, "
        "first answer wins (losers count `hedge_wasted`); 0 disables "
        "hedging (it is also gated off with <2 routable replicas or "
        "in brownout)")
ENV_FLEET_HEDGE_MIN_MS = register_env(
    "MXTPU_FLEET_HEDGE_MIN_MS", default=25.0,
    doc="Floor on the adaptive hedge trigger: never hedge a request "
        "younger than this many ms, whatever the latency percentile "
        "says (bounds duplicate-execution cost at low latency)")
ENV_FLEET_BROWNOUT_MS = register_env(
    "MXTPU_FLEET_BROWNOUT_MS", default=0.0,
    doc="Brownout admission control: when the fleet's aggregate "
        "est_wait_ms (the autoscaler's pressure signal) exceeds this, "
        "router workers shed priority<=0 and over-quota-tenant work "
        "with Retry-After 429s BEFORE queues build; 0 disables")

#: fault point: after a delivered forward, the router re-sends the
#: SAME request (same body, same idempotency key) once more — the
#: deterministic duplicate that proves the replica-side dedup cache
#: collapses it instead of double-executing
DUP_REQUEST_FAULT = "dup_request"


class NoHealthyReplica(MXNetError):
    """No routable replica for the request (HTTP 503)."""


class ReplicaDead(MXNetError):
    """The forward to the chosen replica failed at the transport level
    — the caller applies the exactly-once stance (one keyed resend to
    a different healthy replica; HTTP 502 only when that is
    impossible)."""


class _ReplicaView(object):
    """The router's picture of one replica (updated by the health loop
    + forwarding outcomes)."""

    __slots__ = ("id", "addr", "last_ok", "stats", "inflight", "probes",
                 "probe_retries", "errors", "draining")

    def __init__(self, rid):
        self.id = rid
        self.addr = None            # (host, port) once known
        self.last_ok = None         # monotonic of last good /healthz
        self.stats = None           # last /stats payload
        self.inflight = 0           # router-side forwards in flight
        self.probes = 0
        self.probe_retries = 0      # jittered second tries (GETs only)
        self.errors = 0
        self.draining = False       # the last probe found it draining


class FleetRouter(object):
    """``endpoints``: a :class:`~.controller.ReplicaController` (live
    port discovery + drain forwarding), a static ``{id: (host, port)}``
    dict (tests, external replicas), or a
    :class:`~.view.FleetViewReader` — **view mode**, the sharded front
    end's worker: health, addresses, per-replica stats and the fenced
    set all come from the published snapshot, this process never probes
    and never fences.  ``reuse_port`` binds the public port with
    SO_REUSEPORT so N workers share it; ``worker_id`` + ``run_dir``
    turn on the periodic counter dump that lets ANY worker answer
    ``/stats`` for the whole shard (sibling dumps merged with live
    counters)."""

    def __init__(self, endpoints, manifest, host="127.0.0.1", port=0,
                 spill_queue=None, heartbeat_s=None, evict_s=None,
                 slo_ms=0.0, request_timeout=60.0, reuse_port=False,
                 worker_id=None, run_dir=None):
        self.manifest = manifest
        self.host, self.port = host, int(port)
        self.reuse_port = bool(reuse_port)
        self.worker_id = worker_id
        self.run_dir = run_dir
        self.spill_queue = int(get_env(ENV_FLEET_SPILL_QUEUE)
                               if spill_queue is None else spill_queue)
        self.heartbeat_s = float(get_env(ENV_FLEET_HEARTBEAT_S)
                                 if heartbeat_s is None else heartbeat_s)
        self.evict_s = float(get_env(ENV_FLEET_EVICT_S)
                             if evict_s is None else evict_s)
        self.slo_ms = float(slo_ms or 0.0)
        self.request_timeout = float(request_timeout)
        self.hedge_pct = float(get_env(ENV_FLEET_HEDGE_PCT))
        self.hedge_min_ms = float(get_env(ENV_FLEET_HEDGE_MIN_MS))
        self.brownout_ms = float(get_env(ENV_FLEET_BROWNOUT_MS))
        #: gray-failure ejection (controller/static mode only: a view
        #: worker inherits ejection through the published healthy bit)
        self.outliers = OutlierDetector(
            hold_s=max(2.0 * self.heartbeat_s, 1.0))
        self.stats = Stats()
        self.draining = False
        self._controller = None
        self._static = None
        self._view = None
        self._views = {}
        #: rid -> the forward connections awaiting its answer
        #: (``_abort_evicted``)
        self._inflight = {}
        if isinstance(endpoints, FleetViewReader):
            self._view = endpoints      # worker: snapshot-fed, no probe
        elif hasattr(endpoints, "ports"):
            self._controller = endpoints
            if len(endpoints.replicas) < 1:
                raise MXNetError("a fleet needs at least one replica")
            for rid in range(len(endpoints.replicas)):
                self._views[rid] = _ReplicaView(rid)
        else:
            self._static = {rid: tuple(addr)
                            for rid, addr in dict(endpoints).items()}
            if len(self._static) < 1:
                raise MXNetError("a fleet needs at least one replica")
            for rid in self._static:
                self._views[rid] = _ReplicaView(rid)
        self._order = sorted(self._views)
        #: replicas held out of routing by a rolling swap
        #: (fleet/deploy.py): fenced != evicted — the replica is
        #: healthy and still finishing its in-flight work, it just
        #: takes no NEW work while its weights swap
        self._fenced = set()
        #: the active RollingSwap, when one is attached (fleet serve
        #: --watch) — surfaced on /stats as rollout progress
        self.deploy = None
        self._lock = threading.Lock()
        self._local = threading.local()
        self._server = None
        self._stopped = threading.Event()
        self._stop_health = threading.Event()
        self._health_thread = None
        self._stop_dump = threading.Event()
        self._dump_thread = None
        #: serve/drain handshake: a drain that arrives BEFORE the
        #: accept loop starts marks _aborted so serve_forever returns
        #: immediately instead of serving a drained fleet forever;
        #: once _serving, the drain uses server.shutdown().  The lock
        #: makes the two transitions atomic — without it a drain could
        #: check "not serving yet" in the same instant the accept loop
        #: starts, and neither side would stop the server.
        self._life_lock = threading.Lock()
        self._serving = False
        self._aborted = False
        self.replica_rcs = None     # {id: rc} after a drain

    # -- replica discovery + health ---------------------------------------
    def _addresses(self):
        if self._static is not None:
            return dict(self._static)
        if self._view is not None:
            self._sync_view()
            with self._lock:
                return {rid: v.addr for rid, v in self._views.items()}
        addrs = {rid: ("127.0.0.1", port) if port is not None else None
                 for rid, port in self._controller.ports().items()}
        # the replica SET is dynamic under autoscaling: adopt new
        # replicas, drop scaled-down ones (their fences go with them)
        with self._lock:
            for rid in addrs:
                if rid not in self._views:
                    self._views[rid] = _ReplicaView(rid)
            for rid in [r for r in self._views if r not in addrs]:
                del self._views[rid]
                self._fenced.discard(rid)
            self._order = sorted(self._views)
        return addrs

    def _sync_view(self):
        """View mode: refresh the routing state from the published
        snapshot (addresses, per-replica stats, health, the fenced
        set).  A replica the snapshot calls healthy is routable NOW —
        even off a stale snapshot (publisher hiccup): routing to a
        last-known-healthy replica is safe, because a death since the
        snapshot surfaces as a transport failure the exactly-once
        stance absorbs (one keyed resend elsewhere).  Worker-local
        inflight/error counters survive the sync."""
        doc = self._view.doc()
        now = time.monotonic()
        with self._lock:
            seen = set()
            for key, ent in (doc.get("replicas") or {}).items():
                rid = ent.get("id", key)
                seen.add(rid)
                view = self._views.get(rid)
                if view is None:
                    view = self._views[rid] = _ReplicaView(rid)
                addr = ent.get("addr")
                view.addr = tuple(addr) if addr else None
                view.stats = ent.get("stats")
                view.last_ok = now if ent.get("healthy") else None
            for rid in [r for r in self._views if r not in seen]:
                del self._views[rid]
            self._fenced = set(doc.get("fenced") or [])
            self._order = sorted(self._views)

    def _probe_one(self, view, addr):
        """One /healthz (+ /stats) round trip; returns ``"ok"``,
        ``"draining"`` (the replica deliberately fenced itself) or
        ``"down"`` (transport-level miss)."""
        import http.client
        conn = http.client.HTTPConnection(
            addr[0], addr[1], timeout=max(0.2, min(self.heartbeat_s,
                                                   2.0)))
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                return "down"
            payload = json.loads(body.decode("utf-8"))
            if payload.get("status") == "draining":
                # a draining replica takes no work — evict it NOW, not
                # after the heartbeat age runs out (a rolling restart
                # would otherwise bounce 503s off it for evict_s)
                with self._lock:
                    view.last_ok = None
                    view.draining = True
                return "draining"
            conn.request("GET", "/stats")
            resp = conn.getresponse()
            sbody = resp.read()
            stats = json.loads(sbody.decode("utf-8")) \
                if resp.status == 200 else None
        except Exception:  # noqa: BLE001 — any transport failure = miss
            return "down"
        finally:
            conn.close()
        with self._lock:
            view.addr = addr
            view.last_ok = time.monotonic()
            view.draining = False
            if stats is not None:
                view.stats = stats
        return "ok"

    #: upper bound on the jittered pause before a probe's single retry
    PROBE_RETRY_JITTER_S = 0.08

    def probe(self):
        """One full probe pass (the health loop's body; also called
        synchronously at start so the first routed request never races
        the first heartbeat).

        A transport-level miss gets ONE retry after a jittered pause
        before the heartbeat-age clock is allowed to advance toward
        eviction: a single dropped packet on a loaded replica must not
        start the eviction countdown.  (Predict forwards have their own
        keyed retry discipline in ``proxy_predict`` — these probe GETs
        retry freely because they are idempotent by nature.)  A replica
        that reported ``draining`` is a deliberate eviction, not a
        miss: no retry.

        Retries run CONCURRENTLY with one bounded join: a few
        black-holed hosts (each costing a full connect timeout) must
        not stretch the pass past ``evict_s`` and age out the healthy
        replicas that were stamped at the start of it."""
        import random
        if self._view is not None:
            # workers NEVER probe — that is the whole point of the
            # shared view (one prober, N consumers)
            return self.healthy()
        addrs = self._addresses()
        misses = []
        for rid, view in list(self._views.items()):
            with self._lock:
                view.probes += 1
            addr = addrs.get(rid)
            if addr is None:
                continue            # no port file yet (spawning)
            if self._probe_one(view, addr) == "down":
                misses.append((view, addr))
        if misses:
            def _retry(view, addr):
                time.sleep(random.uniform(
                    0.0, min(self.PROBE_RETRY_JITTER_S,
                             self.heartbeat_s / 4.0)))
                with self._lock:
                    view.probe_retries += 1
                self._probe_one(view, addr)

            threads = [threading.Thread(target=_retry, args=m,
                                        name="mxfleet-probe-retry",
                                        daemon=True)
                       for m in misses]
            for t in threads:
                t.start()
            deadline = time.monotonic() + min(self.heartbeat_s, 2.0) \
                + self.PROBE_RETRY_JITTER_S
            for t in threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
        self._abort_evicted()
        self._update_outliers()
        return self.healthy()

    def _abort_evicted(self):
        """Fail now the in-flight forwards to every replica the heartbeat
        has evicted (a draining replica answers what it holds and keeps
        them).  A SIGKILLed replica whose process is still tearing down
        its CUDA context, or a wedged one, holds its sockets open without
        answering, for up to the forward's ``request_timeout`` — as long
        as a client waits, so the keyed resend came too late; shutting
        the socket down turns the forward into ``ReplicaDead`` and the
        resend goes out at eviction."""
        now = time.monotonic()
        with self._lock:
            doomed = []
            for rid, conns in self._inflight.items():
                view = self._views.get(rid)
                if view is None or view.draining or not conns:
                    continue
                if view.last_ok is None or now - view.last_ok > self.evict_s:
                    doomed.extend(conns)
        for conn in doomed:
            sock = getattr(conn, "sock", None)
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def _update_outliers(self):
        """Feed the gray-failure detector one pass (controller/static
        mode; the probe loop's tail): recent-p99 per replica from its
        own /stats, cumulative forward errors, and the pre-ejection
        routable set so the detector can hold its max-eject/N-1
        floor."""
        det = self.outliers
        if not det.enabled or self._view is not None:
            return
        now = time.monotonic()
        with self._lock:
            routable = [rid for rid in self._order
                        if rid not in self._fenced
                        and self._views[rid].last_ok is not None
                        and now - self._views[rid].last_ok <= self.evict_s
                        and self._views[rid].addr is not None]
            lat, errs = {}, {}
            for rid in routable:
                view = self._views[rid]
                lm = ((view.stats or {}).get("latency_ms") or {})
                sample = lm.get("p99_recent", lm.get("p99"))
                if sample is not None:
                    lat[rid] = float(sample)
                errs[rid] = view.errors
        for key, n in det.update(routable, lat, errs, now=now).items():
            if n:
                self.stats.inc(key, n)

    def _health_loop(self):
        while not self._stop_health.wait(self.heartbeat_s):
            try:
                self.probe()
            except Exception:  # noqa: BLE001 — the loop must survive
                pass

    def healthy(self):
        """Routable replica ids: probed OK within the eviction window,
        not fenced by a rolling swap, and not held out by gray-failure
        ejection (view mode: as the published snapshot says — the sync
        stamps healthy replicas fresh, so a stale snapshot keeps its
        last-known-healthy set routable; the snapshot's healthy bit
        already folds controller-side ejection)."""
        if self._view is not None:
            self._sync_view()
            ejected = set()
        else:
            ejected = self.outliers.ejected()
        now = time.monotonic()
        with self._lock:
            return [rid for rid in self._order
                    if rid not in self._fenced
                    and rid not in ejected
                    and self._views[rid].last_ok is not None
                    and now - self._views[rid].last_ok <= self.evict_s
                    and self._views[rid].addr is not None]

    # -- rolling-swap fencing (fleet/deploy.py) ----------------------------
    def fence(self, rid):
        """Hold ``rid`` out of routing (new traffic goes elsewhere;
        its in-flight work finishes normally).  Raises when fencing it
        would leave NO routable replica — a rollout must never take
        the last server away (capacity floor N-1)."""
        if self._view is not None:
            raise MXNetError(
                "fencing is the controller's job in sharded mode — "
                "fence via the publisher-side router, the snapshot "
                "carries it to every worker")
        now = time.monotonic()
        ejected = self.outliers.ejected()
        with self._lock:
            others = [r for r in self._order
                      if r != rid and r not in self._fenced
                      and r not in ejected
                      and self._views[r].last_ok is not None
                      and now - self._views[r].last_ok <= self.evict_s
                      and self._views[r].addr is not None]
            if not others:
                raise MXNetError(
                    "fencing replica %s would leave no routable "
                    "replica — rollout must wait (a 1-replica fleet "
                    "swaps in place: the swap itself is drop-free)"
                    % (rid,))
            self._fenced.add(rid)
        return self

    def unfence(self, rid):
        """Rejoin ``rid`` to routing (the swap finished or failed —
        either way the replica serves a consistent epoch)."""
        with self._lock:
            self._fenced.discard(rid)
        return self

    def fenced(self):
        with self._lock:
            return sorted(self._fenced)

    def view_export(self):
        """Per-replica routing state for the shared fleet view
        (fleet/view.py publishes it; router workers consume it).  The
        ``healthy`` flag already folds in fencing — a worker needs one
        bit, not the derivation."""
        healthy = set(self.healthy())
        eject = self.outliers.export()
        ctrl = {r["id"]: r for r in self._controller.snapshot()} \
            if self._controller is not None else {}
        out = {}
        with self._lock:
            for rid in self._order:
                view = self._views[rid]
                sup = ctrl.get(rid, {})
                out[str(rid)] = {
                    "id": rid,
                    "addr": list(view.addr) if view.addr else None,
                    # the healthy bit folds fencing AND ejection — a
                    # worker needs one bit; the eject detail rides
                    # alongside for observability
                    "healthy": rid in healthy,
                    "ejected": bool(
                        (eject.get(rid) or {}).get("ejected")),
                    "stats": view.stats,
                    "forward_errors": view.errors,
                    "state": sup.get("state"),
                    # supervision fields travel with the view: in the
                    # sharded front end the controller lives in the
                    # parent, but any worker must still answer the full
                    # /stats table (pid drives kill-replica drills,
                    # restarts drives respawn crediting)
                    "pid": sup.get("pid"),
                    "restarts": sup.get("restarts"),
                    "last_rc": sup.get("last_rc")}
        return out

    # -- routing policy ----------------------------------------------------
    def _load(self, view, model=None):
        """Routing load signal: replica-reported queue depth (per model
        when asked, total otherwise) + the router's own in-flight count
        toward it (the fast-moving half of the signal)."""
        depth = 0
        if view.stats:
            depths = view.stats.get("queue_depth") or {}
            depth = depths.get(model, 0) if model is not None \
                else sum(depths.values())
        return depth + view.inflight

    def route(self, model):
        """Pick the replica for one request; raises
        :class:`NoHealthyReplica` when nothing is routable.  Returns
        ``(replica_id, reason)`` with ``reason`` one of ``None`` (the
        healthy home took it), ``"spilled"`` (the home was healthy but
        past its depth/SLO bar — the LOAD policy moved it) or
        ``"rerouted"`` (the home was not routable — failover, counted
        separately so the spill counter stays evidence of load spill,
        not of dead homes)."""
        if model not in self.manifest.models:
            raise MXNetError("no model %r in the fleet manifest "
                             "(have: %s)" % (model, self.manifest.names()))
        candidates = self.healthy()
        if not candidates:
            raise NoHealthyReplica(
                "no healthy replica for %r (fleet of %d, all evicted "
                "or starting)" % (model, len(self._views)))
        if self._view is not None:
            age = self._view.age_s()
            if age is not None and age > self.evict_s:
                # routing on a stale snapshot is SAFE (the keyed
                # resend covers any death since) but worth counting: a
                # climbing stale_view_routes means the publisher is
                # gone
                self.stats.inc("stale_view_routes")
        home = self._order[self.manifest.home(model) % len(self._order)]
        with self._lock:
            if home in candidates:
                hview = self._views[home]
                depth = self._load(hview, model)
                est = ((hview.stats or {}).get("est_wait_ms") or {}) \
                    .get(model, 0.0)
                if depth < self.spill_queue and \
                        (self.slo_ms <= 0 or est <= self.slo_ms):
                    return home, None
            # spill/reroute: least-loaded healthy replica, ties broken
            # AWAY from the home — a home past its bar sheds overflow
            # when loads tie (that is what the bar means), but a
            # deeper-loaded alternative never wins just for not being
            # the home (spill balances load, it must not invert it)
            best = min(candidates,
                       key=lambda rid: (self._load(self._views[rid]),
                                        rid == home, rid))
        if best == home:
            return best, None
        return best, "spilled" if home in candidates else "rerouted"

    # -- forwarding --------------------------------------------------------
    #: retire a pooled keep-alive connection idle longer than this:
    #: the replica handler's socket timeout closes ITS side after 10s
    #: (serving/frontend.py), and a request written onto such a socket
    #: fails at getresponse() — which this router must treat as a dead
    #: replica (one keyed resend elsewhere, then 502).  Refreshing
    #: before the replica's deadline keeps idle gaps from minting
    #: spurious retries.
    CONN_IDLE_S = 5.0

    def _connection(self, rid, addr, fresh=False):
        """Per-(handler-)thread keep-alive connection to a replica."""
        import http.client
        pool = getattr(self._local, "conns", None)
        if pool is None:
            pool = self._local.conns = {}
        key = (rid, addr)
        now = time.monotonic()
        entry = pool.get(key)
        if entry is not None and not fresh and \
                now - entry[1] <= self.CONN_IDLE_S:
            conn = entry[0]
        else:
            if entry is not None:
                entry[0].close()
            conn = http.client.HTTPConnection(
                addr[0], addr[1], timeout=self.request_timeout)
        pool[key] = (conn, now)
        return conn

    def forward(self, rid, method, path, body=None, headers=None):
        """One proxied request -> ``(status, raw_body, content_type)``.
        A transport failure raises :class:`ReplicaDead`; THIS method
        never resends — the exactly-once retry decision (same key,
        different replica, once) belongs to :meth:`proxy_predict`."""
        with self._lock:
            addr = self._views[rid].addr
        if addr is None:
            raise ReplicaDead("replica %d has no known address" % rid)
        try:
            conn = self._connection(rid, addr)
            try:
                conn.request(method, path, body=body,
                             headers=headers or {})
            except Exception:
                # the keep-alive socket may have idled out between
                # requests; ONE fresh connection for the SEND phase only
                # (nothing reached the replica yet — not a resend)
                conn = self._connection(rid, addr, fresh=True)
                conn.request(method, path, body=body,
                             headers=headers or {})
            # the heartbeat fails it if the replica is evicted meanwhile
            with self._lock:
                self._inflight.setdefault(rid, set()).add(conn)
            try:
                resp = conn.getresponse()
                data = resp.read()
            finally:
                with self._lock:
                    self._inflight.get(rid, set()).discard(conn)
            ctype = resp.getheader("Content-Type") or "application/json"
            return resp.status, data, ctype
        except Exception as e:  # noqa: BLE001 — transport-level loss
            pool = getattr(self._local, "conns", None)
            dead = pool.pop((rid, addr), None) if pool else None
            if dead is not None:
                try:
                    dead[0].close()
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    pass
            with self._lock:
                self._views[rid].errors += 1
            raise ReplicaDead(
                "replica %d died mid-request (%s: %s)"
                % (rid, type(e).__name__, e))

    # -- load pressure (shared with fleet/autoscale.py) --------------------
    def pressure_ms(self):
        """Aggregate fleet pressure: mean over healthy replicas of each
        one's worst per-model ``est_wait_ms``.  ONE definition, two
        consumers — the autoscaler's scale signal (fleet/autoscale.py)
        and the brownout admission gate: capacity growth and load
        shedding must watch the same number or they fight each
        other."""
        healthy = self.healthy()
        if not healthy:
            return 0.0
        worst = []
        with self._lock:
            for rid in healthy:
                view = self._views.get(rid)
                est = ((view.stats or {}).get("est_wait_ms") or {}) \
                    if view is not None else {}
                worst.append(max(est.values()) if est else 0.0)
        return sum(worst) / len(worst) if worst else 0.0

    def _flooder_tenant(self):
        """The tenant holding the largest summed queued depth across
        the fleet, when that depth has reached the spill bound — the
        over-quota tenant brownout sheds even at priority > 0."""
        depths = {}
        with self._lock:
            for view in self._views.values():
                per_model = (view.stats or {}).get("tenants") or {}
                for depth_map in per_model.values():
                    for tenant, d in (depth_map or {}).items():
                        depths[tenant] = depths.get(tenant, 0) + int(d)
        if not depths:
            return None
        tenant = max(depths, key=lambda t: depths[t])
        return tenant if depths[tenant] >= self.spill_queue else None

    def _brownout_sheds(self, headers):
        """Whether THIS request goes first under brownout: everything
        not explicitly prioritized (priority <= 0), plus the flooder
        tenant's work regardless of priority."""
        headers = headers or {}
        try:
            priority = int(headers.get("X-MXTPU-Priority") or 0)
        except (TypeError, ValueError):
            priority = 0
        if priority <= 0:
            return True
        tenant = headers.get("X-MXTPU-Tenant")
        return tenant is not None and tenant == self._flooder_tenant()

    # -- exactly-once forwarding + tail defense ----------------------------
    def _pick_other(self, exclude):
        """Least-loaded healthy replica outside ``exclude`` — the
        retry/hedge target; ``None`` means neither applies (the
        single-routable-replica gate)."""
        exclude = set(exclude)
        cands = [r for r in self.healthy() if r not in exclude]
        with self._lock:
            cands = [r for r in cands if r in self._views]
            if not cands:
                return None
            return min(cands,
                       key=lambda r: (self._load(self._views[r]), r))

    def _hedge_threshold_ms(self):
        """Adaptive hedge trigger: the configured percentile of recent
        router-observed latency, floored at ``hedge_min_ms``; ``None``
        disables hedging."""
        if self.hedge_pct <= 0:
            return None
        pct = self.stats.latency_percentile(self.hedge_pct)
        return max(self.hedge_min_ms, float(pct)) \
            if pct is not None else self.hedge_min_ms

    def _mark_retried(self, data, ctype):
        """Surface ``"retried": true`` in a JSON response body — the
        client-visible receipt that the exactly-once layer resent the
        request on its behalf."""
        if "json" not in (ctype or ""):
            return data
        try:
            payload = json.loads(data.decode("utf-8"))
            payload["retried"] = True
            return json.dumps(payload).encode("utf-8")
        except Exception:  # noqa: BLE001 — any non-object body: as-is
            return data

    def _spawn_attempt(self, rid, path, body, headers, results, state):
        """One forward attempt on a helper thread (the hedged path);
        results land on ``results`` as ``(rid, (status, data, ctype)
        or None, error or None)``.  An attempt finishing after the
        request settled is the hedge race's loser: ``hedge_wasted``."""
        def run():
            with self._lock:
                view = self._views.get(rid)
                if view is not None:
                    view.inflight += 1
            try:
                try:
                    out = self.forward(rid, "POST", path, body=body,
                                       headers=headers)
                    err = None
                except ReplicaDead as e:
                    out, err = None, e
            finally:
                with self._lock:
                    view = self._views.get(rid)
                    if view is not None:
                        view.inflight -= 1
                # the pool is per-thread and this thread is about to
                # die — close the sockets now instead of leaving them
                # to the GC so attempt threads don't pile up FDs
                for conn in getattr(self._local, "conns", {}).values():
                    try:
                        conn.close()
                    except Exception:  # noqa: BLE001 — teardown only
                        pass
                self._local.conns = {}
            with state["lock"]:
                late = state["done"]
            if late:
                self.stats.inc("hedge_wasted")
            results.put((rid, out, err))
        threading.Thread(target=run, name="mxfleet-attempt",
                         daemon=True).start()

    def _forward_exactly_once(self, rid, path, body, headers):
        """Primary forward + at most ONE keyed resend to a different
        healthy replica on transport failure (the request id in
        ``headers`` makes the resend safe — replica dedup collapses a
        duplicate, and bucket bit-stability makes even a dedup-miss
        re-execution bit-identical).  Returns ``(status, data, ctype,
        final_rid, resent)``; ``status None`` = total transport failure
        with the error message in ``data``."""
        with self._lock:
            view = self._views.get(rid)
            if view is not None:
                view.inflight += 1
        try:
            try:
                status, data, ctype = self.forward(
                    rid, "POST", path, body=body, headers=headers)
                return status, data, ctype, rid, False
            except ReplicaDead as e:
                first_err = e
        finally:
            with self._lock:
                view = self._views.get(rid)
                if view is not None:
                    view.inflight -= 1
        alt = self._pick_other({rid})
        if alt is None:
            return None, ("%s — no other healthy replica to resend to"
                          % (first_err,)), None, rid, False
        self.stats.inc("retries")
        with self._lock:
            view = self._views.get(alt)
            if view is not None:
                view.inflight += 1
        try:
            try:
                status, data, ctype = self.forward(
                    alt, "POST", path, body=body, headers=headers)
                return status, data, ctype, alt, True
            except ReplicaDead as e2:
                return None, ("%s — after one keyed resend" % (e2,)), \
                    None, alt, True
        finally:
            with self._lock:
                view = self._views.get(alt)
                if view is not None:
                    view.inflight -= 1

    def _forward_hedged(self, rid, path, body, headers, thr_ms):
        """Tail-defense forward: the primary attempt runs on a helper
        thread; past ``thr_ms`` with no answer, a backup goes to the
        next-least-loaded replica with the SAME key (``hedges``) and
        the first answer wins.  A transport failure while the other
        attempt is still in flight lets that attempt double as the
        retry; with nothing in flight the explicit one-resend rule
        applies, same as the inline path."""
        results = queue.Queue()
        state = {"lock": threading.Lock(), "done": False}
        launched = [rid]
        self._spawn_attempt(rid, path, body, headers, results, state)
        outstanding = 1
        got = None
        try:
            try:
                got = results.get(timeout=thr_ms / 1000.0)
            except queue.Empty:
                backup = self._pick_other(set(launched))
                if backup is not None:
                    self.stats.inc("hedges")
                    launched.append(backup)
                    self._spawn_attempt(backup, path, body, headers,
                                        results, state)
                    outstanding += 1
            failed = 0
            retried_once = False
            last_err, last_rid = None, rid
            while outstanding > 0:
                if got is None:
                    try:
                        got = results.get(
                            timeout=self.request_timeout + 5.0)
                    except queue.Empty:
                        break
                arid, out, err = got
                got = None
                outstanding -= 1
                if err is None:
                    status, data, ctype = out
                    return status, data, ctype, arid, failed > 0
                failed += 1
                last_err, last_rid = err, arid
                if outstanding > 0:
                    continue        # the hedge doubles as the retry
                if not retried_once:
                    alt = self._pick_other(set(launched))
                    if alt is not None:
                        retried_once = True
                        self.stats.inc("retries")
                        launched.append(alt)
                        self._spawn_attempt(alt, path, body, headers,
                                            results, state)
                        outstanding += 1
            msg = str(last_err) if last_err is not None else \
                ("request timed out across %d attempt(s)"
                 % len(launched))
            return None, msg, None, last_rid, failed > 1 or retried_once
        finally:
            with state["lock"]:
                state["done"] = True

    def proxy_predict(self, model, body, headers):
        """The full per-request path: brownout gate -> route -> forward
        (exactly-once retry + optional hedge) -> account.  Returns
        ``(status, raw_body, content_type)``."""
        if self.draining:
            return 503, json.dumps(
                {"error": "fleet is draining"}).encode("utf-8"), \
                "application/json"
        in_brownout = False
        if self.brownout_ms > 0:
            pressure = self.pressure_ms()
            in_brownout = pressure > self.brownout_ms
            if in_brownout and self._brownout_sheds(headers):
                tenant = (headers or {}).get("X-MXTPU-Tenant")
                self.stats.inc("brownout_shed")
                self.stats.inc("brownout_shed:%s" % (tenant or "-",))
                retry_after = max(0.5, pressure / 1000.0)
                return 429, json.dumps(
                    {"error": "brownout: fleet pressure %.1fms past "
                     "%.1fms — shed before queueing" % (
                         pressure, self.brownout_ms),
                     "reason": "brownout", "tenant": tenant,
                     "retry_after_s": round(retry_after, 3)}
                ).encode("utf-8"), "application/json"
        try:
            rid, reason = self.route(model)
        except NoHealthyReplica as e:
            self.stats.inc("no_replica")
            return 503, json.dumps(
                {"error": str(e)}).encode("utf-8"), "application/json"
        except MXNetError as e:     # unknown model
            return 404, json.dumps(
                {"error": str(e)}).encode("utf-8"), "application/json"
        path = "/predict/%s" % model
        tic = time.monotonic()
        # hedging is gated off in brownout (a fleet already shedding
        # load must not mint duplicate work) — the retry stance is NOT:
        # absorbing a dead replica is cheap exactly when it matters
        thr_ms = None if in_brownout else self._hedge_threshold_ms()
        if thr_ms is None:
            status, data, ctype, final_rid, resent = \
                self._forward_exactly_once(rid, path, body, headers)
        else:
            status, data, ctype, final_rid, resent = \
                self._forward_hedged(rid, path, body, headers, thr_ms)
        if status is None:
            # replica_errors counts FINAL client-visible failures, so
            # the 502 ledger (chaos drills) stays exact; per-attempt
            # transport failures live in each view's forward_errors
            self.stats.inc("replica_errors")
            return 502, json.dumps(
                {"error": data, "replica": final_rid,
                 "retried": resent}).encode("utf-8"), "application/json"
        if resent:
            self.stats.inc("retry_ok")
            data = self._mark_retried(data, ctype)
        self.stats.inc("routed")
        if reason is not None:
            self.stats.inc(reason)      # "spilled" | "rerouted"
        self.stats.record_latency((time.monotonic() - tic) * 1000.0)
        if faults.consume(DUP_REQUEST_FAULT):
            # deterministic duplicate: deliver the SAME request (same
            # body, same key) once more — the replica-side dedup cache
            # must collapse it onto the original execution
            self.stats.inc("dup_requests")
            try:
                self.forward(final_rid, "POST", path, body=body,
                             headers=headers)
            except ReplicaDead:
                pass
        return status, data, ctype

    # -- observation -------------------------------------------------------
    def stats_payload(self):
        """Fleet-level aggregation: router counters + router-measured
        p50/p99 (every request crosses the router, so its window IS the
        fleet latency distribution) + summed per-replica shed/served
        counters + the per-replica table."""
        healthy = set(self.healthy())
        fleet_counters = {}
        freshness = []
        replicas = {}
        ctrl = {r["id"]: r for r in self._controller.snapshot()} \
            if self._controller is not None else {}
        if not ctrl and self._view is not None:
            # sharded front end: no controller in this process — the
            # supervision fields (state/pid/restarts/last_rc) arrive
            # through the published view instead, so a router worker's
            # /stats table matches the controller-side one
            for rid, ent in self._view.replicas().items():
                sup = {k: ent[k]
                       for k in ("state", "pid", "restarts", "last_rc")
                       if ent.get(k) is not None}
                if sup:
                    ctrl[rid] = sup
        now = time.monotonic()
        if self._view is not None:
            ejected = {rid for rid, ent in self._view.replicas().items()
                       if ent.get("ejected")}
        else:
            ejected = self.outliers.ejected()
        with self._lock:
            for rid in self._order:
                view = self._views[rid]
                entry = {"healthy": rid in healthy,
                         "fenced": rid in self._fenced,
                         "ejected": rid in ejected,
                         "port": view.addr[1] if view.addr else None,
                         "inflight": view.inflight,
                         "forward_errors": view.errors,
                         "probe_retries": view.probe_retries,
                         "heartbeat_age_s":
                             round(now - view.last_ok, 3)
                             if view.last_ok is not None else None}
                if view.stats:
                    entry["queue_depth"] = view.stats.get("queue_depth")
                    entry["est_wait_ms"] = view.stats.get("est_wait_ms")
                    # per-replica served epochs: the rollout-progress
                    # signal a rolling swap advances one replica at a
                    # time (fleet/deploy.py)
                    entry["epochs"] = view.stats.get("epochs")
                    # per-model publish->served freshness from each
                    # replica's watcher (serving/deploy.py) — the
                    # region drill aggregates the fleet-wide worst case
                    fresh = {}
                    for name, blk in (view.stats.get("deploy")
                                      or {}).items():
                        ms = (blk or {}).get("last_freshness_ms")
                        if ms is not None:
                            fresh[name] = ms
                            freshness.append(ms)
                    if fresh:
                        entry["freshness_ms"] = fresh
                    for k, v in (view.stats.get("counters")
                                 or {}).items():
                        fleet_counters[k] = fleet_counters.get(k, 0) + v
                entry.update(ctrl.get(rid, {}))
                replicas[rid] = entry
        if self._view is not None and self.run_dir is not None:
            router_block, workers = self._merged_worker_stats()
        else:
            router_block, workers = self.stats.snapshot(), None
        payload = {"router": router_block,
                   "replicas": replicas,
                   "fleet": {"counters": fleet_counters,
                             "models": self.manifest.names(),
                             "replicas_total": len(self._order),
                             "replicas_healthy": len(healthy),
                             "freshness_ms":
                                 max(freshness) if freshness else None},
                   "draining": self.draining}
        pressure = self.pressure_ms()
        payload["brownout"] = {
            "slo_ms": self.brownout_ms,
            "pressure_ms": round(pressure, 3),
            "active": self.brownout_ms > 0
            and pressure > self.brownout_ms}
        if self.outliers.enabled:
            payload["ejection"] = self.outliers.export()
        # fleet p50/p99 = the router tier's end-to-end window (merged
        # across every worker in sharded mode — any worker can answer)
        payload["fleet"]["latency_ms"] = payload["router"]["latency_ms"]
        if workers is not None:
            payload["workers"] = workers
        if self._view is not None:
            age = self._view.age_s()
            payload["view"] = {"generation": self._view.generation,
                               "age_s": round(age, 3)
                               if age is not None else None,
                               "read_errors": self._view.read_errors}
            rollout = self._view.doc().get("rollout")
            if rollout is not None:
                payload["rollout"] = rollout
        if self.deploy is not None:
            payload["rollout"] = self.deploy.stats()
        return payload

    def _merged_worker_stats(self):
        """Any worker answers /stats for the WHOLE front end: its live
        counters merged with every sibling's periodic dump (counters
        summed, latency windows concatenated for shard-wide p50/p99).
        Siblings are per-file best-effort — a worker mid-respawn just
        contributes its last dump or nothing."""
        exports = [self.stats.export()]
        workers = {str(self.worker_id): {"pid": os.getpid(),
                                         "live": True}}
        pattern = os.path.join(self.run_dir, "rworker-*.stats.json")
        for path in sorted(glob.glob(pattern)):
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue            # mid-replace or mid-respawn
            wid = doc.get("worker")
            if wid is None or wid == self.worker_id:
                continue
            exports.append(doc.get("router") or {})
            workers[str(wid)] = {
                "pid": doc.get("pid"),
                "age_s": round(max(0.0, time.time()
                                   - float(doc.get("updated_at") or 0)),
                               3),
                "generation": doc.get("generation")}
        return Stats.merged_snapshot(exports), workers

    def dump_worker_stats(self):
        """Write this worker's counters next to the view file (the
        sibling-merge input and the worker-set readiness marker)."""
        if self.worker_id is None or self.run_dir is None:
            return None
        from ..resilience import atomic_write
        doc = {"worker": self.worker_id, "pid": os.getpid(),
               "updated_at": time.time(),
               "router": self.stats.export(),
               "generation": self._view.generation
               if self._view is not None else None}
        path = worker_stats_path(self.run_dir, self.worker_id)
        atomic_write(path, json.dumps(doc).encode("utf-8"),
                     fault_point="worker_stats_dump")
        return path

    def healthz_payload(self):
        healthy = self.healthy()
        return {"status": "draining" if self.draining else "ok",
                "replicas": len(self._order),
                "replicas_healthy": len(healthy),
                "healthy_ids": healthy}

    def _dump_loop(self):
        period = self._view.refresh_s if self._view is not None else 0.5
        while not self._stop_dump.wait(max(0.1, period)):
            try:
                self.dump_worker_stats()
            except Exception:  # noqa: BLE001 — the loop must survive
                pass

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Bind the public port, run one synchronous probe pass, start
        the health loop.  Returns self (``self.port`` holds the real
        port).  View mode starts NO probe/health machinery — the
        snapshot is the health signal — and instead dumps its counters
        (first dump immediately: the worker-set readiness marker)."""
        if self._server is not None:
            return self
        router = self

        class Handler(_Handler):
            rt = router

        server_cls = _ReuseportHTTPServer if self.reuse_port \
            else ServeHTTPServer
        self._server = server_cls((self.host, self.port), Handler)
        self._server.daemon_threads = False
        self._server.block_on_close = True
        self.port = self._server.server_address[1]
        if self._view is not None:
            self._sync_view()
            if self.worker_id is not None and self.run_dir is not None:
                self.dump_worker_stats()
                self._dump_thread = threading.Thread(
                    target=self._dump_loop, name="mxfleet-stats-dump",
                    daemon=True)
                self._dump_thread.start()
            return self
        self.probe()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="mxfleet-health", daemon=True)
        self._health_thread.start()
        return self

    def serve_forever(self):
        self.start()
        with self._life_lock:
            if self._aborted:       # drained before the loop started
                self._server.server_close()
                self._stopped.set()
                return
            self._serving = True
        try:
            self._server.serve_forever(poll_interval=0.1)
        finally:
            self._server.server_close()
            self._stopped.set()

    def serve_in_background(self):
        self.start()
        t = threading.Thread(target=self.serve_forever,
                             name="mxfleet-http", daemon=True)
        t.start()
        return self

    def drain_and_stop(self, timeout=60.0):
        """SIGTERM path: fence new work, wait out the router's own
        in-flight forwards, drain every replica through the controller,
        stop.  Idempotent."""
        self.draining = True
        if self.deploy is not None:
            # no rollout may fence/swap replicas the drain is stopping
            self.deploy.stop()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if all(v.inflight == 0 for v in self._views.values()):
                    break
            time.sleep(0.05)
        self._stop_health.set()
        self._stop_dump.set()
        try:
            # final counter dump so a sibling's post-drain /stats merge
            # still sees this worker's full ledger
            self.dump_worker_stats()
        except Exception:  # noqa: BLE001 — best-effort observability
            pass
        if self._controller is not None:
            self.replica_rcs = self._controller.drain(
                timeout=max(1.0, deadline - time.monotonic()))
        with self._life_lock:
            serving = self._serving
            if not serving:
                self._aborted = True
        if serving and self._server is not None:
            self._server.shutdown()

    def install_signal_handlers(self, signals=(signal.SIGTERM,
                                               signal.SIGINT)):
        def _on_signal(signum, frame):
            threading.Thread(target=self.drain_and_stop,
                             name="mxfleet-drain", daemon=True).start()
        for sig in signals:
            signal.signal(sig, _on_signal)
        return self

    def wait_stopped(self, timeout=None):
        return self._stopped.wait(timeout)


class _ReuseportHTTPServer(ServeHTTPServer):
    """ServeHTTPServer that binds with SO_REUSEPORT: N router
    workers listen on the SAME public port and the kernel balances new
    connections across them (established keep-alive connections stay
    with their worker — per-worker connection pools and the
    exactly-once retry discipline are untouched)."""

    def server_bind(self):
        if not hasattr(socket, "SO_REUSEPORT"):
            raise MXNetError(
                "SO_REUSEPORT is not available on this platform — the "
                "sharded front end needs Linux")
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        ServeHTTPServer.server_bind(self)


class _Handler(BaseHTTPRequestHandler):
    """Thin proxy handler onto the owning :class:`FleetRouter` (``rt``
    class attr, set by ``start()``)."""

    rt = None
    protocol_version = "HTTP/1.1"
    #: same rationale as the mxserve handler: bound idle keep-alive
    #: reads so block_on_close joins cannot wedge the drain
    timeout = 10.0

    def log_message(self, fmt, *args):
        pass

    def _reply_raw(self, status, body, ctype, extra=None):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for name, value in (extra or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _reply(self, status, payload):
        self._reply_raw(status, json.dumps(payload).encode("utf-8"),
                        "application/json")

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, self.rt.healthz_payload())
        elif self.path == "/stats":
            self._reply(200, self.rt.stats_payload())
        else:
            self._reply(404, {"error": "unknown path %r" % self.path})

    def do_POST(self):
        if not self.path.startswith("/predict/"):
            self._reply(404, {"error": "unknown path %r" % self.path})
            return
        model = self.path[len("/predict/"):].strip("/")
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        fwd_headers = {"Content-Type":
                       self.headers.get("Content-Type")
                       or "application/json"}
        for h in ("X-MXTPU-Priority", "X-MXTPU-Deadline-Ms",
                  "X-MXTPU-Tenant", "X-MXTPU-Request-Id"):
            if self.headers.get(h) is not None:
                fwd_headers[h] = self.headers[h]
        status, data, ctype = self.rt.proxy_predict(model, body,
                                                    fwd_headers)
        extra = None
        if status == 429:
            # brownout shed: tell well-behaved clients when to come
            # back instead of letting them hammer a saturated fleet
            try:
                secs = json.loads(data.decode("utf-8")) \
                    .get("retry_after_s")
            except Exception:  # noqa: BLE001
                secs = None
            if secs is not None:
                extra = {"Retry-After":
                         str(max(1, int(round(float(secs)))))}
        self._reply_raw(status, data, ctype, extra=extra)
