"""Replica autoscaling: a controller-side loop that ACTS on the
signals the router already aggregates (port of
``mxnet_tpu/fleet/autoscale.py``).

The router's probe loop collects every replica's ``est_wait_ms`` and
queue depths, and the rolling swap owns a safe way to take a replica
out of routing (fence -> drain -> stop).  The :class:`Autoscaler`
closes the loop, with deliberately boring policy:

- **signal**: mean over healthy replicas of each replica's WORST
  per-model ``est_wait_ms`` (the batcher's own wait estimate — the
  same number the spill policy trusts).  Injectable (``signal_fn``)
  so policy tests drive a synthetic square wave instead of a fleet.
- **hysteresis**: the signal must sit above ``high_ms`` for
  ``up_after`` consecutive ticks to scale up, below ``low_ms`` for
  ``down_after`` ticks to scale down; the band between the watermarks
  does nothing and resets neither streak's opposite.  A chaos drill
  bouncing one replica produces a spike, not a flap.
- **cooldown**: after ANY action, no further action for
  ``cooldown_s`` — a new replica needs its start-up and warmup before
  it absorbs load, and judging the new capacity with the old signal
  would double-scale.
- **scale-up** = :meth:`ReplicaController.add_replica` (it joins
  routing when its port file appears and a probe lands).
- **scale-down** = the rolling swap's safety dance, then retirement:
  fence the victim at the PROBER router (the capacity floor check
  lives in ``fence`` — at the floor the fence raises and the tick just
  counts ``blocked_floor``), publish so every front-end worker stops
  routing to it, wait out its queue, then
  :meth:`ReplicaController.stop_replica` (SIGTERM -> the replica
  drains its accepted work to rc 0 — the daemon's contract) and
  unfence the retired id.  Victim = the highest-id healthy replica,
  so the boot-time replicas (with their CPU pinning and manifest
  homes) are the last to go.

The loop never drops below ``min_replicas`` and never grows past
``max_replicas`` — and independently of ``min_replicas``, the fence's
own N-1 floor means scale-down can NEVER take the last routable
replica.
"""
from __future__ import annotations

import threading
import time

from ..base import MXNetError, get_env, register_env

__all__ = ["Autoscaler", "ENV_FLEET_SCALE_HIGH_MS",
           "ENV_FLEET_SCALE_LOW_MS", "ENV_FLEET_SCALE_COOLDOWN_S",
           "ENV_FLEET_MIN_REPLICAS", "ENV_FLEET_MAX_REPLICAS"]

ENV_FLEET_SCALE_HIGH_MS = register_env(
    "MXTPU_FLEET_SCALE_HIGH_MS", default=50.0,
    doc="Autoscaler high watermark: mean healthy-replica worst-model "
        "est_wait_ms above this for up_after consecutive ticks triggers "
        "a scale-up")
ENV_FLEET_SCALE_LOW_MS = register_env(
    "MXTPU_FLEET_SCALE_LOW_MS", default=5.0,
    doc="Autoscaler low watermark: the signal below this for down_after "
        "consecutive ticks triggers a fenced scale-down (fence -> drain "
        "-> stop, never below the capacity floor)")
ENV_FLEET_SCALE_COOLDOWN_S = register_env(
    "MXTPU_FLEET_SCALE_COOLDOWN_S", default=10.0,
    doc="Seconds after any autoscaler action during which no further "
        "action fires (new capacity must be judged by the new signal, "
        "not the spike that caused it)")
ENV_FLEET_MIN_REPLICAS = register_env(
    "MXTPU_FLEET_MIN_REPLICAS", default=1,
    doc="Autoscaler floor: scale-down never goes below this many live "
        "replicas (the fence's N-1 routable floor applies on top)")
ENV_FLEET_MAX_REPLICAS = register_env(
    "MXTPU_FLEET_MAX_REPLICAS", default=4,
    doc="Autoscaler ceiling: scale-up never grows the fleet past this "
        "many live replicas")

#: replica states that no longer count toward live capacity
_DEAD_STATES = ("failed", "scaled_down", "drained", "exited")


class Autoscaler(object):
    """Closes the load -> capacity loop over one
    :class:`~.controller.ReplicaController` + the PROBER-side
    :class:`~.router.FleetRouter` (controller mode — the one that owns
    fencing; in the sharded front end that is the publisher's router,
    never a worker).  ``publisher``, when given, gets a
    ``publish_once()`` after every fence/unfence so front-end workers
    see the change within one view refresh instead of one publish
    period."""

    def __init__(self, controller, router, publisher=None,
                 min_replicas=None, max_replicas=None, high_ms=None,
                 low_ms=None, up_after=2, down_after=6, cooldown_s=None,
                 period_s=1.0, settle_s=0.5, drain_wait_s=10.0,
                 signal_fn=None, log=None):
        self.controller = controller
        self.router = router
        self.publisher = publisher
        self.min_replicas = int(get_env(ENV_FLEET_MIN_REPLICAS)
                                if min_replicas is None else min_replicas)
        self.max_replicas = int(get_env(ENV_FLEET_MAX_REPLICAS)
                                if max_replicas is None else max_replicas)
        self.high_ms = float(get_env(ENV_FLEET_SCALE_HIGH_MS)
                             if high_ms is None else high_ms)
        self.low_ms = float(get_env(ENV_FLEET_SCALE_LOW_MS)
                            if low_ms is None else low_ms)
        if self.low_ms > self.high_ms:
            raise MXNetError(
                "autoscaler watermarks inverted: low %.1fms > high "
                "%.1fms — the hysteresis band must be non-empty"
                % (self.low_ms, self.high_ms))
        if self.min_replicas < 1:
            raise MXNetError("min_replicas must be >= 1 (a fleet that "
                             "scales to zero cannot serve)")
        self.up_after = max(1, int(up_after))
        self.down_after = max(1, int(down_after))
        self.cooldown_s = float(get_env(ENV_FLEET_SCALE_COOLDOWN_S)
                                if cooldown_s is None else cooldown_s)
        self.period_s = float(period_s)
        self.settle_s = float(settle_s)
        self.drain_wait_s = float(drain_wait_s)
        self.signal_fn = signal_fn
        self._log = log or (lambda msg: None)
        # guards counters and the hysteresis streaks: tick() runs on
        # the autoscale thread, but tests and operators call it (and
        # stats()) from the main thread too
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._high_streak = 0
        self._low_streak = 0
        self._last_action_at = None
        self._last_signal = None
        self.counters = {"ticks": 0, "scale_ups": 0, "scale_downs": 0,
                         "blocked_floor": 0, "blocked_max": 0,
                         "blocked_min": 0, "blocked_cooldown": 0,
                         "errors": 0}

    # -- signal ------------------------------------------------------------
    def _pressure_ms(self):
        """Mean over healthy replicas of each one's worst per-model
        ``est_wait_ms``.  Mean, not max: one replica's spike is the
        SPILL policy's problem (move the traffic); the autoscaler acts
        when the fleet as a whole is behind.  Delegates to
        ``FleetRouter.pressure_ms`` — the SAME aggregation the brownout
        admission gate sheds on, so adding capacity and shedding load
        react to one number instead of fighting each other."""
        return self.router.pressure_ms()

    def _live(self):
        """Replicas that count toward capacity bounds: everything the
        controller has not written off — including ones still warming
        up, so a scale-up in flight blocks the next one."""
        return [r for r in self.controller.replicas
                if r.state not in _DEAD_STATES]

    def _publish(self):
        if self.publisher is not None:
            try:
                self.publisher.publish_once()
            except Exception:  # noqa: BLE001 — the loop publishes next
                pass

    # -- policy ------------------------------------------------------------
    def tick(self):
        """One synchronous policy evaluation (the loop body; also the
        test surface).  Returns the action taken: ``"up"``, ``"down"``
        or ``None``."""
        sig = self.signal_fn() if self.signal_fn is not None \
            else self._pressure_ms()
        self._last_signal = sig
        with self._lock:
            self.counters["ticks"] += 1
            if sig >= self.high_ms:
                self._high_streak += 1
                self._low_streak = 0
            elif sig <= self.low_ms:
                self._low_streak += 1
                self._high_streak = 0
            else:
                # the hysteresis band: no pressure either way
                self._high_streak = 0
                self._low_streak = 0
            want_up = self._high_streak >= self.up_after
            want_down = self._low_streak >= self.down_after
        if not (want_up or want_down):
            return None
        now = time.monotonic()
        if self._last_action_at is not None and \
                now - self._last_action_at < self.cooldown_s:
            with self._lock:
                self.counters["blocked_cooldown"] += 1
            return None
        if want_up:
            if len(self._live()) >= self.max_replicas:
                with self._lock:
                    self.counters["blocked_max"] += 1
                return None
            return self._scale_up(sig)
        if len(self._live()) <= self.min_replicas:
            with self._lock:
                self.counters["blocked_min"] += 1
            return None
        return self._scale_down(sig)

    def _scale_up(self, sig):
        try:
            rep = self.controller.add_replica()
        except MXNetError as e:     # draining — the fleet is going away
            with self._lock:
                self.counters["errors"] += 1
            self._log("autoscale: scale-up refused (%s)" % (e,))
            return None
        with self._lock:
            self.counters["scale_ups"] += 1
            self._high_streak = 0
        self._last_action_at = time.monotonic()
        self._log("autoscale: UP -> replica %d (signal %.1fms >= "
                  "%.1fms)" % (rep.id, sig, self.high_ms))
        return "up"

    def _scale_down(self, sig):
        """The fenced retirement dance.  Any failure unwinds the fence
        — a half-retired replica must keep serving."""
        healthy = self.router.healthy()
        if not healthy:
            return None
        rid = max(healthy)
        try:
            self.router.fence(rid)
        except MXNetError:
            # fencing would leave no routable replica — the N-1 floor
            # outranks the low watermark, always
            with self._lock:
                self.counters["blocked_floor"] += 1
            return None
        try:
            self._publish()         # workers stop routing to rid
            if self.settle_s > 0:
                time.sleep(self.settle_s)
            self._wait_drained(rid)
            self.controller.stop_replica(rid)
        except Exception as e:  # noqa: BLE001 — unwind, keep serving
            with self._lock:
                self.counters["errors"] += 1
            self._log("autoscale: scale-down of %d failed (%s: %s) — "
                      "unfenced" % (rid, type(e).__name__, e))
            self.router.unfence(rid)
            self._publish()
            return None
        self.router.unfence(rid)    # the id is gone; don't leak a fence
        self._publish()
        with self._lock:
            self.counters["scale_downs"] += 1
            self._low_streak = 0
        self._last_action_at = time.monotonic()
        self._log("autoscale: DOWN -> replica %d retired (signal "
                  "%.1fms <= %.1fms)" % (rid, sig, self.low_ms))
        return "down"

    def _wait_drained(self, rid):
        """Wait for the fenced replica's reported queue to empty (new
        work stopped at the fence; what's left is in-flight).  Bounded:
        SIGTERM itself drains accepted work to 200s, so timing out here
        costs nothing but politeness."""
        deadline = time.monotonic() + self.drain_wait_s
        while time.monotonic() < deadline:
            with self.router._lock:
                view = self.router._views.get(rid)
                stats = (view.stats or {}) if view is not None else {}
                inflight = view.inflight if view is not None else 0
            depth = sum((stats.get("queue_depth") or {}).values())
            if depth == 0 and inflight == 0:
                return
            time.sleep(0.1)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop,
                                        name="mxfleet-autoscale",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.period_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                with self._lock:
                    self.counters["errors"] += 1

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        return self

    def stats(self):
        with self._lock:
            out = dict(self.counters)
            out.update({"high_streak": self._high_streak,
                        "low_streak": self._low_streak})
        out.update({"live": len(self._live()),
                    "min": self.min_replicas, "max": self.max_replicas,
                    "high_ms": self.high_ms, "low_ms": self.low_ms,
                    "last_signal_ms": self._last_signal})
        return out
