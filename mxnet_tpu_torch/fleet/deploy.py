"""Rolling hot swap across a fleet: one replica at a time, capacity
never below N-1, a bad epoch halts with most replicas untouched (port
of ``mxnet_tpu/fleet/deploy.py``).

:class:`RollingSwap` composes the single-daemon promote path
(``serving/deploy.py`` — every replica owns its own verify -> stage ->
swap -> probe pipeline behind ``POST /swap/<model>``) into a
fleet-level rollout:

1. **Watch** each directory-loaded model's checkpoint dir with the
   SAME verifier the replicas use (:func:`~..resilience.
   verify_promotion`) — a damaged publish never even starts a rollout.
2. **Roll** a verified new epoch one replica at a time:
   **fence** (the router holds new traffic off the replica — in-flight
   work finishes, the other N-1 replicas carry the fleet) -> **swap**
   (``POST /swap/<model>`` — the replica re-verifies the bytes itself,
   stages, swaps at its dispatch boundary, probes; defense in depth) ->
   **probe** (``/healthz`` + ``/stats`` must show the replica healthy
   AND serving the new epoch) -> **rejoin** (unfence).
3. **Halt on failure**: a replica that refuses the epoch (verification,
   validation or probe — it rolled itself back and still serves the old
   epoch) stops the rollout THERE: replicas not yet reached keep the
   old epoch, the fleet keeps serving, and ``/stats`` shows the halted
   rollout for the operator.

Per the fleet idiom this module imports neither torch nor jax (stdlib
+ ``..base`` + ``..resilience`` only): it runs inside the router
process, which must never hold a CUDA context beside its replicas.
"""
from __future__ import annotations

import json
import os
import threading

from ..base import MXNetError, get_env
from ..resilience import verify_promotion
from ..serving.deploy import ENV_SWAP_POLL_S  # noqa: F401 — shared knob

__all__ = ["RollingSwap"]


def _log_default(msg):
    import logging
    logging.getLogger(__name__).warning(msg)


class RollingSwap(object):
    """``models``: ``{model_name: checkpoint_directory}`` — the
    directory-loaded subset of the fleet manifest (prefix:epoch models
    have no stream to follow).  ``router``: the :class:`~.router.
    FleetRouter` owning replica addresses, fencing and /stats."""

    def __init__(self, router, models, prefix="checkpoint", poll_s=None,
                 http_timeout=120.0, log=None):
        if not models:
            raise MXNetError("RollingSwap needs at least one "
                             "checkpoint-directory model to watch")
        self.router = router
        self.models = {name: os.fspath(d) for name, d in models.items()}
        self.prefix = prefix
        self.poll_s = float(get_env(ENV_SWAP_POLL_S)
                            if poll_s is None else poll_s)
        self.http_timeout = float(http_timeout)
        self._log = log or _log_default
        #: model -> fleet-wide epoch (every replica agreed); seeded
        #: from the replicas' own /healthz on the first poll
        self._current = {}
        #: failed publishes already counted/halted, model -> (epoch,
        #: manifest-entry mark): held until the epoch is rewritten or
        #: a newer one appears — a bad epoch must not re-roll (and
        #: re-fence replicas) every poll
        self._rejected = {}
        self.counters = {"polls": 0, "rollouts": 0, "rejected": 0,
                         "halted": 0}
        self._progress = {"state": "idle"}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        router.deploy = self

    # -- observation -------------------------------------------------------
    def stats(self):
        with self._lock:
            out = dict(self.counters)
            out["state"] = dict(self._progress)
            out["watching"] = self._thread is not None and \
                self._thread.is_alive()
            out["models"] = dict(self._current)
        return out

    def _set_progress(self, **kw):
        with self._lock:
            self._progress = dict(kw)

    # -- replica HTTP ------------------------------------------------------
    def _replica_request(self, addr, method, path, payload=None):
        """One request to a replica -> (status, parsed payload).  Like
        the router's forwards: never retried (a /swap POST is not
        idempotent — the replica may already be swapping)."""
        import http.client
        conn = http.client.HTTPConnection(addr[0], addr[1],
                                          timeout=self.http_timeout)
        try:
            body = None
            headers = {}
            if payload is not None:
                body = json.dumps(payload).encode("utf-8")
                headers["Content-Type"] = "application/json"
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            try:
                doc = json.loads(data.decode("utf-8")) if data else {}
            except ValueError:
                doc = {"raw": data.decode("utf-8", "replace")}
            return resp.status, doc
        finally:
            conn.close()

    def _replica_epoch(self, addr, model):
        try:
            status, doc = self._replica_request(addr, "GET", "/healthz")
        except Exception:  # noqa: BLE001 — replica down
            return None
        if status != 200:
            return None
        return (doc.get("epochs") or {}).get(model)

    # -- the rollout -------------------------------------------------------
    def check_once(self):
        """One poll over every watched model; returns the outcomes
        (``{model: action}``)."""
        with self._lock:
            self.counters["polls"] += 1
        out = {}
        for model, directory in self.models.items():
            out[model] = self._check_model(model, directory)
        return out

    def _entry_mark(self, directory, epoch):
        """Identity of one publish (resilience.publish_mark — the SAME
        helper CheckpointWatcher keys on): a rewritten epoch re-enters,
        an unchanged failed one is held."""
        from ..resilience import publish_mark
        return publish_mark(directory, epoch, prefix=self.prefix)

    def _check_model(self, model, directory):
        epoch, problems = verify_promotion(directory,
                                           prefix=self.prefix)
        if epoch is None:
            return "no_checkpoint"
        current = self._current.get(model)
        if current is None:
            # adopt the fleet's own view: what the replicas already
            # serve (they loaded the newest intact epoch at bring-up)
            current = self._seed_current(model)
        if current is not None and epoch <= current and not problems:
            return "current"
        mark = self._entry_mark(directory, epoch)
        if problems:
            if self._rejected.get(model) != (epoch, mark):
                self._rejected[model] = (epoch, mark)
                self.counters["rejected"] += 1
                self._log("fleet rollout: REJECTING epoch %d of %r — "
                          "verification failed, fleet stays on %s: %s"
                          % (epoch, model, current,
                             "; ".join(problems)))
            return "rejected"
        if self._rejected.get(model) == (epoch, mark):
            # this publish already failed a rollout: hold until it is
            # rewritten or a newer epoch appears
            return "rejected"
        return self._rollout(model, epoch, current, mark)

    def _seed_current(self, model):
        addrs = self.router._addresses()
        epochs = [self._replica_epoch(addr, model)
                  for addr in addrs.values() if addr is not None]
        epochs = [e for e in epochs if e is not None]
        if not epochs:
            return None
        seed = min(epochs)          # the laggiest replica defines "done"
        self._current[model] = seed
        return seed

    def _rollout(self, model, epoch, current, mark=None):
        """Fence -> swap -> probe -> rejoin, one replica at a time."""
        self.counters["rollouts"] += 1
        addrs = self.router._addresses()
        order = sorted(addrs)
        done = []
        self._set_progress(state="rolling", model=model, epoch=epoch,
                           from_epoch=current, done=list(done),
                           total=len(order))
        for rid in order:
            if self._stop.is_set():
                self._set_progress(state="stopped", model=model,
                                   epoch=epoch, done=list(done))
                return "stopped"
            addr = addrs.get(rid)
            if addr is None:
                # a replica mid-respawn: its supervisor brings it back
                # on the NEW newest epoch (load_dir reads the manifest)
                continue
            if self._replica_epoch(addr, model) == epoch:
                done.append(rid)    # already there (e.g. respawned)
                continue
            fenced = False
            if len(order) > 1:
                try:
                    self.router.fence(rid)
                    fenced = True
                except MXNetError as e:
                    # transient (the other replicas are evicted right
                    # now): halt WITHOUT holding — the next poll
                    # retries once capacity is back
                    self._log("fleet rollout: cannot fence replica %s "
                              "(%s) — halting" % (rid, e))
                    self._halt(model, epoch, done, str(e))
                    return "halted"
            try:
                try:
                    status, doc = self._replica_request(
                        addr, "POST", "/swap/%s" % model,
                        {"epoch": epoch})
                except Exception as e:  # noqa: BLE001 — replica died
                    # TRANSPORT failure, not a refusal: the replica
                    # crashed/hung — its supervisor respawns it (on
                    # the new newest epoch) and the next poll resumes
                    # the rollout; holding here would freeze a healthy
                    # epoch out of the rest of the fleet forever
                    self._halt(model, epoch, done,
                               "replica %s unreachable mid-swap: %s"
                               % (rid, e))
                    return "halted"
                if status != 200:
                    # the replica refused (verify/validation/probe
                    # failed — it rolled itself back): halt with every
                    # later replica untouched on the old epoch
                    self._halt(model, epoch, done,
                               "replica %s refused epoch %d: %s"
                               % (rid, epoch,
                                  doc.get("problems") or doc), mark)
                    return "halted"
                if self._replica_epoch(addr, model) != epoch:
                    # inconsistent replica (200 but wrong epoch):
                    # retryable — do not hold the epoch fleet-wide
                    self._halt(model, epoch, done,
                               "replica %s reports the wrong epoch "
                               "after a 200 swap" % rid)
                    return "halted"
            finally:
                if fenced:
                    self.router.unfence(rid)
            done.append(rid)
            self._set_progress(state="rolling", model=model,
                               epoch=epoch, from_epoch=current,
                               done=list(done), total=len(order))
        self._current[model] = epoch
        self._rejected.pop(model, None)
        self._set_progress(state="complete", model=model, epoch=epoch,
                           done=list(done), total=len(order))
        self._log("fleet rollout: %r now serves epoch %d on %d "
                  "replica(s)" % (model, epoch, len(done)))
        return "complete"

    def _halt(self, model, epoch, done, reason, mark=None):
        """Stop the rollout here.  ``mark`` set = a replica REFUSED
        the epoch (its own verify/validate/probe said the bytes are
        bad): hold this publish so the poll loop does not re-roll it
        forever — a REWRITTEN or newer epoch re-enters normally.
        ``mark=None`` = a transport-level failure (crash, fence race):
        nothing said the epoch is bad, so the next poll retries."""
        self.counters["halted"] += 1
        if mark is not None:
            self._rejected[model] = (epoch, mark)
        self._set_progress(state="halted", model=model, epoch=epoch,
                           done=list(done), reason=str(reason))
        self._log("fleet rollout: HALTED promoting epoch %d of %r "
                  "after %d replica(s): %s"
                  % (epoch, model, len(done), reason))

    # -- the poll thread ---------------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="mxfleet-rollout", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def _loop(self):
        delay = self.poll_s
        while not self._stop.wait(delay):
            try:
                self.check_once()
                delay = self.poll_s
            except Exception as e:  # noqa: BLE001 — the tail must live
                delay = min(delay * 2.0, self.poll_s * 32.0)
                self._log("fleet rollout: poll failed (%s: %s) — "
                          "backing off to %.1fs"
                          % (type(e).__name__, e, delay))
