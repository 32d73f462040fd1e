"""The port's fleet (``mxnet_tpu_torch/fleet/``) against the JAX package's
(``mxnet_tpu/fleet/``), on the CPU.

Each parity test runs ONE scripted scenario twice, once with each
package's fleet, against fresh fake replicas (``tests/test_fleet.py``'s
``_FakeReplica``: stdlib HTTP servers speaking the daemon's surface),
and compares what the scenario records: each request's status and
``route``'s (replica, reason), the router's counters, what each fake
received, the controller's states and exit codes, the autoscaler's
actions.  Equality is exact (the records are ints, strings and bools);
the scenario's own assertions pin the expected values on top.

Beside the parity scenarios: the manifest's ``cuda:`` device sets and
``--context``, a warm store whose build fails, a real port
frontend collapsing a ``dup_request``, and ``fleet_main.py`` run with
``torch`` and ``jax`` made unimportable.  Every wait has a deadline and
every subprocess a timeout.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu.fleet as jfleet
import mxnet_tpu_torch.fleet as tfleet
from mxnet_tpu.base import MXNetError as JError
from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu_torch.base import MXNetError as TError
from mxnet_tpu_torch.resilience import faults as tfaults

from test_fleet import (_CHILD, _STUB_SERVE, _DuckController,  # noqa: E402
                        _FakeReplica, _SupervisedFakes, _publish_epoch,
                        _publish_sharded_epoch)

pytestmark = pytest.mark.serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_MAIN = os.path.join(REPO, "mxnet_tpu_torch", "fleet", "fleet_main.py")


class Pkg(object):
    """One package's fleet surface, so a scenario runs against either."""

    def __init__(self, name, fleet, error, faults):
        self.name, self.fleet, self.Error, self.faults = (name, fleet,
                                                          error, faults)


JAX = Pkg("jax", jfleet, JError, jfaults)
PORT = Pkg("torch", tfleet, TError, tfaults)


def both(scenario, *args, **kw):
    """Run ``scenario(pkg, ...)`` with the JAX package, then the port;
    the two records must be equal.  Returns the port's."""
    ref = scenario(JAX, *args, **kw)
    got = scenario(PORT, *args, **kw)
    assert got == ref, "port %r\njax  %r" % (got, ref)
    return got


@pytest.fixture
def port_faults():
    tfaults.disarm()
    jfaults.disarm()
    yield
    tfaults.disarm()
    jfaults.disarm()


def _wait(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out: %s" % msg
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------

def test_fleet_names_modules_and_knobs_match_jax():
    import mxnet_tpu.base as jbase
    import mxnet_tpu_torch as tmx
    import mxnet_tpu_torch.base as tbase
    assert tmx.fleet is tfleet
    assert tfleet.__all__ == jfleet.__all__
    for name in jfleet.__all__:
        assert hasattr(tfleet, name), name
    for mod in ("manifest", "view", "router", "controller", "warm",
                "deploy", "autoscale"):
        jmod, tmod = getattr(jfleet, mod), getattr(tfleet, mod)
        for name in jmod.__all__:
            assert hasattr(tmod, name), (mod, name)
    knobs = sorted(k for k in jbase.ENV_REGISTRY
                   if k.startswith("MXTPU_FLEET_"))
    assert len(knobs) == 15, knobs
    for k in knobs:
        assert k in tbase.ENV_REGISTRY, k
        assert tbase.ENV_REGISTRY[k].default == \
            jbase.ENV_REGISTRY[k].default, k
    assert sorted(k for k in tbase.ENV_REGISTRY
                  if k.startswith("MXTPU_FLEET_")) == knobs


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------

SHAPE_SPECS = [
    [], ["data=784"], ["mlp:data=784"], ["mlp:data=3,32,32", "data=4"],
    ["a:x=1,2", "a:y=3", "b:x=5"], ["data=4,"],
    # errors: the message must match too
    ["data="], ["=4"], ["mlp:data=a,b"], ["mlp:"], ["justaname"],
]


def _outcome(error, fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except error as e:
        return ("error", str(e))


@pytest.mark.parametrize("specs", SHAPE_SPECS,
                         ids=[",".join(s) or "none" for s in SHAPE_SPECS])
def test_parse_shape_specs_parity(specs):
    both(lambda p: _outcome(p.Error, p.fleet.parse_shape_specs, specs))


MODEL_GRID = [
    (["a=/x:1"], ["data=4"], 1),
    (["a=/x:1", "b=/y:2", "c=/z"], ["data=4", "b:data=8"], 2),
    (["zeta=/z:3", "alpha=/a:1", "mid=/m"], ["alpha:data=3,8,8"], 3),
    (["m=/x:1"], [], 5),
    # errors
    (["justaname"], [], 1), (["=/x:1"], [], 1), (["a=/x:1"], [], 0),
    ([], [], 1),
]


@pytest.mark.parametrize("models,shapes,replicas", MODEL_GRID)
def test_manifest_doc_and_homes_parity(models, shapes, replicas):
    def scenario(p):
        try:
            man = p.fleet.FleetManifest.from_flags(
                models, shapes, replicas=replicas, buckets="1,2,4")
        except p.Error as e:
            return ("error", str(e))
        homes = {n: man.home(n) for n in man.names()}
        return ("ok", man.to_doc(), homes,
                _outcome(p.Error, man.home, "nope"))
    both(scenario)


def test_manifest_files_load_in_the_other_package(tmp_path):
    """A manifest saved by either package loads in the other with an equal
    document (the device sets stay as written: each package validates
    them only when it places a replica)."""
    flags = (["mlp=/ckpts/mlp:3", "resnet=/ckpts/rdir"],
             ["mlp:data=784", "resnet:data=3,224,224"])
    for i, (writer, reader) in enumerate(((JAX, PORT), (PORT, JAX))):
        man = writer.fleet.FleetManifest.from_flags(
            *flags, replicas=2, buckets="1,8,32", device_sets="cpu")
        man.router_workers = 2
        path = man.save(str(tmp_path / ("fleet%d.json" % i)))
        back = reader.fleet.FleetManifest.from_file(path)
        assert back.to_doc() == man.to_doc()
        assert back.names() == ["mlp", "resnet"]
        assert back.models["resnet"]["shapes"] == {"data": (3, 224, 224)}


def test_serve_argv_equals_jax_but_binary_and_context():
    def argv(p, device_sets, **kw):
        man = p.fleet.FleetManifest.from_flags(
            ["resnet=/ckpts/r", "mlp=/ckpts/mlp:3"],
            ["mlp:data=784", "resnet:data=3,224,224"], replicas=2,
            buckets="1,8,32", device_sets=device_sets)
        return man.serve_argv("SERVE", port_file="/run/p", python="PY",
                              **kw)

    for kw in ({}, {"warmup_only": True}, {"warmup": False},
               {"warmup_only": True, "export_aot": True},
               {"extra": ["--watch"]}):
        ref = argv(JAX, None, **kw)
        assert argv(PORT, None, **kw) == ref    # inherit: no --context
        got = argv(PORT, "cpu", **kw)
        i = got.index("--context")
        assert got[i + 1] == "cpu"
        assert got[:i] + got[i + 2:] == ref
        got = argv(PORT, "cuda:0;1", **kw)
        i = got.index("--context")
        assert got[i + 1] == "gpu(0)"
        assert got[:i] + got[i + 2:] == ref
    # the default binary is the port's daemon
    assert tfleet.default_serve_py() == os.path.join(
        REPO, "mxnet_tpu_torch", "serving", "serve_main.py")
    assert os.path.exists(tfleet.default_serve_py())


def test_replica_device_env_cuda_sets_wrap_and_refuse_tpu():
    env = tfleet.replica_device_env
    assert env(None, 0) == {} and env("", 3) == {}
    assert env("cpu", 3) == {"CUDA_VISIBLE_DEVICES": ""}
    assert env("cuda:0", 0) == {"CUDA_VISIBLE_DEVICES": "0"}
    # replicas beyond the sets wrap: co-tenants on one card
    assert env("cuda:0", 1) == {"CUDA_VISIBLE_DEVICES": "0"}
    assert env("cuda:0;0", 1) == {"CUDA_VISIBLE_DEVICES": "0"}
    assert [env("cuda:0,1;2,3", i)["CUDA_VISIBLE_DEVICES"]
            for i in range(3)] == ["0,1", "2,3", "0,1"]
    for bad in ("tpu:0,1;2,3", "tpu:0", "gpu:0", "cuda:", "cuda:a",
                "cuda:0;x", "cpu:0", "mps"):
        with pytest.raises(TError, match="bad device-sets spec"):
            env(bad, 0)
        man = tfleet.FleetManifest({"m": "/x:1"}, replicas=1,
                                   device_sets=bad)
        with pytest.raises(TError, match="bad device-sets spec"):
            man.serve_argv("s.py")
    from mxnet_tpu_torch.fleet.manifest import replica_context
    assert [replica_context(s) for s in (None, "cpu", "cuda:3;4")] == \
        [None, "cpu", "gpu(0)"]


# ---------------------------------------------------------------------------
# the router, against fake replicas
# ---------------------------------------------------------------------------

def _mk_router(p, fakes, models=("a", "b"), **kw):
    man = p.fleet.FleetManifest.from_flags(
        ["%s=/x:1" % m for m in models], ["data=4"], replicas=len(fakes))
    endpoints = {i: ("127.0.0.1", f.port) for i, f in enumerate(fakes)}
    kw.setdefault("heartbeat_s", 0.15)
    kw.setdefault("evict_s", 0.6)
    kw.setdefault("spill_queue", 4)
    return p.fleet.FleetRouter(endpoints, man, port=0, **kw)


class Fakes(object):
    """``n`` fresh fake replicas for one scenario run, closed after it."""

    def __init__(self, n):
        self.n = n

    def __enter__(self):
        self.fakes = [_FakeReplica() for _ in range(self.n)]
        return self.fakes

    def __exit__(self, *exc):
        for f in self.fakes:
            f.close()


def _record_routes(router):
    """Wrap ``router.route`` so every decision lands in the list."""
    decisions = []
    inner = router.route

    def route(model):
        out = inner(model)
        decisions.append(list(out))
        return out
    router.route = route
    return decisions


BODY = json.dumps({"inputs": {"data": [0, 0, 0, 0]}}).encode()
JSON_CT = {"Content-Type": "application/json"}


def _send(router, model, n=1, headers=None):
    """``n`` predicts -> [status, retried flag, fake port or None]."""
    out = []
    for _ in range(n):
        status, data, _ = router.proxy_predict(model, BODY,
                                               dict(headers or JSON_CT))
        try:
            payload = json.loads(data.decode())
        except ValueError:
            payload = {}
        out.append([status, payload.get("retried"), payload.get("reason")])
    return out


def _counters(router, *keys):
    c = router.stats.snapshot()["counters"]
    return {k: c.get(k, 0) for k in keys}


def _received(fakes, prefix="/predict"):
    return [[p for p, _ in f.received if p.startswith(prefix)]
            for f in fakes]


ROUTE_KEYS = ("routed", "spilled", "rerouted", "retries", "retry_ok",
              "replica_errors", "no_replica", "hedges", "brownout_shed")


def test_router_routes_home_then_spills_on_depth_and_slo():
    def scenario(p, kind):
        with Fakes(2) as fakes:
            kw = {}
            if kind == "depth":
                fakes[0].depths = {"a": 10}     # home of "a" saturated
            elif kind == "slo":
                fakes[0].est_wait = {"a": 500.0}
                kw["slo_ms"] = 100.0
            router = _mk_router(p, fakes, **kw)
            healthy = router.probe()
            routes = _record_routes(router)
            sent = _send(router, "a", 3) + _send(router, "b", 2)
            return (healthy, routes, sent, _counters(router, *ROUTE_KEYS),
                    _received(fakes))

    home = both(scenario, "home")
    assert home[1] == [[0, None]] * 3 + [[1, None]] * 2
    assert home[4] == [["/predict/a"] * 3, ["/predict/b"] * 2]
    for kind in ("depth", "slo"):
        rec = both(scenario, kind)
        assert rec[1][:3] == [[1, "spilled"]] * 3
        assert rec[3]["spilled"] == 3 and rec[3]["routed"] == 5


def test_router_evicts_on_heartbeat_age_then_rejoins():
    def scenario(p):
        with Fakes(2) as fakes:
            router = _mk_router(p, fakes).serve_in_background()
            try:
                routes = _record_routes(router)
                first = sorted(router.healthy())
                fakes[0].die()
                _wait(lambda: 0 not in router.healthy(), 5, "eviction")
                sent = _send(router, "a")      # failover, not spill
                counters = _counters(router, *ROUTE_KEYS)
                fakes[0].revive()
                _wait(lambda: 0 in router.healthy(), 5, "rejoin")
                sent += _send(router, "a")     # home again
                return (first, routes, sent, counters, _received(fakes))
            finally:
                router.drain_and_stop(timeout=5)

    rec = both(scenario)
    assert rec[1] == [[1, "rerouted"], [0, None]]
    assert rec[3]["rerouted"] == 1 and rec[3]["spilled"] == 0
    assert rec[4] == [["/predict/a"], ["/predict/a"]]


def test_router_probe_retry_heals_one_drop_not_a_draining_replica():
    def scenario(p):
        with Fakes(2) as fakes:
            router = _mk_router(p, fakes, evict_s=10.0)
            out = [router.probe()]
            fakes[0].fail_healthz = 1
            out.append(router.probe())      # healed in the same pass
            out.append(router._views[0].probe_retries)
            fakes[0].fail_healthz = 99
            last_ok = router._views[0].last_ok
            router.probe()
            out.append([router._views[0].last_ok == last_ok,
                        router._views[0].probe_retries])
            fakes[0].fail_healthz = 0
            router.probe()
            fakes[1].draining = True        # a self-fence: no retry
            out.append(router.probe())
            out.append(router._views[1].probe_retries)
            out.append(_received(fakes))
            return out

    rec = both(scenario)
    assert rec[:5] == [[0, 1], [0, 1], 1, [True, 2], [0]]
    assert rec[5] == 0 and rec[6] == [[], []]


@pytest.mark.parametrize("dead", ["home", "all", "single"])
def test_router_exactly_once_resend(dead):
    """One keyed resend to another healthy replica (200, ``retried``);
    with every candidate dead one final 502 after the resend; a
    single-replica fleet has nowhere to resend (502, not retried)."""
    def scenario(p):
        with Fakes(1 if dead == "single" else 2) as fakes:
            router = _mk_router(p, fakes)
            router.probe()
            routes = _record_routes(router)
            for f in (fakes if dead != "home" else fakes[:1]):
                f.die()
            status, data, _ = router.proxy_predict("a", BODY, JSON_CT)
            payload = json.loads(data.decode())
            return (routes, status, payload.get("retried"),
                    "no other healthy replica" in payload.get("error", ""),
                    _counters(router, *ROUTE_KEYS),
                    [len(x) for x in _received(fakes)])

    rec = both(scenario)
    routes, status, retried, no_target, counters, _ = rec
    assert routes == [[0, None]]
    if dead == "home":
        assert (status, retried) == (200, True)
        assert counters["retries"] == counters["retry_ok"] == 1
        assert counters["replica_errors"] == 0
        assert rec[5] == [0, 1]
    elif dead == "all":
        assert (status, retried, no_target) == (502, True, False)
        assert counters["retries"] == 1 and counters["retry_ok"] == 0
        assert counters["replica_errors"] == 1
    else:
        assert (status, retried, no_target) == (502, False, True)
        assert counters["retries"] == 0 and counters["replica_errors"] == 1


def test_router_hedges_slow_primary_first_answer_wins(monkeypatch):
    monkeypatch.setenv("MXTPU_FLEET_HEDGE_PCT", "95")
    monkeypatch.setenv("MXTPU_FLEET_HEDGE_MIN_MS", "40")

    def scenario(p):
        with Fakes(2) as fakes:
            fakes[0].predict_delay_s = 0.6      # gray-slow home of "a"
            router = _mk_router(p, fakes)
            router.probe()
            tic = time.monotonic()
            status, data, _ = router.proxy_predict("a", BODY, JSON_CT)
            fast = time.monotonic() - tic < 0.5
            payload = json.loads(data.decode())
            _wait(lambda: router.stats.snapshot()["counters"].get(
                "hedge_wasted", 0) >= 1, 5, "the loser's accounting")
            return (status, payload["fake"] == fakes[1].port,
                    payload.get("retried"), fast,
                    _counters(router, "hedges", "hedge_wasted", "retries"),
                    [len(x) for x in _received(fakes)])

    rec = both(scenario)
    assert rec == (200, True, None, True,
                   {"hedges": 1, "hedge_wasted": 1, "retries": 0}, [1, 1])


def test_router_hedged_path_still_absorbs_dead_replica(monkeypatch):
    monkeypatch.setenv("MXTPU_FLEET_HEDGE_PCT", "95")
    monkeypatch.setenv("MXTPU_FLEET_HEDGE_MIN_MS", "40")

    def scenario(p):
        with Fakes(2) as fakes:
            router = _mk_router(p, fakes)
            router.probe()
            fakes[0].die()
            sent = _send(router, "a")
            return sent, _counters(router, "replica_errors")

    assert both(scenario) == ([[200, True, None]], {"replica_errors": 0})


def test_router_eviction_fails_in_flight_forwards_into_the_resend():
    """A replica that stops answering (a SIGKILLed daemon still tearing
    down its CUDA context keeps its sockets open; or a wedged one) holds
    the forwards in flight to it until the router's request_timeout,
    as long as a client waits.  The port's heartbeat fails them when it
    evicts the replica: the keyed resend answers 200 from the other
    replica within the eviction window (the JAX router waits out the
    timeout; the fleet drill on the H100 lost a request to it)."""
    with Fakes(2) as fakes:
        router = _mk_router(PORT, fakes)
        router.probe()
        home = router.route("a")[0]
        other = 1 - home
        fakes[home].predict_delay_s = 20.0
        stop = threading.Event()

        def heartbeat():
            while not stop.wait(router.heartbeat_s):
                router.probe()
        beat = threading.Thread(target=heartbeat, daemon=True)
        try:
            tic = time.monotonic()
            beat.start()
            # the home stops answering its probes as the predict goes out
            fakes[home].fail_healthz = 10 ** 6
            status, data, _ = router.proxy_predict("a", BODY, JSON_CT)
            took = time.monotonic() - tic
        finally:
            stop.set()
            beat.join(timeout=5)
        payload = json.loads(data.decode())
        assert status == 200 and payload.get("retried") is True, payload
        assert payload["fake"] == fakes[other].port, payload
        assert took < 5.0, took
        counters = _counters(router, "retries", "retry_ok", "replica_errors")
        assert counters == {"retries": 1, "retry_ok": 1,
                            "replica_errors": 0}, counters


def test_router_brownout_sheds_low_priority_and_flooder_first(monkeypatch):
    monkeypatch.setenv("MXTPU_FLEET_BROWNOUT_MS", "100")

    def scenario(p):
        with Fakes(2) as fakes:
            for f in fakes:
                f.est_wait = {"a": 500.0, "b": 500.0}
            fakes[0].tenants = {"a": {"noisy": 9}}
            router = _mk_router(p, fakes, spill_queue=4)
            router.probe()
            sent = []
            for extra in ({}, {"X-MXTPU-Priority": "5",
                               "X-MXTPU-Tenant": "noisy"},
                          {"X-MXTPU-Priority": "5",
                           "X-MXTPU-Tenant": "quiet"}):
                sent += _send(router, "a", headers=dict(JSON_CT, **extra))
            c = router.stats.snapshot()["counters"]
            return (sent, c.get("brownout_shed"), c.get("brownout_shed:-"),
                    c.get("brownout_shed:noisy"),
                    router.stats_payload()["brownout"]["active"])

    rec = both(scenario)
    assert rec == ([[429, None, "brownout"], [429, None, "brownout"],
                    [200, None, None]], 2, 1, 1, True)


def test_outlier_detector_ejects_respects_floor_and_rejoins_half_open():
    def scenario(p):
        det_cls = p.fleet.view.OutlierDetector
        det = det_cls(eject_x=3.0, min_samples=3, hold_s=5.0)
        out = [det.enabled]
        t = 100.0
        for _ in range(4):
            out.append(det.update({0, 1, 2}, {0: 10.0, 1: 12.0, 2: 400.0},
                                  {}, now=t))
            t += 1.0
        out.append(sorted(det.ejected(now=t)))
        t += 10.0
        out.append(sorted(det.ejected(now=t)))
        out.append(det.export(now=t)[2]["half_open"])
        out.append(det.update({0, 1, 2}, {0: 10.0, 1: 12.0, 2: 11.0}, {},
                              now=t))
        out.append(dict(det.counters))
        # the floor: two replicas growing error streaks together
        det = det_cls(eject_x=3.0, min_samples=3, hold_s=60.0,
                      error_streak=2)
        errs = {0: 0, 1: 0}
        t = 100.0
        det.update({0, 1}, {}, dict(errs), now=t)
        for _ in range(3):
            t += 1.0
            errs = {r: errs[r] + 1 for r in errs}
            out.append(det.update({0, 1}, {}, dict(errs), now=t))
        out.append([dict(det.counters), len(det.ejected(now=t))])
        return out

    rec = both(scenario)
    assert rec[5] == [2] and rec[6] == [] and rec[7] is True
    assert rec[9] == {"ejects": 1, "eject_rejoins": 1,
                      "eject_blocked_floor": 0}
    assert rec[-1][0]["ejects"] == 1 and rec[-1][1] == 1
    assert rec[-1][0]["eject_blocked_floor"] >= 1


def test_router_folds_ejection_into_healthy_and_stats(monkeypatch):
    monkeypatch.setenv("MXTPU_FLEET_EJECT_X", "3")

    def scenario(p):
        with Fakes(3) as fakes:
            for f, p99 in zip(fakes, (900.0, 10.0, 12.0)):
                f.p99_recent = p99
            router = _mk_router(p, fakes)
            for _ in range(4):
                router.probe()
            payload = router.stats_payload()
            routes = _record_routes(router)
            _send(router, "a", 3)
            return (router.healthy(),
                    [payload["replicas"][r]["ejected"] for r in range(3)],
                    payload["ejection"][0]["ejected"],
                    _counters(router, "ejects"), routes,
                    [len(x) for x in _received(fakes)])

    rec = both(scenario)
    assert rec[0] == [1, 2] and rec[1] == [True, False, False]
    assert rec[3] == {"ejects": 1} and rec[5][0] == 0


def test_router_fence_floor_and_spill_never_onto_a_fenced_replica():
    def scenario(p):
        with Fakes(3) as fakes:
            router = _mk_router(p, fakes, models=("a",))
            router.probe()
            home = router.manifest.home("a") % 3
            fenced_rid, spill_rid = [r for r in range(3) if r != home]
            fakes[home].depths["a"] = 10        # past the spill bar
            router.probe()
            router.fence(fenced_rid)
            fenced_flag = router.stats_payload()["replicas"][
                fenced_rid]["fenced"]
            hits, errs = [], []

            def worker():
                for _ in range(25):
                    try:
                        hits.append(tuple(router.route("a")))
                    except p.Error as e:
                        errs.append(str(e))

            threads = [threading.Thread(target=worker) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            assert not any(t.is_alive() for t in threads)
            router.fence(spill_rid)
            fallback = router.route("a")
            floor = _outcome(p.Error, router.fence, home)
            router.unfence(spill_rid)
            router.unfence(fenced_rid)
            return (home, fenced_flag, sorted(set(hits)), len(hits), errs,
                    list(fallback), floor[0],
                    "no routable" in str(floor[1]), router.healthy())

    rec = both(scenario)
    home, flag, hits, n, errs, fallback, floor, msg, healthy = rec
    spill = [r for r in range(3) if r != home][1]
    assert flag is True and n == 100 and not errs
    assert hits == [(spill, "spilled")]
    assert fallback == [home, None] and floor == "error" and msg
    assert healthy == [0, 1, 2]


def test_router_503_404_drain_and_draining_replica():
    def scenario(p):
        with Fakes(2) as fakes:
            router = _mk_router(p, fakes)   # never probed: 503
            out = [_send(router, "a"), _counters(router, "no_replica")]
            router.probe()
            out.append(router.proxy_predict("nope", b"{}", {})[0])
            fakes[0].draining = True
            out.append(router.probe())
            router.draining = True
            out.append(_send(router, "b"))
            out.append(_received(fakes))
            return out

    rec = both(scenario)
    assert rec[0] == [[503, None, None]] and rec[1] == {"no_replica": 1}
    assert rec[2] == 404 and rec[3] == [1]
    assert rec[4] == [[503, None, None]] and rec[5] == [[], []]


def test_router_stats_aggregates_replica_counters():
    def scenario(p):
        with Fakes(2) as fakes:
            fakes[0].counters = {"completed": 5, "shed_queue": 2}
            fakes[1].counters = {"completed": 7, "shed_queue": 1}
            router = _mk_router(p, fakes)
            router.probe()
            _send(router, "a", 2)
            s = router.stats_payload()
            return (s["fleet"]["counters"], s["fleet"]["replicas_healthy"],
                    s["fleet"]["replicas_total"], sorted(s["replicas"]),
                    [s["replicas"][r]["healthy"] for r in (0, 1)],
                    s["fleet"]["latency_ms"] == s["router"]["latency_ms"],
                    s["router"]["counters"]["routed"], s["draining"],
                    sorted(s))

    rec = both(scenario)
    assert rec[0] == {"completed": 12, "shed_queue": 3}
    assert rec[1:8] == (2, 2, [0, 1], [True, True], True, 2, False)


def test_router_http_surface_end_to_end():
    """The public port speaks the daemon's client protocol: /healthz,
    /stats, /predict/<m> proxied with the body bit-intact."""
    def scenario(p):
        from mxnet_tpu_torch.serving import ServeClient
        with Fakes(2) as fakes:
            router = _mk_router(p, fakes).serve_in_background()
            try:
                cli = ServeClient("127.0.0.1", router.port, timeout=10)
                h = cli.healthz()
                pred = cli.predict("a", np.arange(4, dtype="f"), npy=True,
                                   priority=1, deadline_ms=4000)
                s = cli.stats()
                get404 = cli._request("GET", "/nope")[0]
                post404 = cli._request("POST", "/swap/a", b"{}")[0]
                cli.close()
                path, body = fakes[0].received[0]
                arr = np.load(__import__("io").BytesIO(body),
                              allow_pickle=False)
                return (h[0], h[1]["status"], pred[0],
                        pred[1]["fake"] == fakes[0].port, s[0],
                        s[1]["router"]["counters"]["routed"], path,
                        arr.tolist(), get404, post404)
            finally:
                router.drain_and_stop(timeout=5)

    rec = both(scenario)
    assert rec == (200, "ok", 200, True, 200, 1, "/predict/a",
                   [0.0, 1.0, 2.0, 3.0], 404, 404)


def test_router_listens_with_the_daemons_backlog():
    """The router's public port, plain and reuseport, listens with the
    daemon's SOMAXCONN backlog (socketserver's 5 reset a burst of new
    connections: tests/test_torch_fleet_drill.py)."""
    import socket
    from mxnet_tpu_torch.serving.frontend import ServeHTTPServer
    with Fakes(1) as fakes:
        for reuse in (False, True):
            router = _mk_router(PORT, fakes, reuse_port=reuse).start()
            try:
                assert isinstance(router._server, ServeHTTPServer)
                assert router._server.request_queue_size == \
                    socket.SOMAXCONN
            finally:
                router.drain_and_stop(timeout=5)
                router._server.server_close()


def test_router_dup_request_collapsed_by_a_port_replica(port_faults,
                                                        tmp_path):
    """``dup_request`` re-delivers the first routed request (same bytes,
    same key) to the replica that answered it: the router counts it once
    and the port's frontend collapses it onto the first execution — its
    ``completed`` is not doubled, one dedup hit (or join) shows."""
    import mxnet_tpu_torch as tmx
    from test_torch_serving_daemon import _params, _sym
    sym = _sym()
    args, auxs = _params(sym, 3)
    prefix = str(tmp_path / "net")
    tmx.model.save_checkpoint(prefix, 1, sym, args, auxs, blocking=True)

    def scenario(p):
        pool = tmx.serving.ModelPool(ctx=tmx.cpu())
        pool.load("net", prefix, 1, sample_shapes={"data": (3, 6, 6)})
        fe = tmx.serving.ServingFrontend(pool, port=0, buckets="1,2")
        fe.serve_in_background()
        try:
            man = p.fleet.FleetManifest.from_flags(["net=%s:1" % prefix],
                                                   ["data=3,6,6"],
                                                   replicas=1)
            router = p.fleet.FleetRouter({0: ("127.0.0.1", fe.port)}, man,
                                         port=0, heartbeat_s=0.15,
                                         evict_s=5.0)
            router.probe()
            p.faults.arm("dup_request", 1)
            x = np.random.RandomState(4).standard_normal(
                (3, 6, 6)).astype("f")
            import io as _io
            buf = _io.BytesIO()
            np.save(buf, x, allow_pickle=False)
            hdrs = {"Content-Type": "application/x-npy",
                    "X-MXTPU-Request-Id": "dup-%s" % p.name}
            statuses = [router.proxy_predict("net", buf.getvalue(),
                                             dict(hdrs))[0]]
            statuses.append(router.proxy_predict(
                "net", buf.getvalue(),
                dict(hdrs, **{"X-MXTPU-Request-Id": "next-%s"
                              % p.name}))[0])
            c = fe.stats.snapshot()["counters"]
            return (statuses, _counters(router, "dup_requests", "routed"),
                    c.get("completed"),
                    c.get("dedup_hits", 0) + c.get("dedup_joined", 0))
        finally:
            fe.drain_and_stop(timeout=10)

    rec = both(scenario)
    assert rec == ([200, 200], {"dup_requests": 1, "routed": 2}, 2, 1)


# ---------------------------------------------------------------------------
# the rolling swap, against fake replicas
# ---------------------------------------------------------------------------

def _rolling(p, fakes, ckpt):
    for f in fakes:
        f.epochs["a"] = 1
    router = _mk_router(p, fakes)
    router.probe()
    roll = p.fleet.RollingSwap(router, {"a": ckpt}, poll_s=0.05,
                               log=lambda m: None)
    assert router.deploy is roll
    return router, roll


def _swaps(fakes):
    return _received(fakes, "/swap/")


def test_rolling_swap_rolls_one_replica_at_a_time(tmp_path):
    def scenario(p):
        ckpt = str(tmp_path / p.name / "ckpts")
        _publish_epoch(ckpt, 1, b"epoch-one-bytes")
        with Fakes(2) as fakes:
            router, roll = _rolling(p, fakes, ckpt)
            fenced_during = []
            for i, f in enumerate(fakes):
                f.on_swap = (lambda m, e, i=i: fenced_during.append(
                    (i, router.fenced())))
            out = [roll.check_once()]
            _publish_epoch(ckpt, 2, b"epoch-two-bytes")
            out.append(roll.check_once())
            st = router.stats_payload()["rollout"]
            out += [[f.epochs["a"] for f in fakes], router.fenced(),
                    st["state"]["state"], st["state"]["epoch"],
                    _swaps(fakes), fenced_during, roll.check_once()]
            return out

    rec = both(scenario)
    assert rec == [{"a": "current"}, {"a": "complete"}, [2, 2], [],
                   "complete", 2, [["/swap/a"], ["/swap/a"]],
                   [(0, [0]), (1, [1])], {"a": "current"}]


def test_rolling_swap_rejects_damaged_epoch_before_any_replica(tmp_path):
    def scenario(p):
        ckpt = str(tmp_path / p.name / "ckpts")
        _publish_epoch(ckpt, 1, b"epoch-one")
        with Fakes(2) as fakes:
            router, roll = _rolling(p, fakes, ckpt)
            _publish_epoch(ckpt, 2, b"epoch-two")
            p2 = os.path.join(ckpt, "checkpoint-0002.params")
            blob = bytearray(open(p2, "rb").read())
            blob[3] ^= 0xFF
            open(p2, "wb").write(bytes(blob))
            return ([roll.check_once(), roll.check_once()],
                    roll.counters["rejected"], _swaps(fakes),
                    [f.epochs["a"] for f in fakes])

    assert both(scenario) == ([{"a": "rejected"}] * 2, 1, [[], []], [1, 1])


def test_rolling_swap_halts_when_a_replica_refuses(tmp_path):
    def scenario(p):
        ckpt = str(tmp_path / p.name / "ckpts")
        _publish_epoch(ckpt, 1, b"epoch-one")
        with Fakes(2) as fakes:
            router, roll = _rolling(p, fakes, ckpt)
            fakes[0].swap_refuse = True
            _publish_epoch(ckpt, 2, b"epoch-two")
            out = [roll.check_once(), dict(roll.counters),
                   [f.epochs["a"] for f in fakes], _swaps(fakes),
                   router.fenced(), router.healthy()]
            st = router.stats_payload()["rollout"]["state"]
            out += [st["state"], st["epoch"], roll.check_once()]
            fakes[0].swap_refuse = False
            _publish_epoch(ckpt, 2, b"epoch-two-rewritten")
            out += [roll.check_once(), [f.epochs["a"] for f in fakes]]
            return out

    rec = both(scenario)
    assert rec[0] == {"a": "halted"} and rec[1]["halted"] == 1
    assert rec[2] == [1, 1] and rec[3] == [["/swap/a"], []]
    assert rec[4] == [] and rec[5] == [0, 1]
    assert rec[6:] == ["halted", 2, {"a": "rejected"}, {"a": "complete"},
                       [2, 2]]


def test_rolling_swap_races_elastic_publish_and_a_dying_replica(tmp_path):
    def scenario(p, dying):
        ckpt = str(tmp_path / p.name / ("ckpts-%s" % dying))
        _publish_epoch(ckpt, 1, b"epoch-one")
        with Fakes(2) as fakes:
            router, roll = _rolling(p, fakes, ckpt)
            _publish_epoch(ckpt, 2, b"epoch-two")
            fired = []

            def race(model, epoch):
                if fired:
                    return
                fired.append(epoch)
                if not dying:
                    _publish_epoch(ckpt, 2, b"epoch-two-resume-rewrite")
                _publish_epoch(ckpt, 3, b"epoch-three")
                fakes[1].swap_drop = dying

            fakes[1].on_swap = race
            out = [roll.check_once(), fired,
                   [f.epochs["a"] for f in fakes], router.fenced()]
            fakes[1].swap_drop = False
            fakes[1].on_swap = None
            router.probe()
            out += [roll.check_once(), [f.epochs["a"] for f in fakes],
                    router.fenced(), dict(roll.counters)]
            return out

    clean = both(scenario, False)
    assert clean[:4] == [{"a": "complete"}, [2], [2, 2], []]
    assert clean[4:7] == [{"a": "complete"}, [3, 3], []]
    dying = both(scenario, True)
    assert dying[:4] == [{"a": "halted"}, [2], [2, 1], []]
    assert dying[4:7] == [{"a": "complete"}, [3, 3], []]
    assert dying[7]["halted"] == 1


def test_rolling_swap_sharded_publish_rolls_and_gates(tmp_path):
    def scenario(p):
        ckpt = str(tmp_path / p.name / "ckpts")
        _publish_sharded_epoch(ckpt, 1)
        with Fakes(2) as fakes:
            router, roll = _rolling(p, fakes, ckpt)
            out = [roll.check_once()]
            _publish_sharded_epoch(ckpt, 2)
            out.append(roll.check_once())
            _publish_sharded_epoch(ckpt, 3, damage=(1, "drop"))
            out += [roll.check_once(), roll.check_once()]
            _publish_sharded_epoch(ckpt, 4, damage=(0, "rot"))
            out += [roll.check_once(), roll.counters["rejected"],
                    [f.epochs["a"] for f in fakes], _swaps(fakes)]
            return out

    rec = both(scenario)
    assert rec == [{"a": "current"}, {"a": "complete"}] + \
        [{"a": "rejected"}] * 3 + [2, [2, 2], [["/swap/a"], ["/swap/a"]]]


# ---------------------------------------------------------------------------
# the sharded front end: the published view + SO_REUSEPORT workers
# ---------------------------------------------------------------------------

def _manifest(p, n, models=("a", "b")):
    return p.fleet.FleetManifest.from_flags(
        ["%s=/x:1" % m for m in models], ["data=4"], replicas=n)


def test_view_publisher_generation_and_reader_last_good(tmp_path):
    def scenario(p):
        path = str(tmp_path / ("view-%s.json" % p.name))
        with Fakes(2) as fakes:
            prober = _mk_router(p, fakes)
            pub = p.fleet.FleetViewPublisher(prober, path)
            pub.publish_once()
            reader = p.fleet.FleetViewReader(path, refresh_s=0.0)
            doc = reader.doc()
            out = [reader.generation, sorted(int(r) for r in
                                             doc["replicas"]),
                   [r["healthy"] for r in doc["replicas"].values()]]
            prober.fence(1)
            pub.publish_once()
            out += [reader.generation, reader.fenced(),
                    reader.replicas()[1]["healthy"]]
            with open(path, "w") as f:
                f.write("{half a json docum")
            out += [reader.doc(force=True)["generation"],
                    reader.read_errors >= 1, pub.stats()["publishes"]]
            prober.unfence(1)
            return out

    rec = both(scenario)
    assert rec == [1, [0, 1], [True, True], 2, [1], False, 2, True, 2]


def test_view_worker_routes_follows_fence_and_counts_stale(tmp_path):
    def scenario(p):
        path = str(tmp_path / ("view-%s.json" % p.name))
        with Fakes(2) as fakes:
            prober = _mk_router(p, fakes)
            prober.probe()
            pub = p.fleet.FleetViewPublisher(prober, path)
            pub.publish_once()
            worker = p.fleet.FleetRouter(
                p.fleet.FleetViewReader(path, refresh_s=0.0),
                _manifest(p, 2), port=0, evict_s=0.4, spill_queue=4)
            routes = _record_routes(worker)
            out = [_send(worker, "a", 2)]
            prober.fence(0)
            pub.publish_once()
            out.append(_send(worker, "a", 2))
            prober.unfence(0)
            pub.publish_once()
            time.sleep(0.5)                 # the publisher goes quiet
            out.append(_send(worker, "a"))
            out += [routes, [len(x) for x in _received(fakes)],
                    worker.stats.snapshot()["counters"].get(
                        "stale_view_routes", 0) >= 1,
                    _outcome(p.Error, worker.fence, 0)[0]]
            return out

    rec = both(scenario)
    assert rec[3] == [[0, None], [0, None], [1, "rerouted"],
                      [1, "rerouted"], [0, None]]
    assert rec[4] == [3, 2] and rec[5] is True and rec[6] == "error"


def test_router_workers_share_reuseport_and_merge_stats(tmp_path):
    import http.client
    import socket as socket_mod
    assert hasattr(socket_mod, "SO_REUSEPORT")

    def scenario(p):
        run = tmp_path / p.name
        run.mkdir()
        path = str(run / "fleet-view.json")
        with Fakes(2) as fakes:
            prober = _mk_router(p, fakes)
            prober.probe()
            p.fleet.FleetViewPublisher(prober, path).publish_once()
            sock, port = p.fleet.reserve_port("127.0.0.1", 0)
            workers = []
            try:
                for i in range(2):
                    w = p.fleet.FleetRouter(
                        p.fleet.FleetViewReader(path, refresh_s=0.05),
                        _manifest(p, 2), host="127.0.0.1", port=port,
                        reuse_port=True, worker_id=i, run_dir=str(run),
                        spill_queue=8, evict_s=60.0)
                    w.serve_in_background()
                    workers.append(w)
                statuses = []
                for _ in range(20):
                    conn = http.client.HTTPConnection("127.0.0.1", port,
                                                      timeout=10)
                    conn.request("POST", "/predict/a", body=BODY,
                                 headers=JSON_CT)
                    statuses.append(conn.getresponse().status)
                    conn.close()
                for w in workers:
                    w.dump_worker_stats()
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=10)
                conn.request("GET", "/stats")
                resp = conn.getresponse()
                payload = json.loads(resp.read().decode())
                conn.close()
                return (set(statuses), resp.status,
                        sorted(payload["workers"]),
                        payload["router"]["merged_from"],
                        payload["router"]["counters"]["routed"],
                        payload["view"]["generation"])
            finally:
                for w in workers:
                    w.drain_and_stop(timeout=5)
                sock.close()

    assert both(scenario) == ({200}, 200, ["0", "1"], 2, 20, 1)


def test_worker_stats_carry_supervision_fields_through_view(tmp_path):
    def scenario(p):
        path = str(tmp_path / ("view-%s.json" % p.name))
        with Fakes(2) as fakes:
            man = _manifest(p, 2)
            prober = p.fleet.FleetRouter(_SupervisedFakes(fakes), man,
                                         port=0, heartbeat_s=0.15,
                                         evict_s=0.6, spill_queue=4)
            prober.probe()
            p.fleet.FleetViewPublisher(prober, path).publish_once()
            worker = p.fleet.FleetRouter(
                p.fleet.FleetViewReader(path, refresh_s=0.0), man, port=0,
                evict_s=0.4, spill_queue=4)
            reps = worker.stats_payload()["replicas"]
            ctrl = prober.stats_payload()["replicas"]
            return [[reps[r][k] for k in ("pid", "restarts", "state")]
                    + [ctrl[r]["pid"]] for r in (0, 1)]

    assert both(scenario) == [[40000, 0, "serving", 40000],
                              [40001, 1, "serving", 40001]]


# ---------------------------------------------------------------------------
# the controller, against dummy children
# ---------------------------------------------------------------------------

def _mk_controller(p, tmp_path, n=1, exit_plan=(), **kw):
    tmp_path.mkdir(parents=True, exist_ok=True)
    child = tmp_path / "child.py"
    child.write_text(_CHILD)
    man = p.fleet.FleetManifest.from_flags(["m=/x:1"], ["data=4"],
                                           replicas=n)
    kw.setdefault("backoff", 0.05)
    ctl = p.fleet.ReplicaController(
        man, str(tmp_path / "run"), serve_py=str(child),
        extra_env={"CHILD_EXIT_PLAN": json.dumps(list(exit_plan))}, **kw)
    for rep in ctl.replicas:
        rep.argv = [sys.executable, str(child), rep.port_file,
                    str(tmp_path / ("state-%d.json" % rep.id))]
    return ctl


def _state(tmp_path, rid=0):
    return json.loads((tmp_path / ("state-%d.json" % rid)).read_text())


def test_controller_spawns_reads_ports_drains(tmp_path):
    def scenario(p):
        d = tmp_path / p.name
        ctl = _mk_controller(p, d, n=2).start()
        try:
            ports = ctl.wait_ready(timeout=30)
            snap = {r["id"]: r for r in ctl.snapshot()}
            pids = [snap[r]["pid"] is not None for r in (0, 1)]
            rcs = ctl.drain(timeout=20)
            return (ports, [snap[r]["state"] for r in (0, 1)], pids, rcs,
                    [r.state for r in ctl.replicas])
        finally:
            ctl.kill()

    assert both(scenario) == ({0: 1234, 1: 1234}, ["serving"] * 2,
                              [True, True], {0: 0, 1: 0}, ["drained"] * 2)


@pytest.mark.parametrize("plan,resume", [([87], "1"), ([85], "1"),
                                         ([1], None), ([-9], None)])
def test_controller_relaunch_discipline(tmp_path, plan, resume):
    """85/87 relaunch with MXTPU_RESUME=1; any other death (an rc, a
    signal) relaunches without it."""
    def scenario(p):
        d = tmp_path / p.name
        if plan == [-9]:
            # a real SIGKILL of the first run, after it served
            ctl = _mk_controller(p, d).start()
            try:
                ctl.wait_ready(timeout=30)
                os.kill(ctl.replicas[0].proc.pid, 9)
                _wait(lambda: os.path.exists(ctl.replicas[0].port_file)
                      and _state(d)["runs"] == 2, 30, "respawn")
                ctl.wait_ready(timeout=30)
                return (ctl.replicas[0].last_rc, ctl.replicas[0].restarts,
                        _state(d)["runs"], _state(d)["resume"])
            finally:
                ctl.kill()
        ctl = _mk_controller(p, d, exit_plan=plan).start()
        try:
            ctl.wait_ready(timeout=30)
            return (ctl.replicas[0].last_rc, ctl.replicas[0].restarts,
                    _state(d)["runs"], _state(d)["resume"])
        finally:
            ctl.kill()

    rec = both(scenario)
    assert rec == (plan[0], 1, 2, resume)


def test_controller_restart_budget_exhausts_to_failed(tmp_path):
    def scenario(p):
        d = tmp_path / p.name
        ctl = _mk_controller(p, d, exit_plan=[1] * 6, max_restarts=2)
        ctl.start()
        try:
            _wait(lambda: ctl.replicas[0].state == "failed", 30,
                  "budget exhaustion")
            with pytest.raises(p.Error, match="failed during bring-up"):
                ctl.wait_ready(timeout=5)
            return _state(d)["runs"], ctl.replicas[0].restarts
        finally:
            ctl.kill()

    assert both(scenario) == (3, 2)


def test_controller_add_and_stop_replica(tmp_path):
    """add_replica spawns the next id from the manifest's command line
    and supervises it; stop_replica drains it to 0, retires its port and
    never relaunches it; a draining controller refuses to scale up."""
    def scenario(p):
        d = tmp_path / ("%s-2" % p.name)
        d.mkdir(parents=True)
        child = d / "flag_child.py"
        child.write_text(FLAG_CHILD)
        man = p.fleet.FleetManifest.from_flags(["m=/x:1"], ["data=4"],
                                               replicas=1)
        ctl = p.fleet.ReplicaController(man, str(d / "run"),
                                        serve_py=str(child), backoff=0.05)
        ctl.start()
        try:
            ctl.wait_ready(timeout=30)
            rep = ctl.add_replica()
            ports = ctl.wait_ready(timeout=30)
            rc = ctl.stop_replica(rep.id, timeout=20)
            after = ctl.ports()
            time.sleep(0.3)                 # nothing relaunches it
            states = [r.state for r in ctl.replicas]
            alive = rep.proc.poll() is not None
            ctl.drain(timeout=20)
            with pytest.raises(p.Error, match="draining"):
                ctl.add_replica()
            return (rep.id, sorted(ports), rc, sorted(after), states,
                    alive, os.path.exists(rep.port_file), rep.restarts)
        finally:
            ctl.kill()

    assert both(scenario) == (1, [0, 1], 0, [0], ["serving",
                                                   "scaled_down"],
                               True, False, 0)


#: a dummy daemon that takes the manifest's command line: writes its
#: port file, records its argv and env, exits 0 on SIGTERM
FLAG_CHILD = r"""
import json, os, signal, sys, time
argv = sys.argv[1:]
port_file = argv[argv.index("--port-file") + 1]
with open(port_file + ".json", "w") as f:
    json.dump({"argv": argv,
               "cuda": os.environ.get("CUDA_VISIBLE_DEVICES"),
               "cache": os.environ.get("MXTPU_COMPILE_CACHE"),
               "faults": os.environ.get("MXTPU_FAULTS")}, f)
with open(port_file + ".tmp", "w") as f:
    f.write("127.0.0.1:%d" % (4000 + os.getpid() % 1000))
os.replace(port_file + ".tmp", port_file)
signal.signal(signal.SIGTERM, lambda s, f: sys.exit(0))
time.sleep(600)
"""


def test_controller_places_cuda_co_tenants_and_exports_store(tmp_path):
    """``cuda:0`` with two replicas: both see card 0 and run on
    ``--context gpu(0)``; the warm store is every replica's
    MXTPU_COMPILE_CACHE; per-replica env lands on one replica; host
    cores are partitioned only for ``cpu`` sets."""
    child = tmp_path / "flag_child.py"
    child.write_text(FLAG_CHILD)
    man = tfleet.FleetManifest.from_flags(["m=/x:1"], ["m:data=4"],
                                          replicas=2, device_sets="cuda:0")
    ctl = tfleet.ReplicaController(
        man, str(tmp_path / "run"), serve_py=str(child),
        warm_store=str(tmp_path / "store"),
        extra_env_by_rid={1: {"MXTPU_FAULTS": "slow_replica:5"}})
    assert [r.affinity for r in ctl.replicas] == [None, None]
    ctl.start()
    try:
        ctl.wait_ready(timeout=30)
        seen = [json.load(open(r.port_file + ".json")) for r in ctl.replicas]
        assert ctl.drain(timeout=20) == {0: 0, 1: 0}
    finally:
        ctl.kill()
    for rid, s in enumerate(seen):
        assert s["cuda"] == "0"
        assert s["argv"][s["argv"].index("--context") + 1] == "gpu(0)"
        assert s["cache"] == str(tmp_path / "store")
        assert "--warmup" in s["argv"]
    assert [s["faults"] for s in seen] == [None, "slow_replica:5"]
    cpu_man = tfleet.FleetManifest.from_flags(["m=/x:1"], [], replicas=2,
                                              device_sets="cpu")
    cpu_ctl = tfleet.ReplicaController(cpu_man, str(tmp_path / "run2"),
                                       serve_py=str(child))
    sets = jfleet.ReplicaController._affinity_sets(2)
    assert [r.affinity for r in cpu_ctl.replicas] == sets
    assert tfleet.ReplicaController._affinity_sets(2) == sets
    assert cpu_ctl.replicas[0].env["CUDA_VISIBLE_DEVICES"] == ""


# ---------------------------------------------------------------------------
# the autoscaler, synthetic signal over a duck fleet
# ---------------------------------------------------------------------------

class _DuckView(object):
    def __init__(self):
        self.stats = {"queue_depth": {}, "est_wait_ms": {}}
        self.inflight = 0


class _DuckRouter(object):
    """Fencing with the N-1 floor, raising the given package's error."""

    def __init__(self, rids, error):
        self._lock = threading.Lock()
        self._views = {r: _DuckView() for r in rids}
        self._fenced = set()
        self.error = error
        self.log = []

    def healthy(self):
        return sorted(set(self._views) - self._fenced)

    def fence(self, rid):
        if len(self.healthy()) <= 1:
            raise self.error("fencing replica %d would leave no "
                             "routable replica" % rid)
        self._fenced.add(rid)
        self.log.append(("fence", rid))

    def unfence(self, rid):
        self._fenced.discard(rid)
        self.log.append(("unfence", rid))


def _mk_scaler(p, n=2, **kw):
    ctrl = _DuckController(n)
    router = _DuckRouter(range(n), p.Error)
    sig = {"v": 0.0}
    for k, v in (("high_ms", 50.0), ("low_ms", 5.0), ("up_after", 2),
                 ("down_after", 2), ("cooldown_s", 0.0), ("settle_s", 0.0),
                 ("drain_wait_s", 0.5), ("min_replicas", 1),
                 ("max_replicas", 4)):
        kw.setdefault(k, v)
    scaler = p.fleet.Autoscaler(ctrl, router, signal_fn=lambda: sig["v"],
                                **kw)
    return scaler, ctrl, router, sig


def _scaler_record(scaler, ctrl, router, ticks):
    return (ticks, ctrl.log, router.log, dict(scaler.counters),
            [r.state for r in ctrl.replicas])


def test_autoscaler_square_wave_never_flaps():
    def scenario(p):
        scaler, ctrl, router, sig = _mk_scaler(p)
        ticks = []
        for i in range(20):
            sig["v"] = 100.0 if i % 2 == 0 else 0.0
            ticks.append(scaler.tick())
        return _scaler_record(scaler, ctrl, router, ticks)

    rec = both(scenario)
    assert rec[0] == [None] * 20 and rec[1] == [] and rec[2] == []


def test_autoscaler_streak_cooldown_and_ceiling():
    def scenario(p, n, **kw):
        scaler, ctrl, router, sig = _mk_scaler(p, n=n, **kw)
        sig["v"] = 100.0
        ticks = [scaler.tick() for _ in range(4)]
        return _scaler_record(scaler, ctrl, router, ticks)

    rec = both(scenario, 2, cooldown_s=60.0)
    assert rec[0] == [None, "up", None, None] and rec[1] == [("add", 2)]
    assert rec[3]["blocked_cooldown"] >= 1
    rec = both(scenario, 4, max_replicas=4)
    assert rec[0] == [None] * 4 and rec[1] == []
    assert rec[3]["blocked_max"] == 3


def test_autoscaler_scale_down_order_floors_and_unwind():
    def scenario(p, case):
        scaler, ctrl, router, sig = _mk_scaler(p, n=2, min_replicas=1)
        sig["v"] = 0.0
        if case == "n1":
            router._fenced.add(0)       # the sibling is already fenced
        if case == "boom":
            def boom(rid, timeout=30.0):
                raise RuntimeError("stop failed")
            ctrl.stop_replica = boom
        ticks = [scaler.tick(), scaler.tick()]
        if case == "order":
            router._views.pop(1)
            ticks += [scaler.tick(), scaler.tick()]
        return _scaler_record(scaler, ctrl, router, ticks) + (
            sorted(router._fenced),)

    rec = both(scenario, "order")
    assert rec[0] == [None, "down", None, None]
    assert rec[2] == [("fence", 1), ("unfence", 1)]
    assert rec[1] == [("stop", 1)] and rec[4] == ["running", "scaled_down"]
    assert rec[3]["blocked_min"] >= 1 and rec[3]["scale_downs"] == 1
    rec = both(scenario, "n1")
    assert rec[0] == [None, None] and rec[3]["blocked_floor"] == 1
    assert rec[1] == [] and rec[2] == [] and rec[5] == [0]
    rec = both(scenario, "boom")
    assert rec[0] == [None, None] and rec[3]["errors"] == 1
    assert rec[2] == [("fence", 1), ("unfence", 1)] and rec[5] == []


def test_autoscaler_validates_its_bounds():
    for p in (JAX, PORT):
        with pytest.raises(p.Error, match="inverted"):
            _mk_scaler(p, high_ms=1.0, low_ms=5.0)
        with pytest.raises(p.Error, match="min_replicas"):
            _mk_scaler(p, min_replicas=0)


# ---------------------------------------------------------------------------
# the warm store
# ---------------------------------------------------------------------------

def test_warm_store_manifest_reads_a_jax_built_marker(tmp_path):
    stub = tmp_path / "stub_serve.py"
    stub.write_text(_STUB_SERVE)
    man = jfleet.FleetManifest.from_flags(["m=/x:1"], ["m:data=4"],
                                          replicas=1, buckets="1,2")
    store = str(tmp_path / "store")
    doc = jfleet.build_warm_store(man, store, serve_py=str(stub))
    assert tfleet.warm_store_manifest(store) == doc
    assert tfleet.warm_store_manifest(store)["buckets"] == "1,2"
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "FLEET_WARM.json").write_text("{torn")
    assert tfleet.warm_store_manifest(str(tmp_path / "bad")) is None
    assert tfleet.warm_store_manifest(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# fleet_main.py, with torch and jax unimportable
# ---------------------------------------------------------------------------

#: a stand-in replica speaking the daemon's surface on an ephemeral
#: port: /healthz, /stats, /predict/<m> (echoes its pid); SIGTERM -> 0
STUB_DAEMON = r"""
import json, os, signal, sys, threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
argv = sys.argv[1:]
port_file = argv[argv.index("--port-file") + 1]
assert argv[argv.index("--context") + 1] == "cpu", argv
assert os.environ.get("CUDA_VISIBLE_DEVICES") == "", "a card is visible"
served = [0]

class H(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    def log_message(self, *a):
        pass
    def _reply(self, payload):
        body = json.dumps(payload).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
    def do_GET(self):
        if self.path == "/healthz":
            self._reply({"status": "ok", "epochs": {}})
        else:
            self._reply({"queue_depth": {}, "est_wait_ms": {},
                         "counters": {"completed": served[0]}})
    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        served[0] += 1
        self._reply({"pid": os.getpid(), "outputs": [[1.0]]})

srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
with open(port_file + ".tmp", "w") as f:
    f.write("127.0.0.1:%d" % srv.server_address[1])
os.replace(port_file + ".tmp", port_file)

def _term(s, f):
    threading.Thread(target=srv.shutdown).start()
signal.signal(signal.SIGTERM, _term)
srv.serve_forever()
sys.stderr.write("stub daemon: served %d\n" % served[0])
"""

#: runs fleet_main.py with the stub daemon as the replica binary
FLEET_WRAPPER = r"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("fleet_main", %(main)r)
main = importlib.util.module_from_spec(spec)
spec.loader.exec_module(main)
main._bootstrap()
from mxnet_tpu_torch.fleet import controller
controller.default_serve_py = lambda: %(stub)r
rc = main.main(sys.argv[1:])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "mxnet_tpu"))
sys.stderr.write("fleet test: loaded %%s\n" %% loaded)
sys.exit(rc)
"""


def _poisoned_env(tmp_path):
    for name in ("torch", "jax"):
        d = tmp_path / "poison" / name
        d.mkdir(parents=True)
        (d / "__init__.py").write_text(
            "raise ImportError('the fleet process imported %s')\n" % name)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tmp_path / "poison")
    for k in ("MXTPU_FAULTS", "MXTPU_RESUME", "MXTPU_COMPILE_CACHE"):
        env.pop(k, None)
    return env


def _fleet_cmd(tmp_path):
    stub = tmp_path / "stub_daemon.py"
    stub.write_text(STUB_DAEMON)
    wrapper = tmp_path / "fleet_wrapper.py"
    wrapper.write_text(FLEET_WRAPPER % {"main": FLEET_MAIN,
                                        "stub": str(stub)})
    return [sys.executable, str(wrapper)]


@pytest.mark.parametrize("workers", [1, 2])
def test_fleet_main_serve_torch_free_reaches_ready_and_drains(tmp_path,
                                                              workers):
    from mxnet_tpu_torch.serving import ServeClient
    env = _poisoned_env(tmp_path)
    port_file = str(tmp_path / "fleet.port")
    run_dir = str(tmp_path / "run")
    cmd = _fleet_cmd(tmp_path) + [
        "serve", "--model", "m=/x:1", "--input-shape", "m:data=4",
        "--replicas", "2", "--device-sets", "cpu", "--port", "0",
        "--port-file", port_file, "--run-dir", run_dir,
        "--workers", str(workers)]
    proc = subprocess.Popen(cmd, env=env, cwd=str(tmp_path),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(port_file):
            assert proc.poll() is None, proc.stderr.read()[-3000:]
            assert time.monotonic() < deadline, "fleet never ready"
            time.sleep(0.05)
        port = int(open(port_file).read().split(":")[1])
        cli = ServeClient("127.0.0.1", port, timeout=10)
        answers = [cli.predict("m", np.zeros(4, "f"), npy=True)
                   for _ in range(6)]
        status, h = cli.healthz()
        cli.close()
        assert [a[0] for a in answers] == [200] * 6
        assert status == 200 and h["replicas_healthy"] == 2
        proc.send_signal(15)
        rc = proc.wait(timeout=60)
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert rc == 0, err[-3000:]
    assert "fleet test: loaded []" in err, err[-3000:]
    if workers == 1:
        assert "replica exit codes {0: 0, 1: 0}" in err
    else:
        assert "worker exit codes {0: 0, 1: 0}" in err
        assert "replica exit codes {0: 0, 1: 0}" in err


def test_fleet_main_warm_store_and_tpu_sets_refused_before_spawn(tmp_path):
    """A warm store whose build fails (here the builder daemon cannot
    import torch) exits 1 with the daemon's stderr and no marker, before
    any replica is spawned; a ``tpu:`` device set is refused the same
    way."""
    env = _poisoned_env(tmp_path)
    cmd = _fleet_cmd(tmp_path)
    flags = ["--model", "m=/x:1", "--input-shape", "m:data=4"]
    jax_manifest = str(tmp_path / "tpu_fleet.json")
    jfleet.FleetManifest.from_flags(["m=/x:1"], ["m:data=4"], replicas=2,
                                    device_sets="tpu:0;1").save(jax_manifest)
    runs = {
        "warmup": ["warmup"] + flags + ["--warm-store",
                                        str(tmp_path / "store")],
        "serve_store": ["serve"] + flags + [
            "--device-sets", "cpu", "--port", "0", "--warm-store",
            str(tmp_path / "store2"), "--run-dir", str(tmp_path / "run1")],
        "serve_tpu": ["serve", "--manifest", jax_manifest, "--port", "0",
                      "--run-dir", str(tmp_path / "run2")],
    }
    for name, args in runs.items():
        res = subprocess.run(cmd + args, env=env, cwd=str(tmp_path),
                             capture_output=True, text=True, timeout=60)
        assert res.returncode == 1, (name, res.stderr[-2000:])
        assert "fleet test: loaded []" in res.stderr
        if name == "serve_tpu":
            assert "bad device-sets spec 'tpu:0;1'" in res.stderr
        else:
            assert "warm-store build failed" in res.stderr, \
                res.stderr[-2000:]
            assert "the fleet process imported torch" in res.stderr
        assert "spawned" not in res.stderr
    for store in ("store", "store2"):
        assert not os.path.exists(str(tmp_path / store / "FLEET_WARM.json"))
    for run in ("run1", "run2"):
        d = tmp_path / run
        assert not d.exists() or not any(
            n.startswith("replica-") for n in os.listdir(str(d)))