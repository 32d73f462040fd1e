#!/usr/bin/env python
"""mxfleet on the port: a multi-replica serving fleet behind one routing
front end (the counterpart of the JAX package's ``tools/fleet.py``, with
its subcommands and flags).

::

    # serve: N replica daemons + the router on the public port; two
    # replicas co-tenant on card 0
    python mxnet_tpu_torch/fleet/fleet_main.py serve \\
        --model resnet=/ckpts/resnet-dir --input-shape resnet:data=3,224,224 \\
        --replicas 2 --device-sets cuda:0 --port 8200 \\
        [--manifest fleet.json] [--buckets 1,8,32] [--watch] \\
        [--run-dir DIR] [--port-file F] [--max-restarts N] \\
        [--workers N] [--autoscale] [--replica-env RID:NAME=VALUE]

    # the same on the host (what the tests run)
    python mxnet_tpu_torch/fleet/fleet_main.py serve --device-sets cpu ...

Each replica is ``mxnet_tpu_torch/serving/serve_main.py`` with the
manifest's models, ``--warmup`` and ``--context`` from the device sets
(``cpu``, or ``gpu(0)`` of the replica's ``CUDA_VISIBLE_DEVICES`` set:
``cuda:0;1`` puts replica *i* on card ``i % 2``, ``cuda:0`` puts every
replica on card 0).  ``--workers N`` (default ``MXTPU_FLEET_WORKERS``)
SHARDS the front end: N router worker processes accept on the SAME
public port via SO_REUSEPORT, each routing off the shared fleet-view
snapshot ONE controller-side prober publishes (``fleet/view.py``).
``--autoscale`` closes the loop on the aggregated est_wait_ms signal
(``fleet/autoscale.py``).  ``--watch`` rolls every verified new epoch of
each checkpoint-directory model across the replicas one at a time
(``fleet/deploy.py``).  The ``router-worker`` subcommand is the worker
binary (spawned by ``serve``, not run by hand).

The warm store: ``warmup --warm-store DIR`` builds it (one daemon run
that exports every (model, bucket) program, ``fleet/warm.py``), and
``serve --warm-store DIR`` builds it when it is absent, then passes it
to every replica as ``MXTPU_COMPILE_CACHE``: each replica, respawns
included, warms from the stored programs.  A failed build exits 1 with
the daemon's stderr tail before any replica is spawned.

Exits: ``serve`` runs until SIGTERM/SIGINT, which fences new work on the
public port, drains the router's in-flight forwards, forwards the drain
to every replica (each exits 0) and exits 0 (1 when a replica did not
exit 0 or bring-up failed).

IMPORT DISCIPLINE: this process NEVER imports torch or jax — a router
that created a CUDA context would hold device memory beside its
replicas, and a router worker that imported torch would pay that import
on every respawn.  The fleet package is torch-free by design; it is
imported through a stub ``mxnet_tpu_torch`` package whose ``__path__``
points at the real directory, so ``mxnet_tpu_torch/__init__.py`` (which
imports torch and the kernels) never executes.
"""
import argparse
import importlib.machinery
import json
import os
import sys
import types

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG_DIR = os.path.dirname(_HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path.pop(0)


def _bootstrap():
    """Install the package-path stub (unless the real package is already
    imported) and import the torch-free fleet."""
    if "mxnet_tpu_torch" not in sys.modules:
        pkg = types.ModuleType("mxnet_tpu_torch")
        pkg.__path__ = [_PKG_DIR]
        pkg.__spec__ = importlib.machinery.ModuleSpec(
            "mxnet_tpu_torch", None, is_package=True)
        pkg.__spec__.submodule_search_locations = pkg.__path__
        sys.modules["mxnet_tpu_torch"] = pkg
    from mxnet_tpu_torch import fleet
    return fleet


def _build_manifest(fleet, args):
    if args.manifest:
        man = fleet.FleetManifest.from_file(args.manifest)
        if args.model:          # flags override/extend the file
            over = fleet.FleetManifest.from_flags(
                args.model, args.input_shape, replicas=man.replicas)
            man.models.update(over.models)
        if args.replicas is not None:
            man.replicas = int(args.replicas)
        if args.buckets is not None:
            man.buckets = args.buckets
        if args.device_sets is not None:
            man.device_sets = args.device_sets
        return man
    if not args.model:
        raise SystemExit("need --model (or --manifest)")
    return fleet.FleetManifest.from_flags(
        args.model, args.input_shape, replicas=args.replicas,
        buckets=args.buckets, device_sets=args.device_sets)


def _add_manifest_flags(p):
    p.add_argument("--manifest", default=None,
                   help="fleet manifest JSON (flags override)")
    p.add_argument("--model", action="append", default=[],
                   metavar="NAME=PREFIX:EPOCH|NAME=DIR",
                   help="model to serve (repeatable; serve_main.py "
                        "format)")
    p.add_argument("--input-shape", action="append", default=[],
                   metavar="[MODEL:]INPUT=D1,D2,...",
                   help="per-sample input shape (repeatable)")
    p.add_argument("--replicas", type=int, default=None,
                   help="replica daemon count (default "
                        "MXTPU_FLEET_REPLICAS)")
    p.add_argument("--buckets", default=None,
                   help="override MXTPU_SERVE_BUCKETS for every replica")
    p.add_argument("--device-sets", default=None,
                   help="device placement: 'cpu' or 'cuda:0,1;2,3' "
                        "(replica i -> card set i mod the set count)")
    p.add_argument("--warm-store", default=None,
                   help="AOT warm store directory (MXTPU_COMPILE_CACHE "
                        "for every replica; `serve` builds it when "
                        "missing)")


def _log(msg):
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def _cmd_warmup(fleet, args):
    man = _build_manifest(fleet, args)
    if not args.warm_store:
        raise SystemExit("warmup needs --warm-store DIR")
    doc = fleet.build_warm_store(man, args.warm_store, log=_log,
                                 force=args.force)
    print(json.dumps(doc, sort_keys=True))
    return 0


def _cmd_serve(fleet, args):
    man = _build_manifest(fleet, args)
    if args.warm_store and \
            fleet.warm_store_manifest(args.warm_store) is None:
        fleet.build_warm_store(man, args.warm_store, log=_log)
    if args.run_dir:
        run_dir = args.run_dir
    elif args.warm_store:
        run_dir = os.path.join(args.warm_store,
                               "fleet-run-%d" % os.getpid())
    else:
        import tempfile
        run_dir = tempfile.mkdtemp(prefix="mxfleet_run_")
    workers_n = args.workers
    if workers_n is None:
        workers_n = man.router_workers
    if workers_n is None:
        from mxnet_tpu_torch.base import get_env as _get_env
        workers_n = int(_get_env(fleet.ENV_FLEET_WORKERS))
    man.router_workers = int(workers_n)
    env_by_rid = {}
    for spec in getattr(args, "replica_env", []):
        try:
            rid, assign = spec.split(":", 1)
            name, value = assign.split("=", 1)
        except ValueError:
            raise SystemExit("--replica-env wants RID:NAME=VALUE, "
                             "got %r" % spec)
        env_by_rid.setdefault(int(rid), {})[name] = value
    controller = fleet.ReplicaController(
        man, run_dir, warm_store=args.warm_store,
        max_restarts=args.max_restarts, extra_env_by_rid=env_by_rid,
        log=_log)
    # sharded mode: this router never serves HTTP — it is the
    # controller-side PROBER (health loop, fence state, capacity
    # floor) behind the view publisher; port 0 keeps the public port
    # free for the reuseport worker shard
    router = fleet.FleetRouter(controller, man, host=args.host,
                               port=args.port if workers_n <= 1 else 0,
                               slo_ms=args.slo_ms)
    # a SIGTERM during the (possibly long) replica bring-up must drain
    # the already-spawned replicas to rc 0 and exit 0 — the full router
    # drain path only takes over once bring-up completed (its server
    # does not exist yet, and the controller drain makes wait_ready
    # bail instead of sitting out --ready-timeout)
    import signal as _signal
    import threading as _threading
    early_drain = _threading.Event()

    def _on_early_signal(signum, frame):
        early_drain.set()
        _threading.Thread(target=router.drain_and_stop,
                          name="mxfleet-early-drain",
                          daemon=True).start()
    for _sig in (_signal.SIGTERM, _signal.SIGINT):
        _signal.signal(_sig, _on_early_signal)
    controller.start()
    try:
        controller.wait_ready(timeout=args.ready_timeout)
    except Exception as e:  # noqa: BLE001 — bring-up failed: clean up
        if early_drain.is_set():
            _log("fleet: drained during bring-up — exiting 0")
            return 0
        _log("fleet: bring-up failed: %s" % e)
        controller.kill()
        return 1
    if early_drain.is_set():
        _log("fleet: drained during bring-up — exiting 0")
        return 0
    if workers_n > 1:
        return _serve_sharded(fleet, args, man, run_dir, controller,
                              router, int(workers_n))
    router.install_signal_handlers()
    router.start()          # binds + one synchronous probe pass
    if args.watch:
        # rolling hot swap: tail every checkpoint-DIRECTORY model and
        # roll verified new epochs one replica at a time (torch-free
        # like the rest of this process)
        watched = {name: spec["target"]
                   for name, spec in man.models.items()
                   if os.path.isdir(spec["target"])}
        if watched:
            fleet.RollingSwap(router, watched, log=_log).start()
            _log("fleet: watching %s for new epochs"
                 % sorted(watched.values()))
        else:
            _log("fleet: --watch: no checkpoint-directory models in "
                 "the manifest — nothing to watch")
    if args.autoscale:
        fleet.Autoscaler(controller, router, log=_log).start()
        _log("fleet: autoscaler on (replica bounds via "
             "MXTPU_FLEET_MIN/MAX_REPLICAS)")
    _log("fleet: %d replica(s) ready; router on %s:%d (models: %s)"
         % (man.replicas, router.host, router.port, man.names()))
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write("%s:%d" % (router.host, router.port))
        os.replace(tmp, args.port_file)
    router.serve_forever()
    if router.draining and router.replica_rcs is None:
        # the drain thread may still be collecting replica exits
        import time as _time
        deadline = _time.monotonic() + 120
        while router.replica_rcs is None and \
                _time.monotonic() < deadline:
            _time.sleep(0.1)
    rcs = router.replica_rcs or {}
    _log("fleet: drained — replica exit codes %s"
         % {k: rcs[k] for k in sorted(rcs)})
    return 0 if all(rc == 0 for rc in rcs.values()) else 1


def _serve_sharded(fleet, args, man, run_dir, controller, prober,
                   workers_n):
    """The sharded front end: publish the fleet view off ``prober``
    (which never serves HTTP), reserve the public port, spawn
    ``workers_n`` reuseport router workers, optionally close the
    autoscale loop, then park until SIGTERM and drain everything in
    dependency order (workers first — they stop ANSWERING; replicas
    last — they stop COMPUTING)."""
    import signal as _signal
    import threading as _threading
    from mxnet_tpu_torch.fleet.view import VIEW_BASENAME
    view_path = os.path.join(run_dir, VIEW_BASENAME)
    manifest_path = os.path.join(run_dir, "manifest.json")
    man.save(manifest_path)
    if args.watch:
        watched = {name: spec["target"]
                   for name, spec in man.models.items()
                   if os.path.isdir(spec["target"])}
        if watched:
            fleet.RollingSwap(prober, watched, log=_log).start()
            _log("fleet: watching %s for new epochs"
                 % sorted(watched.values()))
    publisher = fleet.FleetViewPublisher(prober, view_path,
                                         log=_log).start()
    autoscaler = None
    if args.autoscale:
        autoscaler = fleet.Autoscaler(controller, prober,
                                      publisher=publisher,
                                      log=_log).start()
        _log("fleet: autoscaler on (replica bounds via "
             "MXTPU_FLEET_MIN/MAX_REPLICAS)")
    sock, port = fleet.reserve_port(args.host, args.port)
    wset = fleet.RouterWorkerSet(
        manifest_path, view_path, args.host, port, workers_n, run_dir,
        slo_ms=args.slo_ms, log=_log)
    stop = _threading.Event()

    def _on_signal(signum, frame):
        stop.set()
    for _sig in (_signal.SIGTERM, _signal.SIGINT):
        _signal.signal(_sig, _on_signal)
    failed = False
    try:
        wset.start()
        wset.wait_ready(timeout=60.0)
        _log("fleet: %d replica(s) ready; %d router worker(s) on "
             "%s:%d (models: %s)" % (man.replicas, workers_n,
                                     args.host, port, man.names()))
        if args.port_file:
            tmp = args.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write("%s:%d" % (args.host, port))
            os.replace(tmp, args.port_file)
        stop.wait()
    except Exception as e:  # noqa: BLE001 — bring-up failed: clean up
        _log("fleet: sharded bring-up failed: %s" % e)
        failed = True
    if autoscaler is not None:
        autoscaler.stop()
    wrcs = wset.drain()
    publisher.stop()
    rrcs = controller.drain()
    sock.close()
    _log("fleet: drained — worker exit codes %s, replica exit codes %s"
         % ({k: wrcs[k] for k in sorted(wrcs)},
            {k: rrcs[k] for k in sorted(rrcs)}))
    ok = all(rc == 0 for rc in wrcs.values()) and \
        all(rc == 0 for rc in rrcs.values())
    return 0 if (ok and not failed) else 1


def _cmd_router_worker(fleet, args):
    """One reuseport router worker (spawned by ``serve --workers N``):
    route off the shared view snapshot, never probe, dump counters for
    the sibling /stats merge, drain on SIGTERM."""
    man = fleet.FleetManifest.from_file(args.manifest_file)
    reader = fleet.FleetViewReader(args.view)
    router = fleet.FleetRouter(
        reader, man, host=args.host, port=args.port,
        spill_queue=args.spill_queue, slo_ms=args.slo_ms,
        request_timeout=args.request_timeout, reuse_port=True,
        worker_id=args.worker_id, run_dir=args.run_dir)
    router.install_signal_handlers()
    _log("fleet: router worker %d on %s:%d (pid %d)"
         % (args.worker_id, args.host, args.port, os.getpid()))
    router.serve_forever()
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="multi-replica serving fleet on the port "
                    "(the JAX package's tools/fleet.py)")
    sub = parser.add_subparsers(dest="cmd")

    p_warm = sub.add_parser("warmup", help="build the AOT warm store")
    _add_manifest_flags(p_warm)
    p_warm.add_argument("--force", action="store_true",
                        help="rebuild even if the store marker exists")

    p_serve = sub.add_parser("serve", help="run the fleet")
    _add_manifest_flags(p_serve)
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--port", type=int, default=8200,
                         help="the router's public port (0 = ephemeral; "
                              "see --port-file)")
    p_serve.add_argument("--port-file", default=None,
                         help="write 'host:port' here once the fleet "
                              "is ready")
    p_serve.add_argument("--run-dir", default=None,
                         help="replica port files + logs (default: "
                              "under --warm-store or cwd)")
    p_serve.add_argument("--replica-env", action="append", default=[],
                         metavar="RID:NAME=VALUE",
                         help="extra env for ONE replica (repeatable) "
                              "— e.g. 0:MXTPU_FAULTS=slow_replica:100 "
                              "arms a fault on replica 0 only (chaos "
                              "drills)")
    p_serve.add_argument("--max-restarts", type=int, default=3,
                         help="per-replica consecutive-relaunch budget")
    p_serve.add_argument("--slo-ms", type=float, default=0.0,
                         help="spill when the home replica's estimated "
                              "wait exceeds this (0 = depth-only)")
    p_serve.add_argument("--ready-timeout", type=float, default=600.0,
                         help="seconds to wait for every replica's "
                              "bring-up")
    p_serve.add_argument("--watch", action="store_true",
                         help="tail each checkpoint-directory model "
                              "and roll verified new epochs across "
                              "the replicas one at a time "
                              "(MXTPU_SWAP_* knobs)")
    p_serve.add_argument("--workers", type=int, default=None,
                         help="router worker processes sharing the "
                              "public port via SO_REUSEPORT (default "
                              "manifest router_workers, then "
                              "MXTPU_FLEET_WORKERS; 1 = in-line "
                              "single-process router)")
    p_serve.add_argument("--autoscale", action="store_true",
                         help="close the autoscale loop on the "
                              "aggregated est_wait_ms signal "
                              "(MXTPU_FLEET_SCALE_* / MIN/MAX_REPLICAS "
                              "knobs; scale-down is fence -> drain -> "
                              "stop)")

    p_rw = sub.add_parser("router-worker",
                          help="one reuseport router worker (spawned "
                               "by `serve --workers N`, not run by "
                               "hand)")
    p_rw.add_argument("--manifest-file", required=True,
                      help="the manifest JSON `serve` saved under the "
                           "run dir")
    p_rw.add_argument("--view", required=True,
                      help="the shared fleet-view snapshot path")
    p_rw.add_argument("--host", default="127.0.0.1")
    p_rw.add_argument("--port", type=int, required=True,
                      help="the reserved public port (every worker "
                           "binds it with SO_REUSEPORT)")
    p_rw.add_argument("--worker-id", type=int, required=True)
    p_rw.add_argument("--run-dir", required=True,
                      help="where this worker dumps its counters for "
                           "the sibling /stats merge")
    p_rw.add_argument("--slo-ms", type=float, default=0.0)
    p_rw.add_argument("--request-timeout", type=float, default=60.0)
    p_rw.add_argument("--spill-queue", type=int, default=None)

    args = parser.parse_args(argv)
    if not args.cmd:
        parser.error("need a subcommand: serve, warmup or "
                     "router-worker")
    fleet = _bootstrap()
    from mxnet_tpu_torch.base import MXNetError
    try:
        if args.cmd == "warmup":
            return _cmd_warmup(fleet, args)
        if args.cmd == "router-worker":
            return _cmd_router_worker(fleet, args)
        return _cmd_serve(fleet, args)
    except MXNetError as e:
        _log("fleet: error: %s" % e)
        return 1


if __name__ == "__main__":
    sys.exit(main())
