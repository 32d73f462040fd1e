"""mxfleet on the port: a multi-replica serving fleet on the port's
serving stack (port of ``mxnet_tpu/fleet/``).

The port's daemon (``serving/serve_main.py``) is ONE process: one warm
``ModelPool``, one public port, one GIL — its request rate is bounded by
its host path long before one H100 is busy.  This package composes N of
those daemons into one serving system, co-tenant on one card or spread
over several:

- :mod:`.manifest` — the fleet manifest (models, replica count, device
  placement: ``cpu`` or ``cuda:0,1;2,3`` card sets, wrapping so that
  replicas beyond the sets share a card) + each model's stable HOME
  replica.
- :mod:`.controller` — replica lifecycle: spawns N real daemon
  processes, each on its card set (``CUDA_VISIBLE_DEVICES`` +
  ``--context``; CPU-core affinity on the CPU tier), supervised by the
  ``tools/supervise.py`` exit-code discipline (85/87 relaunch with
  ``MXTPU_RESUME=1``; any other death respawns within a streak budget;
  drains relaunch nothing).
- :mod:`.router` — the routing front end that owns the public port:
  route-by-model to the home replica, SPILL to the least-loaded replica
  when the home's queue/SLO signal crosses the bar, heartbeat-age
  eviction off ``/healthz``, exactly-once keyed retry on a dead replica
  (one resend to a different healthy replica, same request id — replica
  dedup + bucket bit-stability make it safe), hedging, brownout, the
  ``dup_request`` fault point, SIGTERM drain that fences new work then
  drains every replica, and fleet-level p50/p99/shed on ``/stats``.
- :mod:`.warm` — the AOT warm store: one ``--warmup-only
  --export-aot`` daemon run exports every (model, bucket) program, and
  every replica (respawns included) warms from it.
- :mod:`.view` — the shared fleet view that shards the front end: ONE
  controller-side prober publishes manifest + health + the fenced set
  into an atomic JSON snapshot with a generation counter; N
  ``FleetRouter`` worker processes (:class:`~.view.RouterWorkerSet`)
  accept on the SAME public port via SO_REUSEPORT and route off the
  snapshot — workers never probe and never coordinate.
- :mod:`.deploy` — :class:`RollingSwap`: a verified new epoch rolled
  one replica at a time through each replica's ``POST /swap``.
- :mod:`.autoscale` — the loop that ACTS on the aggregated
  ``est_wait_ms`` signal: hysteresis + cooldown, scale-up through
  :meth:`~.controller.ReplicaController.add_replica`, scale-down through
  the fence -> drain -> stop path (never below the capacity floor).

``fleet/fleet_main.py`` is the CLI (``serve`` + ``warmup`` +
``router-worker`` subcommands).  Every ``MXTPU_FLEET_*`` knob is
registered EAGERLY at its owner module below.  This package imports the
standard library and the port's ``base``, ``resilience`` and ``serving``
only: never torch at module level, never jax — the router and
controller are pure-host processes, and ``fleet_main.py`` imports them
under a stub package so that no torch import (and no CUDA context)
happens in them.
"""
from .manifest import (FleetManifest, parse_shape_specs,
                       replica_device_env, default_serve_py,
                       ENV_FLEET_REPLICAS)
from .controller import Replica, ReplicaController
from .router import (FleetRouter, NoHealthyReplica, ReplicaDead,
                     ENV_FLEET_SPILL_QUEUE, ENV_FLEET_HEARTBEAT_S,
                     ENV_FLEET_EVICT_S)
from .warm import build_warm_store, warm_store_manifest
from .deploy import RollingSwap
from .view import (FleetViewPublisher, FleetViewReader, RouterWorkerSet,
                   reserve_port, ENV_FLEET_WORKERS,
                   ENV_FLEET_VIEW_REFRESH_S)
from .autoscale import (Autoscaler, ENV_FLEET_SCALE_HIGH_MS,
                        ENV_FLEET_SCALE_LOW_MS,
                        ENV_FLEET_SCALE_COOLDOWN_S,
                        ENV_FLEET_MIN_REPLICAS, ENV_FLEET_MAX_REPLICAS)

__all__ = ["FleetManifest", "parse_shape_specs", "replica_device_env",
           "default_serve_py", "Replica", "ReplicaController",
           "FleetRouter", "NoHealthyReplica", "ReplicaDead",
           "build_warm_store", "warm_store_manifest", "RollingSwap",
           "FleetViewPublisher", "FleetViewReader", "RouterWorkerSet",
           "reserve_port", "Autoscaler",
           "ENV_FLEET_REPLICAS", "ENV_FLEET_SPILL_QUEUE",
           "ENV_FLEET_HEARTBEAT_S", "ENV_FLEET_EVICT_S",
           "ENV_FLEET_WORKERS", "ENV_FLEET_VIEW_REFRESH_S",
           "ENV_FLEET_SCALE_HIGH_MS", "ENV_FLEET_SCALE_LOW_MS",
           "ENV_FLEET_SCALE_COOLDOWN_S", "ENV_FLEET_MIN_REPLICAS",
           "ENV_FLEET_MAX_REPLICAS"]
