"""Fleet manifest: WHAT the fleet serves and WHERE each model lives (port
of ``mxnet_tpu/fleet/manifest.py``).

The manifest is the routing front end's source of truth (the router
knows models and policies, never weights).  It names the models
(checkpoint targets + per-sample input shapes, the daemon's spec
format), the replica count, the bucket set, and the device placement
spec; from it the controller derives each replica's launch command and
the router derives each model's HOME replica.

Placement model: EVERY replica loads EVERY model (the warm pool is
replicated), but each model has one stable **home** replica (its
position in the sorted name list mod the replica count) that takes its
traffic by default.  Routing to a home concentrates a model's requests
where its buckets stay hot, while the replicated pool means SPILL needs
no model loading: when the home's queue crosses the bar, any replica
can take the overflow immediately.

Device sets speak CUDA: ``cpu`` runs every replica on the host
(``--context cpu``, no visible card), ``cuda:0;1`` gives replica *i*
the card set ``i % n_sets`` through ``CUDA_VISIBLE_DEVICES`` and
``--context gpu(0)``.  More replicas than sets wrap around: co-tenant
replicas share one card, each its own process with its own CUDA
context and caching allocator.
"""
from __future__ import annotations

import json
import os
import sys

from ..base import MXNetError, get_env, register_env

__all__ = ["FleetManifest", "replica_device_env", "replica_context",
           "parse_shape_specs", "default_serve_py", "ENV_FLEET_REPLICAS"]

ENV_FLEET_REPLICAS = register_env(
    "MXTPU_FLEET_REPLICAS", default=2,
    doc="Default replica-daemon count for `fleet_main.py serve` when "
        "the manifest/--replicas does not say otherwise")

_SPEC_HELP = "want 'cpu' or 'cuda:0,1;2,3'"


def parse_shape_specs(specs):
    """``["mlp:data=784", "data=3,32,32"]`` -> ``{model_or_None:
    {input: shape}}`` — the daemon's ``--input-shape`` format (no model
    prefix = applies to every model)."""
    out = {}
    for spec in specs or ():
        model = None
        head, _, tail = str(spec).partition("=")
        if ":" in head:
            model, _, head = head.partition(":")
        try:
            shape = tuple(int(x) for x in tail.split(",") if x)
        except ValueError:
            raise MXNetError("bad --input-shape spec %r" % (spec,))
        if not head or not shape:
            raise MXNetError("bad --input-shape spec %r (want "
                             "[MODEL:]INPUT=D1,D2,...)" % (spec,))
        out.setdefault(model, {})[head] = shape
    return out


def _cuda_sets(device_sets):
    """``"cuda:0,1;2"`` -> ``["0,1", "2"]``; raises on any other form
    (a ``tpu:`` spec written for the JAX fleet included)."""
    plat, _, rest = str(device_sets).partition(":")
    groups = [g.strip() for g in rest.split(";") if g.strip()]
    if plat != "cuda" or not groups or not all(
            d.strip().isdigit() for g in groups for d in g.split(",")):
        raise MXNetError("bad device-sets spec %r (%s)"
                         % (device_sets, _SPEC_HELP))
    return groups


def replica_device_env(device_sets, index):
    """Device pinning for replica ``index`` -> env-overlay dict.

    ``device_sets``:

    - ``None``/``""`` — inherit the parent environment untouched.
    - ``"cpu"`` — every replica runs on the host and sees no card
      (``CUDA_VISIBLE_DEVICES=""``); core partitioning is the
      controller's ``cpu_affinity`` job.
    - ``"cuda:0,1;2,3"`` — replica *i* sees only card set ``i % n_sets``
      (``CUDA_VISIBLE_DEVICES``).  More replicas than sets wrap around:
      ``cuda:0`` with two replicas makes them co-tenants on card 0.

    Any other form raises :class:`MXNetError`.
    """
    if not device_sets:
        return {}
    if device_sets == "cpu":
        return {"CUDA_VISIBLE_DEVICES": ""}
    groups = _cuda_sets(device_sets)
    return {"CUDA_VISIBLE_DEVICES": groups[index % len(groups)]}


def replica_context(device_sets):
    """The daemon's ``--context`` for ``device_sets``: ``"cpu"``,
    ``"gpu(0)"`` (the first card of the replica's visible set) or
    ``None`` (inherit: the daemon's own default)."""
    if not device_sets:
        return None
    if device_sets == "cpu":
        return "cpu"
    _cuda_sets(device_sets)
    return "gpu(0)"


class FleetManifest(object):
    """models: ``{name: {"target": "prefix:epoch"|"ckpt-dir",
    "shapes": {input: shape} | None}}`` + replicas/buckets/device_sets.
    """

    def __init__(self, models, replicas=None, buckets=None,
                 device_sets=None, router_workers=None):
        if not models:
            raise MXNetError("a fleet manifest needs at least one model")
        self.models = {}
        for name, spec in models.items():
            if isinstance(spec, str):
                spec = {"target": spec}
            target = spec.get("target")
            if not name or not target:
                raise MXNetError("bad model spec %r=%r (want name -> "
                                 "{'target': prefix:epoch|dir})"
                                 % (name, spec))
            shapes = spec.get("shapes") or None
            if shapes:
                shapes = {k: tuple(int(d) for d in v)
                          for k, v in shapes.items()}
            self.models[name] = {"target": target, "shapes": shapes}
        self.replicas = int(get_env(ENV_FLEET_REPLICAS)
                            if replicas is None else replicas)
        if self.replicas < 1:
            raise MXNetError("replicas must be >= 1, got %d"
                             % self.replicas)
        self.buckets = buckets
        self.device_sets = device_sets
        #: router worker processes sharing the public port (the sharded
        #: front end); None = the MXTPU_FLEET_WORKERS default at serve
        #: time, 1 = the in-line single-process router
        self.router_workers = None if router_workers is None \
            else int(router_workers)
        if self.router_workers is not None and self.router_workers < 1:
            raise MXNetError("router_workers must be >= 1, got %d"
                             % self.router_workers)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_flags(cls, model_flags, shape_flags=(), replicas=None,
                   buckets=None, device_sets=None):
        """The daemon's flag formats: ``--model
        name=prefix:epoch|name=dir`` (repeatable) + ``--input-shape
        [MODEL:]INPUT=D1,D2`` (repeatable)."""
        shapes = parse_shape_specs(shape_flags)
        models = {}
        for spec in model_flags or ():
            name, _, target = str(spec).partition("=")
            if not name or not target:
                raise MXNetError("bad --model spec %r (want "
                                 "name=prefix:epoch or name=ckpt-dir)"
                                 % (spec,))
            models[name] = {"target": target,
                            "shapes": shapes.get(name, shapes.get(None))}
        return cls(models, replicas=replicas, buckets=buckets,
                   device_sets=device_sets)

    @classmethod
    def from_file(cls, path):
        with open(path) as f:
            doc = json.load(f)
        return cls(doc.get("models") or {},
                   replicas=doc.get("replicas"),
                   buckets=doc.get("buckets"),
                   device_sets=doc.get("device_sets"),
                   router_workers=doc.get("router_workers"))

    def to_doc(self):
        return {"models": {n: {"target": s["target"],
                               "shapes": {k: list(v) for k, v in
                                          (s["shapes"] or {}).items()}
                               or None}
                           for n, s in self.models.items()},
                "replicas": self.replicas,
                "buckets": self.buckets,
                "device_sets": self.device_sets,
                "router_workers": self.router_workers}

    def save(self, path):
        from ..resilience import atomic_write
        atomic_write(path, json.dumps(self.to_doc(), indent=2,
                                      sort_keys=True).encode("utf-8"))
        return path

    # -- routing geometry --------------------------------------------------
    def names(self):
        return sorted(self.models)

    def home(self, model):
        """The model's HOME replica index: stable position in the
        sorted name list mod the replica count — every router instance
        computes the same homes with no coordination."""
        if model not in self.models:
            raise MXNetError("no model %r in the fleet manifest "
                             "(have: %s)" % (model, self.names()))
        return self.names().index(model) % self.replicas

    # -- launch plumbing ---------------------------------------------------
    def serve_argv(self, serve_py, port_file=None, port=0, python=None,
                   warmup=True, warmup_only=False, export_aot=False,
                   extra=()):
        """The daemon's command line for ONE replica (every replica
        serves the whole manifest — the replicated warm pool), with
        ``--context`` from the device sets.  ``export_aot`` makes it the
        warm-store BUILDER instead."""
        argv = [python or sys.executable, serve_py, "--port", str(port)]
        if port_file:
            argv += ["--port-file", port_file]
        if self.buckets:
            argv += ["--buckets", str(self.buckets)]
        for name in self.names():
            spec = self.models[name]
            argv += ["--model", "%s=%s" % (name, spec["target"])]
            for inp, shape in (spec["shapes"] or {}).items():
                argv += ["--input-shape", "%s:%s=%s"
                         % (name, inp, ",".join(str(d) for d in shape))]
        if warmup_only:
            argv += ["--warmup-only"]
        elif warmup:
            argv += ["--warmup"]
        if export_aot:
            argv += ["--export-aot"]
        context = replica_context(self.device_sets)
        if context is not None:
            argv += ["--context", context]
        argv += list(extra)
        return argv


def default_serve_py():
    """The port's daemon, ``serving/serve_main.py`` in this package (the
    replica binary)."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "serving", "serve_main.py")
