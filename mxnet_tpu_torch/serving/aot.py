"""AOT executable store (port of ``mxnet_tpu/serving/aot.py``): its
layout, its meta check and its fallback.

The JAX package serializes one weight-free COMPILED forward per (model,
bucket) with ``jax.experimental.serialize_executable``, so a respawned
replica loads its bucket programs instead of tracing them.  The port has
no compiled forward yet: its ``Predictor`` runs the eager plan, and
``predict.export_compiled`` (a ``torch.export`` program) is still to be
ported.  So this module keeps what carries over —

- the store's layout (``<MXTPU_COMPILE_CACHE>/aot/``)::

      <model>.json            meta: sample shapes, dtype, param/aux names,
                              param digest, platform, buckets
      <model>-b<bucket>.exec  the serialized executable
      <model>-b<bucket>.tree  its (in_tree, out_tree)

- :func:`entry_meta` and :func:`params_digest`, which give the JAX
  package's dict for the same model;
- :meth:`AotStore.verify` and the fallback: a store whose meta does not
  match (another model, dtype or parameter set, a JAX-built store whose
  platform is ``cpu`` or ``tpu`` and which has no ``runtime`` key) or
  whose artifact cannot be loaded warns and returns nothing, and the
  daemon warms the bucket executors the usual way —

while :meth:`AotStore.save`, :func:`build_forward` and
``PooledModel.export_aot`` raise :class:`~..base.MXNetError`: an empty
artifact that a later load would "succeed" on must never be written.
The port's platform is ``cuda:<device name>`` or ``cpu``.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..base import MXNetError

__all__ = ["AotStore", "aot_dir_for_cache"]

_META_VERSION = 1

#: the runtime a store's artifacts are for; a JAX-built meta has none
RUNTIME = "mxnet_tpu_torch"

_NO_COMPILED = ("the port has no compiled forward to store yet: "
                "predict.export_compiled and the compiled step are still "
                "to be ported (ROADMAP.md queue 1, item 5); serve with "
                "--warmup, which warms each bucket's executor")


def aot_dir_for_cache(cache_dir):
    """The store's location inside a compile-cache directory."""
    return os.path.join(cache_dir, "aot")


def _log():
    import logging
    return logging.getLogger(__name__)


def platform_of(ctx):
    """The meta's platform for a context: ``cuda:<device name>`` on a
    card, ``cpu`` on the host."""
    if ctx is None or ctx.device_type == "cpu":
        return "cpu"
    import torch
    return "cuda:%s" % torch.cuda.get_device_name(ctx.device_id)


class AotStore(object):
    """One directory of serialized compiled forwards.  ``platform`` is
    what a loadable store must have been built for (the pool passes
    :func:`platform_of` its context)."""

    def __init__(self, directory, platform="cpu"):
        self.dir = directory
        self.platform = platform

    def _base(self, model, bucket):
        return os.path.join(self.dir, "%s-b%d" % (model, int(bucket)))

    def _meta_path(self, model):
        return os.path.join(self.dir, "%s.json" % model)

    def meta(self, model):
        try:
            with open(self._meta_path(model)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def buckets(self, model):
        doc = self.meta(model)
        return sorted(int(b) for b in (doc or {}).get("buckets", []))

    # -- build side --------------------------------------------------------
    def save(self, model, bucket, compiled, meta):
        """Raises: there is no compiled forward to serialize (module
        docstring)."""
        raise MXNetError("AotStore.save(%r, bucket %d): %s"
                         % (model, int(bucket), _NO_COMPILED))

    # -- load side ---------------------------------------------------------
    def verify(self, model, meta):
        """Does the store's meta match this pool entry on this platform
        and runtime?  Returns the meta doc on match, None (with a
        warning) otherwise — stale or foreign artifacts must fall back,
        never serve wrong math."""
        doc = self.meta(model)
        if doc is None:
            return None
        checks = dict(meta)
        checks["platform"] = self.platform
        checks["runtime"] = RUNTIME
        checks["meta_version"] = _META_VERSION
        for key, want in checks.items():
            got = doc.get(key)
            # JSON roundtrips tuples as lists
            norm = lambda v: json.loads(json.dumps(v))  # noqa: E731
            if norm(got) != norm(want):
                _log().warning(
                    "AOT store %s: meta mismatch for %r on %r "
                    "(store %r != pool %r) — falling back to "
                    "the bucket warmup", self.dir, model, key, got, want)
                return None
        return doc

    def load(self, model, bucket):
        """One executable -> callable, or None: this package has no
        loader for compiled forwards yet (module docstring), so the
        caller always falls back."""
        _log().warning("AOT store %s: cannot load %s-b%d (%s) — falling "
                       "back to the bucket warmup", self.dir, model,
                       int(bucket), _NO_COMPILED)
        return None


def build_forward(symbol, arg_params, aux_params, sample_shapes,
                  bucket):
    """Raises: the port has no compiled forward to build (module
    docstring)."""
    raise MXNetError("build_forward(bucket %d): %s"
                     % (int(bucket), _NO_COMPILED))


def _dtype_name(v):
    """The numpy name of a value's element type; the port's bfloat16
    arrays answer ``"bfloat16"`` (as ``ml_dtypes`` names it)."""
    dt = getattr(v, "dtype", np.float32)
    if isinstance(dt, str):
        return dt
    return np.dtype(dt).name


def entry_meta(entry):
    """The verification meta for one pool entry (shape/dtype/param-set
    identity — what must match for a stored executable to be THIS
    model's forward)."""
    if entry.sample_shapes is None:
        raise MXNetError("model %r has no declared sample_shapes — the "
                         "AOT store needs them" % entry.name)
    return {"sample_shapes": {k: list(v)
                              for k, v in sorted(
                                  entry.sample_shapes.items())},
            "dtype": entry.dtype or "float32",
            "param_names": sorted(entry.arg_params),
            "aux_names": sorted(entry.aux_params),
            "param_digest": params_digest(entry.arg_params,
                                          entry.aux_params)}


def params_digest(arg_params, aux_params):
    """Cheap shape/dtype digest of the parameter set (NOT a content
    hash — weights ride at call time, only the program signature must
    match)."""
    import hashlib
    h = hashlib.sha256()
    for prefix, d in (("arg", arg_params), ("aux", aux_params)):
        for k in sorted(d):
            v = d[k]
            h.update(("%s:%s:%s:%s;" % (
                prefix, k, tuple(int(n) for n in getattr(v, "shape", ())),
                _dtype_name(v))).encode())
    return h.hexdigest()[:16]
