"""The fleet's AOT warm store (port of ``mxnet_tpu/fleet/warm.py``).

In the JAX package the warm store kills replica cold-start: ONE
``--warmup-only --export-aot`` daemon run serializes every (model,
bucket) compiled forward into ``<store>/aot/``, the store doubles as
every replica's ``MXTPU_COMPILE_CACHE``, and a fresh or respawned
replica warms by deserializing instead of compiling.

The port has no compiled forward to store yet (``serving/aot.py``; the
daemon's ``--export-aot`` exits with an error), so here:

- :func:`build_warm_store` raises :class:`MXNetError` naming what it
  waits for, BEFORE anything runs: it spawns no daemon and writes no
  ``FLEET_WARM.json`` marker that would claim a warm store;
- :func:`warm_store_manifest` reads a marker as the JAX package does, so
  ``fleet_main.py serve --warm-store`` can tell a built store (one the
  JAX package wrote) from a missing one.  A replica pointed at a
  JAX-built store takes the daemon's AOT fallback (each bucket's
  executor warms) with its warning.
"""
from __future__ import annotations

import json
import os

from ..base import MXNetError

__all__ = ["build_warm_store", "warm_store_manifest", "MARKER",
           "NO_WARM_STORE"]

#: the store's marker file: records what was warmed (and doubles as the
#: "already built" sentinel for `fleet_main.py serve --warm-store`)
MARKER = "FLEET_WARM.json"

#: why the port builds no warm store
NO_WARM_STORE = (
    "the port cannot build a fleet warm store: it has no compiled "
    "forward to store yet (the compiled step and the AOT artifact are "
    "still to be ported, ROADMAP.md queue 1, item 5); serve without "
    "--warm-store, and each replica warms its buckets' executors")


def warm_store_manifest(store_dir):
    """The store's marker doc, or None when the store is absent/unbuilt."""
    path = os.path.join(store_dir, MARKER)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def build_warm_store(manifest, store_dir, serve_py=None, python=None,
                     timeout=1800.0, force=False, extra_env=None,
                     log=None):
    """The JAX package's signature; in the port it always raises
    :class:`MXNetError` (:data:`NO_WARM_STORE`) without spawning the
    daemon or writing the marker."""
    raise MXNetError("warm store %r: %s" % (store_dir, NO_WARM_STORE))
