"""The fleet's AOT warm store (port of ``mxnet_tpu/fleet/warm.py``):
replicas warm from stored programs instead of warming every bucket.

A fresh (or respawned) replica's bring-up cost is building one forward
per (model, bucket) pair and faulting it in.  The fleet builds those
programs ONCE, ahead of traffic: ONE ``serve_main.py --warmup-only
--export-aot`` run over the whole manifest exports each (model, bucket)
forward as a weight-free ``torch.export`` program into ``<store>/aot/``
(``serving/aot.py``), and the store directory doubles as every
replica's ``MXTPU_COMPILE_CACHE``.  A replica launched with the store
loads its programs — respawns included — and serves through them.

The store is built by the same binary that serves, under replica 0's
device env, so the stored programs are the forwards a replica runs
(same eval plan, same card, same shapes).  The marker
(``FLEET_WARM.json``) records the builder's ``warmup_s``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import time

from ..base import MXNetError
from .manifest import default_serve_py, replica_device_env

__all__ = ["build_warm_store", "warm_store_manifest", "MARKER"]

#: the store's marker file: records what was warmed (and doubles as the
#: "already built" sentinel for `fleet_main.py serve --warm-store`)
MARKER = "FLEET_WARM.json"

WARMUP_RE = re.compile(r"mxserve: warmup_s=([0-9.]+)")


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
    """Populate ``store_dir`` with every (model, bucket) program; returns
    the marker doc (with ``warmup_s``, the builder's export time).

    Idempotent: an already-built store returns its marker unless
    ``force``.  Raises :class:`MXNetError` with the daemon's stderr tail
    when the build fails; no marker is written then."""
    log = log or (lambda msg: None)
    existing = warm_store_manifest(store_dir)
    if existing is not None and not force:
        log("fleet: warm store %r already built (%d models)"
            % (store_dir, len(existing.get("models", []))))
        return existing
    os.makedirs(store_dir, exist_ok=True)
    argv = manifest.serve_argv(serve_py or default_serve_py(),
                               port_file=None, port=0, python=python,
                               warmup_only=True, export_aot=True)
    env = dict(os.environ)
    # the store must hold the replicas' platform's programs: build under
    # replica 0's device env (every replica shares one platform)
    env.update(replica_device_env(manifest.device_sets, 0))
    env.update(extra_env or {})
    env["MXTPU_COMPILE_CACHE"] = store_dir
    log("fleet: building warm store %r (%s)"
        % (store_dir, ", ".join(manifest.names())))
    tic = time.monotonic()
    try:
        res = subprocess.run(argv, env=env, capture_output=True,
                             text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        raise MXNetError("warm-store build exceeded %.0fs" % timeout)
    if res.returncode != 0:
        raise MXNetError("warm-store build failed (rc %d):\n%s"
                         % (res.returncode, (res.stderr or "")[-2000:]))
    m = WARMUP_RE.search(res.stderr or "")
    warmup_s = float(m.group(1)) if m else round(
        time.monotonic() - tic, 3)
    doc = {"models": manifest.names(),
           "buckets": manifest.buckets,
           "device_sets": manifest.device_sets,
           "warmup_s": warmup_s,
           "built_unix": time.time()}
    from ..resilience import atomic_write
    atomic_write(os.path.join(store_dir, MARKER),
                 json.dumps(doc, indent=2, sort_keys=True)
                 .encode("utf-8"))
    log("fleet: warm store built in %.2fs" % warmup_s)
    return doc
