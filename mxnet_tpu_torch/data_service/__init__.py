"""The input-data service (port of ``mxnet_tpu/data_service/``).

Input processing runs outside the trainer process: a sharded recordio
reader splits the ``.rec``/``.idx`` across N decode worker processes, each
decoding straight into a shared-memory ring, and a collector in the
trainer process hands zero-copy views to the upload path.

- :mod:`.common`: seeds, epoch order, shard assignment, ring layout
  (stdlib + numpy; shared by every process).
- :mod:`.ring`: the single-producer / single-consumer shared-memory
  batch ring (stdlib + numpy).
- :mod:`._worker_main`: the decode worker's entry point (a stub package
  over the torch-free leaves).
- :mod:`.service`: ``DataService``, the coordinator (spawn, collect,
  heartbeat monitoring, respawn, stats; torch-free).
- :mod:`.net`: the network tier (torch-free): ``BatchServer`` streams a
  DataService's slots over TCP, ``NetDataService`` collects from N such
  servers; :mod:`.server_main` is the server's entry point.
- :mod:`.iter`: ``DataServiceIter``, the ``DataIter`` over either
  service (torch tensors).

Through the iterators: ``ImageRecordIter(..., data_service=True)`` (or
``MXTPU_DATA_WORKERS=N``) routes through the local service,
``data_service='host:port,host:port'`` (or ``MXTPU_DATA_SERVERS``)
through the network tier, and ``device_augment=`` moves crop, mirror and
normalization onto the device (``kernels/augment.py``).

This file stays torch-free: decode workers and the server import the
package through a stub that runs it.
"""
from __future__ import annotations

from ..base import register_env
from . import common  # noqa: F401
from .common import chunk_seed  # noqa: F401

__all__ = ["DataService", "DataServiceIter", "NetDataService",
           "BatchServer", "chunk_seed"]

# registered here, eagerly, as the JAX package registers them: the env
# registry must know every knob before anything reads it
ENV_DATA_RING_SLOTS = register_env(
    "MXTPU_DATA_RING_SLOTS", default=4,
    doc="Shared-memory ring slots per data-service worker (one slot = "
        "one padded batch)")
ENV_DATA_SLOT_BYTES = register_env(
    "MXTPU_DATA_SLOT_BYTES", default=0,
    doc="Override (grow) the per-slot data-region bytes; 0 derives "
        "batch_size x prod(data_shape) x itemsize")
ENV_DATA_HEARTBEAT = register_env(
    "MXTPU_DATA_HEARTBEAT_S", default=30.0,
    doc="Seconds without a data-service worker heartbeat before the "
        "collector declares it hung and respawns it")
ENV_DATA_NET_TIMEOUT = register_env(
    "MXTPU_DATA_NET_TIMEOUT_S", default=30.0,
    doc="Seconds without any frame (batches or heartbeats) from a data "
        "server before the consumer evicts the connection and "
        "reconnects (resume is exactly-once at the last consumed "
        "batch)")
ENV_DATA_NET_RETRIES = register_env(
    "MXTPU_DATA_NET_RETRIES", default=10,
    doc="Consecutive reconnect attempts per data server before the "
        "network-tier consumer gives up (the streak resets on every "
        "delivered batch)")
ENV_DATA_NET_RECONNECT = register_env(
    "MXTPU_DATA_NET_RECONNECT_S", default=0.5,
    doc="Delay between data-server reconnect attempts (the remote "
        "host's supervisor needs time to respawn a killed server)")
ENV_DATA_NET_FRAME_BYTES = register_env(
    "MXTPU_DATA_NET_FRAME_BYTES", default=1 << 30,
    doc="Upper bound on one network-tier frame payload; a header "
        "announcing more is treated as a torn frame and the connection "
        "is re-established")


def __getattr__(name):
    # service/net/iter load lazily: importing the package for `common`
    # stays cheap, and iter (which imports torch) loads only when asked
    if name == "DataService":
        from .service import DataService
        return DataService
    if name == "DataServiceIter":
        from .iter import DataServiceIter
        return DataServiceIter
    if name in ("NetDataService", "BatchServer"):
        from . import net
        return getattr(net, name)
    raise AttributeError(name)
