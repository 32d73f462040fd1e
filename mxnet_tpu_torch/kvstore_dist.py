"""Distributed KVStore over the process group (port of
``mxnet_tpu/kvstore_dist.py``).

The reference's ps-lite parameter-server column (kvstore_dist.h worker,
kvstore_dist_server.h server) becomes one collective: gradients pushed on
every worker are summed across processes and the optimizer ("the updater
on the server") runs locally on the sum, identically on every worker —
the reference's ``dist_sync`` protocol (the servers aggregate all
NumWorkers pushes, apply the updater once, broadcast).  Workers are
launched with ``tools/launch.py`` and join through
:func:`distributed.initialize`; ``dist_async`` has no collective analog
and raises, as in the JAX package.
"""
from __future__ import annotations

from . import distributed
from .base import MXNetError
from .kvstore import KVStore, _key_value, _updater_key

__all__ = ["KVStoreTPU"]


class KVStoreTPU(KVStore):
    """kvstore for 'tpu' / 'dist_sync' / 'dist_device_sync'."""

    def __init__(self, kind="tpu"):
        if "async" in kind:
            raise MXNetError(
                "dist_async has no collective analog (no parameter server); "
                "use 'tpu' / 'dist_sync'")
        super().__init__(kind)
        distributed.initialize()  # no-op unless launched by tools/launch.py
        distributed.start_heartbeat()  # liveness stamps for dead nodes
        self._coll = None

    def get_num_dead_node(self, node_id=-1, timeout=60):
        """Workers with stale liveness stamps (the reference's ps-lite
        heartbeat query, kvstore_dist.h:158-167); collectives stay
        all-or-nothing, this is the monitoring side."""
        return distributed.num_dead_nodes(node_id=node_id, timeout=timeout)

    @property
    def _collective(self):
        if self._coll is None:
            self._coll = distributed.Collective()
        return self._coll

    @property
    def rank(self):
        return distributed.rank()

    @property
    def num_workers(self):
        return distributed.num_workers()

    def init(self, key, value):
        """Init, then broadcast rank 0's value so all workers start
        identical (the reference's init push lands on the servers once
        and every worker pulls the same bytes)."""
        super().init(key, value)
        if self.num_workers > 1:
            keys, _ = _key_value(key, value)
            for k in keys:
                stored = self._store[k]
                stored._data = self._collective.broadcast(
                    stored._data).to(stored._data.device)

    def push(self, key, value, priority=0):
        """Sum the local copies, then across workers; with an updater set,
        run it on the sum."""
        keys, vals = _key_value(key, value)
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                raise MXNetError("key %r not initialized" % (k,))
            store_ctx = self._store[k].context
            merged = vlist[0].as_in_context(store_ctx).copy()
            for v in vlist[1:]:
                merged._data = merged._data + \
                    v.as_in_context(store_ctx)._data
            if self.num_workers > 1:
                merged._data = self._collective.allreduce_sum(merged._data)
            if self._updater is not None:
                self._updater(_updater_key(k), merged, self._store[k])
            else:
                self._store[k]._data = merged._data

    def barrier(self):
        distributed.barrier("kvstore_barrier")

    _barrier = barrier
