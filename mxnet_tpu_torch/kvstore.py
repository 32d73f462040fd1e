"""KVStore — parameter synchronization (port of
``mxnet_tpu/kvstore.py:26-175``).

``local``/``device`` aggregate gradients over the device copies of a key
and, with an optimizer set, update on the store (the reference's
kvstore_local.h).  ``tpu``, ``dist_sync`` and ``dist_device_sync`` make
the collective store across processes (``kvstore_dist.KVStoreTPU``; one
process is a world of one): a Module given ``tpu`` takes the fused
``SPMDTrainer`` step, ``dist_sync`` the executor route with the store.
"""
from __future__ import annotations

from .base import MXNetError
from .ndarray import NDArray
from . import optimizer as opt

__all__ = ["KVStore", "create"]


def _key_value(keys, vals):
    if isinstance(keys, (int, str)):
        if isinstance(vals, NDArray):
            return [keys], [[vals]]
        return [keys], [list(vals)]
    assert len(keys) == len(vals)
    out_keys, out_vals = [], []
    for k, v in zip(keys, vals):
        ks, vs = _key_value(k, v)
        out_keys += ks
        out_vals += vs
    return out_keys, out_vals


def _updater_key(k):
    return k if isinstance(k, int) else str(k)


class KVStore(object):
    """Single-process store (observable behaviour of
    src/kvstore/kvstore_local.h)."""

    def __init__(self, kind="local"):
        self._kind = kind
        self._store = {}
        self._updater = None
        self._optimizer = None

    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        keys, vals = _key_value(key, value)
        for k, vlist in zip(keys, vals):
            if k in self._store:
                raise MXNetError("key %r already initialized" % (k,))
            self._store[k] = vlist[0].copy()

    def push(self, key, value, priority=0):
        """Sum the values (device copies) into the store's context; with
        an updater set, run it on the merged gradient."""
        keys, vals = _key_value(key, value)
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                raise MXNetError("key %r not initialized" % (k,))
            store_ctx = self._store[k].context
            merged = vlist[0].as_in_context(store_ctx).copy()
            for v in vlist[1:]:
                merged._data = merged._data + \
                    v.as_in_context(store_ctx)._data
            if self._updater is not None:
                self._updater(_updater_key(k), merged, self._store[k])
            else:
                self._store[k]._data = merged._data

    def pull(self, key, out=None, priority=0):
        assert out is not None
        keys, outs = _key_value(key, out)
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %r not initialized" % (k,))
            src = self._store[k]
            for o in olist:
                o._data = src._data.to(o._data.device, o._data.dtype,
                                       copy=True)

    def set_optimizer(self, optimizer):
        """Install the optimizer as the store-side updater."""
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        """Install ``updater(key, grad, weight)`` as the store-side update
        (the reference's MXKVStoreSetUpdater)."""
        self._updater = updater

    def barrier(self):
        """A no-op in one process (reference KVStore::Barrier)."""

    _barrier = barrier

    def get_num_dead_node(self, node_id=-1, timeout=60):
        """0: a store in one process has no other node to lose (reference
        kvstore_dist.h:158-167)."""
        return 0

    @property
    def is_recovery(self):
        """False: a store in one process never rejoins a running cluster
        (reference ps::Postoffice::is_recovery)."""
        return False

    def get_optimizer_states(self):
        if self._updater is None:
            raise MXNetError("updater is not set")
        return self._updater.get_states()

    def set_optimizer_states(self, states):
        if self._updater is None:
            raise MXNetError("updater is not set")
        self._updater.set_states(states)

    def save_optimizer_states(self, fname):
        # temp + fsync + rename: a crash mid-save never tears an existing
        # optimizer-state file (the checkpoints' contract)
        from .resilience import atomic_write
        atomic_write(fname, self.get_optimizer_states())

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            self.set_optimizer_states(f.read())


def create(name="local"):
    """Factory (reference src/kvstore/kvstore.cc name dispatch):
    'local'/'device' give the in-process store; 'dist_sync',
    'dist_device_sync' and 'tpu' the collective store over the process
    group ('dist_async' raises)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if "dist" in name or name == "tpu":
        from .kvstore_dist import KVStoreTPU
        return KVStoreTPU(name)
    if name not in ("local", "device") and not name.startswith("local"):
        raise MXNetError("unknown kvstore type %r" % name)
    return KVStore(name)
