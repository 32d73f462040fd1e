"""Automatic symbol naming (port of ``mxnet_tpu/name.py``; reference
python/mxnet/name.py).  Auto-names (``pooling0``, ``flatten0``) must match
the JAX package's so both build identical graph JSON."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]


class NameManager(object):
    """Assigns default names to symbols (NameManager, name.py:8-60)."""

    _state = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old_manager = current()
        NameManager._state.current = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._state.current = self._old_manager


class Prefix(NameManager):
    """Prepends a prefix to every name it gives (name.py:63-78)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name


def current():
    if not hasattr(NameManager._state, "current"):
        NameManager._state.current = NameManager()
    return NameManager._state.current
