"""Base utilities: the error type, the env-knob registry, attr parsing.

PyTorch port of ``mxnet_tpu/base.py`` (its own copy: the port imports
nothing of the JAX package).  ``MXNetError`` mirrors the reference's
python/mxnet/base.py:35; ``get_env`` mirrors dmlc::GetEnv.
"""
from __future__ import annotations

import ast
import logging
import os
from collections import namedtuple

__all__ = ["MXNetError", "get_env", "register_env", "ENV_REGISTRY",
           "parse_attr_value", "attr_to_string", "Registry",
           "ENV_FUSED_KERNELS", "ENV_STEP_GUARD", "ENV_MAX_BAD_STEPS",
           "ENV_COMPILE_CACHE"]

_LOG = logging.getLogger(__name__)


class MXNetError(Exception):
    """Framework error type (name kept for API parity with the reference)."""


_TRUE_STRINGS = frozenset(("1", "true", "yes", "on"))
_FALSE_STRINGS = frozenset(("0", "false", "no", "off"))


class EnvSpec(namedtuple("EnvSpec", ["name", "default", "doc", "scope"])):
    """One registered runtime knob."""


#: every ``MXTPU_*``/``MXNET_*`` knob this package reads
ENV_REGISTRY = {}


def register_env(name, default=None, doc="", scope="runtime"):
    """Register one env knob; returns ``name`` so call sites can write
    ``ENV_FOO = register_env("MXTPU_FOO", ...)``.  A ``get_env`` call that
    passes its own default wins over the one registered here."""
    ENV_REGISTRY[name] = EnvSpec(name, default, doc, scope)
    return name


_WARNED_UNREGISTERED = set()


def get_env(name, default=None, typ=None):
    """Read a runtime config env var (dmlc::GetEnv analog).  A
    framework-prefixed name missing from :data:`ENV_REGISTRY` warns once:
    a typo'd knob silently reading its default is what the registry is
    for."""
    if name.startswith(("MXTPU_", "MXNET_")) and name not in ENV_REGISTRY \
            and name not in _WARNED_UNREGISTERED:
        _WARNED_UNREGISTERED.add(name)
        _LOG.warning("env var %s is not registered in base.ENV_REGISTRY", name)
    if default is None and name in ENV_REGISTRY:
        default = ENV_REGISTRY[name].default
    raw = os.environ.get(name)
    if raw is None:
        return default
    if typ is None and default is not None:
        typ = type(default)
    if typ is bool:
        low = raw.strip().lower()
        if low in _TRUE_STRINGS:
            return True
        if low in _FALSE_STRINGS:
            return False
        raise MXNetError("Invalid boolean env var %s=%r" % (name, raw))
    if typ is not None:
        return typ(raw)
    return raw


class Registry(object):
    """Generic name -> object registry (dmlc registry analog), used for
    optimizers and initializers (``mxnet_tpu/base.py:158``)."""

    def __init__(self, kind):
        self._kind = kind
        self._entries = {}

    def register(self, obj=None, name=None, aliases=()):
        def _do(o):
            key = (name or o.__name__).lower()
            self._entries[key] = o
            for a in aliases:
                self._entries[a.lower()] = o
            return o
        if obj is None:
            return _do
        return _do(obj)

    def get(self, name):
        key = name.lower()
        if key not in self._entries:
            raise MXNetError(
                "Cannot find %s %r. Registered: %s"
                % (self._kind, name, sorted(self._entries)))
        return self._entries[key]

    def list(self):
        return sorted(self._entries)

    def create(self, name, *args, **kwargs):
        return self.get(name)(*args, **kwargs)


def parse_attr_value(value):
    """Parse a string attribute into a Python value: ``"(2, 2)"`` ->
    (2, 2), ``"1"`` -> 1, ``"True"`` -> True, ``"relu"`` -> "relu"."""
    if not isinstance(value, str):
        return value
    s = value.strip()
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        low = s.lower()
        if low in _TRUE_STRINGS and s.isalpha():
            return True
        if low in _FALSE_STRINGS and s.isalpha():
            return False
        return s


def attr_to_string(value):
    """Serialize an attr value to the string form used in symbol JSON."""
    if isinstance(value, str):
        return value
    if isinstance(value, bool):
        return "True" if value else "False"
    if isinstance(value, (list, tuple)):
        return "(" + ", ".join(attr_to_string(v) for v in value) + \
            (",)" if len(value) == 1 else ")")
    return str(value)


#: the same knob name as the JAX package, so one setting toggles both
ENV_FUSED_KERNELS = register_env(
    "MXTPU_FUSED_KERNELS", default="1",
    doc="Fused-kernel + plan-optimizer routing: 1 = everything on "
        "(default), 0 = exact pre-fusion graphs, or a comma list of "
        "kernel names (kernels.KNOWN_KERNELS) to enable individually")

#: the JAX package's step-guard knobs (``mxnet_tpu/resilience.py:94-99``)
ENV_MAX_BAD_STEPS = register_env(
    "MXTPU_MAX_BAD_STEPS", default=10,
    doc="Consecutive guard-skipped steps before the divergence abort")
ENV_STEP_GUARD = register_env(
    "MXTPU_STEP_GUARD", default=1,
    doc="0 disables the in-step NaN/Inf gradient guard")

#: the JAX package's cache knob (``mxnet_tpu/base.py:219``).  The port has
#: no compiled forward to cache yet; the serving daemon reads it for the
#: location of its AOT store (``serving/aot.py``)
ENV_COMPILE_CACHE = register_env(
    "MXTPU_COMPILE_CACHE",
    doc="Directory of the compile cache; the serving daemon keeps its AOT "
        "store under <dir>/aot")
