"""Random state: :func:`seed` and one seeded ``torch.Generator`` per
device (port of ``mxnet_tpu/random.py``: ``seed``, ``get_state``/
``set_state``, ``uniform``/``normal``/``randint``, ``next_key``/
``peek_key``).

The JAX package draws from one ``jax.random`` key chain; the port draws
from an explicit ``torch.Generator`` for each device, made on first use
and seeded from the last :func:`seed`.  ``uniform``/``normal`` (and
every imperative sampling op, ``mx.nd.uniform``/``_sample_*``) draw from
the generator of the context's device.  Graph forwards take an integer
seed each from :func:`next_seed` (the JAX package's ``next_key``), and a
node that draws gets a generator of its own from
:func:`node_generator` (``fold_in``).  :func:`get_state` snapshots all
of it (an opaque object) and :func:`set_state` restores it.  The two
packages give different numbers from the same seed: weights cross
between them as numpy arrays or ``.params`` files, never by matching
random streams.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["seed", "get_seed", "get_state", "set_state", "generator",
           "uniform", "normal", "randint", "next_seed", "peek_seed",
           "node_generator"]

_DEFAULT_SEED = 0
_seed_int = _DEFAULT_SEED
_generators = {}          # torch.device -> torch.Generator
_forwards = 0             # seeds handed out by next_seed since seed()
_lock = threading.Lock()
_MASK63 = (1 << 63) - 1


def seed(seed_state):
    """Seed every device's generator (parity: ``mx.random.seed``).  The
    generators restart from ``seed_state`` at their next use; numpy's own
    RNG is not touched."""
    if not isinstance(seed_state, (int, np.integer)):
        raise ValueError("seed must be an int")
    global _seed_int, _forwards
    with _lock:
        _seed_int = int(seed_state)
        _forwards = 0
        _generators.clear()


def get_seed():
    """The integer last passed to :func:`seed` (the default if never)."""
    return _seed_int


def generator(device):
    """This package's ``torch.Generator`` for ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _generators.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_seed_int)
            _generators[device] = gen
        return gen


def get_state():
    """A snapshot of the random state: the seed, the forwards seeded since,
    and every device generator's state.  Opaque; :func:`set_state` takes
    it back."""
    with _lock:
        return {"seed": _seed_int, "forwards": _forwards,
                "generators": {str(dev): gen.get_state()
                               for dev, gen in _generators.items()}}


def set_state(state):
    """Restore a :func:`get_state` snapshot."""
    global _seed_int, _forwards
    with _lock:
        _seed_int = int(state["seed"])
        _forwards = int(state["forwards"])
        _generators.clear()
        for name, gen_state in state["generators"].items():
            dev = torch.device(name)
            gen = torch.Generator(device=dev)
            gen.set_state(gen_state)
            _generators[dev] = gen


def _draw(op_name, attrs, shape, ctx, dtype, out):
    """Run the sampling op ``op_name``; with ``out`` its shape, context
    and dtype are taken and the values written into its storage."""
    from . import ndarray as nd
    from .ops.registry import get_op
    if out is not None:
        shape, ctx, dtype = out.shape, out.context, out._data.dtype
    attrs = dict(attrs, shape=tuple(shape) if not isinstance(shape, int)
                 else (shape,), dtype=dtype)
    res = nd._invoke(get_op(op_name), [], attrs, ctx=ctx)[0]
    if out is None:
        return res
    out._data.copy_(res._data)
    return out


def uniform(low=0, high=1, shape=(), ctx=None, dtype="float32", out=None):
    """U(low, high) into ``out`` (or a new NDArray on ``ctx``), through
    the ``_sample_uniform`` op."""
    return _draw("_sample_uniform", {"low": low, "high": high}, shape, ctx,
                 dtype, out)


def normal(loc=0, scale=1, shape=(), ctx=None, dtype="float32", out=None):
    """N(loc, scale) into ``out`` (or a new NDArray on ``ctx``), through
    the ``_sample_normal`` op."""
    return _draw("_sample_normal", {"loc": loc, "scale": scale}, shape, ctx,
                 dtype, out)


def randint(low, high, shape=(), ctx=None, dtype="int32"):
    """Integers uniform in [low, high) on ``ctx``."""
    from . import ndarray as nd
    from .context import current_context
    from .ops.tensor import torch_dtype
    ctx = ctx if ctx is not None else current_context()
    dev = ctx.torch_device
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    data = torch.randint(int(low), int(high), shape, generator=generator(dev),
                         device=dev, dtype=torch_dtype(dtype))
    return nd.NDArray._from_torch(data, ctx)


def _mix(a, b):
    """A 63-bit seed from two integers (splitmix64's finaliser over
    ``a * golden + b``), so neighbouring inputs give unrelated seeds."""
    z = (a * 0x9E3779B97F4A7C15 + b + 1) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK63


def next_seed():
    """The next forward's integer seed (the JAX package's ``next_key``):
    a stream that :func:`seed` restarts."""
    global _forwards
    with _lock:
        out = _mix(_seed_int, _forwards)
        _forwards += 1
    return out


def peek_seed():
    """The seed :func:`next_seed` would return, without taking it (the
    JAX package's ``peek_key``)."""
    with _lock:
        return _mix(_seed_int, _forwards)


def node_generator(seed_value, offset, device):
    """A ``torch.Generator`` on ``device`` for the node at plan position
    ``offset`` of a forward seeded ``seed_value`` (``fold_in``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix(int(seed_value), int(offset)))
    return gen
