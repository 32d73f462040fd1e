"""Random state: :func:`seed` and one seeded ``torch.Generator`` per
device (port of ``mxnet_tpu/random.py``'s ``seed``/``uniform``/``normal``).

The JAX package draws from one ``jax.random`` key chain; the port draws
from an explicit ``torch.Generator`` for each device, made on first use
and seeded from the last :func:`seed`.  The two give different numbers
from the same seed: weights cross between the packages as numpy arrays
or ``.params`` files, never by matching random streams.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["seed", "get_seed", "generator", "uniform", "normal"]

_DEFAULT_SEED = 0
_seed_int = _DEFAULT_SEED
_generators = {}          # torch.device -> torch.Generator
_lock = threading.Lock()


def seed(seed_state):
    """Seed every device's generator (parity: ``mx.random.seed``).  The
    generators restart from ``seed_state`` at their next use; numpy's own
    RNG is not touched."""
    if not isinstance(seed_state, (int, np.integer)):
        raise ValueError("seed must be an int")
    global _seed_int
    with _lock:
        _seed_int = int(seed_state)
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


def _out(shape, ctx, dtype, out):
    if out is not None:
        return out
    from . import ndarray as nd
    return nd.empty(shape, ctx=ctx, dtype=dtype)


def uniform(low=0, high=1, shape=(), ctx=None, dtype="float32", out=None):
    """U(low, high) into ``out`` (or a new NDArray on ``ctx``)."""
    out = _out(shape, ctx, dtype, out)
    out._data.uniform_(low, high, generator=generator(out._data.device))
    return out


def normal(loc=0, scale=1, shape=(), ctx=None, dtype="float32", out=None):
    """N(loc, scale) into ``out`` (or a new NDArray on ``ctx``)."""
    out = _out(shape, ctx, dtype, out)
    out._data.normal_(loc, scale, generator=generator(out._data.device))
    return out
