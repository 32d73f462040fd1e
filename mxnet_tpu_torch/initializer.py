"""Weight initializers (port of ``mxnet_tpu/initializer.py``).

The name dispatch of :meth:`Initializer.__call__` is the JAX package's
(:37-126): ``*_bias`` -> 0, ``*_gamma`` -> 1, ``*_beta`` -> 0,
``*_moving_mean`` -> 0, ``*_moving_var`` -> 1, ``*_weight`` ->
``_init_weight``, and an ``__init__`` attr on an :class:`InitDesc`
overrides it.  Random draws come from the package's seeded
``torch.Generator`` for the array's device (:mod:`random`); they are not
the JAX package's numbers.
"""
from __future__ import annotations

import json
import logging
import re

import numpy as np
import torch

from .base import MXNetError, Registry
from .ndarray import NDArray, zeros as nd_zeros
from . import random as _random

__all__ = ["Initializer", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "One", "Zero", "Constant", "Load", "Mixed",
           "LSTMBias", "FusedRNN", "InitDesc", "register"]

init_registry = Registry("initializer")
register = init_registry.register


class InitDesc(str):
    """Name + attrs descriptor (later-reference compat)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer(object):
    """Base initializer: dispatch on parameter name (reference
    initializer.py:Initializer.__call__)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, name, arr):
        if not isinstance(name, str):
            raise TypeError("name must be a string")
        if not isinstance(arr, NDArray):
            raise TypeError("arr must be NDArray")
        if isinstance(name, InitDesc) and name.attrs.get("__init__"):
            klass, kwargs = json.loads(name.attrs["__init__"])
            init_registry.create(klass, **kwargs)._init_weight(name, arr)
            return
        if name.startswith("upsampling"):
            self._init_bilinear(name, arr)
        elif name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("parameters"):
            self._init_rnn_parameters(name, arr)
        elif "init_h" in name or "init_c" in name or "begin_state" in name:
            self._init_zero(name, arr)
        elif name.endswith("moving_mean"):
            self._init_zero(name, arr)
        elif name.endswith("moving_var"):
            self._init_one(name, arr)
        elif name.endswith("moving_inv_var"):
            self._init_zero(name, arr)
        elif name.endswith("moving_avg"):
            self._init_zero(name, arr)
        else:
            self._init_default(name, arr)

    def _init_bilinear(self, _, arr):
        shape = arr.shape
        weight = np.zeros(int(np.prod(shape)), dtype="float32")
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[:] = weight.reshape(shape)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_gamma(self, _, arr):
        arr[:] = 1.0

    def _init_beta(self, _, arr):
        arr[:] = 0.0

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")

    def _init_rnn_parameters(self, name, arr):
        """Fused-RNN packed 1-D parameter vectors: the subclass's weight
        rule where it takes vectors, else the classic small-uniform RNN
        init."""
        try:
            self._init_weight(name, arr)
        except ValueError:
            _random.uniform(-0.07, 0.07, out=arr)

    def _init_default(self, name, _):
        raise ValueError(
            "Unknown initialization pattern for %s. Default initialization "
            "is now limited to \"weight\", \"bias\", \"gamma\" (1.0), and "
            "\"beta\" (0.0)." % name)


@register
class Load(object):
    """Initialize from a dict of arrays, fall back to ``default_init``
    (reference initializer.py:Load)."""

    def __init__(self, param, default_init=None, verbose=False):
        qualified = {}
        for name, arr in param.items():
            if name.startswith("arg:") or name.startswith("aux:"):
                qualified[name[4:]] = arr
            else:
                qualified[name] = arr
        self.param = qualified
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            if tuple(arr.shape) != tuple(self.param[name].shape):
                raise MXNetError(
                    "Parameter %s cannot be initialized from loading. "
                    "Shape mismatch, target %s vs loaded %s"
                    % (name, arr.shape, self.param[name].shape))
            arr[:] = self.param[name]
            if self.verbose:
                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise MXNetError(
                    "Cannot Initialize %s. Not found in loaded param and no "
                    "default Initializer is provided." % name)
            self.default_init(name, arr)


@register
class Mixed(object):
    """Pattern-dispatched mix of initializers (reference initializer.py:Mixed)."""

    def __init__(self, patterns, initializers):
        assert len(patterns) == len(initializers)
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError("Parameter name %s did not match any pattern" % name)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    """U(-scale, scale) (reference initializer.py:Uniform)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        _random.uniform(-self.scale, self.scale, out=arr)


@register
class Normal(Initializer):
    """N(0, sigma) (reference initializer.py:Normal)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        _random.normal(0, self.sigma, out=arr)


@register
class Orthogonal(Initializer):
    """An orthogonal matrix times ``scale`` (reference
    initializer.py:Orthogonal): the singular vectors of a (nout, nin)
    draw, uniform on [-1, 1] or standard normal.  The draw comes from
    the package's seeded host generator (:mod:`random`), in float64; the
    JAX package draws from numpy's global stream, so the two packages
    agree on the properties (orthogonal rows or columns of norm
    ``scale``), not on the values."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        gen = _random.generator(torch.device("cpu"))
        if self.rand_type == "uniform":
            tmp = torch.rand((nout, nin), generator=gen,
                             dtype=torch.float64) * 2.0 - 1.0
        else:
            tmp = torch.randn((nout, nin), generator=gen,
                              dtype=torch.float64)
        tmp = tmp.numpy()
        u, _v, q = np.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == tmp.shape else q
        arr[:] = (self.scale * res).reshape(arr.shape)


@register
class Xavier(Initializer):
    """Xavier/Glorot (reference initializer.py:Xavier)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = 1.0
        if len(shape) < 2:
            raise ValueError(
                "Xavier initializer cannot be applied to vector %s. It requires"
                " at least 2D." % name)
        if len(shape) > 2:
            hw_scale = np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = 1.0
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = np.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _random.uniform(-scale, scale, out=arr)
        elif self.rnd_type == "gaussian":
            _random.normal(0, scale, out=arr)
        else:
            raise ValueError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """MSRA/He init (reference initializer.py:MSRAPrelu)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """Bilinear upsampling weights for a deconvolution (reference
    initializer.py:Bilinear)."""

    def _init_weight(self, name, arr):
        self._init_bilinear(name, arr)


@register
class LSTMBias(Initializer):
    """Initialize LSTM stacked bias [i,f,c,o] with the forget gate set to
    ``forget_bias`` and the rest zero (reference initializer.py LSTMBias;
    ``rnn.LSTMCell``'s ``i2h_bias`` names it in its ``__init__`` attr)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        arr[:] = 0.0
        num_hidden = int(arr.shape[0] / 4)
        arr[num_hidden:2 * num_hidden] = self.forget_bias

    _init_bias = _init_weight


class FusedRNN(Initializer):
    """Initialize fused-RNN packed parameter vectors by unpacking into
    per-layer gate matrices, applying an inner initializer, and re-packing
    (reference initializer.py FusedRNN; the JAX package's :317-)."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        super().__init__()
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_rnn_parameters(self, name, arr):
        self._init_weight(name, arr)

    def _init_weight(self, name, arr):
        from .ops.nn import _RNN_GATES
        gates = _RNN_GATES[self._mode]
        dirs = 2 if self._bidirectional else 1
        h = self._num_hidden
        flat = np.zeros(arr.size, dtype="float32")
        # solve input size from total (see rnn_param_size)
        rest = arr.size - (self._num_layers - 1) * dirs * gates * h * \
            (dirs * h + h + 2)
        in_size = rest // (dirs * gates * h) - h - 2
        p = 0
        for layer in range(self._num_layers):
            li = in_size if layer == 0 else h * dirs
            for _d in range(dirs):
                for kind_cols in (li, h):
                    w = nd_zeros((gates * h, kind_cols), ctx=arr.context)
                    self._init("weight", w)
                    flat[p:p + w.size] = w.asnumpy().reshape(-1)
                    p += w.size
        for layer in range(self._num_layers):
            for _d in range(dirs):
                for _kind in range(2):
                    b = nd_zeros((gates * h,), ctx=arr.context)
                    if self._mode == "lstm":
                        LSTMBias(self._forget_bias)._init_bias("bias", b)
                    flat[p:p + b.size] = b.asnumpy().reshape(-1)
                    p += b.size
        arr[:] = flat
