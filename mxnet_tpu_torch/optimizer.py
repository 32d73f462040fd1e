"""Optimizers (port of ``mxnet_tpu/optimizer.py``: ``Optimizer``,
``create``/``register``, ``SGD``, ``NAG``, ``SGLD``, ``Adam``,
``AdaGrad``, ``RMSProp``, ``AdaDelta``, ``DCASGD``, ``Test``,
``Updater``).

SGD, Adam and RMSProp apply the registered update ops (``ops/tensor.py``
``sgd_update``/``sgd_mom_update``/``adam_update``/``rmsprop_update``/
``rmspropalex_update``), which ``SPMDTrainer`` also applies inside its
step; the other six are written, as in the JAX package
(``mxnet_tpu/optimizer.py:147-357``), in NDArray arithmetic
(``weight -= lr * g``, ``nd.clip``, ``nd.sqrt``, ``nd.normal``), run
through ``Module``'s executor routes, and are refused by ``SPMDTrainer``.
An update gives the weight's and the state's NDArrays new tensors (the
in-place operators swap the handle) or writes into them (``a[:] = v``).
"""
from __future__ import annotations

import math
import pickle

import numpy as np

from . import ndarray as nd
from .base import Registry
from .context import cpu
from .ndarray import NDArray, zeros
from .ops import tensor as T

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "RMSProp",
           "AdaDelta", "SGLD", "DCASGD", "Test", "Updater", "get_updater",
           "create", "register"]

opt_registry = Registry("optimizer")
register = opt_registry.register


class Optimizer(object):
    """Base optimizer (reference optimizer.py:Optimizer)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        if param_idx2name is None:
            param_idx2name = {}
        self.idx2name = param_idx2name.copy()
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    @staticmethod
    def create_optimizer(name, **kwargs):
        return opt_registry.create(name, **kwargs)

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "lr_mult" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["lr_mult"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            # zero decay for every name ending neither in _weight nor in
            # _gamma: biases and betas lose it, gammas KEEP it (the JAX
            # package's rule, mxnet_tpu/optimizer.py:79)
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "wd_mult" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["wd_mult"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _clip(self):
        return self.clip_gradient if self.clip_gradient is not None else -1.0


def create(name, **kwargs):
    return opt_registry.create(name, **kwargs)


def _assign(arrays, tensors):
    for arr, t in zip(arrays, tensors):
        arr._data = t


@register(aliases=("ccsgd",))
class SGD(Optimizer):
    """SGD with momentum (reference optimizer.py:279; update rule =
    sgd_update / sgd_mom_update ops)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, ctx=weight.context,
                     dtype=weight._data.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                      rescale_grad=self.rescale_grad,
                      clip_gradient=self._clip())
        if state is not None:
            _assign((weight, state), T.sgd_mom_update(
                weight._data, grad._data, state._data,
                momentum=self.momentum, **kwargs))
        else:
            weight._data = T.sgd_update(weight._data, grad._data, **kwargs)


@register
class NAG(SGD):
    """Nesterov accelerated SGD (reference optimizer.py:380)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.clip(grad, a_min=-self.clip_gradient,
                           a_max=self.clip_gradient)
        if state is not None:
            state *= self.momentum
            grad += wd * weight
            state += grad
            grad += self.momentum * state
            weight -= lr * grad
        else:
            weight -= lr * (grad + wd * weight)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference optimizer.py:416)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.clip(grad, a_min=-self.clip_gradient,
                           a_max=self.clip_gradient)
        noise = nd.normal(loc=0, scale=math.sqrt(lr), shape=weight.shape,
                          ctx=weight.context)
        weight += -lr / 2 * (grad + wd * weight) + noise


@register
class Adam(Optimizer):
    """Adam (reference optimizer.py:451; update = adam_update op with the
    reference's bias-corrected effective lr)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        dtype = weight._data.dtype
        return (zeros(weight.shape, ctx=weight.context, dtype=dtype),
                zeros(weight.shape, ctx=weight.context, dtype=dtype))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        lr *= math.sqrt(coef2) / coef1
        mean, var = state
        _assign((weight, mean, var), T.adam_update(
            weight._data, grad._data, mean._data, var._data, lr=lr,
            beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon, wd=wd,
            rescale_grad=self.rescale_grad, clip_gradient=self._clip()))


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference optimizer.py:499)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros(weight.shape, ctx=weight.context)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.clip(grad, a_min=-self.clip_gradient,
                           a_max=self.clip_gradient)
        state += grad * grad
        weight -= lr * (grad / nd.sqrt(state + self.float_stable_eps)
                        + wd * weight)


@register
class RMSProp(Optimizer):
    """RMSProp (reference optimizer.py:536; centered=True uses Graves'
    variant = rmspropalex_update, else rmsprop_update)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (zeros(weight.shape, ctx=weight.context),
                    zeros(weight.shape, ctx=weight.context),
                    zeros(weight.shape, ctx=weight.context))
        return (zeros(weight.shape, ctx=weight.context),)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                      rescale_grad=self.rescale_grad, gamma1=self.gamma1,
                      epsilon=self.epsilon, clip_gradient=self._clip(),
                      clip_weights=self.clip_weights if self.clip_weights
                      is not None else -1.0)
        if not self.centered:
            (n,) = state
            _assign((weight, n), T.rmsprop_update(
                weight._data, grad._data, n._data, **kwargs))
        else:
            n, g, delta = state
            _assign((weight, n, g, delta), T.rmspropalex_update(
                weight._data, grad._data, n._data, g._data, delta._data,
                gamma2=self.gamma2, **kwargs))


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference optimizer.py:605)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, ctx=weight.context),
                zeros(weight.shape, ctx=weight.context))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.clip(grad, a_min=-self.clip_gradient,
                           a_max=self.clip_gradient)
        acc_g, acc_delta = state
        acc_g[:] = self.rho * acc_g + (1.0 - self.rho) * grad * grad
        current_delta = nd.sqrt(acc_delta + self.epsilon) / \
            nd.sqrt(acc_g + self.epsilon) * grad
        acc_delta[:] = self.rho * acc_delta + \
            (1.0 - self.rho) * current_delta * current_delta
        weight[:] = weight - current_delta - wd * weight


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (reference optimizer.py:325)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (zeros(weight.shape, ctx=weight.context), weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.clip(grad, a_min=-self.clip_gradient,
                           a_max=self.clip_gradient)
        mom, previous_weight = state
        if mom is not None:
            mom[:] = self.momentum * mom - lr * (
                grad + wd * weight +
                self.lamda * grad * grad * (weight - previous_weight))
            weight += mom
        else:
            weight += -lr * (grad + wd * weight + self.lamda * grad * grad *
                             (weight - previous_weight))
        previous_weight[:] = weight


@register
class Test(Optimizer):
    """Test optimizer (reference optimizer.py:653): adds
    ``rescale_grad * g`` to the weight, as the reference's code does."""

    def create_state(self, index, weight):
        return zeros(weight.shape, ctx=weight.context)

    def update(self, index, weight, grad, state):
        weight += grad * self.rescale_grad
        state[:] = weight


class Updater(object):
    """Stateful per-key updater closure (reference optimizer.py:669
    get_updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self._unplaced = set()    # loaded states not yet on their weight's

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        elif index in self._unplaced:
            self.states[index] = _state_to_context(self.states[index],
                                                   weight.context)
            self._unplaced.discard(index)
        self.optimizer.update(index, weight, grad, self.states[index])

    def set_states(self, states):
        loaded = pickle.loads(states)
        if isinstance(loaded, dict) and "states" in loaded \
                and "num_update" in loaded:
            # a blob of the fused SPMDTrainer ({name: tuple}): convert to
            # this updater's {index: state}, every index of a name
            name2indices = {}
            for i, n in (getattr(self.optimizer, "idx2name", {}) or {}
                         ).items():
                name2indices.setdefault(n, []).append(i)
            self.optimizer.num_update = max(self.optimizer.num_update,
                                            loaded["num_update"])
            converted = {}
            for name, s in loaded["states"].items():
                val = None if len(s) == 0 else s[0] if len(s) == 1 \
                    else tuple(s)
                for key in name2indices.get(name, [name]):
                    converted[key] = val
            loaded = converted
        # each state goes where the one it replaces lives; one with no
        # predecessor waits on the host and moves to its weight's context
        # at its first update
        states = {}
        for k, v in loaded.items():
            ctx = _context_of(self.states.get(k))
            if ctx is None:
                self._unplaced.add(k)
            states[k] = _state_from_numpy(v, ctx if ctx is not None
                                          else cpu())
        self.states = states

    def get_states(self):
        return pickle.dumps({k: _state_to_numpy(v)
                             for k, v in self.states.items()})


def _state_to_numpy(v):
    if isinstance(v, NDArray):
        return v.asnumpy()
    if isinstance(v, (tuple, list)):
        return tuple(_state_to_numpy(x) for x in v)
    return v


def _context_of(state):
    if isinstance(state, NDArray):
        return state.context
    if isinstance(state, (tuple, list)):
        for s in state:
            if isinstance(s, NDArray):
                return s.context
    return None


def _state_to_context(v, ctx):
    if isinstance(v, NDArray):
        return v.as_in_context(ctx)
    if isinstance(v, (tuple, list)):
        return tuple(_state_to_context(x, ctx) for x in v)
    return v


def _state_from_numpy(v, ctx):
    if isinstance(v, np.ndarray):
        from .ndarray import array as nd_array
        return nd_array(v, ctx=ctx, dtype=v.dtype)
    if isinstance(v, (tuple, list)):
        return tuple(_state_from_numpy(x, ctx) for x in v)
    return v


def get_updater(optimizer):
    return Updater(optimizer)
