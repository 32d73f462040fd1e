"""Imperative autograd — differentiation of NDArray code (port of
``mxnet_tpu/autograd.py``; reference python/mxnet/contrib/autograd.py and
src/ndarray/autograd.cc).

The JAX package records every imperative op on a tape and replays the tape
through ``jax.vjp``.  Here torch's own graph is the tape: inside a
``train_section`` imperative ops run with torch's grad mode on
(``ndarray._RECORDING``), every marked NDArray's tensor is replaced by a
leaf that requires grad, and :func:`backward` calls
``torch.autograd.grad`` on the outputs with respect to those leaves.
Writes into an array while recording (``__setitem__``, ``copyto``,
``out=``, the in-place operators) swap in a new tensor rather than writing
into one the graph saved.

The JAX package's semantics, and how they hold here:

- A leaf is linearized at its value when recording reaches it: the leaf is
  the marked array's tensor when the section starts (or when it is marked
  inside one); a later in-place operator swaps in a new tensor computed
  from the leaf, so the gradient is still taken at the leaf's value.
- Only the marked arrays the outputs depend on get a gradient; a stale mark
  from an earlier backward keeps its holder as it was.
- ``grad_req`` ``write`` replaces the holder's tensor, ``add`` adds to it,
  ``null`` leaves it.
- A random op's gradient uses the mask it drew (torch saves it).
- ``retain_graph=False`` frees the graph: a second backward through it
  raises.
- Head gradients are cast to each output's dtype.
- Sections nest, also a train section inside a test section; only the
  outermost exit ends recording, turning every leaf back into a plain
  tensor (the same storage).

Outside a section, imperative ops run with grad mode off for inputs that
still require grad, so a leaf or a recorded result never makes a later op
build a graph, and the executor and trainer, which set torch's grad mode
themselves, never see a section's mode.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from . import ndarray as _nd
from .base import MXNetError
from .ndarray import NDArray

__all__ = [
    "set_is_training", "train_section", "test_section", "mark_variables",
    "unmark_variables", "backward", "compute_gradient", "grad_and_loss",
    "grad", "is_recording", "is_training",
]


class _Mark(object):
    __slots__ = ("var", "grad", "req", "leaf")

    def __init__(self, var, grad, req, leaf=None):
        self.var = var
        self.grad = grad
        self.req = req
        self.leaf = leaf      # the var's tensor as a leaf while recording


class _AutogradState(object):
    def __init__(self):
        self.recording = False
        self.training = False
        self.depth = 0          # train_section nesting
        self.grad_mode = None   # torch's grad mode before recording began
        self.marked = {}        # id(NDArray) -> _Mark


_STATE = _AutogradState()


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def _make_leaf(mark):
    if mark.leaf is None:
        mark.leaf = mark.var._data.detach().requires_grad_(True)
        mark.var._data = mark.leaf


def _drop_leaf(mark):
    if mark.leaf is not None:
        if mark.var._data is mark.leaf:
            mark.var._data = mark.leaf.detach()
        mark.leaf = None


def _set_recording(on, training):
    _STATE.recording = on
    _STATE.training = training
    _nd._RECORDING[0] = on


def set_is_training(is_train):
    """Turn recording on or off; returns the previous state (reference
    MXAutogradSetIsTraining, contrib/autograd.py:22-36).  Turning it off
    ends the recording: every leaf goes back to a plain tensor."""
    prev = _STATE.recording
    if prev == bool(is_train):
        return prev
    if is_train:
        if _STATE.grad_mode is None:
            _STATE.grad_mode = torch.is_grad_enabled()
        torch.set_grad_enabled(True)
        _set_recording(True, True)
        _nd._TRAIN_MODE[0] = True
        for mark in _STATE.marked.values():
            _make_leaf(mark)
    else:
        _set_recording(False, False)
        _nd._TRAIN_MODE[0] = None
        for mark in _STATE.marked.values():
            _drop_leaf(mark)
        if _STATE.grad_mode is not None:
            torch.set_grad_enabled(_STATE.grad_mode)
            _STATE.grad_mode = None
    return prev


@contextlib.contextmanager
def train_section():
    """Scope in which imperative ops are recorded for gradient computation
    (reference contrib/autograd.py train_section).  Nested sections, even
    across a test_section, share one recording; only the outermost exit
    ends it."""
    _STATE.depth += 1
    prev = set_is_training(True)
    try:
        yield
    finally:
        _STATE.depth -= 1
        if _STATE.depth == 0 and not prev:
            set_is_training(False)


@contextlib.contextmanager
def test_section():
    """Scope that pauses recording inside a train_section: ops run in
    inference mode and build no graph."""
    prev = (_STATE.recording, _STATE.training, _nd._TRAIN_MODE[0])
    _set_recording(False, False)
    _nd._TRAIN_MODE[0] = False
    try:
        with torch.no_grad():
            yield
    finally:
        _set_recording(prev[0], prev[1])
        _nd._TRAIN_MODE[0] = prev[2]


def mark_variables(variables, gradients, grad_reqs="write"):
    """Declare NDArrays as differentiation leaves with paired gradient
    holders (reference AutogradRuntime::MarkVariables,
    autograd.cc:35-50)."""
    if isinstance(variables, NDArray):
        variables = [variables]
        gradients = [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    if not (len(variables) == len(gradients) == len(grad_reqs)):
        raise MXNetError("variables/gradients/grad_reqs length mismatch")
    for var, g, req in zip(variables, gradients, grad_reqs):
        if not isinstance(var, NDArray) or not isinstance(g, NDArray):
            raise MXNetError("mark_variables expects NDArrays")
        old = _STATE.marked.get(id(var))
        mark = _Mark(var, g, req, old.leaf if old is not None else None)
        _STATE.marked[id(var)] = mark
        if _STATE.recording:
            _make_leaf(mark)


def unmark_variables(variables):
    """Remove marks set by mark_variables."""
    if isinstance(variables, NDArray):
        variables = [variables]
    for var in variables:
        mark = _STATE.marked.pop(id(var), None)
        if mark is not None:
            _drop_leaf(mark)


def backward(outputs, out_grads=None, retain_graph=False):
    """Compute gradients of ``outputs`` with respect to the marked
    variables they depend on and write or add them into the paired
    holders (reference MXAutogradBackward / ComputeGradient,
    autograd.cc:65-215)."""
    if isinstance(outputs, NDArray):
        outputs = [outputs]
    if not _STATE.marked:
        raise MXNetError("no variables marked — call mark_variables first")
    if _STATE.depth == 0 and not _STATE.recording:
        raise MXNetError("autograd tape is empty — record inside "
                         "train_section()")
    outs = [o._data for o in outputs]
    if out_grads is None:
        heads = [torch.ones_like(o) for o in outs]
    else:
        if isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        if len(out_grads) != len(outs):
            raise MXNetError("backward: %d head gradients for %d outputs"
                             % (len(out_grads), len(outs)))
        # cast to each output's dtype (a float32 head on a bfloat16
        # output), and onto its device
        heads = [(g._data if isinstance(g, NDArray) else
                  torch.as_tensor(np.asarray(g))).to(o.device, o.dtype)
                 for g, o in zip(out_grads, outs)]
    pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
    if not pairs:
        raise MXNetError("autograd tape is empty — no output was recorded "
                         "from a marked variable inside train_section()")
    active = [m for m in _STATE.marked.values() if m.leaf is not None]
    if not active:
        raise MXNetError("no marked variable is used by the recorded tape")
    with torch.enable_grad():
        grads = torch.autograd.grad(
            [o for o, _ in pairs], [m.leaf for m in active],
            [h for _, h in pairs], retain_graph=retain_graph,
            allow_unused=True)
    if all(g is None for g in grads):
        raise MXNetError("no marked variable is used by the recorded tape")
    for mark, g in zip(active, grads):
        if g is None or mark.req == "null":
            continue
        holder = mark.grad
        g = g.to(holder._data.device, holder._data.dtype)
        if mark.req == "add":
            holder._data = holder._data.detach() + g
        else:
            holder._data = g


def compute_gradient(outputs):
    """Reference contrib/autograd.py compute_gradient: ones head
    gradients."""
    backward(outputs)


def grad_and_loss(func, argnum=None):
    """Decorator returning (gradients, loss) of ``func`` with respect to
    its NDArray arguments (reference contrib/autograd.py:60-97)."""
    @functools.wraps(func)
    def wrapped(*args):
        variables = list(args)
        if argnum is not None:
            argnums = [argnum] if isinstance(argnum, int) else list(argnum)
            variables = [args[i] for i in argnums]
        for v in variables:
            if not isinstance(v, NDArray):
                raise MXNetError("grad_and_loss arguments must be NDArrays")
        grads = [_nd.zeros(v.shape, ctx=v.context, dtype=v._data.dtype)
                 for v in variables]
        try:
            with train_section():
                mark_variables(variables, grads)
                outputs = func(*args)
                outs = [outputs] if isinstance(outputs, NDArray) \
                    else list(outputs)
                compute_gradient(outs)
        finally:
            unmark_variables(variables)
        for o in outs:      # the loss leaves without its graph
            o._data = o._data.detach()
        return grads, outputs
    return wrapped


def grad(func, argnum=None):
    """Decorator returning only the gradients (reference
    contrib/autograd.py:100-120)."""
    grad_with_loss_func = grad_and_loss(func, argnum)

    @functools.wraps(grad_with_loss_func)
    def wrapped(*args):
        return grad_with_loss_func(*args)[0]
    return wrapped
