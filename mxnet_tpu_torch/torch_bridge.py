"""Torch interoperability (port of ``mxnet_tpu/torch_bridge.py``; the
reference's plugin/torch and python/mxnet/torch.py).

The surface is the JAX package's: ``TorchModule`` puts a
``torch.nn.Module`` into a graph as a ``Custom`` node whose parameters are
MXNet arguments named ``<name>_torch_<param>``, ``TorchCriterion`` puts a
torch loss in as an output layer, and ``mx.th.<fn>`` calls a torch
function on NDArrays.

Where the JAX package runs torch on the host behind the Custom op's host
round trip, here the node runs on the node's own device, inside the
graph: ``TorchModule`` calls ``torch.func.functional_call`` of the user's
module with the node's argument tensors as its parameters, so autograd
flows into the MXNet arguments and the optimizers update them, and no
tensor leaves the card.  The module's buffers (BatchNorm's running
statistics) are moved to the node's device at the first call and updated
there by the module in training, as torch updates them; they are the
module's state, not MXNet aux states.  ``TorchCriterion`` computes the
loss and, in the backward, the loss's own gradient with respect to the
data, ignoring the head gradient (the loss-layer convention); a floating
label with one dimension fewer than the data is taken as class indices
(``torch.nn.CrossEntropyLoss`` wants integers).  ``mx.th`` runs on the
NDArray's device and returns an NDArray there.
"""
from __future__ import annotations

import torch

from . import operator as _op
from . import symbol as _sym
from .context import current_context
from .ndarray import NDArray

__all__ = ["TorchModule", "TorchCriterion", "th"]

_MODULE_REGISTRY = {}


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _infer_out_shape(tmod, in_shape):
    """The module's output shape for ``in_shape``, run on meta tensors
    (no data, no device)."""
    state = {n: _meta(t) for n, t in list(tmod.named_parameters()) +
             list(tmod.named_buffers())}
    out = torch.func.functional_call(
        tmod, state, (torch.empty(in_shape, device="meta"),))
    return tuple(out.shape)


class _TorchModuleProp(_op.CustomOpProp):
    def __init__(self, torch_key=None, **_):
        super().__init__(need_top_grad=True)
        self._tmod = _MODULE_REGISTRY[str(torch_key)]
        self._param_names = [n for n, _ in self._tmod.named_parameters()]

    def list_arguments(self):
        return ["data"] + ["torch_%s" % n.replace(".", "_")
                           for n in self._param_names]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        params = dict(self._tmod.named_parameters())
        p_shapes = [tuple(params[n].shape) for n in self._param_names]
        out = _infer_out_shape(self._tmod, tuple(in_shape[0]))
        return [tuple(in_shape[0])] + p_shapes, [out], []

    def _device_call(self, inputs, is_train):
        """The module on the node's device, under the caller's autograd."""
        x, params = inputs[0], inputs[1:]
        tmod = self._tmod
        if any(b.device != x.device for b in tmod.buffers()):
            tmod.to(x.device)
        was_training = tmod.training
        tmod.train(bool(is_train))
        try:
            out = torch.func.functional_call(
                tmod, dict(zip(self._param_names, params)), (x,))
        finally:
            tmod.train(was_training)
        return (out,)


_op.register("_TorchModule")(_TorchModuleProp)


def TorchModule(torch_module, data, name="torch"):
    """Wrap a ``torch.nn.Module`` as a symbol layer.

    The module's parameters appear as MXNet arguments named
    ``<name>_torch_<param>``, initialized, updated and checkpointed by
    MXNet like any other weight (reference plugin/torch/torch_module)::

        net = mx.torch_bridge.TorchModule(torch.nn.Linear(10, 4), data,
                                          name="tl")
    """
    key = "%s@%d" % (name, id(torch_module))
    _MODULE_REGISTRY[key] = torch_module
    return _sym.Custom(data, op_type="_TorchModule", torch_key=key,
                       name=name)


class _CriterionFn(torch.autograd.Function):
    """A torch loss as an output layer: the backward injects the loss's
    gradient with respect to the data and ignores the head gradient."""

    @staticmethod
    def forward(ctx, crit, x, label):
        with torch.enable_grad():
            leaf = x.detach().requires_grad_(True)
            if label.is_floating_point() and label.dim() == x.dim() - 1:
                label = label.long()      # class indices
            loss = crit(leaf, label)
        ctx.graph = (leaf, loss)
        return loss.detach().reshape(1)

    @staticmethod
    def backward(ctx, _head):
        leaf, loss = ctx.graph
        ctx.graph = None
        (gx,) = torch.autograd.grad(loss, [leaf])
        return None, gx, None


class _TorchCriterionProp(_op.CustomOpProp):
    def __init__(self, torch_key=None, **_):
        super().__init__(need_top_grad=False)
        self._crit = _MODULE_REGISTRY[str(torch_key)]

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["loss"]

    def infer_shape(self, in_shape):
        # the loss as shape (1,), like the reference criterion
        return [tuple(in_shape[0]), tuple(in_shape[1])], [(1,)], []

    def _device_call(self, inputs, is_train):
        return (_CriterionFn.apply(self._crit, inputs[0], inputs[1]),)


_op.register("_TorchCriterion")(_TorchCriterionProp)


def TorchCriterion(criterion, data, label, name="torchloss"):
    """Wrap a torch loss (e.g. ``torch.nn.MSELoss()``) as an output layer
    (reference plugin/torch/torch_criterion)."""
    key = "%s@%d" % (name, id(criterion))
    _MODULE_REGISTRY[key] = criterion
    return _sym.Custom(data, label, op_type="_TorchCriterion",
                       torch_key=key, name=name)


class _ThNamespace(object):
    """``mx.th.*``: torch functions on NDArrays, run on the arrays' own
    device; a tensor result comes back as an NDArray there."""

    def __getattr__(self, fname):
        fn = getattr(torch, fname, None)
        if fn is None:
            raise AttributeError("torch has no function %r" % fname)

        def call(*args, **kwargs):
            ctx = next((a.context for a in args if isinstance(a, NDArray)),
                       None)
            targs = [a._data if isinstance(a, NDArray) else a for a in args]
            out = fn(*targs, **kwargs)
            if isinstance(out, torch.Tensor):
                if ctx is None:
                    return NDArray(out, ctx=current_context())
                return NDArray._from_torch(out, ctx)
            return out
        call.__name__ = fname
        return call


th = _ThNamespace()
