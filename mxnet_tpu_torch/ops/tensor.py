"""Tensor ops (port of ``mxnet_tpu/ops/tensor.py`` :57, :246, :453,
:702-745): ``elemwise_add``, ``identity``, ``Flatten`` and the optimizer
update ops ``sgd_update``, ``sgd_mom_update``, ``adam_update``,
``rmsprop_update``, ``rmspropalex_update`` (:746) — the rules of the reference's
src/operator/tensor/optimizer_op.cc, in the JAX package's op order.  The
update ops return new tensors; callers that keep state assign them."""
from __future__ import annotations

import torch

from .registry import register


@register("elemwise_add", input_names=("lhs", "rhs"),
          aliases=("_add", "_plus", "_Plus"))
def elemwise_add(lhs, rhs):
    return torch.add(lhs, rhs)


@register("identity", aliases=("_copy", "_identity_with_attr_like_rhs"))
def identity(data):
    return data


@register("Flatten", aliases=("flatten",))
def flatten(data):
    return torch.reshape(data, (data.shape[0], -1))


# ---------------------------------------------------------------------------
# optimizer update ops — optimizer_op.cc:18-73 (the dist-server update path)
# ---------------------------------------------------------------------------

def _apply_wd_clip(weight, grad, rescale_grad, clip_gradient, wd):
    grad = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        grad = torch.clamp(grad, -clip_gradient, clip_gradient)
    return grad + wd * weight


@register("sgd_update", input_names=("weight", "grad"))
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    g = _apply_wd_clip(weight, grad, rescale_grad, clip_gradient, wd)
    return weight - lr * g


@register("sgd_mom_update", input_names=("weight", "grad", "mom"),
          num_outputs=2)
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd_clip(weight, grad, rescale_grad, clip_gradient, wd)
    mom = momentum * mom - lr * g
    return weight + mom, mom


@register("adam_update", input_names=("weight", "grad", "mean", "var"),
          num_outputs=3)
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd_clip(weight, grad, rescale_grad, clip_gradient, wd)
    mean = beta1 * mean + (1.0 - beta1) * g
    var = beta2 * var + (1.0 - beta2) * torch.square(g)
    weight = weight - lr * mean / (torch.sqrt(var) + epsilon)
    return weight, mean, var


@register("rmsprop_update", input_names=("weight", "grad", "n"),
          num_outputs=2)
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _apply_wd_clip(weight, grad, rescale_grad, clip_gradient, wd)
    n = gamma1 * n + (1.0 - gamma1) * torch.square(g)
    weight = weight - lr * g / torch.sqrt(n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        weight = torch.clamp(weight, -clip_weights, clip_weights)
    return weight, n


@register("rmspropalex_update", input_names=("weight", "grad", "n", "g",
                                             "delta"),
          num_outputs=4)
def rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    gr = _apply_wd_clip(weight, grad, rescale_grad, clip_gradient, wd)
    n = gamma1 * n + (1.0 - gamma1) * torch.square(gr)
    g = gamma1 * g + (1.0 - gamma1) * gr
    delta = gamma2 * delta - lr * gr / torch.sqrt(n - torch.square(g)
                                                  + epsilon)
    weight = weight + delta
    if clip_weights is not None and clip_weights > 0:
        weight = torch.clamp(weight, -clip_weights, clip_weights)
    return weight, n, g, delta
