"""Tensor ops (port of ``mxnet_tpu/ops/tensor.py``): elementwise
``elemwise_add``/``_sub``/``_mul``/``_div`` (:57-74) and the scalar ops
(:150-162), ``identity``, the ``sum`` reduction (:283-291), the matrix
ops ``SwapAxis``, ``Reshape`` with the reference's special codes
(:380-452), ``Flatten``, ``expand_dims`` and ``tile`` (:453-505), and the
optimizer update ops ``sgd_update``, ``sgd_mom_update``, ``adam_update``,
``rmsprop_update``, ``rmspropalex_update`` (:702-746) — the rules of the
reference's src/operator/tensor/optimizer_op.cc, in the JAX package's op
order.  The update ops return new tensors; callers that keep state assign
them."""
from __future__ import annotations

import torch

from .registry import register


@register("elemwise_add", input_names=("lhs", "rhs"),
          aliases=("_add", "_plus", "_Plus"))
def elemwise_add(lhs, rhs):
    return torch.add(lhs, rhs)


@register("elemwise_sub", input_names=("lhs", "rhs"),
          aliases=("_sub", "_minus", "_Minus"))
def elemwise_sub(lhs, rhs):
    return torch.sub(lhs, rhs)


@register("elemwise_mul", input_names=("lhs", "rhs"), aliases=("_mul", "_Mul"))
def elemwise_mul(lhs, rhs):
    return torch.mul(lhs, rhs)


@register("elemwise_div", input_names=("lhs", "rhs"), aliases=("_div", "_Div"))
def elemwise_div(lhs, rhs):
    return torch.div(lhs, rhs)


# ---------------------------------------------------------------------------
# scalar ops — elemwise_binary_scalar_op.cc
# ---------------------------------------------------------------------------

def _scalar_op(name, fn, aliases=()):
    @register(name, aliases=aliases)
    def _op(data, scalar=0.0, _fn=fn):
        # the scalar is rounded to the data's dtype first, as
        # jnp.asarray(scalar, dtype=data.dtype) rounds it
        return _fn(data, torch.tensor(scalar, dtype=data.dtype))
    _op.__name__ = name
    return _op


_scalar_op("_plus_scalar", lambda a, s: a + s, aliases=("_PlusScalar",))
_scalar_op("_minus_scalar", lambda a, s: a - s, aliases=("_MinusScalar",))
_scalar_op("_rminus_scalar", lambda a, s: s - a, aliases=("_RMinusScalar",))
_scalar_op("_mul_scalar", lambda a, s: a * s, aliases=("_MulScalar",))
_scalar_op("_div_scalar", lambda a, s: a / s, aliases=("_DivScalar",))
_scalar_op("_rdiv_scalar", lambda a, s: s / a, aliases=("_RDivScalar",))


@register("identity", aliases=("_copy", "_identity_with_attr_like_rhs"))
def identity(data):
    return data


# ---------------------------------------------------------------------------
# reductions — broadcast_reduce_op_value.cc
# ---------------------------------------------------------------------------

def _tuple(x):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


def _norm_axis(axis, ndim):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(a + ndim if a < 0 else a for a in axis)
    return axis + ndim if axis < 0 else axis


def _reduce_axes(data, axis, exclude=False):
    if axis is None or axis == () or axis == []:
        axes = tuple(range(data.ndim))
    else:
        axes = _norm_axis(_tuple(axis), data.ndim)
    if exclude:
        axes = tuple(i for i in range(data.ndim) if i not in axes)
    return axes


@register("sum", aliases=("sum_axis",))
def sum_op(data, axis=None, keepdims=False, exclude=False):
    axes = _reduce_axes(data, axis, exclude)
    if not axes:
        return data
    return torch.sum(data, dim=axes, keepdim=bool(keepdims))


# ---------------------------------------------------------------------------
# matrix ops — matrix_op.cc, swapaxis.cc
# ---------------------------------------------------------------------------

@register("SwapAxis", aliases=("swapaxes", "SwapAxes"))
def swapaxes(data, dim1=0, dim2=0):
    """reference src/operator/swapaxis.cc"""
    return torch.swapaxes(data, dim1, dim2)


def infer_reshape(in_shape, target, reverse=False):
    """Implements the reference ReshapeParam special codes
    (matrix_op-inl.h): 0 copy, -1 infer, -2 copy-all-remaining,
    -3 merge-two, -4 split-one; ``reverse`` matches them right to left.
    The JAX package's function (:386-433), step for step."""
    in_shape = list(in_shape)
    if reverse:
        in_shape = in_shape[::-1]
        target = list(target)[::-1]
    out = []
    src_idx = 0
    infer_idx = -1
    i = 0
    target = list(target)
    while i < len(target):
        t = target[i]
        if t == 0:
            out.append(in_shape[src_idx])
            src_idx += 1
        elif t == -1:
            infer_idx = len(out)
            out.append(1)
        elif t == -2:
            out.extend(in_shape[src_idx:])
            src_idx = len(in_shape)
        elif t == -3:
            out.append(in_shape[src_idx] * in_shape[src_idx + 1])
            src_idx += 2
        elif t == -4:
            d1, d2 = target[i + 1], target[i + 2]
            src = in_shape[src_idx]
            src_idx += 1
            if d1 == -1:
                d1 = src // d2
            if d2 == -1:
                d2 = src // d1
            out.extend([d1, d2])
            i += 2
        else:
            out.append(t)
            if t != -1:
                src_idx += 1 if src_idx < len(in_shape) else 0
        i += 1
    total = 1
    for d in in_shape:
        total *= d
    if infer_idx >= 0:
        known = 1
        for j, d in enumerate(out):
            if j != infer_idx:
                known *= d
        out[infer_idx] = total // max(known, 1)
    if reverse:
        out = out[::-1]
    return tuple(out)


@register("Reshape", aliases=("reshape",))
def reshape(data, shape=(), reverse=False, target_shape=None,
            keep_highest=False):
    if target_shape:  # legacy attr (matrix_op-inl.h:144-161): exactly one
        # 0 entry is INFERRED from the rest (unlike new-style shape,
        # where 0 copies the input dim); keep_highest pins dim0
        tgt = list(_tuple(target_shape))
        start = 0
        if keep_highest:
            tgt[0] = data.shape[0]
            start = 1
        zeros = [i for i in range(start, len(tgt)) if tgt[i] == 0]
        if len(zeros) == 1:
            tgt[zeros[0]] = -1
        return torch.reshape(data, tuple(tgt))
    return torch.reshape(data, infer_reshape(data.shape, _tuple(shape),
                                             reverse))


@register("Flatten", aliases=("flatten",))
def flatten(data):
    return torch.reshape(data, (data.shape[0], -1))


@register("expand_dims")
def expand_dims(data, axis=0):
    return torch.unsqueeze(data, axis)


@register("tile")
def tile(data, reps=()):
    return torch.tile(data, _tuple(reps))


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
