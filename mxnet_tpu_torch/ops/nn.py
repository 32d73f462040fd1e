"""Neural-network layer ops (port of ``mxnet_tpu/ops/nn.py``).

The attributes, their defaults and the shape inference are the JAX
package's; the lowerings are PyTorch: ``F.conv{1,2,3}d`` for Convolution,
``F.max_pool``/``F.avg_pool`` over an explicitly padded input for Pooling,
``torch.matmul`` for FullyConnected.  They differentiate through torch
autograd as they are, except SoftmaxOutput, whose hand backward
``(p - onehot(label)) * grad_scale`` is a ``torch.autograd.Function``
(the JAX package's ``custom_vjp``, :618-668).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register
from ..base import MXNetError


def _tuple(x, n=None):
    if isinstance(x, (list, tuple)):
        t = tuple(x)
    else:
        t = (x,)
    if n is not None and len(t) == 1 and n > 1:
        t = t * n
    return t


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


# ---------------------------------------------------------------------------
# FullyConnected — src/operator/fully_connected-inl.h
# ---------------------------------------------------------------------------

def _fc_inputs(attrs):
    if attrs.get("no_bias", False):
        return ("data", "weight")
    return ("data", "weight", "bias")


def _fc_infer(attrs, in_shapes):
    num_hidden = int(attrs["num_hidden"])
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], []
    in_dim = _prod(data[1:])
    shapes = [tuple(data), (num_hidden, in_dim)]
    if not attrs.get("no_bias", False):
        shapes.append((num_hidden,))
    return shapes, [(data[0], num_hidden)], []


@register("FullyConnected", input_names=_fc_inputs, infer_shape=_fc_infer)
def fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False):
    """y = x @ W.T + b with the input flattened to 2D."""
    out = torch.matmul(data.reshape(data.shape[0], -1), weight.t())
    if bias is not None:
        out = out + bias
    return out


# ---------------------------------------------------------------------------
# Convolution — src/operator/convolution-inl.h (NCHW)
# ---------------------------------------------------------------------------

_CONV_FNS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv_infer(attrs, in_shapes):
    kernel = _tuple(attrs["kernel"])
    nd = len(kernel)
    num_filter = int(attrs["num_filter"])
    num_group = int(attrs.get("num_group", 1))
    no_bias = attrs.get("no_bias", False)
    stride = _tuple(attrs.get("stride", (1,) * nd), nd)
    pad = _tuple(attrs.get("pad", (0,) * nd), nd)
    dilate = _tuple(attrs.get("dilate", (1,) * nd), nd)
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], []
    c_in = data[1]
    wshape = (num_filter, c_in // num_group) + kernel
    shapes = [tuple(data), wshape] + ([] if no_bias else [(num_filter,)])
    out_sp = tuple(
        (data[2 + i] + 2 * pad[i] - (dilate[i] * (kernel[i] - 1) + 1)) // stride[i] + 1
        for i in range(nd))
    return shapes, [(data[0], num_filter) + out_sp], []


@register("Convolution", input_names=_fc_inputs, infer_shape=_conv_infer,
          aliases=("Convolution_v1",))
def convolution(data, weight, bias=None, kernel=(), stride=None, dilate=None,
                pad=None, num_filter=0, num_group=1, no_bias=False,
                workspace=1024, cudnn_tune=None, cudnn_off=False, layout=None):
    kernel = _tuple(kernel)
    nd = len(kernel)
    stride = _tuple(stride or (1,) * nd, nd)
    dilate = _tuple(dilate or (1,) * nd, nd)
    pad = _tuple(pad if pad is not None else (0,) * nd, nd)
    return _CONV_FNS[nd](data, weight, bias, stride=stride, padding=pad,
                         dilation=dilate, groups=int(num_group))


# ---------------------------------------------------------------------------
# Pooling — src/operator/pooling-inl.h (+ pooling_v1)
# ---------------------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_out_dim(size, k, s, p, convention):
    if convention == "full":
        return int(math.ceil((size + 2 * p - k) / float(s))) + 1
    return (size + 2 * p - k) // s + 1


def _pool_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], []
    if attrs.get("global_pool", False):
        return [tuple(data)], [tuple(data[:2]) + (1,) * (len(data) - 2)], []
    kernel = _tuple(attrs["kernel"])
    nd = len(kernel)
    stride = _tuple(attrs.get("stride", (1,) * nd), nd)
    pad = _tuple(attrs.get("pad", (0,) * nd), nd)
    conv = str(attrs.get("pooling_convention", "valid"))
    out_sp = tuple(_pool_out_dim(data[2 + i], kernel[i], stride[i], pad[i], conv)
                   for i in range(nd))
    return [tuple(data)], [tuple(data[:2]) + out_sp], []


@register("Pooling", infer_shape=_pool_infer, aliases=("Pooling_v1",))
def pooling(data, kernel=(), pool_type="max", stride=None, pad=None,
            global_pool=False, pooling_convention="valid", cudnn_off=False):
    """Max pooling pads with -inf; avg divides by the kernel size with the
    padding included (the reference mshadow pool); ``full`` is ceil-mode,
    extending the right padding so the last window fits."""
    nd = data.ndim - 2
    if global_pool:
        axes = tuple(range(2, data.ndim))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        summed = data.sum(dim=axes, keepdim=True)
        if pool_type == "sum":
            return summed
        if pool_type == "avg":
            return summed / _prod(data.shape[2:])
        raise MXNetError("unknown pool_type %r" % pool_type)
    kernel = _tuple(kernel)
    stride = _tuple(stride or (1,) * nd, nd)
    pad = _tuple(pad if pad is not None else (0,) * nd, nd)
    pads = []
    for i in range(nd):
        right = pad[i]
        if pooling_convention == "full":
            out_d = _pool_out_dim(data.shape[2 + i], kernel[i], stride[i],
                                  pad[i], "full")
            needed = (out_d - 1) * stride[i] + kernel[i] \
                - data.shape[2 + i] - pad[i]
            right = max(needed, pad[i])
        pads.append((pad[i], right))
    # F.pad takes (left, right) pairs from the LAST dim backwards
    flat = [p for lr in reversed(pads) for p in lr]
    if pool_type == "max":
        if data.is_floating_point():
            fill = float("-inf")
        else:
            fill = torch.iinfo(data.dtype).min
        x = F.pad(data, flat, value=fill) if any(flat) else data
        return _MAX_POOL[nd](x, kernel, stride)
    x = F.pad(data, flat, value=0.0) if any(flat) else data
    avg = _AVG_POOL[nd](x, kernel, stride)
    if pool_type == "avg":
        return avg
    if pool_type == "sum":
        return avg * _prod(kernel)
    raise MXNetError("unknown pool_type %r" % pool_type)


# ---------------------------------------------------------------------------
# Activation — src/operator/activation-inl.h
# ---------------------------------------------------------------------------

@register("Activation")
def activation(data, act_type="relu"):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return F.softsign(data)
    raise MXNetError("unknown act_type %r" % act_type)


# ---------------------------------------------------------------------------
# BatchNorm — src/operator/batch_norm-inl.h (aux: moving_mean, moving_var)
# ---------------------------------------------------------------------------

def _bn_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None, None, None], [None, None]
    c = (data[1],)
    return [tuple(data), c, c], [tuple(data), c, c], [c, c]


@register("BatchNorm", input_names=("data", "gamma", "beta"),
          aux_names=("moving_mean", "moving_var"),
          num_outputs=lambda attrs: 3 if attrs.get("output_mean_var", False) else 1,
          output_names=lambda attrs: (("output", "mean", "var")
                                      if attrs.get("output_mean_var", False)
                                      else ("output",)),
          infer_shape=_bn_infer, needs_is_train=True)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=0.001,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, is_train=False):
    """Batch normalization over the channel axis (axis 1, NCHW), in the
    JAX package's op order: ``(x - mean) * rsqrt(var + eps) * gamma +
    beta``.  Train mode uses the batch statistics and returns the
    updated moving stats as trailing outputs."""
    axes = (0,) + tuple(range(2, data.ndim))
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    if is_train and not use_global_stats:
        mean = torch.mean(data, dim=axes)
        var = torch.var(data, dim=axes, unbiased=False)
        # state, not a differentiable output (the JAX package's has_aux)
        new_moving_mean = (moving_mean * momentum
                           + mean * (1 - momentum)).detach()
        new_moving_var = (moving_var * momentum
                          + var * (1 - momentum)).detach()
    else:
        mean, var = moving_mean, moving_var
        new_moving_mean, new_moving_var = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    out = (data - mean.reshape(bshape)) * inv.reshape(bshape) * \
        gamma.reshape(bshape) + beta.reshape(bshape)
    if output_mean_var:
        return out, mean, inv, new_moving_mean, new_moving_var
    return out, new_moving_mean, new_moving_var


# ---------------------------------------------------------------------------
# SoftmaxOutput — src/operator/softmax_output-inl.h
# ---------------------------------------------------------------------------

def _softmax_fwd_only(data, multi_output):
    if multi_output and data.ndim > 2:
        return torch.softmax(data, dim=1)
    return torch.softmax(data, dim=-1)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; the backward is the loss gradient
    ``(p - onehot(label)) * grad_scale``, normalized as asked, and
    ignores the incoming head gradient unless ``out_grad`` (the JAX
    package's ``_softmax_output_bwd``, :636-665).  The label's gradient is
    zeros."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                multi_output, normalization, out_grad):
        out = _softmax_fwd_only(data, multi_output)
        ctx.save_for_backward(out, label)
        ctx.attrs = (grad_scale, ignore_label, use_ignore, multi_output,
                     normalization, out_grad)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, multi_output, normalization, \
            out_grad = ctx.attrs
        axis = 1 if (multi_output and out.ndim > 2) else out.ndim - 1
        if label.shape == out.shape:
            grad = out - label
            valid = float(out.shape[0])
        else:
            idx = label.to(torch.int32)
            # jax.nn.one_hot: an out-of-range class (ignore_label -1) is
            # all zeros, where F.one_hot would raise
            classes = torch.arange(out.shape[axis], device=out.device)
            classes = classes.reshape([-1 if d == axis else 1
                                       for d in range(out.ndim)])
            onehot = (torch.unsqueeze(idx, axis) == classes).to(out.dtype)
            grad = out - onehot
            if use_ignore:
                mask = (idx != int(ignore_label)).to(out.dtype)
                grad = grad * torch.unsqueeze(mask, axis)
                valid = torch.clamp(torch.sum(mask), min=1.0)
            else:
                valid = float(_prod(label.shape))
        if normalization == "batch":
            grad = grad * (grad_scale / out.shape[0])
        elif normalization == "valid":
            grad = grad * grad_scale / valid
        else:
            grad = grad * grad_scale
        if out_grad:
            grad = grad * g
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad, dlabel, None, None, None, None, None, None


def _softmax_label_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], []
    if attrs.get("multi_output", False) and len(data) > 2:
        label = (data[0],) + tuple(data[2:])
    else:
        label = tuple(data[:-1])
    if len(in_shapes) > 1 and in_shapes[1] is not None:
        label = tuple(in_shapes[1])
    return [tuple(data), label], [tuple(data)], []


@register("SoftmaxOutput", input_names=("data", "label"),
          infer_shape=_softmax_label_infer, aliases=("Softmax_",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax forward over the last axis (axis 1 with ``multi_output``);
    backward = (p - onehot(label)) * grad_scale, ignoring the incoming
    head gradient — reference src/operator/softmax_output-inl.h."""
    return _SoftmaxOutput.apply(data, label, float(grad_scale),
                                float(ignore_label), bool(use_ignore),
                                bool(multi_output), str(normalization),
                                bool(out_grad))
