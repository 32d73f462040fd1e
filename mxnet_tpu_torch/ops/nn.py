"""Neural-network layer ops (port of ``mxnet_tpu/ops/nn.py``).

The attributes, their defaults and the shape inference are the JAX
package's; the lowerings are PyTorch: ``F.conv{1,2,3}d`` for Convolution,
``F.max_pool``/``F.avg_pool`` over an explicitly padded input for Pooling,
``torch.matmul`` for FullyConnected, ``F.embedding`` for Embedding, and
for the fused ``RNN`` op one hoisted input projection per layer and
direction, then, for the fused LSTM, one ``lstm_seq`` recurrence (one
persistent kernel launch on the card) and otherwise a Python loop over
time; ``F.conv_transpose{1,2,3}d`` for Deconvolution and bilinear
UpSampling.  They differentiate through torch autograd as they are,
except the loss layers, whose backward supplies its own gradient and
ignores the head gradient (SoftmaxOutput's ``(p - onehot(label)) *
grad_scale``, the three regression outputs, SVMOutput's hinge and
MakeLoss: each a ``torch.autograd.Function``, the JAX package's
``custom_vjp``s, :618-803), and the LSTM recurrence
(``kernels/lstm_cell.py``).  Dropout, RNN and LeakyReLU's rrelu draw
from the ``torch.Generator`` the executor hands them as ``rng``.
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
# Deconvolution — src/operator/deconvolution-inl.h
# ---------------------------------------------------------------------------

_DECONV_FNS = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
               3: F.conv_transpose3d}


def _deconv_infer(attrs, in_shapes):
    kernel = _tuple(attrs["kernel"])
    nd = len(kernel)
    num_filter = int(attrs["num_filter"])
    num_group = int(attrs.get("num_group", 1))
    no_bias = attrs.get("no_bias", True)
    stride = _tuple(attrs.get("stride", (1,) * nd), nd)
    pad = _tuple(attrs.get("pad", (0,) * nd), nd)
    adj = _tuple(attrs.get("adj", (0,) * nd), nd)
    dilate = _tuple(attrs.get("dilate", (1,) * nd), nd)
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], []
    c_in = data[1]
    wshape = (c_in, num_filter // num_group) + kernel
    shapes = [tuple(data), wshape] + ([] if no_bias else [(num_filter,)])
    out_sp = tuple(
        stride[i] * (data[2 + i] - 1) + dilate[i] * (kernel[i] - 1) + 1
        - 2 * pad[i] + adj[i]
        for i in range(nd))
    return shapes, [(data[0], num_filter) + out_sp], []


@register("Deconvolution",
          input_names=lambda attrs: (("data", "weight") if attrs.get("no_bias", True)
                                     else ("data", "weight", "bias")),
          infer_shape=_deconv_infer)
def deconvolution(data, weight, bias=None, kernel=(), stride=None, pad=None,
                  adj=None, dilate=None, num_filter=0, num_group=1,
                  no_bias=True, workspace=512, target_shape=None,
                  cudnn_tune=None, cudnn_off=False, layout=None):
    """Transposed convolution (the gradient of Convolution w.r.t. its
    input), weight (C_in, num_filter / num_group, k...).  The output
    extent is ``stride * (in - 1) + dilate * (k - 1) + 1 - 2 * pad +
    adj`` per axis; ``target_shape`` is accepted and, as in the JAX
    package, does not change it.  ``F.conv_transpose`` takes ``adj`` as
    its ``output_padding`` where torch allows it (below the stride or the
    dilation); otherwise the unpadded transposed conv is computed and
    its window ``[pad, pad + out)`` taken, zero past its end."""
    kernel = _tuple(kernel)
    nd = len(kernel)
    stride = _tuple(stride or (1,) * nd, nd)
    pad = _tuple(pad if pad is not None else (0,) * nd, nd)
    adj = _tuple(adj if adj is not None else (0,) * nd, nd)
    dilate = _tuple(dilate if dilate is not None else (1,) * nd, nd)
    fn = _DECONV_FNS[nd]
    if all(a < max(s, d) for a, s, d in zip(adj, stride, dilate)):
        return fn(data, weight, bias, stride=stride, padding=pad,
                  output_padding=adj, groups=int(num_group), dilation=dilate)
    full = fn(data, weight, None, stride=stride, groups=int(num_group),
              dilation=dilate)
    index = [slice(None), slice(None)]
    grow = []
    for i in range(nd):
        size = full.shape[2 + i]
        out = size - 2 * pad[i] + adj[i]
        index.append(slice(pad[i], min(pad[i] + out, size)))
        grow.append(max(pad[i] + out - size, 0))
    out = full[tuple(index)]
    if any(grow):
        out = F.pad(out, [p for g in reversed(grow) for p in (0, g)])
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


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


def _lrelu_inputs(attrs):
    if str(attrs.get("act_type", "leaky")) == "prelu":
        return ("data", "gamma")
    return ("data",)


def _lrelu_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], []
    if str(attrs.get("act_type", "leaky")) == "prelu":
        return [tuple(data), (data[1],)], [tuple(data)], []
    return [tuple(data)], [tuple(data)], []


@register("LeakyReLU", input_names=_lrelu_inputs, infer_shape=_lrelu_infer,
          needs_is_train=True, needs_rng=True)
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, is_train=False, rng=None):
    """``x`` where ``x >= 0``, else ``slope * x`` (leaky), ``slope *
    expm1(x)`` (elu), ``gamma[c] * x`` (prelu) or ``s * x`` (rrelu: ``s``
    drawn uniform in [lower_bound, upper_bound) from the node's generator
    in training, their mean otherwise)."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2))
        return torch.where(data >= 0, data, g * data)
    if act_type == "rrelu":
        if is_train:
            s = torch.rand(data.shape, generator=rng, device=data.device,
                           dtype=data.dtype) * (upper_bound - lower_bound) \
                + lower_bound
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data >= 0, data, s * data)
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
# InstanceNorm / L2Normalization / LRN — src/operator/instance_norm-inl.h,
# l2_normalization-inl.h, lrn-inl.h
# ---------------------------------------------------------------------------

def _in_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], []
    c = (data[1],)
    return [tuple(data), c, c], [tuple(data)], []


@register("InstanceNorm", input_names=("data", "gamma", "beta"),
          infer_shape=_in_infer)
def instance_norm(data, gamma, beta, eps=0.001):
    """Each (n, c) map normalized by its own mean and (biased) variance,
    then scaled by ``gamma[c]`` and shifted by ``beta[c]``."""
    axes = tuple(range(2, data.ndim))
    mean = torch.mean(data, dim=axes, keepdim=True)
    var = torch.var(data, dim=axes, keepdim=True, unbiased=False)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape) + \
        beta.reshape(bshape)


@register("L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance"):
    """``x / sqrt(sum(x^2) + eps)`` over every axis but the batch
    (instance), the channel axis (channel) or the spatial axes
    (spatial)."""
    if mode == "instance":
        axes = tuple(range(1, data.ndim))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, data.ndim))
    else:
        raise MXNetError("unknown mode %r" % mode)
    norm = torch.sqrt(torch.sum(torch.square(data), dim=axes, keepdim=True)
                      + eps)
    return data / norm


@register("LRN", num_outputs=1)
def lrn(data, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    """Cross-channel local response normalization in MXNet's form:
    ``x * (knorm + alpha / nsize * sum of x^2 over the nsize channels
    around c)^-beta``, the window zero-padded by ``nsize // 2`` at both
    ends of the channel axis (not ``F.local_response_norm``'s
    average-pool form)."""
    sq = torch.square(data)
    half = nsize // 2
    zeros = sq.new_zeros((sq.shape[0], half) + tuple(sq.shape[2:]))
    padded = torch.cat([zeros, sq, zeros], dim=1)
    c = data.shape[1]
    windows = sum(padded[:, i:i + c] for i in range(nsize))
    norm = torch.pow(knorm + (alpha / nsize) * windows, -beta)
    return data * norm


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


@register("SoftmaxActivation")
def softmax_activation(data, mode="instance"):
    """Softmax over the channel axis (channel) or over everything but the
    batch axis (instance)."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


# ---------------------------------------------------------------------------
# The other loss layers — regression_output-inl.h, svm_output-inl.h,
# make_loss-inl.h.  Each backward supplies its own gradient and ignores the
# incoming head gradient (the JAX package's custom_vjps, :712-803); the
# label's gradient is zeros.
# ---------------------------------------------------------------------------

def _loss_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], []
    label = in_shapes[1] if len(in_shapes) > 1 and in_shapes[1] is not None \
        else (data[0],)
    return [tuple(data), tuple(label)], [tuple(data)], []


def _zero_label_grad(ctx, label):
    return torch.zeros_like(label) if ctx.needs_input_grad[1] else None


def _make_regression(name, fwd_fn, bwd_fn):
    class _Regression(torch.autograd.Function):
        @staticmethod
        def forward(ctx, data, label, grad_scale):
            out = fwd_fn(data)
            ctx.save_for_backward(out, label)
            ctx.grad_scale = grad_scale
            return out

        @staticmethod
        def backward(ctx, g):
            out, label = ctx.saved_tensors
            num_output = _prod(label.shape[1:]) if label.ndim > 1 else 1
            grad = (ctx.grad_scale / num_output) * bwd_fn(
                out, label.reshape(out.shape))
            return grad, _zero_label_grad(ctx, label), None

    _Regression.__name__ = "_" + name

    @register(name, input_names=("data", "label"), infer_shape=_loss_infer)
    def _op(data, label, grad_scale=1.0):
        return _Regression.apply(data, label, float(grad_scale))
    _op.__name__ = name
    return _op


_make_regression("LinearRegressionOutput", lambda d: d, lambda o, l: o - l)
_make_regression("LogisticRegressionOutput", torch.sigmoid,
                 lambda o, l: o - l)
_make_regression("MAERegressionOutput", lambda d: d,
                 lambda o, l: torch.sign(o - l))


class _SVMOutput(torch.autograd.Function):
    """Forward identity; backward the one-vs-all hinge of the reference
    kernels (svm_output.cc L1_SVM/L2_SVM): the true class's score pushed
    above +margin, every other class's below -margin."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.attrs = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.attrs
        classes = torch.arange(data.shape[1], device=data.device)
        onehot = (label.to(torch.int32).unsqueeze(1) == classes).to(
            data.dtype)
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        if use_linear:
            g_true = torch.where(data < margin, zero - reg, zero)
            g_other = torch.where(data > -margin, zero + reg, zero)
        else:
            g_true = torch.where(data < margin, -2.0 * reg * (margin - data),
                                 zero)
            g_other = torch.where(data > -margin,
                                  2.0 * reg * (margin + data), zero)
        grad = onehot * g_true + (1 - onehot) * g_other
        return grad.to(data.dtype), _zero_label_grad(ctx, label), None, \
            None, None


@register("SVMOutput", input_names=("data", "label"), infer_shape=_loss_infer)
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


class _MakeLoss(torch.autograd.Function):
    """Forward identity; backward ``grad_scale`` everywhere, divided by the
    batch size (batch) or the element count (valid) — make_loss-inl.h:
    92-98."""

    @staticmethod
    def forward(ctx, data, grad_scale, normalization):
        scale = grad_scale
        if normalization == "batch":
            scale = scale / data.shape[0]
        elif normalization == "valid":
            scale = scale / _prod(data.shape)
        ctx.scale = scale
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.scale), None, None


@register("MakeLoss", aliases=("make_loss",))
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Forward identity; backward emits grad_scale (reference
    src/operator/make_loss-inl.h:92-98)."""
    return _MakeLoss.apply(data, float(grad_scale), str(normalization))


@register("IdentityAttachKLSparseReg")
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1, penalty=0.001,
                                  momentum=0.9):
    """Identity, as in the JAX package: the KL sparseness penalty's
    gradient and its moving average of activations are not modelled
    there (no aux state), so the port keeps the same surface."""
    return data


# ---------------------------------------------------------------------------
# Dropout — src/operator/dropout-inl.h
# ---------------------------------------------------------------------------

def _keep_mask(shape, keep, rng, device):
    """Bernoulli(keep) mask drawn from the generator ``rng``."""
    return torch.rand(shape, generator=rng, device=device) < keep


@register("Dropout", needs_is_train=True, needs_rng=True, num_outputs=1)
def dropout(data, p=0.5, is_train=False, rng=None, mode=None):
    if not is_train or p <= 0:
        return data
    keep = 1.0 - p
    mask = _keep_mask(data.shape, keep, rng, data.device)
    return torch.where(mask, data / keep, torch.zeros_like(data))


# ---------------------------------------------------------------------------
# Embedding — src/operator/tensor/indexing_op.h (EmbeddingOp)
# ---------------------------------------------------------------------------

def _embed_infer(attrs, in_shapes):
    input_dim = int(attrs["input_dim"])
    output_dim = int(attrs["output_dim"])
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], []
    return [tuple(data), (input_dim, output_dim)], \
        [tuple(data) + (output_dim,)], []


@register("Embedding", input_names=("data", "weight"),
          infer_shape=_embed_infer)
def embedding(data, weight, input_dim=0, output_dim=0, dtype="float32"):
    """Rows of ``weight`` at the ids in ``data``, with ``jnp.take``'s
    semantics: float ids truncate toward zero (``astype(int32)``), ids in
    [-V, 0) count from the end, and an id outside [-V, V) gives a row of
    NaN (the ``fill`` mode) instead of a device-side fault."""
    rows = weight.shape[0]
    idx = data.to(torch.int64)
    valid = (idx >= -rows) & (idx < rows)
    idx = torch.remainder(idx, rows)
    out = F.embedding(idx, weight)
    return torch.where(valid.unsqueeze(-1), out,
                       torch.full((), float("nan"), dtype=out.dtype,
                                  device=out.device))


# ---------------------------------------------------------------------------
# Concat / SliceChannel — src/operator/concat-inl.h, slice_channel-inl.h
# ---------------------------------------------------------------------------

def _concat_inputs(attrs):
    n = int(attrs.get("num_args", 1))
    return tuple("arg%d" % i for i in range(n))


def _concat_infer(attrs, in_shapes):
    dim = int(attrs.get("dim", 1))
    known = [s for s in in_shapes if s is not None]
    if not known or any(s is None for s in in_shapes):
        return in_shapes, [None], []
    out = list(known[0])
    out[dim] = sum(s[dim] for s in in_shapes)
    return [tuple(s) for s in in_shapes], [tuple(out)], []


@register("Concat", input_names=_concat_inputs, variable_inputs=True,
          infer_shape=_concat_infer, aliases=("concat",))
def concat(*args, num_args=1, dim=1):
    return torch.cat(args, dim=dim)


def _slice_channel_infer(attrs, in_shapes):
    n = int(attrs.get("num_outputs", 1))
    axis = int(attrs.get("axis", 1))
    squeeze = attrs.get("squeeze_axis", False)
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None] * n, []
    out = list(data)
    out[axis] //= n
    if squeeze and out[axis] == 1:
        out.pop(axis)
    return [tuple(data)], [tuple(out)] * n, []


@register("SliceChannel", aliases=("split",),
          num_outputs=lambda attrs: int(attrs.get("num_outputs", 1)),
          infer_shape=_slice_channel_infer)
def slice_channel(data, num_outputs=1, axis=1, squeeze_axis=False):
    if data.shape[axis] % num_outputs:
        raise MXNetError("SliceChannel: axis %d of size %d does not split "
                         "into %d equal parts" % (axis, data.shape[axis],
                                                  num_outputs))
    parts = torch.split(data, data.shape[axis] // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, axis) for p in parts]
    return tuple(parts)


# ---------------------------------------------------------------------------
# Pad / Crop / UpSampling — src/operator/pad.cc, crop.cc, upsampling.cc
# ---------------------------------------------------------------------------

def _pad_index(n, left, right, mode, device):
    """Source index of each output position of one axis padded by
    ``(left, right)``: the nearest end (edge) or the mirror image without
    repeating the end (reflect, periodic in ``2 (n - 1)`` as numpy's)."""
    i = torch.arange(-left, n + right, device=device)
    if mode == "edge" or n == 1:
        return torch.clamp(i, 0, n - 1)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j <= n - 1, j, period - j)


@register("Pad", aliases=("pad",))
def pad_op(data, pad_width=(), mode="constant", constant_value=0.0):
    """``pad_width`` holds (before, after) for every axis, in axis order:
    constant fills with ``constant_value``; edge and reflect gather along
    each padded axis."""
    pw = _tuple(pad_width)
    pads = [(int(pw[2 * i]), int(pw[2 * i + 1])) for i in range(data.ndim)]
    if mode == "constant":
        flat = [p for lr in reversed(pads) for p in lr]
        return F.pad(data, flat, value=float(constant_value))
    if mode not in ("edge", "reflect"):
        raise MXNetError("unknown pad mode %r" % mode)
    out = data
    for axis, (left, right) in enumerate(pads):
        if left or right:
            out = torch.index_select(
                out, axis, _pad_index(out.shape[axis], left, right, mode,
                                      out.device))
    return out


def _crop_inputs(attrs):
    n = int(attrs.get("num_args", 1))
    return ("data",) if n == 1 else ("data", "crop_like")


def _crop_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], []
    if int(attrs.get("num_args", 1)) == 2 and in_shapes[1] is not None:
        hw = in_shapes[1][2:]
    else:
        hw = _tuple(attrs.get("h_w", ()))
    out = tuple(data[:2]) + tuple(hw)
    return [tuple(s) if s else s for s in in_shapes], [out], []


@register("Crop", input_names=_crop_inputs, infer_shape=_crop_infer)
def crop(data, crop_like=None, num_args=1, offset=(0, 0), h_w=(0, 0),
         center_crop=False):
    """An (h, w) window of the NCHW input: h, w from ``crop_like``'s
    spatial shape or ``h_w``; its corner centred or at ``offset``, moved
    back inside the input where it would leave it (``lax.dynamic_slice``
    clamps its start the same way)."""
    if crop_like is not None:
        h, w = crop_like.shape[2], crop_like.shape[3]
    else:
        h, w = _tuple(h_w, 2)
    if center_crop:
        oy = (data.shape[2] - h) // 2
        ox = (data.shape[3] - w) // 2
    else:
        oy, ox = _tuple(offset, 2)
    oy = min(max(int(oy), 0), data.shape[2] - h)
    ox = min(max(int(ox), 0), data.shape[3] - w)
    return data[:, :, oy:oy + h, ox:ox + w]


def _upsample_infer(attrs, in_shapes):
    scale = int(attrs.get("scale", 1))
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], []
    out = (data[0], data[1], data[2] * scale, data[3] * scale)
    shapes = [tuple(s) if s else s for s in in_shapes]
    if str(attrs.get("sample_type", "nearest")) == "bilinear":
        k = 2 * scale - scale % 2
        nf = int(attrs.get("num_filter", data[1]) or data[1])
        shapes = [tuple(data), (nf, 1, k, k)]
        out = (data[0], nf, data[2] * scale, data[3] * scale)
    return shapes, [out], []


def _upsample_inputs(attrs):
    if str(attrs.get("sample_type", "nearest")) == "bilinear":
        return ("data", "weight")
    return _concat_inputs(attrs)


@register("UpSampling", variable_inputs=True, input_names=_upsample_inputs,
          infer_shape=_upsample_infer)
def upsampling(*args, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=512):
    """Nearest: each pixel repeated ``scale`` x ``scale``; several inputs
    are concatenated on the channel axis or summed.  Bilinear: the
    reference's UpSamplingBilinear, a transposed conv with one (learnable)
    filter per channel, kernel ``2 * scale - scale % 2``, stride
    ``scale``."""
    if sample_type == "bilinear":
        data, weight = args[0], args[1]
        k = 2 * scale - scale % 2
        p = int(math.ceil((scale - 1) / 2.0))
        nf = num_filter or data.shape[1]
        w = torch.reshape(weight, (data.shape[1], 1, k, k))
        return deconvolution(data, w, None, kernel=(k, k),
                             stride=(scale, scale), pad=(p, p),
                             num_filter=nf, num_group=data.shape[1],
                             no_bias=True)
    outs = [torch.repeat_interleave(torch.repeat_interleave(
        data, scale, dim=2), scale, dim=3) for data in args]
    if len(outs) == 1:
        return outs[0]
    if multi_input_mode == "sum":
        return sum(outs)
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Sequence ops — src/operator/sequence_{last,mask,reverse}-inl.h (the JAX
# package's :815-860).  Data is time-major (T, N, ...); with
# ``use_sequence_length`` the (N,) lengths are read on the device (a
# gather or a mask), never on the host.
# ---------------------------------------------------------------------------

def _seq_inputs(attrs):
    if attrs.get("use_sequence_length", False):
        return ("data", "sequence_length")
    return ("data",)


def _seq_last_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], []
    return [tuple(s) if s else s for s in in_shapes], [tuple(data[1:])], []


def _seq_index(sequence_length, data):
    """The (N,) lengths as int64 shaped to broadcast against the time
    axis of ``data``: (1, N, 1, ...)."""
    return sequence_length.to(torch.int32).to(torch.int64).reshape(
        (1, -1) + (1,) * (data.ndim - 2))


@register("SequenceLast", input_names=_seq_inputs, infer_shape=_seq_last_infer)
def sequence_last(data, sequence_length=None, use_sequence_length=False):
    """Each sequence's last valid step: ``data[length - 1, n]``."""
    if not use_sequence_length or sequence_length is None:
        return data[-1]
    idx = (_seq_index(sequence_length, data) - 1).expand(
        (1,) + tuple(data.shape[1:]))
    return torch.gather(data, 0, idx)[0]


@register("SequenceMask", input_names=_seq_inputs)
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0):
    """Steps at or past each sequence's length set to ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    T = data.shape[0]
    steps = torch.arange(T, device=data.device).reshape(
        (T,) + (1,) * (data.ndim - 1))
    lens = sequence_length.reshape((1, -1) + (1,) * (data.ndim - 2))
    return torch.where(steps < lens, data,
                       torch.tensor(value, dtype=data.dtype,
                                    device=data.device))


@register("SequenceReverse", input_names=_seq_inputs)
def sequence_reverse(data, sequence_length=None, use_sequence_length=False):
    """Each sequence's first ``length`` steps reversed in place; the
    padding after them stays where it is."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    T = data.shape[0]
    steps = torch.arange(T, device=data.device).reshape(
        (T,) + (1,) * (data.ndim - 1))
    lens = _seq_index(sequence_length, data)
    rev_idx = torch.where(steps < lens, lens - 1 - steps, steps)
    return torch.gather(data, 0, rev_idx.expand(tuple(data.shape)))


# ---------------------------------------------------------------------------
# Fused RNN — src/operator/rnn-inl.h / cudnn_rnn-inl.h (the JAX package's
# :862-1052).  Weight layout matches the reference's fused vector format so
# rnn_cell pack/unpack round-trips (python/mxnet/rnn/rnn_cell.py:541-607):
# per layer, per direction: all i2h weights (gates stacked), all h2h
# weights, then per layer/direction all i2h biases, all h2h biases.
# Gate order: LSTM [i, f, c, o]; GRU [r, z, n].
# ---------------------------------------------------------------------------

_RNN_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    gates = _RNN_GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        size += dirs * gates * state_size * (in_sz + state_size + 2)
    return size


def _rnn_split_params(params, num_layers, input_size, state_size,
                      bidirectional, mode):
    """Split the fused 1-D parameter vector into per-layer weight matrices
    (views of it, so gradients flow back into the vector)."""
    gates = _RNN_GATES[mode]
    dirs = 2 if bidirectional else 1
    ws, bs = [], []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        layer_w = []
        for _d in range(dirs):
            n_i2h = gates * state_size * in_sz
            w_i2h = params[off:off + n_i2h].reshape(gates * state_size, in_sz)
            off += n_i2h
            n_h2h = gates * state_size * state_size
            w_h2h = params[off:off + n_h2h].reshape(gates * state_size,
                                                    state_size)
            off += n_h2h
            layer_w.append((w_i2h, w_h2h))
        ws.append(layer_w)
    for layer in range(num_layers):
        layer_b = []
        for _d in range(dirs):
            b_i2h = params[off:off + gates * state_size]
            off += gates * state_size
            b_h2h = params[off:off + gates * state_size]
            off += gates * state_size
            layer_b.append((b_i2h, b_h2h))
        bs.append(layer_b)
    return ws, bs


def _rnn_cell_step(mode):
    """``step(carry, xb, w_h2h) -> (carry, h)`` for one time step, where
    ``xb`` is the step's hoisted input projection with both biases added.
    The unfused LSTM step splits the gates and chains the activations as
    the JAX package's :934-937 (the fused LSTM runs the whole sequence
    through ``kernels/lstm_cell.py`` ``lstm_seq`` instead)."""
    def step(carry, xb, w_h2h):
        h = carry[0]
        if mode == "lstm":
            gates = torch.addmm(xb, h, w_h2h.t())
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            c = torch.sigmoid(f) * carry[1] + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            return (h, c), h
        if mode == "gru":
            xr, xz, xn, hb_n = xb
            hp = torch.matmul(h, w_h2h.t())
            hr, hz, hn = torch.chunk(hp, 3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * (hn + hb_n))
            h = (1 - z) * n + z * h
            return (h,), h
        pre = torch.addmm(xb, h, w_h2h.t())
        h = torch.relu(pre) if mode == "rnn_relu" else torch.tanh(pre)
        return (h,), h
    return step


def _rnn_inputs(attrs):
    mode = str(attrs.get("mode", "lstm"))
    if mode == "lstm":
        return ("data", "parameters", "state", "state_cell")
    return ("data", "parameters", "state")


def _rnn_num_outputs(attrs):
    if not attrs.get("state_outputs", False):
        return 1
    return 3 if str(attrs.get("mode", "lstm")) == "lstm" else 2


def _rnn_infer(attrs, in_shapes):
    mode = str(attrs.get("mode", "lstm"))
    num_layers = int(attrs.get("num_layers", 1))
    state_size = int(attrs.get("state_size"))
    bi = attrs.get("bidirectional", False)
    dirs = 2 if bi else 1
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None] * _rnn_num_outputs(attrs), []
    T, N, I = data
    psize = rnn_param_size(num_layers, I, state_size, bi, mode)
    sshape = (num_layers * dirs, N, state_size)
    shapes = [tuple(data), (psize,), sshape]
    if mode == "lstm":
        shapes.append(sshape)
    outs = [(T, N, state_size * dirs)]
    if attrs.get("state_outputs", False):
        outs.append(sshape)
        if mode == "lstm":
            outs.append(sshape)
    return shapes, outs, []


@register("RNN", input_names=_rnn_inputs, num_outputs=_rnn_num_outputs,
          infer_shape=_rnn_infer, needs_is_train=True, needs_rng=True)
def rnn(data, parameters, state, state_cell=None, state_size=0, num_layers=1,
        bidirectional=False, mode="lstm", p=0.0, state_outputs=False,
        lstm_state_clip_min=None, lstm_state_clip_max=None, is_train=False,
        rng=None):
    """Fused multi-layer RNN over time-major data (T, N, I) (reference
    src/operator/cudnn_rnn-inl.h).

    Per layer and direction, the input projection of the whole sequence
    is one (T*N, I) x (I, G*H) matmul with both biases added once, hoisted
    out of the recurrence, as the JAX package hoists it (:1023).  With
    ``MXTPU_FUSED_KERNELS`` enabling ``lstm_cell``, an lstm layer's
    recurrence is one ``lstm_seq`` call (``kernels/lstm_cell.py``: on the
    card one persistent kernel for all T steps, or its ``per_step``
    route where W_h2h does not fit; the plain loop on the CPU);
    otherwise it is a Python loop over T whose step is one ``addmm`` (the
    h2h product into the hoisted projection) and the gate ops.  GRU keeps
    its h2h bias of the new-gate part inside the reset product, as the
    reference does.  Between layers
    a training forward with ``p > 0`` drops units with masks drawn from
    ``rng``.  The ``lstm_state_clip_*`` attrs are accepted and ignored,
    as in the JAX package."""
    T, N, _ = data.shape
    dirs = 2 if bidirectional else 1
    ws, bs = _rnn_split_params(parameters, num_layers, data.shape[2],
                               state_size, bidirectional, mode)
    step = _rnn_cell_step(mode)
    lstm_seq = None
    if mode == "lstm":
        from ..kernels import fused_enabled
        if fused_enabled("lstm_cell"):
            from ..kernels.lstm_cell import lstm_seq
    h0 = state.reshape(num_layers, dirs, N, state_size)
    c0 = state_cell.reshape(num_layers, dirs, N, state_size) \
        if state_cell is not None else None

    layer_in = data
    h_finals, c_finals = [], []
    for layer in range(num_layers):
        outs_dir = []
        for d in range(dirs):
            w_i2h, w_h2h = ws[layer][d]
            b_i2h, b_h2h = bs[layer][d]
            seq = layer_in if d == 0 else torch.flip(layer_in, dims=(0,))
            x_proj = torch.matmul(seq, w_i2h.t()) + b_i2h
            if mode == "gru":
                # the new gate's h2h bias stays inside r * (...)
                hb_r, hb_z, hb_n = torch.chunk(b_h2h, 3)
                xr, xz, xn = torch.chunk(x_proj, 3, dim=-1)
                xs = [(xr[t] + hb_r, xz[t] + hb_z, xn[t], hb_n)
                      for t in range(T)]
            elif lstm_seq is None:
                xs = torch.unbind(x_proj + b_h2h, dim=0)
            carry = (h0[layer, d], c0[layer, d]) if mode == "lstm" \
                else (h0[layer, d],)
            if lstm_seq is not None:
                hs, h_last, c_last = lstm_seq(x_proj + b_h2h, w_h2h,
                                              *carry)
                carry = (h_last, c_last)
            else:
                hs = []
                for t in range(T):
                    carry, h = step(carry, xs[t], w_h2h)
                    hs.append(h)
                hs = torch.stack(hs)
            if d == 1:
                hs = torch.flip(hs, dims=(0,))
            outs_dir.append(hs)
            h_finals.append(carry[0])
            if mode == "lstm":
                c_finals.append(carry[1])
        layer_in = outs_dir[0] if dirs == 1 else torch.cat(outs_dir, dim=-1)
        if is_train and p > 0 and layer < num_layers - 1:
            keep = 1.0 - p
            mask = _keep_mask(layer_in.shape, keep, rng, layer_in.device)
            layer_in = torch.where(mask, layer_in / keep,
                                   torch.zeros_like(layer_in))

    if not state_outputs:
        return layer_in
    h_out = torch.stack(h_finals).reshape(num_layers * dirs, N, state_size)
    if mode == "lstm":
        c_out = torch.stack(c_finals).reshape(num_layers * dirs, N,
                                              state_size)
        return layer_in, h_out, c_out
    return layer_in, h_out
