"""Fused BatchNorm + activation, and BN-into-conv folding.

Port of ``mxnet_tpu/kernels/bn_act.py``.  Same entry points, signatures
and returns:

- :func:`fused_bn_act` — ``(out, new_moving_mean, new_moving_var)``
  exactly like the registered ``BatchNorm`` op, plus ``act_type``.  The
  per-channel ``scale``/``shift`` come from batch or moving statistics in
  plain torch (as in the JAX package, :191-204, cast to the data's
  dtype); the elementwise pass ``act(x * scale + shift)`` is
  :class:`NormAct`, a ``torch.autograd.Function`` (the JAX package's
  ``custom_vjp``, :151-161).  Its forward is :func:`norm_act`, its
  backward :func:`norm_act_bwd`.  On a CUDA tensor both are the
  hand-written CUDA kernels of ``csrc/bn_act.cu`` (replacing the Pallas
  ``fwd_kernel`` and ``bwd_kernel``, ``mxnet_tpu/kernels/bn_act.py:
  109-149``), for every shape: the TPU's ``H*W % 128 == 0 and C % 8 ==
  0`` tiling gate does not exist here.  On a CPU tensor they are
  :func:`norm_act_plain` and :func:`norm_act_bwd_plain`.  Gradients into
  mean, var, gamma and beta flow through the ``scale``/``shift``
  computation by torch autograd.
- :func:`fused_bn_act_plain` — the forward's math in the kernel's order
  as plain torch ops (differentiated by torch autograd), the oracle the
  tests and ``chip_smoke.py`` hold the kernels against.
- :func:`fold_bn_into_conv` — with frozen statistics, ``BN(conv(x, W) +
  b)`` is ``conv(x, W * s) + (b - mean) * s + beta``,
  ``s = gamma * rsqrt(var + eps)``.

Activations outside {relu, sigmoid, tanh, none} take the composed
``BatchNorm``/``Activation`` ops on any device: the JAX package's routing
(:186-190), where such activations leave the Pallas tier.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["fused_bn_act", "fused_bn_act_plain", "fold_bn_into_conv",
           "NormAct", "norm_act", "norm_act_plain", "norm_act_bwd",
           "norm_act_bwd_plain", "LAUNCHES", "BWD_LAUNCHES"]

#: launches of the CUDA forward kernel since the process started (or the
#: caller last reset it); incremented only where the kernel is launched
LAUNCHES = 0
#: launches of the CUDA backward kernel, counted the same way
BWD_LAUNCHES = 0

#: activation name -> the kernel's template id (csrc/bn_act.cu ``Act``)
_KERNEL_ACTS = {None: 0, "": 0, "relu": 1, "sigmoid": 2, "tanh": 3}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _apply_act(y, act_type):
    if act_type == "relu":
        return torch.relu(y)
    if act_type == "sigmoid":
        return torch.sigmoid(y)
    if act_type == "tanh":
        return torch.tanh(y)
    return y


def norm_act_plain(x, scale, shift, act_type=None):
    """``act(x * scale + shift)`` over NC... ``x`` with per-channel
    ``scale``/``shift`` of shape (C,), in plain torch."""
    bshape = (1, -1) + (1,) * (x.ndim - 2)
    return _apply_act(x * scale.reshape(bshape) + shift.reshape(bshape),
                      act_type)


def _act_grad_from_y(y, act_type):
    """act'(pre) from the post-activation value ``y`` (the JAX package's
    :80-88); for relu a NaN ``y`` gives 0, as ``(y > 0)`` does."""
    if act_type == "relu":
        return (y > 0).to(y.dtype)
    if act_type == "sigmoid":
        return y * (1.0 - y)
    if act_type == "tanh":
        return 1.0 - y * y
    return torch.ones_like(y)


def norm_act_bwd_plain(x, scale, shift, dy, act_type=None):
    """The backward kernel's function in its order, in plain torch:
    recompute ``y = act(x * scale + shift)`` and ``dpre = dy * act'(y)``
    in float32 (float64 for a float64 ``x``, which only the CPU takes),
    write ``dx = dpre * scale`` in x's dtype, take the per-(n, c)
    partials ``sum_m dpre * x`` and ``sum_m dpre`` in that type and sum
    them over n.  Returns ``(dx, dscale, dshift)``, the last two of shape
    (C,) in scale's dtype."""
    n, c = x.shape[0], x.shape[1]
    bshape = (1, -1) + (1,) * (x.ndim - 2)
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    sf = scale.to(acc).reshape(bshape)
    y = _apply_act(xf * sf + shift.to(acc).reshape(bshape), act_type)
    dpre = dy.to(acc) * _act_grad_from_y(y, act_type)
    dx = (dpre * sf).to(x.dtype)
    ds_rows = (dpre * xf).reshape(n, c, -1).sum(dim=2)
    db_rows = dpre.reshape(n, c, -1).sum(dim=2)
    return (dx, ds_rows.sum(dim=0).to(scale.dtype),
            db_rows.sum(dim=0).to(scale.dtype))


def _bind(lib):
    fwd = lib.mxt_bn_act_fwd
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + \
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.mxt_bn_act_bwd
    bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 3 + \
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return fwd, bwd


_FNS = []


def _kernels():
    """``(forward, backward)`` C entry points of ``csrc/bn_act.cu``,
    built and loaded on first use."""
    if not _FNS:
        from . import load_library
        _FNS.append(_bind(load_library("bn_act")))
    return _FNS[0]


def _check_cuda_args(act_type, x, channel_vecs, same_shape=()):
    """Raise unless the kernel takes these tensors: a contiguous
    float32/bfloat16 x of rank >= 2, (C,) channel vectors and same-shape
    tensors of its dtype on its device, all contiguous."""
    if act_type not in _KERNEL_ACTS:
        raise ValueError("bn_act kernel: unsupported act_type %r" % act_type)
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError("bn_act kernel: dtype %s (float32 or bfloat16)"
                        % x.dtype)
    if x.ndim < 2 or not x.is_contiguous():
        raise ValueError("bn_act kernel: needs a contiguous N,C,... tensor, "
                         "got shape %s strides %s" % (tuple(x.shape),
                                                      x.stride()))
    c = x.shape[1]
    for name, t in channel_vecs:
        if t.device != x.device or t.dtype != x.dtype \
                or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(
                "bn_act kernel: %s must be a contiguous (%d,) %s tensor on "
                "%s, got %s %s on %s" % (name, c, x.dtype, x.device,
                                         tuple(t.shape), t.dtype, t.device))
    for name, t in same_shape:
        if t.device != x.device or t.dtype != x.dtype \
                or t.shape != x.shape or not t.is_contiguous():
            raise ValueError(
                "bn_act kernel: %s must be a contiguous %s %s tensor on %s, "
                "got %s %s on %s" % (name, tuple(x.shape), x.dtype, x.device,
                                     tuple(t.shape), t.dtype, t.device))
    m = 1
    for d in x.shape[2:]:
        m *= int(d)
    return x.shape[0], c, m


def norm_act(x, scale, shift, act_type=None):
    """The forward kernel's wrapper: ``act(x * scale + shift)``.

    A CPU tensor takes :func:`norm_act_plain`.  A CUDA tensor launches
    ``csrc/bn_act.cu`` on the current stream, or raises: it must be a
    contiguous float32/bfloat16 tensor of rank >= 2 with ``scale`` and
    ``shift`` of shape (C,), same dtype and device.  The output is a new
    tensor; nothing synchronises."""
    global LAUNCHES
    if not x.is_cuda:
        return norm_act_plain(x, scale, shift, act_type)
    n, c, m = _check_cuda_args(act_type, x, (("scale", scale),
                                             ("shift", shift)))
    fwd, _ = _kernels()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fwd(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                  y.data_ptr(), n, c, m, _KERNEL_DTYPES[x.dtype],
                  _KERNEL_ACTS[act_type], stream)
    if err != 0:
        raise RuntimeError("bn_act kernel launch failed: CUDA error %d" % err)
    LAUNCHES += 1
    return y


def norm_act_bwd(x, scale, shift, dy, act_type=None):
    """The backward kernel's wrapper: ``(dx, dscale, dshift)`` of
    ``y = act(x * scale + shift)`` for the cotangent ``dy``.

    A CPU tensor takes :func:`norm_act_bwd_plain`.  A CUDA tensor
    launches ``csrc/bn_act.cu``'s backward on the current stream, or
    raises: ``x`` and ``dy`` contiguous float32/bfloat16 tensors of one
    shape and dtype, ``scale`` and ``shift`` of shape (C,).  The kernel
    writes ``dx`` and per-(n, c) float32 partial sums; the N-sum is one
    torch reduction here, as the JAX package folds its partials in lax
    (:146-148).  ``dscale``/``dshift`` come back in scale's dtype."""
    global BWD_LAUNCHES
    if not x.is_cuda:
        return norm_act_bwd_plain(x, scale, shift, dy, act_type)
    n, c, m = _check_cuda_args(act_type, x, (("scale", scale),
                                             ("shift", shift)),
                               (("dy", dy),))
    _, bwd = _kernels()
    dx = torch.empty_like(x)
    rows = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = bwd(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                  dy.data_ptr(), dx.data_ptr(), rows[0].data_ptr(),
                  rows[1].data_ptr(), n, c, m, _KERNEL_DTYPES[x.dtype],
                  _KERNEL_ACTS[act_type], stream)
    if err != 0:
        raise RuntimeError("bn_act backward kernel launch failed: CUDA "
                           "error %d" % err)
    BWD_LAUNCHES += 1
    sums = rows.sum(dim=1).to(scale.dtype)
    return dx, sums[0], sums[1]


class NormAct(torch.autograd.Function):
    """``act(x * scale + shift)`` with the hand-written backward: the
    JAX package's ``custom_vjp`` pair (:151-161).  The forward saves its
    inputs, not ``y``; the backward recomputes ``y`` inside the kernel."""

    @staticmethod
    def forward(ctx, x, scale, shift, act_type):
        ctx.save_for_backward(x, scale, shift)
        ctx.act_type = act_type
        return norm_act(x, scale, shift, act_type)

    @staticmethod
    def backward(ctx, dy):
        x, scale, shift = ctx.saved_tensors
        dx, dscale, dshift = norm_act_bwd(x, scale, shift, dy.contiguous(),
                                          ctx.act_type)
        return dx, dscale, dshift, None


def _scale_shift(data, gamma, beta, moving_mean, moving_var, eps, momentum,
                 fix_gamma, use_global_stats, is_train):
    """Per-channel (scale, shift) in the data's dtype, plus the updated
    moving stats — the JAX package's :191-204, op for op.  The moving
    stats come back detached: they are state, not a differentiable output
    (the JAX package returns them as ``has_aux``)."""
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    if is_train and not use_global_stats:
        axes = (0,) + tuple(range(2, data.ndim))
        mean = torch.mean(data, dim=axes)
        var = torch.var(data, dim=axes, unbiased=False)
        new_mm = (moving_mean * momentum + mean * (1 - momentum)).detach()
        new_mv = (moving_var * momentum + var * (1 - momentum)).detach()
    else:
        mean, var = moving_mean, moving_var
        new_mm, new_mv = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    scale = (inv * gamma).to(data.dtype)
    shift = (beta - mean * inv * gamma).to(data.dtype)
    return scale, shift, new_mm, new_mv


def _composed(data, gamma, beta, moving_mean, moving_var, act_type, eps,
              momentum, fix_gamma, use_global_stats, is_train):
    """The registered BatchNorm and Activation ops, one after the other."""
    from ..ops import nn as _nn
    out, new_mm, new_mv = _nn.batch_norm(
        data, gamma, beta, moving_mean, moving_var, eps=eps,
        momentum=momentum, fix_gamma=fix_gamma,
        use_global_stats=use_global_stats, is_train=is_train)
    if act_type:
        out = _nn.activation(out, act_type=act_type)
    return out, new_mm, new_mv


def fused_bn_act_plain(data, gamma, beta, moving_mean, moving_var,
                       act_type=None, eps=0.001, momentum=0.9,
                       fix_gamma=True, use_global_stats=False,
                       is_train=False):
    """Fused BN(+act) in plain torch, with the kernel's math in the
    kernel's order: statistics -> (scale, shift) -> ``x * scale + shift``
    -> act."""
    if act_type not in _KERNEL_ACTS:
        return _composed(data, gamma, beta, moving_mean, moving_var,
                         act_type, eps, momentum, fix_gamma,
                         use_global_stats, is_train)
    scale, shift, new_mm, new_mv = _scale_shift(
        data, gamma, beta, moving_mean, moving_var, eps, momentum,
        fix_gamma, use_global_stats, is_train)
    return norm_act_plain(data, scale, shift, act_type), new_mm, new_mv


def fused_bn_act(data, gamma, beta, moving_mean, moving_var, act_type=None,
                 eps=0.001, momentum=0.9, fix_gamma=True,
                 use_global_stats=False, is_train=False):
    """Fused BN(+activation) through :class:`NormAct`: the CUDA kernels
    for a CUDA tensor, their plain versions for a CPU one.  Semantics
    and returns match the registered BatchNorm op, plus ``act_type``."""
    if act_type not in _KERNEL_ACTS:
        return fused_bn_act_plain(
            data, gamma, beta, moving_mean, moving_var, act_type=act_type,
            eps=eps, momentum=momentum, fix_gamma=fix_gamma,
            use_global_stats=use_global_stats, is_train=is_train)
    scale, shift, new_mm, new_mv = _scale_shift(
        data, gamma, beta, moving_mean, moving_var, eps, momentum,
        fix_gamma, use_global_stats, is_train)
    return NormAct.apply(data.contiguous(), scale.contiguous(),
                         shift.contiguous(), act_type), new_mm, new_mv


def fold_bn_into_conv(weight, bias, gamma, beta, moving_mean, moving_var,
                      eps=0.001, fix_gamma=True):
    """Fold frozen BN statistics into the preceding conv's parameters.

    ``weight``: (O, I/g, *k); ``bias``: (O,) or None.  Returns
    ``(weight', bias')`` such that ``conv(x, w') + b'`` equals
    ``BN(conv(x, w) + b)`` with the moving statistics (inference mode),
    up to float reassociation.
    """
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    scale = gamma * torch.rsqrt(moving_var + eps)
    w = weight * scale.reshape((-1,) + (1,) * (weight.ndim - 1)) \
        .to(weight.dtype)
    b = bias if bias is not None else torch.zeros_like(moving_mean)
    b = ((b - moving_mean) * scale + beta).to(w.dtype)
    return w, b
