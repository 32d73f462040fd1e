"""pool_act — pooling/activation fusion and the shifted-slice pooling.

Port of ``mxnet_tpu/kernels/pool_act.py``.  Three rewrites
(:func:`mxnet_tpu_torch.mxfuse.pass_pool_act`):

- **act → max-pool reorder** (:func:`make_act_then_maxpool`): every
  registered activation type is monotone non-decreasing, so it commutes
  with max pooling bit for bit — ``f(max(a, b)) == max(f(a), f(b))``.
  Pooling first shrinks the tensor the activation touches by the pool
  stride squared.  Only under the ``valid`` convention: ``full`` (ceil)
  windows can cover only -inf padding, where the two no longer commute.
- **pool → act collapse** (:func:`make_pool_then_act`): the same
  composition as ONE plan entry.
- **shifted-slice pooling** (:func:`pooling_opt`, used by every override
  here and by standalone Pooling entries): the same pooling as k² strided
  slices of the padded input combined by ``maximum``/``add``.  Only for
  2-D, non-global, ``valid`` windows, for max pooling only on the
  inference path (its backward breaks ties on another window element than
  the registered op's), and only up to a spatial extent (input H * W) that
  depends on the device:

  - on the CPU, :data:`POOL_SLICE_MAX_SPATIAL`, the JAX package's gate,
    kept for parity with it;
  - on CUDA, :data:`POOL_SLICE_MAX_SPATIAL_CUDA`, set from the slice form
    timed against the registered ``Pooling`` op at Inception-BN's pooling
    shapes on an H100 by ``chip_smoke.py``'s ``phase_pool_gate``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["make_act_then_maxpool", "make_pool_then_act", "make_pool_opt",
           "pooling_opt", "slice_pool_eligible", "POOL_SLICE_MAX_SPATIAL",
           "POOL_SLICE_MAX_SPATIAL_CUDA"]

#: input H * W up to which the CPU path takes the slice form (the JAX
#: package's gate)
POOL_SLICE_MAX_SPATIAL = 3200
#: input H * W up to which a CUDA tensor takes the slice form: 0, never.
#: At Inception-BN's ten batch-32 pooling sites (H * W from 112² down to
#: 7²) the registered op (``F.max_pool2d`` / ``F.avg_pool2d``, one kernel)
#: ran in 0.40-0.60 of the slice form's device time (9 strided passes and
#: 8 launches) on an H100 80GB HBM3 at 700 W (``chip_smoke.py``
#: ``phase_pool_gate``; PERF.md)
POOL_SLICE_MAX_SPATIAL_CUDA = 0


def _slice_pool(data, kernel, stride, pad, op, init):
    _n, _c, h, w = data.shape
    kh, kw = kernel
    sh, sw = stride
    ph, pw = pad
    xp = F.pad(data, (pw, pw, ph, ph), value=init) if ph or pw else data
    hp, wp = h + 2 * ph, w + 2 * pw
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    out = None
    for di in range(kh):
        for dj in range(kw):
            v = xp[:, :, di:di + (ho - 1) * sh + 1:sh,
                   dj:dj + (wo - 1) * sw + 1:sw]
            out = v if out is None else op(out, v)
    return out


def _pool_geometry(pool_attrs):
    kernel = pool_attrs.get("kernel") or ()
    stride = pool_attrs.get("stride") or (1,) * len(kernel)
    pad = pool_attrs.get("pad") or (0,) * len(kernel)
    return kernel, stride, pad


def slice_pool_eligible(data, pool_attrs, is_train=False, limit=None):
    """Whether :func:`pooling_opt` takes the slice form for ``data``:
    2-D, non-global, ``valid``, max/avg/sum (max only when not training),
    and H * W at most ``limit`` (default: the device's gate)."""
    kernel, _stride, _pad = _pool_geometry(pool_attrs)
    pool_type = str(pool_attrs.get("pool_type", "max"))
    if limit is None:
        limit = POOL_SLICE_MAX_SPATIAL_CUDA if data.is_cuda \
            else POOL_SLICE_MAX_SPATIAL
    return (data.ndim == 4 and len(kernel) == 2
            and not pool_attrs.get("global_pool", False)
            and str(pool_attrs.get("pooling_convention", "valid")) == "valid"
            and pool_type in ("max", "avg", "sum")
            and int(data.shape[2]) * int(data.shape[3]) <= limit
            and not (pool_type == "max" and is_train))


def pooling_opt(data, pool_attrs, is_train=False, limit=None):
    """The routed pooling: the shifted-slice form when
    :func:`slice_pool_eligible` (``limit`` overrides the device's gate, for
    timing both forms), the registered ``Pooling`` op otherwise."""
    from ..ops.nn import pooling
    if not slice_pool_eligible(data, pool_attrs, is_train, limit):
        return pooling(data, **pool_attrs)
    kernel, stride, pad = _pool_geometry(pool_attrs)
    kernel = tuple(int(k) for k in kernel)
    stride = tuple(int(s) for s in (stride if len(stride) == 2
                                    else (stride,) * 2))
    pad = tuple(int(p) for p in (pad if len(pad) == 2 else (pad,) * 2))
    pool_type = str(pool_attrs.get("pool_type", "max"))
    if pool_type == "max":
        init = float("-inf") if data.is_floating_point() \
            else torch.iinfo(data.dtype).min
        return _slice_pool(data, kernel, stride, pad, torch.maximum, init)
    out = _slice_pool(data, kernel, stride, pad, torch.add, 0.0)
    if pool_type == "avg":
        out = out / float(kernel[0] * kernel[1])
    return out


def make_act_then_maxpool(act_type):
    """Override body for the Pooling node of an act→max-pool pair: pool
    the PRE-activation input (the act entry is a passthrough), then
    activate the pooled tensor.  Bitwise-equal to act-then-pool."""
    def fused(data, is_train=False, **pool_attrs):
        from ..ops.nn import activation
        return activation(pooling_opt(data, pool_attrs, is_train),
                          act_type=act_type)
    return fused


def make_pool_then_act(pool_attrs):
    """Override body for the Activation node of a pool→act pair: the pool
    entry is a passthrough; this entry runs the original pool-then-activate
    composition in one call."""
    def fused(data, is_train=False, **act_attrs):
        from ..ops.nn import activation
        return activation(pooling_opt(data, pool_attrs, is_train),
                          **act_attrs)
    return fused


def make_pool_opt():
    """Override body for a standalone Pooling entry: same math, the routed
    (possibly shifted-slice) lowering."""
    def fused(data, is_train=False, **pool_attrs):
        return pooling_opt(data, pool_attrs, is_train)
    return fused
