"""Tensor ops (port of ``mxnet_tpu/ops/tensor.py``, every op it registers,
in its order): elementwise binary, broadcast, logic and scalar ops, the
unary ops, reductions, ``broadcast_to``/``broadcast_axis``, the matrix
ops (``dot``, ``batch_dot``, ``transpose``, ``Reshape`` with the
reference's special codes, ``slice``, ...), init, indexing, control-flow,
ordering and sampling ops, the optimizer update ops (the rules of the
reference's src/operator/tensor/optimizer_op.cc) and the hidden graph
ops.  Each op is a plain function over ``torch.Tensor``s, so autograd
gives its gradient (``BlockGrad`` is ``detach``); the update ops return
new tensors and callers that keep state assign them.

Where torch's defaults part from the JAX package's, the JAX package's
definitions hold:

- a scalar op rounds its scalar to the array's dtype first
  (``jnp.asarray(scalar, dtype=data.dtype)``), so ``int32 * 2.5``
  multiplies by 2 and stays int32;
- comparison and logic ops return 0/1 in the lhs dtype, not bool;
- ``mod`` follows Python's sign rule (``jnp.mod``: ``torch.remainder``);
- integer sums and products stay in the input's dtype (torch widens them
  to int64); float16/bfloat16 sums and means accumulate in float32;
  ``mean`` and the transcendental ops of an integer array are float32;
- ``argmax``/``argmin``/``argsort``/``topk`` indices are float32;
  ``topk`` is ``lax.top_k`` (on a tie the lower index wins, in both
  directions) and a descending ``sort``/``argsort`` is the flip of the
  stable ascending one (tied indices come out reversed);
- ``one_hot`` gives a zero row for an index out of range, ``take``
  clamps (``clip``) or wraps (``wrap``) its indices before gathering;
- ``gamma`` is ``exp(lgamma(x))`` (the sign is lost for negative x);
  ``round``/``rint`` round half to even.

Ops without tensor inputs (``_zeros``, ``_arange``, the samplers) take
the device to create their result on as ``ctx`` (a ``torch.device``,
which the imperative layer and the executor pass); a sampler draws from
the ``torch.Generator`` it is given as ``rng``.  Nothing here copies to
the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register

# ---------------------------------------------------------------------------
# helpers
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


def torch_dtype(dtype):
    """The ``torch.dtype`` of a dtype given as a name, a numpy type or a
    ``torch.dtype`` (``"bfloat16"`` included)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), np.dtype(name))).dtype


def _device(ctx):
    """The device an op without tensor inputs creates its result on:
    ``ctx`` (a ``torch.device``, as the imperative layer and the executor
    pass it), or the host when None."""
    return torch.device("cpu") if ctx is None else torch.device(ctx)


def _inexact(x):
    """``x`` as a floating tensor: integer and bool arrays become float32,
    as ``jnp``'s ``promote_args_inexact`` makes them (x64 off)."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _scalar(data, scalar):
    """``scalar`` rounded to ``data``'s dtype (``jnp.asarray(scalar,
    dtype=data.dtype)``), as a Python number: torch takes it as an
    operand on any device, with no tensor on the host and no copy."""
    return torch.tensor(scalar, dtype=data.dtype).item()


def _as_operand(like, value):
    """``value`` as a 0-dim tensor beside ``like`` (for ops without a
    Python-scalar form), or ``value`` itself if it is a tensor."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.full((), value, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# elemwise binary (same-shape) — elemwise_binary_op.cc
# ---------------------------------------------------------------------------

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


def _power_fn(lhs, rhs):
    return torch.pow(lhs, rhs)


def _hypot_fn(lhs, rhs):
    lhs = _inexact(lhs)
    rhs = _inexact(_as_operand(lhs, rhs))
    return torch.hypot(lhs, rhs)


def _max_fn(lhs, rhs):
    return torch.maximum(lhs, _as_operand(lhs, rhs))


def _min_fn(lhs, rhs):
    return torch.minimum(lhs, _as_operand(lhs, rhs))


def _mod_fn(lhs, rhs):
    return torch.remainder(lhs, rhs)


@register("_power", input_names=("lhs", "rhs"), aliases=("_Power",))
def _power(lhs, rhs):
    return _power_fn(lhs, rhs)


@register("_maximum", input_names=("lhs", "rhs"), aliases=("_Maximum",))
def _maximum(lhs, rhs):
    return torch.maximum(lhs, rhs)


@register("_minimum", input_names=("lhs", "rhs"), aliases=("_Minimum",))
def _minimum(lhs, rhs):
    return torch.minimum(lhs, rhs)


@register("_hypot", input_names=("lhs", "rhs"), aliases=("_Hypot",))
def _hypot(lhs, rhs):
    return _hypot_fn(lhs, rhs)


@register("_grad_add", input_names=("lhs", "rhs"))
def _grad_add(lhs, rhs):
    """Gradient aggregation add (reference src/executor/graph_executor.cc:90)."""
    return torch.add(lhs, rhs)


# ---------------------------------------------------------------------------
# broadcast binary — elemwise_binary_broadcast_op.cc
# ---------------------------------------------------------------------------

def _broadcast_binary(name, tfn, aliases=()):
    @register(name, input_names=("lhs", "rhs"), aliases=aliases)
    def _op(lhs, rhs, _tfn=tfn):
        return _tfn(lhs, rhs)
    _op.__name__ = name
    return _op


_broadcast_binary("broadcast_add", torch.add, aliases=("broadcast_plus",))
_broadcast_binary("broadcast_sub", torch.sub, aliases=("broadcast_minus",))
_broadcast_binary("broadcast_mul", torch.mul)
_broadcast_binary("broadcast_div", torch.div)
_broadcast_binary("broadcast_mod", _mod_fn)
_broadcast_binary("broadcast_power", _power_fn)
_broadcast_binary("broadcast_maximum", torch.maximum)
_broadcast_binary("broadcast_minimum", torch.minimum)
_broadcast_binary("broadcast_hypot", _hypot_fn)


def _logic(name, tfn, aliases=()):
    @register(name, input_names=("lhs", "rhs"), aliases=aliases)
    def _op(lhs, rhs, _tfn=tfn):
        return _tfn(lhs, rhs).to(lhs.dtype)
    _op.__name__ = name
    return _op


_logic("broadcast_equal", torch.eq, aliases=("_equal", "_Equal"))
_logic("broadcast_not_equal", torch.ne, aliases=("_not_equal", "_Not_Equal"))
_logic("broadcast_greater", torch.gt, aliases=("_greater", "_Greater"))
_logic("broadcast_greater_equal", torch.ge,
       aliases=("_greater_equal", "_Greater_Equal"))
_logic("broadcast_lesser", torch.lt, aliases=("_lesser", "_Lesser"))
_logic("broadcast_lesser_equal", torch.le,
       aliases=("_lesser_equal", "_Lesser_Equal"))
_logic("broadcast_logical_and", torch.logical_and)
_logic("broadcast_logical_or", torch.logical_or)
_logic("broadcast_logical_xor", torch.logical_xor)


# ---------------------------------------------------------------------------
# scalar ops — elemwise_binary_scalar_op.cc
# ---------------------------------------------------------------------------

def _scalar_op(name, fn, aliases=()):
    @register(name, aliases=aliases)
    def _op(data, scalar=0.0, _fn=fn):
        return _fn(data, _scalar(data, scalar))
    _op.__name__ = name
    return _op


def _compare(tfn):
    return lambda a, s: tfn(a, s).to(a.dtype)


_scalar_op("_plus_scalar", lambda a, s: a + s, aliases=("_PlusScalar",))
_scalar_op("_minus_scalar", lambda a, s: a - s, aliases=("_MinusScalar",))
_scalar_op("_rminus_scalar", lambda a, s: s - a, aliases=("_RMinusScalar",))
_scalar_op("_mul_scalar", lambda a, s: a * s, aliases=("_MulScalar",))
_scalar_op("_div_scalar", lambda a, s: a / s, aliases=("_DivScalar",))
# (``s / a`` with a Python s is ``reciprocal(a) * s`` in torch: two roundings)
_scalar_op("_rdiv_scalar", lambda a, s: _as_operand(a, s) / a,
           aliases=("_RDivScalar",))
_scalar_op("_mod_scalar", _mod_fn)
_scalar_op("_rmod_scalar", lambda a, s: _mod_fn(s, a))
_scalar_op("_power_scalar", _power_fn, aliases=("_PowerScalar",))
_scalar_op("_rpower_scalar", lambda a, s: _power_fn(s, a),
           aliases=("_RPowerScalar",))
_scalar_op("_maximum_scalar", _max_fn, aliases=("_MaximumScalar",))
_scalar_op("_minimum_scalar", _min_fn, aliases=("_MinimumScalar",))
_scalar_op("_hypot_scalar", _hypot_fn, aliases=("_HypotScalar",))
_scalar_op("_equal_scalar", _compare(torch.eq), aliases=("_EqualScalar",))
_scalar_op("_not_equal_scalar", _compare(torch.ne),
           aliases=("_NotEqualScalar",))
_scalar_op("_greater_scalar", _compare(torch.gt), aliases=("_GreaterScalar",))
_scalar_op("_greater_equal_scalar", _compare(torch.ge),
           aliases=("_GreaterEqualScalar",))
_scalar_op("_lesser_scalar", _compare(torch.lt), aliases=("_LesserScalar",))
_scalar_op("_lesser_equal_scalar", _compare(torch.le),
           aliases=("_LesserEqualScalar",))


@register("smooth_l1")
def smooth_l1(data, scalar=1.0):
    """Smooth L1 (reference src/operator/tensor/elemwise_binary_scalar_op_extended.cc)."""
    s2 = scalar * scalar
    absd = torch.abs(data)
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * data * data,
                       absd - 0.5 / s2)


# ---------------------------------------------------------------------------
# unary — elemwise_unary_op.cc, mshadow_op.h kernels
# ---------------------------------------------------------------------------

def _unary(name, tfn, aliases=()):
    @register(name, aliases=aliases)
    def _op(data, _tfn=tfn):
        return _tfn(data)
    _op.__name__ = name
    return _op


def _on_floats(tfn):
    """``tfn`` of a floating array; an integer array is returned as it
    is (rounding an integer is the identity)."""
    return lambda x: tfn(x) if x.is_floating_point() else x.clone()


def _inexact_op(tfn):
    """``tfn`` computed on ``x`` promoted as ``jnp`` promotes it."""
    return lambda x: tfn(_inexact(x))


def _cbrt(x):
    x = _inexact(x)
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("ceil", _on_floats(torch.ceil))
_unary("floor", _on_floats(torch.floor))
_unary("round", _on_floats(torch.round))
_unary("rint", _inexact_op(torch.round))
_unary("trunc", _on_floats(torch.trunc))
_unary("fix", _on_floats(torch.trunc))
_unary("square", torch.square)
_unary("sqrt", _inexact_op(torch.sqrt))
_unary("rsqrt", torch.rsqrt)
_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("exp", _inexact_op(torch.exp))
_unary("log", _inexact_op(torch.log))
_unary("log10", _inexact_op(torch.log10))
_unary("log2", _inexact_op(torch.log2))
_unary("log1p", _inexact_op(torch.log1p))
_unary("expm1", _inexact_op(torch.expm1))
_unary("sin", _inexact_op(torch.sin))
_unary("cos", _inexact_op(torch.cos))
_unary("tan", _inexact_op(torch.tan))
_unary("arcsin", _inexact_op(torch.asin))
_unary("arccos", _inexact_op(torch.acos))
_unary("arctan", _inexact_op(torch.atan))
_unary("sinh", _inexact_op(torch.sinh))
_unary("cosh", _inexact_op(torch.cosh))
_unary("tanh", _inexact_op(torch.tanh))
_unary("arcsinh", _inexact_op(torch.asinh))
_unary("arccosh", _inexact_op(torch.acosh))
_unary("arctanh", _inexact_op(torch.atanh))
_unary("degrees", _inexact_op(torch.rad2deg))
_unary("radians", _inexact_op(torch.deg2rad))
_unary("relu", torch.relu)
_unary("sigmoid", torch.sigmoid)
_unary("softsign", lambda x: x / (torch.abs(x) + 1))
_unary("negative", torch.neg)
_unary("reciprocal", _inexact_op(torch.reciprocal))
_unary("gamma", lambda x: torch.exp(torch.lgamma(x)))
_unary("gammaln", torch.lgamma)
_unary("erf", torch.erf)
_unary("erfinv", torch.erfinv)
_unary("logical_not", lambda x: (x == 0).to(x.dtype))


@register("identity", aliases=("_copy", "_identity_with_attr_like_rhs"))
def identity(data):
    return data


@register("BlockGrad", aliases=("stop_gradient", "block_grad"))
def block_grad(data):
    """Forward identity, zero gradient (reference src/operator/block_grad.cc)."""
    return data.detach()


@register("Cast", aliases=("cast",))
def cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


@register("clip")
def clip(data, a_min=None, a_max=None):
    return torch.clamp(data, a_min, a_max)


@register("softmax", aliases=("Softmax",))
def softmax(data, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.softmax(data, dim=axis)


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)


# ---------------------------------------------------------------------------
# reductions — broadcast_reduce_op_value.cc
# ---------------------------------------------------------------------------

_HALF = (torch.float16, torch.bfloat16)


def _sum(x, axes, keepdims):
    if x.dtype in _HALF:
        # accumulate in float32, as XLA does (torch's CPU sum of a long
        # half row accumulates in the half type and drifts)
        return torch.sum(x, dim=axes, keepdim=keepdims,
                         dtype=torch.float32).to(x.dtype)
    # integer sums stay in the input's dtype (torch widens to int64)
    dtype = None if x.is_floating_point() else x.dtype
    return torch.sum(x, dim=axes, keepdim=keepdims, dtype=dtype)


class _ProdDim(torch.autograd.Function):
    """The product over one axis, with a backward that stays on the
    device (torch's own looks for zeros in the input on the host): each
    element's gradient is the product of the others, from exclusive
    cumulative products from both ends, which also holds at zeros."""

    @staticmethod
    def forward(ctx, x, dim, keepdim):
        ctx.save_for_backward(x)
        ctx.dim, ctx.keepdim = dim, keepdim
        return torch.prod(x, dim=dim, keepdim=keepdim)

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        dim, n = ctx.dim, x.shape[ctx.dim]
        if not ctx.keepdim:
            grad = grad.unsqueeze(dim)
        if n == 0:
            return torch.zeros_like(x), None, None
        ones = torch.ones_like(x.narrow(dim, 0, 1))

        def exclusive(v):
            return torch.cumprod(torch.cat([ones, v.narrow(dim, 0, n - 1)],
                                           dim), dim)
        others = exclusive(x) * exclusive(x.flip(dim)).flip(dim)
        return grad * others, None, None


def _prod(x, axes, keepdims):
    for a in sorted(axes, reverse=True):
        if x.is_floating_point():
            x = _ProdDim.apply(x, a, keepdims)
        else:   # integer products stay in the input's dtype
            x = torch.prod(x, dim=a, keepdim=keepdims, dtype=x.dtype)
    return x


def _nansum(x, axes, keepdims):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return _sum(x, axes, keepdims)


def _nanprod(x, axes, keepdims):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _prod(x, axes, keepdims)


def _mean(x, axes, keepdims):
    if x.dtype in _HALF:
        return torch.mean(x, dim=axes, keepdim=keepdims,
                          dtype=torch.float32).to(x.dtype)
    return torch.mean(_inexact(x), dim=axes, keepdim=keepdims)


def _reduce(name, tfn, aliases=()):
    @register(name, aliases=aliases)
    def _op(data, axis=None, keepdims=False, exclude=False, _tfn=tfn):
        axes = _reduce_axes(data, axis, exclude)
        if not axes:   # jnp reduces over no axis: the array itself
            return _tfn(data.unsqueeze(0), (0,), False)
        return _tfn(data, axes, bool(keepdims))
    _op.__name__ = name
    return _op


_reduce("sum", _sum, aliases=("sum_axis",))
_reduce("mean", _mean)
_reduce("prod", _prod)
_reduce("nansum", _nansum)
_reduce("nanprod", _nanprod)
_reduce("max", lambda x, a, k: torch.amax(x, dim=a, keepdim=k),
        aliases=("max_axis",))
_reduce("min", lambda x, a, k: torch.amin(x, dim=a, keepdim=k),
        aliases=("min_axis",))


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False):
    axes = _reduce_axes(data, axis)
    if ord == 1:
        return _sum(torch.abs(data), axes, bool(keepdims))
    return torch.sqrt(_inexact(_sum(torch.square(data), axes,
                                    bool(keepdims))))


def _arg_reduce(tfn, data, axis, keepdims):
    if axis is None:
        out = tfn(data.reshape(-1), dim=0)
        if keepdims:
            out = out.reshape((1,) * data.ndim)
    else:
        out = tfn(data, dim=_norm_axis(axis, data.ndim),
                  keepdim=bool(keepdims))
    return out.to(torch.float32)


@register("argmax")
def argmax(data, axis=None, keepdims=False):
    return _arg_reduce(torch.argmax, data, axis, keepdims)


@register("argmin")
def argmin(data, axis=None, keepdims=False):
    return _arg_reduce(torch.argmin, data, axis, keepdims)


@register("argmax_channel")
def argmax_channel(data):
    """argmax over axis 1 (reference broadcast_reduce_op_value.cc argmax_channel)."""
    return torch.argmax(data, dim=1).to(torch.float32)


# ---------------------------------------------------------------------------
# broadcast_to / broadcast_axis
# ---------------------------------------------------------------------------

@register("broadcast_to")
def broadcast_to(data, shape=()):
    shape = _tuple(shape)
    target = tuple(d if s == 0 else s for s, d in zip(shape, data.shape))
    return data.expand(target).contiguous()


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=()):
    axis, size = _tuple(axis), _tuple(size)
    target = list(data.shape)
    for a, s in zip(axis, size):
        target[_norm_axis(a, data.ndim)] = s
    return data.expand(tuple(target)).contiguous()


# ---------------------------------------------------------------------------
# matrix ops — matrix_op.cc
# ---------------------------------------------------------------------------

def _reverse_axes(x):
    return x.permute(tuple(reversed(range(x.ndim))))


def _int_contract(lhs, rhs):
    """``lhs`` (..., K) times ``rhs`` (K, ...) in integer arithmetic
    (cuBLAS has no int32 product): a broadcast multiply summed over K,
    wrapping as the reference's int32 dot wraps."""
    lead, trail = lhs.shape[:-1], rhs.shape[1:]
    a = lhs.reshape(-1, lhs.shape[-1], 1)
    b = rhs.reshape(rhs.shape[0], -1).unsqueeze(0)
    out = torch.sum(a * b, dim=1, dtype=lhs.dtype)
    return out.reshape(lead + trail)


@register("dot", input_names=("lhs", "rhs"))
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """dot (reference src/operator/tensor/matrix_op.cc dot): the last axis
    of ``lhs`` against the first of ``rhs``."""
    if transpose_a:
        lhs = _reverse_axes(lhs)
    if transpose_b:
        rhs = _reverse_axes(rhs)
    if not lhs.is_floating_point():
        if lhs.ndim == 1 and rhs.ndim == 1:
            return torch.sum(lhs * rhs, dtype=lhs.dtype)
        return _int_contract(lhs, rhs)
    if lhs.ndim == 1 and rhs.ndim == 1:
        return torch.dot(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=([lhs.ndim - 1], [0]))


@register("batch_dot", input_names=("lhs", "rhs"))
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    if transpose_a:
        lhs = torch.swapaxes(lhs, -1, -2)
    if transpose_b:
        rhs = torch.swapaxes(rhs, -1, -2)
    if not lhs.is_floating_point():
        return torch.sum(lhs.unsqueeze(-1) * rhs.unsqueeze(-3), dim=-2,
                         dtype=lhs.dtype)
    return torch.matmul(lhs, rhs)


@register("transpose")
def transpose(data, axes=()):
    axes = _tuple(axes)
    if not axes:
        axes = tuple(reversed(range(data.ndim)))
    return data.permute(axes)


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


def _take_slice(data, axis, sl):
    """``data`` sliced by the Python slice ``sl`` along ``axis``; torch
    slicing takes no negative step, so those gather arange indices."""
    start, stop, step = sl.indices(data.shape[axis])
    if step > 0:
        return data[(slice(None),) * axis + (slice(start, stop, step),)]
    idx = torch.arange(start, stop, step, device=data.device)
    return torch.index_select(data, axis, idx)


@register("slice", aliases=("crop",))
def slice_op(data, begin=(), end=(), step=()):
    begin, end = _tuple(begin), _tuple(end)
    step = _tuple(step) if step else (1,) * len(begin)
    for i in range(min(data.ndim, len(begin))):
        b = begin[i]
        e = end[i] if i < len(end) else None
        s = step[i] if i < len(step) and step[i] else 1
        data = _take_slice(data, i, slice(b, e, s))
    return data


@register("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    axis = _norm_axis(axis, data.ndim)
    n = data.shape[axis]
    if end is None:
        end = n
    if end < 0:
        end += n
    if begin < 0:
        begin += n
    return data.narrow(axis, begin, end - begin)


@register("reverse", aliases=("flip",))
def reverse(data, axis=()):
    return torch.flip(data, dims=_norm_axis(_tuple(axis), data.ndim))


@register("repeat")
def repeat(data, repeats=1, axis=None):
    return torch.repeat_interleave(data, repeats,
                                   dim=_norm_axis(axis, data.ndim))


@register("tile")
def tile(data, reps=()):
    return torch.tile(data, _tuple(reps))


def _arg_names(attrs):
    return tuple("arg%d" % i for i in range(int(attrs.get("num_args", 1))))


@register("stack", variable_inputs=True, input_names=_arg_names)
def stack(*args, num_args=1, axis=0):
    return torch.stack(args, dim=axis)


@register("add_n", variable_inputs=True, aliases=("ElementWiseSum", "_sum"),
          input_names=_arg_names)
def add_n(*args, num_args=None):
    """reference src/operator/tensor/elemwise_sum.cc"""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


# ---------------------------------------------------------------------------
# init ops — init_op.cc
# ---------------------------------------------------------------------------

@register("_zeros", input_names=(), aliases=("zeros",))
def _zeros(shape=(), dtype="float32", ctx=None):
    return torch.zeros(_tuple(shape), dtype=torch_dtype(dtype),
                       device=_device(ctx))


@register("_ones", input_names=(), aliases=("ones",))
def _ones(shape=(), dtype="float32", ctx=None):
    return torch.ones(_tuple(shape), dtype=torch_dtype(dtype),
                      device=_device(ctx))


@register("_full", input_names=(), aliases=("full",))
def _full(shape=(), value=0.0, dtype="float32", ctx=None):
    return torch.full(_tuple(shape), value, dtype=torch_dtype(dtype),
                      device=_device(ctx))


@register("_arange", input_names=(), aliases=("arange",))
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
            ctx=None):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                       device=_device(ctx))
    if repeat != 1:
        out = torch.repeat_interleave(out, repeat)
    return out


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


# ---------------------------------------------------------------------------
# indexing — indexing_op.cc
# ---------------------------------------------------------------------------

def _index(indices):
    """Index values as ``astype(int32)`` makes them: truncated toward 0
    (int64 for torch's gathers)."""
    return indices.to(torch.int32).to(torch.int64)


def _wrap_negative(idx, n):
    """Negative indices count from the end (``take_along_axis``)."""
    return torch.where(idx < 0, idx + n, idx)


@register("take", input_names=("a", "indices"))
def take(a, indices, axis=0, mode="clip"):
    axis = _norm_axis(axis, a.ndim)
    n = a.shape[axis]
    idx = _index(indices)
    idx = idx.clamp(0, n - 1) if mode == "clip" else torch.remainder(idx, n)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + indices.shape + a.shape[axis + 1:])


@register("batch_take", input_names=("a", "indices"))
def batch_take(a, indices):
    idx = _wrap_negative(_index(indices), a.shape[1])
    return torch.gather(a, 1, idx.unsqueeze(1))[:, 0]


def _one_hot(indices, depth, dtype):
    """Rows of ``depth`` with a one at each index; all zero for an index
    out of range (``jax.nn.one_hot``)."""
    classes = torch.arange(depth, device=indices.device)
    return (_index(indices).unsqueeze(-1) == classes).to(dtype)


@register("one_hot", input_names=("indices",))
def one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    oh = _one_hot(indices, int(depth), torch_dtype(dtype))
    return oh * on_value + (1.0 - oh) * off_value


@register("_onehot_encode", input_names=("index", "out"),
          aliases=("onehot_encode",))
def _onehot_encode(index, out):
    """One-hot encode ``index`` into the shape/dtype of ``out`` (the
    reference's in-place _onehot_encode, src/ndarray/ndarray.cc:751,
    ndarray_function-inl.h:64)."""
    return _one_hot(index, out.shape[1], out.dtype)


@register("pick", input_names=("data", "index"))
def pick(data, index, axis=1, keepdims=False):
    axis = _norm_axis(axis, data.ndim)
    idx = _wrap_negative(_index(index), data.shape[axis]).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    if not keepdims:
        out = torch.squeeze(out, dim=axis)
    return out


@register("choose_element_0index", input_names=("lhs", "rhs"))
def choose_element_0index(lhs, rhs):
    """out[i] = lhs[i, rhs[i]] — the reference's MatChooseRowElem
    (src/ndarray/ndarray.cc:755, ndarray_function-inl.h:84)."""
    return torch.gather(lhs, 1, _index(rhs).unsqueeze(1))[:, 0]


@register("fill_element_0index", input_names=("lhs", "mhs", "rhs"))
def fill_element_0index(lhs, mhs, rhs):
    """out = lhs with out[i, rhs[i]] = mhs[i] — the reference's
    MatFillRowElem (src/ndarray/ndarray.cc:761, ndarray_function-inl.h:101)."""
    return torch.scatter(lhs, 1, _index(rhs).unsqueeze(1),
                         mhs.to(lhs.dtype).unsqueeze(1))


# ---------------------------------------------------------------------------
# control flow — control_flow_op.cc
# ---------------------------------------------------------------------------

@register("where", input_names=("condition", "x", "y"))
def where(condition, x, y):
    if condition.ndim == 1 and x.ndim > 1:
        shape = (-1,) + (1,) * (x.ndim - 1)
        condition = condition.reshape(shape)
    return torch.where(condition != 0, x, y)


# ---------------------------------------------------------------------------
# ordering — ordering_op.cc
# ---------------------------------------------------------------------------

def _topk_num_outputs(attrs):
    return 2 if str(attrs.get("ret_typ", "indices")) == "both" else 1


@register("topk", num_outputs=_topk_num_outputs)
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False):
    axis = _norm_axis(axis, data.ndim)
    src = torch.swapaxes(data, axis, -1)
    # lax.top_k: the k largest, the lower index first on a tie — the head
    # of a stable descending sort (ascending: of a stable ascending one)
    vals, idxs = torch.sort(src, dim=-1, descending=not is_ascend,
                            stable=True)
    vals, idxs = vals[..., :k], idxs[..., :k]
    if ret_typ == "mask":
        mask = torch.zeros_like(src).scatter(
            -1, idxs, torch.ones((), dtype=src.dtype,
                                 device=src.device).expand(idxs.shape))
        return torch.swapaxes(mask, axis, -1)
    vals = torch.swapaxes(vals, axis, -1)
    idxs = torch.swapaxes(idxs, axis, -1).to(torch.float32)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idxs
    return idxs


@register("sort")
def sort(data, axis=-1, is_ascend=True):
    axis = _norm_axis(axis, data.ndim)
    out = torch.sort(data, dim=axis, stable=True).values
    if not is_ascend:
        out = torch.flip(out, dims=(axis,))
    return out


@register("argsort")
def argsort(data, axis=-1, is_ascend=True):
    axis = _norm_axis(axis, data.ndim)
    out = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, dims=(axis,))
    return out.to(torch.float32)


# ---------------------------------------------------------------------------
# sampling — sample_op.cc
# ---------------------------------------------------------------------------

@register("_sample_uniform", input_names=(), needs_rng=True,
          aliases=("uniform", "_random_uniform", "random_uniform"))
def _sample_uniform(low=0.0, high=1.0, shape=(), dtype="float32", ctx=None,
                    rng=None):
    out = torch.empty(_tuple(shape), dtype=torch_dtype(dtype),
                      device=_device(ctx))
    return out.uniform_(low, high, generator=rng)


@register("_sample_normal", input_names=(), needs_rng=True,
          aliases=("normal", "_random_normal", "random_normal"))
def _sample_normal(loc=0.0, scale=1.0, shape=(), dtype="float32", ctx=None,
                   rng=None):
    out = torch.empty(_tuple(shape), dtype=torch_dtype(dtype),
                      device=_device(ctx))
    return loc + scale * out.normal_(generator=rng)


@register("_sample_gamma", input_names=(), needs_rng=True,
          aliases=("gamma_sample",))
def _sample_gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32", ctx=None,
                  rng=None):
    conc = torch.full(_tuple(shape), float(alpha), dtype=torch.float32,
                      device=_device(ctx))
    draw = torch._standard_gamma(conc, generator=rng)
    return draw.to(torch_dtype(dtype)) * beta


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


# ---------------------------------------------------------------------------
# loss helpers — loss_binary_op.cc
# ---------------------------------------------------------------------------

@register("softmax_cross_entropy", input_names=("data", "label"))
def softmax_cross_entropy(data, label):
    """reference src/operator/loss_binary_op.cc — summed cross entropy."""
    logp = torch.log_softmax(data, dim=-1)
    picked = torch.gather(logp, -1, _index(label).unsqueeze(-1))
    return -torch.sum(picked)


@register("_CrossDeviceCopy", hidden=True)
def _cross_device_copy(data):
    """Placement-boundary copy node (reference cross_device_copy.cc); the
    port binds one device, so graphs that carry it run it as identity."""
    return data


def _slice_like_infer(attrs, in_shapes):
    lhs = in_shapes[0]
    if lhs is None:
        return list(in_shapes), [None], []
    new_in = [tuple(s) if s is not None else None for s in in_shapes]
    if len(in_shapes) > 1 and in_shapes[1] is None:
        # infer rhs as the sliced extent (reference SliceAssignOpShape)
        begin = attrs.get("begin", ())
        end = attrs.get("end", ())
        step = attrs.get("step", ()) or (None,) * len(begin)
        rhs = list(lhs)
        for ax, (b, e, st) in enumerate(zip(begin, end, step)):
            sl = slice(b, e, st)
            start, stop, stride = sl.indices(lhs[ax])
            rhs[ax] = max(0, -(-(stop - start) // stride))
        new_in[1] = tuple(rhs)
    return new_in, [tuple(lhs)], []


def _int_or_none(v):
    return None if v is None else int(v)


@register("_slice_assign", input_names=("lhs", "rhs"),
          aliases=("_crop_assign",), infer_shape=_slice_like_infer,
          hidden=True)
def _slice_assign(lhs, rhs, begin=(), end=(), step=()):
    """lhs with lhs[begin:end] replaced by rhs (reference matrix_op
    _slice_assign / _crop_assign — the graph form of x[a:b] = y).
    begin/end entries may be None (full extent), like the slice op."""
    idx = tuple(slice(_int_or_none(b), _int_or_none(e),
                      _int_or_none(s) if s else None)
                for b, e, s in zip(begin, end,
                                   step or (None,) * len(begin)))
    out = lhs.clone()
    out[idx] = rhs.to(lhs.dtype)
    return out


@register("_crop_assign_scalar", infer_shape=_slice_like_infer, hidden=True)
def _crop_assign_scalar(data, scalar=0.0, begin=(), end=()):
    """data with data[begin:end] = scalar (reference matrix_op
    _crop_assign_scalar — the graph form of x[a:b] = c); None = full
    extent."""
    idx = tuple(slice(_int_or_none(b), _int_or_none(e))
                for b, e in zip(begin, end))
    out = data.clone()
    out[idx] = scalar
    return out
