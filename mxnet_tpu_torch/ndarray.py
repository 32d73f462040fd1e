"""NDArray — the imperative tensor type, over a ``torch.Tensor``.

Port of ``mxnet_tpu/ndarray.py``: the array type (a mutable cell holding
one tensor on its context's device; slicing, ``reshape``, ``T`` and
``expand_dims`` give views, ``copy`` and ``astype`` copies) with the
reference's properties, sync methods and Python protocol, its arithmetic,
comparison and in-place operators dispatched through the op registry
(arrays to the ``broadcast_*`` ops, Python and numpy scalars to the
``_*_scalar`` ops, anything else ``NotImplemented``; ``==`` gives an
NDArray and ``__hash__`` is identity, as in the reference), the creation
functions ``array``/``zeros``/``ones``/``empty``/``full``/``arange``/
``concatenate``/``moveaxis``/``onehot_encode``, ``waitall``, the
imperative op surface (every registered op as ``mx.nd.<op>``,
:func:`_init_ndarray_module`; ops registered later, such as rtc kernels,
inject themselves), and ``.params`` serialization byte-identical to
``mxnet_tpu/ndarray.py:501-575`` (the reference's format,
src/ndarray/ndarray.cc:593-676, kMXAPINDArrayListMagic=0x112), so a file
written by either package loads in the other.

Only ``asnumpy``, ``asscalar``, ``__bool__``, ``__float__``, ``__int__``,
``__array__``, ``wait_to_read`` and ``waitall`` wait for the device or
copy to the host; every other method and operator stays on the device.
"""
from __future__ import annotations

import functools
import inspect
import struct

import numpy as np
import torch

from .base import MXNetError
from .context import Context, cpu, current_context
from .ops.registry import OP_REGISTRY, fn_signature_info, get_op
from .ops import tensor as _tensor_ops
from .ops.tensor import torch_dtype as _torch_dtype

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concatenate", "moveaxis", "onehot_encode", "load", "save",
           "tensor_from_numpy", "waitall"]

# torch dtype <-> reference mshadow type_flag (mshadow/base.h kFloat32=0 ...)
_DTYPE_TO_FLAG = {
    torch.float32: 0,
    torch.float64: 1,
    torch.float16: 2,
    torch.uint8: 3,
    torch.int32: 4,
    # the JAX package's extension flag (not in the reference)
    torch.bfloat16: 100,
}
_FLAG_TO_DTYPE = {v: k for k, v in _DTYPE_TO_FLAG.items()}


def tensor_from_numpy(arr):
    """A CPU tensor holding a copy of a numpy array.  bfloat16 arrays (the
    ``ml_dtypes`` type the JAX package's ``asnumpy`` returns) carry over
    through their bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _tensor_bytes(tensor):
    """The raw little-endian bytes of a tensor, row-major."""
    t = tensor.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


class NDArray(object):
    """A tensor bound to a :class:`Context` (reference
    python/mxnet/ndarray.py:NDArray)."""

    __slots__ = ("_data", "_ctx")

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = tensor_from_numpy(data)
        self._ctx = ctx if ctx is not None else current_context()
        self._data = data.to(self._ctx.torch_device)

    @staticmethod
    def _from_torch(data, ctx):
        """Wrap a tensor that already lies on ``ctx``'s device."""
        arr = NDArray.__new__(NDArray)
        arr._ctx = ctx
        arr._data = data
        return arr

    def _view(self, data):
        return NDArray._from_torch(data, self._ctx)

    # -- basic properties -------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def dtype(self):
        """The element type as the reference gives it
        (``mxnet_tpu/ndarray.py:167-169``): the numpy scalar type, such as
        ``np.float32``, ``np.float16`` or ``np.int32``, so ``a.dtype ==
        np.float32`` holds.  Divergence: numpy has no bfloat16 and the
        port does not import ``ml_dtypes``, so a bfloat16 array answers
        the string ``"bfloat16"`` (the name of the reference's
        ``ml_dtypes.bfloat16``; every dtype argument of the port takes
        it).  Internal code reads ``._data.dtype``, the ``torch.dtype``."""
        return _numpy_type(self._data.dtype)

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def T(self):
        """The transpose (all axes reversed), a view."""
        return self._view(self._data.permute(
            tuple(reversed(range(self._data.ndim)))))

    @property
    def handle(self):
        """The underlying ``torch.Tensor``."""
        return self._data

    # -- sync / transfer --------------------------------------------------
    def wait_to_read(self):
        """Wait until the work queued on this array's device stream is
        done."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A numpy copy on the host (waits for the device), never a view
        of a host array's storage.  bfloat16 has no numpy type here, so
        it comes back as float32 (exact)."""
        t = self._data.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    def asscalar(self):
        """The value of a one-element array, as a numpy scalar."""
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def astype(self, dtype):
        """A copy in another dtype."""
        return self._view(self._data.to(_torch_dtype(dtype), copy=True))

    def copyto(self, other):
        """Copy into another NDArray or to a Context."""
        if isinstance(other, NDArray):
            other._data.copy_(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data, ctx=other)
        raise TypeError("copyto does not support type " + str(type(other)))

    def copy(self):
        """A new NDArray holding a copy, on the same context."""
        return self._view(self._data.clone())

    def as_in_context(self, context):
        if context == self._ctx:
            return self
        return self.copyto(context)

    # -- shape manipulation ----------------------------------------------
    def reshape(self, shape, reverse=False):
        """A view in a new shape, with the ``Reshape`` op's special codes
        (0, -1, -2, -3, -4)."""
        if isinstance(shape, int):
            shape = (shape,)
        return self._view(self._data.reshape(
            _tensor_ops.infer_reshape(self.shape, tuple(shape), reverse)))

    def broadcast_to(self, shape):
        """A new array of ``shape`` with this one broadcast over it."""
        return self._view(self._data.expand(tuple(shape)).contiguous())

    def expand_dims(self, axis):
        return self._view(self._data.unsqueeze(axis))

    def flatten(self):
        return self._view(self._data.reshape(self.shape[0], -1))

    def transpose(self, axes=None):
        if axes is None:
            return self.T
        return self._view(self._data.permute(tuple(axes)))

    def slice(self, start, stop):
        return self[start:stop]

    def slice_axis(self, axis, begin, end):
        n = self._data.shape[axis]
        begin = begin + n if begin < 0 else begin
        end = end + n if end < 0 else end
        return self._view(self._data.narrow(axis, begin, end - begin))

    # -- indexing ---------------------------------------------------------
    @staticmethod
    def _key(key):
        """An NDArray key indexes with its values as integers (the
        reference's ``astype(int32)``)."""
        if isinstance(key, NDArray):
            return key._data.to(torch.int32).to(torch.int64)
        return key

    def __getitem__(self, key):
        """``a[i]``, ``a[i:j]``: a view sharing this array's storage, as
        the reference's slicing gives; an NDArray key gathers rows."""
        return self._view(self._data[self._key(key)])

    def __setitem__(self, key, value):
        """``a[:] = v`` writes ``v`` (array, tensor or scalar) into this
        array's storage, broadcasting and casting to its dtype."""
        key = self._key(key)
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            if np.isscalar(value):
                self._data[key] = value
                return
            value = tensor_from_numpy(value)
        self._data[key] = value.to(self._data.device, self._data.dtype)

    def __len__(self):
        return self.shape[0]

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    # -- python protocol (the sync points) --------------------------------
    def __repr__(self):
        return "%s\n<%s %s @%s>" % (
            str(self.asnumpy()), self.__class__.__name__,
            "x".join(map(str, self.shape)), self._ctx)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # -- arithmetic (dispatched through the op registry, as the reference's
    #    _binary, mxnet_tpu/ndarray.py:317-326) ----------------------------
    def _binary(self, other, op_name, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return _invoke(get_op(op_name), (a, b), {}, ctx=self._ctx)[0]
        if isinstance(other, (int, float, np.number)):
            return _invoke(get_op(scalar_op), (self,),
                           {"scalar": float(other)}, ctx=self._ctx)[0]
        return NotImplemented

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "broadcast_sub", "_rminus_scalar",
                            reverse=True)

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __div__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar")

    __truediv__ = __div__

    def __rdiv__(self, o):
        return self._binary(o, "broadcast_div", "_rdiv_scalar", reverse=True)

    __rtruediv__ = __rdiv__

    def __mod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binary(o, "broadcast_mod", "_rmod_scalar", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binary(o, "broadcast_power", "_rpower_scalar",
                            reverse=True)

    def __neg__(self):
        return self._view(torch.neg(self._data))

    def __abs__(self):
        return self._view(torch.abs(self._data))

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    # in-place: a handle swap — the NDArray is the mutable cell, so an
    # executor or optimizer that holds this NDArray reads the new tensor.
    # Nothing is recorded for autograd (the reference's _record_mutation,
    # mxnet_tpu/ndarray.py:51-86) until autograd.py is ported.
    def _inplace(self, other, op_name, scalar_op):
        res = self._binary(other, op_name, scalar_op)
        if res is NotImplemented:
            return res
        self._data = res._data
        return self

    def __iadd__(self, o):
        return self._inplace(o, "broadcast_add", "_plus_scalar")

    def __isub__(self, o):
        return self._inplace(o, "broadcast_sub", "_minus_scalar")

    def __imul__(self, o):
        return self._inplace(o, "broadcast_mul", "_mul_scalar")

    def __idiv__(self, o):
        return self._inplace(o, "broadcast_div", "_div_scalar")

    __itruediv__ = __idiv__


# ---------------------------------------------------------------------------
# creation functions
# ---------------------------------------------------------------------------

def array(source_array, ctx=None, dtype=None):
    """An NDArray holding a copy of ``source_array`` (float32 unless
    ``dtype`` is given, as in the reference)."""
    if isinstance(source_array, NDArray):
        src = source_array._data
    elif isinstance(source_array, torch.Tensor):
        src = source_array
    else:
        src = tensor_from_numpy(np.asarray(source_array))
    if dtype is not None:
        src = src.to(_torch_dtype(dtype))
    elif not isinstance(source_array, (NDArray, torch.Tensor)):
        src = src.to(torch.float32)
    return NDArray(src.clone(), ctx=ctx)


_NUMPY_TYPES = {torch.bfloat16: "bfloat16"}


def _numpy_type(torch_dtype):
    """The numpy scalar type of a torch dtype; ``"bfloat16"`` for
    bfloat16, which numpy lacks (see :attr:`NDArray.dtype`)."""
    found = _NUMPY_TYPES.get(torch_dtype)
    if found is None:
        found = _NUMPY_TYPES[torch_dtype] = torch.empty(
            (), dtype=torch_dtype).numpy().dtype.type
    return found


def empty(shape, ctx=None, dtype="float32"):
    if isinstance(shape, int):
        shape = (shape,)
    ctx = ctx if ctx is not None else current_context()
    return NDArray._from_torch(
        torch.empty(tuple(shape), dtype=_torch_dtype(dtype),
                    device=ctx.torch_device), ctx)


def zeros(shape, ctx=None, dtype="float32"):
    if isinstance(shape, int):
        shape = (shape,)
    ctx = ctx if ctx is not None else current_context()
    return NDArray._from_torch(
        torch.zeros(tuple(shape), dtype=_torch_dtype(dtype),
                    device=ctx.torch_device), ctx)


def ones(shape, ctx=None, dtype="float32"):
    if isinstance(shape, int):
        shape = (shape,)
    ctx = ctx if ctx is not None else current_context()
    return NDArray._from_torch(
        torch.ones(tuple(shape), dtype=_torch_dtype(dtype),
                   device=ctx.torch_device), ctx)


def full(shape, val, ctx=None, dtype="float32"):
    """An array of ``shape`` filled with ``val``."""
    if isinstance(shape, int):
        shape = (shape,)
    ctx = ctx if ctx is not None else current_context()
    return NDArray._from_torch(
        torch.full(tuple(shape), val, dtype=_torch_dtype(dtype),
                   device=ctx.torch_device), ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    """Evenly spaced values in [start, stop), each repeated ``repeat``
    times (the ``_arange`` op)."""
    ctx = ctx if ctx is not None else current_context()
    return NDArray._from_torch(
        _tensor_ops._arange(start, stop, step, repeat, dtype,
                            ctx.torch_device), ctx)


def moveaxis(tensor, source, destination):
    """A view with axis ``source`` moved to ``destination``."""
    return NDArray._from_torch(
        torch.movedim(tensor._data, source, destination), tensor._ctx)


def onehot_encode(indices, out):
    """One-hot of ``indices`` into ``out`` (its width and dtype), by a
    handle swap as in the reference."""
    out._data = _tensor_ops._onehot_encode(
        indices._data.to(out._data.device), out._data)
    return out


def concatenate(arrays, axis=0, always_copy=True):
    """The arrays joined along ``axis``, on the first one's context."""
    if len(arrays) == 1 and not always_copy:
        return arrays[0]
    return NDArray._from_torch(
        torch.cat([a._data for a in arrays], dim=axis), arrays[0]._ctx)


def waitall():
    """Wait until all work queued on the card has finished
    (``Engine::WaitForAll``); an asynchronous CUDA error surfaces here.
    A no-op on a host without CUDA."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the imperative op surface: every registered op becomes mx.nd.<op>
# (the JAX package's _make_ndarray_function, ndarray.py:596-650)
# ---------------------------------------------------------------------------

def _invoke(opdef, nd_inputs, attrs, is_train=False, ctx=None):
    """Run ``opdef`` on NDArrays with the given attributes; returns the
    op's outputs (aux updates dropped) as NDArrays on ``ctx`` (default:
    the first input's context, or the current one for an op without
    inputs, which gets the device as its ``ctx``).  A sampling op draws
    from that device's generator (``random.generator``)."""
    from . import random as _random
    if ctx is None:
        ctx = nd_inputs[0].context if nd_inputs else current_context()
    if opdef.variable_inputs:
        attrs.setdefault("num_args", len(nd_inputs))
    opdef.validate_attrs(attrs, where="imperative call")
    attrs = opdef.normalize_attrs(attrs)
    n_out = opdef.get_num_outputs(attrs)
    names, has_var_kw = fn_signature_info(opdef.fn)
    if not has_var_kw:
        attrs = {k: v for k, v in attrs.items() if k in names}
    device = ctx.torch_device
    arrays = [a._data if a._data.device == device else a._data.to(device)
              for a in nd_inputs]
    if not arrays and "ctx" in names:
        attrs["ctx"] = device
    if opdef.needs_is_train:
        attrs["is_train"] = bool(is_train)
    if opdef.needs_rng:
        attrs["rng"] = _random.generator(device)
    out = opdef.fn(*arrays, **attrs)
    if not isinstance(out, (tuple, list)):
        out = (out,)
    return [NDArray._from_torch(o, ctx) for o in out[:n_out]]


@functools.lru_cache(maxsize=None)
def _positional_params(fn):
    """The names of ``fn``'s positional parameters, in order."""
    return tuple(p.name for p in inspect.signature(fn).parameters.values()
                 if p.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _make_ndarray_function(opdef, func_name):
    """``mx.nd.<func_name>``: NDArray inputs positionally or by input name,
    attributes as keywords, plus ``out=`` (write the results into these
    arrays), ``ctx=`` and ``is_train=`` (default: whether the op declares
    it needs one, as in the JAX package).  A bare number given
    positionally to an op without tensor inputs is its ``scalar``; to an
    op with inputs, it is the op function's parameter at that place
    (``mx.nd.clip(x, 0, 1)``: ``a_min``, ``a_max``), as the JAX package
    passes it on; other values (lists, numpy arrays) become arrays on the
    context of the call's first NDArray."""
    def generic_op(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        ctx = kwargs.pop("ctx", None)
        if ctx is not None and not isinstance(ctx, Context):
            ctx = Context(ctx)
        is_train = kwargs.pop("is_train", bool(opdef.needs_is_train))
        host = ctx
        if host is None:
            host = next((a.context for a in list(args) +
                         list(kwargs.values()) if isinstance(a, NDArray)),
                        None)
        params = _positional_params(opdef.fn)
        tensor_names = set(opdef.get_input_names(kwargs)) | \
            set(opdef.get_aux_names(kwargs))
        nd_inputs = []
        for pos, a in enumerate(args):
            if isinstance(a, NDArray):
                nd_inputs.append(a)
            elif isinstance(a, (int, float)) and "scalar" not in kwargs \
                    and not opdef.get_input_names(kwargs):
                kwargs["scalar"] = a
            elif isinstance(a, (int, float, np.number)) and \
                    not opdef.variable_inputs and pos < len(params) and \
                    params[pos] not in tensor_names:
                kwargs[params[pos]] = a
            else:
                nd_inputs.append(array(a, ctx=host))
        in_names = opdef.get_input_names(kwargs) + \
            opdef.get_aux_names(kwargs)
        for nm in in_names:
            if nm in kwargs and isinstance(kwargs[nm], NDArray):
                nd_inputs.append(kwargs.pop(nm))
        results = _invoke(opdef, nd_inputs, kwargs, is_train=is_train,
                          ctx=ctx)
        if out is not None:
            outs = out if isinstance(out, (list, tuple)) else (out,)
            for o, r in zip(outs, results):
                o._data = r._data.to(o._data.device, o._data.dtype)
            return out
        if len(results) == 1:
            return results[0]
        return results

    generic_op.__name__ = func_name
    generic_op.__doc__ = opdef.doc
    return generic_op


def _init_ndarray_module():
    """One ``mx.nd.<op>`` per registered op name not already defined here
    (the creation functions ``zeros``/``ones``/... stay as they are)."""
    module = globals()
    for reg_name, opdef in list(OP_REGISTRY.items()):
        if reg_name not in module:
            module[reg_name] = _make_ndarray_function(opdef, reg_name)


# ---------------------------------------------------------------------------
# serialization — byte-compatible with reference .params files
# ---------------------------------------------------------------------------

_LIST_MAGIC = 0x112


def _save_one(fo, arr):
    shape = arr.shape
    fo.write(struct.pack("<I", len(shape)))
    fo.write(struct.pack("<%dI" % len(shape), *shape))
    if len(shape) == 0:
        return
    fo.write(struct.pack("<ii", 1, 0))  # Context: kCPU, dev_id 0
    data = arr._data
    flag = _DTYPE_TO_FLAG.get(data.dtype)
    if flag is None:
        data = data.to(torch.float32)
        flag = 0
    fo.write(struct.pack("<i", flag))
    fo.write(_tensor_bytes(data))


def _load_one(fi, ctx):
    ndim, = struct.unpack("<I", fi.read(4))
    if ndim == 0:
        return zeros((), ctx)
    shape = struct.unpack("<%dI" % ndim, fi.read(4 * ndim))
    fi.read(8)  # Context (dev_type, dev_id) — ignored on load
    flag, = struct.unpack("<i", fi.read(4))
    if flag not in _FLAG_TO_DTYPE:
        raise MXNetError("unknown dtype flag %d in NDArray stream" % flag)
    dtype = _FLAG_TO_DTYPE[flag]
    count = 1
    for d in shape:
        count *= int(d)
    nbytes = count * torch.empty((), dtype=dtype).element_size()
    buf = bytearray(fi.read(nbytes))
    if len(buf) != nbytes:
        raise MXNetError("truncated NDArray stream")
    if count == 0:
        data = torch.empty(shape, dtype=dtype)
    else:
        data = torch.frombuffer(buf, dtype=dtype).reshape(shape)
    return NDArray(data, ctx=ctx)


def save(fname, data):
    """Save a list or dict of NDArrays in the reference ``.params`` format
    (dict entries sorted by name, as the JAX package writes them)."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names, arrays = zip(*sorted(data.items())) if data else ((), ())
    else:
        names, arrays = (), tuple(data)
    with open(fname, "wb") as fo:
        fo.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        fo.write(struct.pack("<Q", len(arrays)))
        for arr in arrays:
            _save_one(fo, arr)
        fo.write(struct.pack("<Q", len(names)))
        for name in names:
            encoded = name.encode("utf-8")
            fo.write(struct.pack("<Q", len(encoded)))
            fo.write(encoded)


def _load_stream(fi, ctx=None):
    """Parse a ``.params``-format stream -> (names, arrays); names is empty
    for unnamed lists.  Arrays land on ``ctx``, the host when None (the
    Context field in the stream is cpu(0) from both writers)."""
    ctx = ctx if ctx is not None else cpu()
    magic, _ = struct.unpack("<QQ", fi.read(16))
    if magic != _LIST_MAGIC:
        raise MXNetError("Invalid NDArray stream format")
    num, = struct.unpack("<Q", fi.read(8))
    arrays = [_load_one(fi, ctx) for _i in range(num)]
    num_names, = struct.unpack("<Q", fi.read(8))
    names = []
    for _i in range(num_names):
        ln, = struct.unpack("<Q", fi.read(8))
        names.append(fi.read(ln).decode("utf-8"))
    return names, arrays


def load(fname, ctx=None):
    """Load a reference-format ``.params`` file -> dict or list of NDArray,
    on ``ctx`` (the host when None)."""
    with open(fname, "rb") as fi:
        try:
            names, arrays = _load_stream(fi, ctx)
        except MXNetError as e:
            raise MXNetError("%s: %s" % (e, fname)) from e
    if names:
        return dict(zip(names, arrays))
    return arrays
