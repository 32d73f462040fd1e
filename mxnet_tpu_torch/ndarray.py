"""NDArray — the imperative tensor type, over a ``torch.Tensor``.

Port of the parts of ``mxnet_tpu/ndarray.py`` the serving, training,
LSTM and Module slices need: the array type (a mutable cell holding one
tensor on its context's device; slicing and ``reshape`` give views,
``copy`` a copy), ``array``/``zeros``/``ones``/``empty``/``concatenate``,
``waitall``, the imperative op surface (every registered op as
``mx.nd.<op>``, :func:`_init_ndarray_module`; ops registered later, such
as rtc kernels, inject themselves), and ``.params`` serialization
byte-identical to ``mxnet_tpu/ndarray.py:501-575`` (the reference's
format, src/ndarray/ndarray.cc:593-676, kMXAPINDArrayListMagic=0x112), so
a file written by either package loads in the other.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from .base import MXNetError
from .context import Context, cpu, current_context
from .ops.registry import OP_REGISTRY, fn_signature_info

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "concatenate",
           "load", "save", "tensor_from_numpy", "waitall"]

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

    # -- basic properties -------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return int(self._data.numel())

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
    def handle(self):
        """The underlying ``torch.Tensor``."""
        return self._data

    # -- sync / transfer --------------------------------------------------
    def asnumpy(self):
        """A numpy copy on the host (waits for the device).  bfloat16 has
        no numpy type here, so it comes back as float32 (exact)."""
        t = self._data.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

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
        return NDArray._from_torch(self._data.clone(), self._ctx)

    def as_in_context(self, context):
        if context == self._ctx:
            return self
        return self.copyto(context)

    def reshape(self, shape, reverse=False):
        """A view in a new shape, with the ``Reshape`` op's special codes
        (0, -1, -2, -3, -4)."""
        from .ops.tensor import infer_reshape
        if isinstance(shape, int):
            shape = (shape,)
        return NDArray._from_torch(
            self._data.reshape(infer_reshape(self.shape, tuple(shape),
                                             reverse)), self._ctx)

    def __getitem__(self, key):
        """``a[i]``, ``a[i:j]``: a view sharing this array's storage, as
        the reference's slicing gives."""
        return NDArray._from_torch(self._data[key], self._ctx)

    def __setitem__(self, key, value):
        """``a[:] = v`` writes ``v`` (array, tensor or scalar) into this
        array's storage, broadcasting and casting to its dtype."""
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            if np.isscalar(value):
                self._data[key] = value
                return
            value = tensor_from_numpy(value)
        self._data[key] = value.to(self._data.device, self._data.dtype)


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


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), np.dtype(name))).dtype


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
    op's outputs (aux updates dropped) as NDArrays on the first input's
    context (or ``ctx``)."""
    from . import random as _random
    if not nd_inputs:
        raise MXNetError("%s: needs at least one NDArray input" % opdef.name)
    if opdef.variable_inputs:
        attrs.setdefault("num_args", len(nd_inputs))
    opdef.validate_attrs(attrs, where="imperative call")
    attrs = opdef.normalize_attrs(attrs)
    n_out = opdef.get_num_outputs(attrs)
    names, has_var_kw = fn_signature_info(opdef.fn)
    if not has_var_kw:
        attrs = {k: v for k, v in attrs.items() if k in names}
    ctx = ctx if ctx is not None else nd_inputs[0].context
    device = ctx.torch_device
    arrays = [a._data if a._data.device == device else a._data.to(device)
              for a in nd_inputs]
    if opdef.needs_is_train:
        attrs["is_train"] = bool(is_train)
    if opdef.needs_rng:
        attrs["rng"] = _random.node_generator(_random.next_seed(), 0, device)
    out = opdef.fn(*arrays, **attrs)
    if not isinstance(out, (tuple, list)):
        out = (out,)
    return [NDArray._from_torch(o, ctx) for o in out[:n_out]]


def _make_ndarray_function(opdef, func_name):
    """``mx.nd.<func_name>``: NDArray inputs positionally or by input name,
    attributes as keywords, plus ``out=`` (write the results into these
    arrays), ``ctx=`` and ``is_train=`` (default: whether the op declares
    it needs one, as in the JAX package).  A bare number given
    positionally to an op without tensor inputs is its ``scalar``."""
    def generic_op(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        ctx = kwargs.pop("ctx", None)
        if ctx is not None and not isinstance(ctx, Context):
            ctx = Context(ctx)
        is_train = kwargs.pop("is_train", bool(opdef.needs_is_train))
        nd_inputs = []
        for a in args:
            if isinstance(a, NDArray):
                nd_inputs.append(a)
            elif isinstance(a, (int, float)) and "scalar" not in kwargs \
                    and not opdef.get_input_names(kwargs):
                kwargs["scalar"] = a
            else:
                nd_inputs.append(array(a, ctx=ctx))
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
