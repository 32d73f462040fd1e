"""Custom operators written in Python (port of ``mxnet_tpu/operator.py``;
reference python/mxnet/operator.py).

The surface is the JAX package's: ``CustomOp``/``CustomOpProp`` with
``mx.operator.register``, the legacy ``PythonOp``/``NumpyOp``/
``NDArrayOp``, and the registered ``Custom`` op, so ``mx.sym.Custom`` and
``mx.nd.Custom`` exist.  As in the JAX package, the user's ``forward`` and
``backward`` run on the host over numpy arrays (:class:`_HostArray`, with
the NDArray conveniences ``asnumpy``/``copyto``/``context``).

On the card a Custom node is one ``torch.autograd.Function``: its forward
copies the inputs and aux states to the host (one stream sync), runs the
user's ``forward`` and copies the outputs and the written aux states back
to the inputs' device; its backward copies the head gradients to the host,
runs the user's ``backward`` with the inputs and outputs the forward kept
on the host, and copies the input gradients back.  Only what
``declare_backward_dependency`` names is kept for the backward (with
``need_top_grad=False`` the head gradients never cross; the user's
``backward`` sees zeros there), and only the gradients of inputs that need
one go back.  Integer inputs take no gradient.  A bfloat16 tensor crosses
as float32.  :data:`HOST_COUNTS` counts the host calls and the bytes that
cross each way.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .base import MXNetError
from .kernels import COUNT_LOCK
from .ops.registry import register as _register_op

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop", "PythonOp",
           "NumpyOp", "NDArrayOp", "HOST_COUNTS"]

#: host round trips of Custom nodes since the process started (or the
#: caller last reset them): user ``forward``/``backward`` calls and the
#: bytes copied to and from the host
HOST_COUNTS = {"forward": 0, "backward": 0, "bytes_to_host": 0,
               "bytes_to_device": 0}


def _assign(dst, req, src):
    """Write src into dst honoring the grad_req (reference operator.py
    CustomOp.assign semantics, shared by all op base classes)."""
    if req == "null":
        return
    if not isinstance(src, np.ndarray) and hasattr(src, "asnumpy"):
        src = src.asnumpy()
    if req in ("write", "inplace"):
        dst[:] = src
    elif req == "add":
        dst[:] += src


# op_type -> CustomOpProp subclass (reference CustomOpPropRegistry)
_PROP_REGISTRY = {}


class CustomOp(object):
    """Base class for custom operator implementations (reference
    operator.py:CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """Write src to dst honoring the grad_req (operator.py:assign)."""
        _assign(dst, req, src)


class CustomOpProp(object):
    """Operator properties: shapes, types and operator creation
    (reference operator.py:CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), \
            [in_type[0]] * len(self.list_auxiliary_states())

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Register a CustomOpProp subclass under ``op_type=reg_name``
    (reference operator.py:register / MXCustomOpRegister)."""
    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("can only register subclass of CustomOpProp")
        _PROP_REGISTRY[reg_name] = prop_cls
        _cached_prop.cache_clear()  # re-registration must not serve stale props
        return prop_cls
    return do_register


def get_prop(op_type):
    try:
        return _PROP_REGISTRY[op_type]
    except KeyError:
        raise MXNetError("custom op type %r is not registered "
                         "(use mx.operator.register)" % (op_type,)) from None


def _user_attrs(attrs):
    """kwargs forwarded to the user's prop ctor, as strings (the reference
    passes all op kwargs through the C API as char**)."""
    return {k: str(v) for k, v in attrs.items()
            if k != "op_type" and not k.startswith("__")}


@functools.lru_cache(maxsize=512)
def _cached_prop(op_type, attr_items):
    return get_prop(op_type)(**dict(attr_items))


def _prop_for(attrs):
    op_type = attrs.get("op_type")
    if op_type is None:
        raise MXNetError("Custom op requires op_type=...")
    return _cached_prop(op_type, tuple(sorted(_user_attrs(attrs).items())))


class _HostArray(np.ndarray):
    """What custom-op callbacks receive: a numpy array with the NDArray
    conveniences (.asnumpy/.wait_to_read/.copyto/.context)."""

    def asnumpy(self):
        return np.asarray(self)

    def wait_to_read(self):
        pass

    wait_to_write = wait_to_read

    def copyto(self, other):
        other[:] = self
        return other

    @property
    def context(self):
        from .context import cpu
        return cpu()


def _wrap_nd(arrays):
    return [np.ascontiguousarray(a).view(_HostArray) for a in arrays]


def _custom_input_names(attrs):
    return tuple(_prop_for(attrs).list_arguments())


def _custom_aux_names(attrs):
    return tuple(_prop_for(attrs).list_auxiliary_states())


def _custom_num_outputs(attrs):
    return len(_prop_for(attrs).list_outputs())


def _custom_output_names(attrs):
    return tuple(_prop_for(attrs).list_outputs())


def _split_infer(ret):
    if len(ret) == 2:
        return ret[0], ret[1], []
    return ret


def _custom_infer_shape(attrs, in_shapes):
    prop = _prop_for(attrs)
    n_out = len(prop.list_outputs())
    if all(s is None for s in in_shapes):
        return list(in_shapes), [None] * n_out, []
    if any(s is None for s in in_shapes):
        # partial knowledge: the prop may fill the rest (weight shapes
        # from the data's); props that need every input bail
        try:
            in_sh, out_sh, aux_sh = _split_infer(prop.infer_shape(
                [list(s) if s is not None else None for s in in_shapes]))
        except (TypeError, IndexError, AttributeError):
            return list(in_shapes), [None] * n_out, []
        return ([tuple(s) if s is not None else None for s in in_sh],
                [tuple(s) if s is not None else None for s in out_sh],
                [tuple(s) for s in aux_sh])
    in_sh, out_sh, aux_sh = _split_infer(
        prop.infer_shape([list(s) for s in in_shapes]))
    return ([tuple(s) for s in in_sh], [tuple(s) for s in out_sh],
            [tuple(s) for s in aux_sh])


def _host_dtype(t):
    """The numpy dtype a tensor crosses to the host as (bfloat16, which
    numpy lacks, as float32)."""
    if t.dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=t.dtype).numpy().dtype


def _to_host(tensors):
    """Writable numpy copies of ``tensors`` (device reads queued together,
    then one stream sync)."""
    staged, cuda = [], None
    for t in tensors:
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.is_cuda:
            cuda = t.device
            staged.append(t.to("cpu", non_blocking=True))
        else:
            staged.append(t.clone())
        with COUNT_LOCK:
            HOST_COUNTS["bytes_to_host"] += t.numel() * t.element_size()
    if cuda is not None:
        torch.cuda.current_stream(cuda).synchronize()
    return [s.numpy() for s in staged]


def _to_device(array, device, dtype):
    t = torch.from_numpy(np.ascontiguousarray(array))
    with COUNT_LOCK:
        HOST_COUNTS["bytes_to_device"] += t.numel() * t.element_size()
    return t.to(device, dtype)


class _CustomRun(object):
    """One Custom node call: the user's operator instance, the node's
    layout, and what its forward keeps on the host for the backward."""

    def __init__(self, prop, op, is_train, n_in, n_aux, out_shapes,
                 out_types):
        self.prop, self.op, self.is_train = prop, op, is_train
        self.n_in, self.n_aux = n_in, n_aux
        self.out_shapes, self.out_types = out_shapes, out_types
        n_out = len(out_shapes)
        ids = list(range(n_out + 2 * n_in + n_out))
        deps = set(prop.declare_backward_dependency(
            ids[:n_out], ids[n_out:n_out + n_in],
            ids[n_out + n_in:n_out + n_in + n_out]))
        self.keep_ograd = [i in deps for i in range(n_out)]
        self.keep_in = [n_out + i in deps for i in range(n_in)]
        self.keep_out = [n_out + n_in + i in deps for i in range(n_out)]

    def forward(self, tensors):
        with COUNT_LOCK:
            HOST_COUNTS["forward"] += 1
        data_in = tensors[:self.n_in]
        self.device = data_in[0].device if data_in else torch.device("cpu")
        self.in_meta = [(tuple(t.shape), _host_dtype(t), t.dtype,
                         t.is_floating_point()) for t in data_in]
        host = _to_host(tensors)
        ins, auxs = host[:self.n_in], host[self.n_in:]
        self.saved_in = [a.copy() if keep else None
                         for a, keep in zip(ins, self.keep_in)]
        self.saved_aux = [a.copy() for a in auxs]
        ins, auxs = _wrap_nd(ins), _wrap_nd(auxs)
        outs = _wrap_nd([np.zeros(s, t) for s, t in
                         zip(self.out_shapes, self.out_types)])
        self.op.forward(is_train=self.is_train,
                        req=["write"] * len(outs), in_data=ins,
                        out_data=outs, aux=auxs)
        self.saved_out = [np.asarray(o) if keep else None
                          for o, keep in zip(outs, self.keep_out)]
        res = [_to_device(o, self.device, self._out_dtype(i))
               for i, o in enumerate(outs)]
        res += [_to_device(a, t.device, t.dtype)
                for a, t in zip(auxs, tensors[self.n_in:])]
        return tuple(res)

    def _out_dtype(self, i):
        typ = np.dtype(self.out_types[i])
        if typ == np.float32 and any(m[2] == torch.bfloat16
                                     for m in self.in_meta):
            return torch.bfloat16      # crossed as float32
        return torch.from_numpy(np.zeros((), typ)).dtype

    def backward(self, grads, needs):
        with COUNT_LOCK:
            HOST_COUNTS["backward"] += 1
        kept = [g for g, keep in zip(grads, self.keep_ograd) if keep]
        host = iter(_to_host(kept))
        ograds = [next(host) if keep else np.zeros(s, t)
                  for keep, s, t in zip(self.keep_ograd, self.out_shapes,
                                        self.out_types)]
        zeros_in = [np.zeros(m[0], m[1]) for m in self.in_meta]
        ins = [a if a is not None else z
               for a, z in zip(self.saved_in, zeros_in)]
        outs = [a if a is not None else np.zeros(s, t)
                for a, s, t in zip(self.saved_out, self.out_shapes,
                                   self.out_types)]
        igrads = _wrap_nd([np.zeros(m[0], m[1]) for m in self.in_meta])
        self.op.backward(req=["write"] * self.n_in,
                         out_grad=_wrap_nd(ograds), in_data=_wrap_nd(ins),
                         out_data=_wrap_nd(outs), in_grad=igrads,
                         aux=_wrap_nd(self.saved_aux))
        res = []
        for g, meta, need in zip(igrads, self.in_meta, needs):
            # integer inputs take no gradient
            res.append(_to_device(g, self.device, meta[2])
                       if need and meta[3] else None)
        return tuple(res) + (None,) * self.n_aux


class _CustomFunction(torch.autograd.Function):
    """A Custom node under torch autograd: the user's forward and backward
    on the host."""

    @staticmethod
    def forward(ctx, run, *tensors):
        outs = run.forward(tensors)
        ctx.run = run
        n_out = len(run.out_shapes)
        ctx.mark_non_differentiable(*[
            o for i, o in enumerate(outs)
            if i >= n_out or not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        run = ctx.run
        n_out = len(run.out_shapes)
        return (None,) + run.backward(grads[:n_out],
                                      ctx.needs_input_grad[1:1 + run.n_in])


@_register_op("Custom", input_names=_custom_input_names,
              aux_names=_custom_aux_names, num_outputs=_custom_num_outputs,
              output_names=_custom_output_names,
              infer_shape=_custom_infer_shape, needs_is_train=True)
def _custom(*inputs, is_train=False, **attrs):
    """Python CustomOp node (reference src/operator/custom/custom.cc):
    outputs, then the aux states as the user's forward left them.  A Prop
    with a ``_device_call(inputs, is_train)`` (the torch bridge's) runs
    that on the inputs' device instead of the host round trip."""
    prop = _prop_for(attrs)
    device_call = getattr(prop, "_device_call", None)
    if device_call is not None:
        # the torch bridge's nodes run on the device, in the graph
        return device_call(inputs, bool(is_train))
    n_in = len(prop.list_arguments())
    n_aux = len(prop.list_auxiliary_states())
    data_in = inputs[:n_in]
    in_shapes = tuple(tuple(x.shape) for x in data_in)
    _, out_shapes, _ = _custom_infer_shape(attrs, in_shapes)
    in_types = [_host_dtype(x) for x in data_in]
    _, out_types, _ = prop.infer_type(in_types)
    dev = data_in[0].device if data_in else torch.device("cpu")
    op = prop.create_operator(
        "gpu(%d)" % (dev.index or 0) if dev.type == "cuda" else "cpu(0)",
        [list(s) for s in in_shapes], [t.name for t in in_types])
    run = _CustomRun(prop, op, bool(is_train), n_in, n_aux,
                     [tuple(s) for s in out_shapes],
                     [np.dtype(t) for t in out_types])
    return _CustomFunction.apply(run, *inputs[:n_in + n_aux])


# ---------------------------------------------------------------------------
# Legacy NumpyOp / NDArrayOp (reference operator.py:126-372): instances are
# callable on symbols, adapted onto the Custom machinery
# ---------------------------------------------------------------------------

class _LegacyOpAdapter(CustomOp):
    """NDArrayOp-style dispatch: the instance's fwd/bwd take the host
    arrays."""

    def __init__(self, inst):
        self._inst = inst

    def forward(self, is_train, req, in_data, out_data, aux):
        self._inst.forward(in_data=in_data, out_data=out_data)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        self._inst.backward(out_grad=out_grad, in_data=in_data,
                            out_data=out_data, in_grad=in_grad)


def _np_copy(arrays):
    return [np.array(a.asnumpy()) for a in arrays]


class _NumpyOpAdapter(_LegacyOpAdapter):
    """NumpyOp-style dispatch: the instance's fwd/bwd take numpy arrays."""

    def forward(self, is_train, req, in_data, out_data, aux):
        ins = _np_copy(in_data)
        outs = _np_copy(out_data)
        self._inst.forward(in_data=ins, out_data=outs)
        for dst, src in zip(out_data, outs):
            dst[:] = src

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        ograds = _np_copy(out_grad)
        ins = _np_copy(in_data)
        outs = _np_copy(out_data)
        igrads = _np_copy(in_grad)
        self._inst.backward(out_grad=ograds, in_data=ins, out_data=outs,
                            in_grad=igrads)
        for dst, src in zip(in_grad, igrads):
            dst[:] = src


class _LegacyProp(CustomOpProp):
    """Adapter exposing a PythonOp instance through CustomOpProp."""

    def __init__(self, instance):
        super().__init__(need_top_grad=instance.need_top_grad_)
        self._inst = instance

    def list_arguments(self):
        return self._inst.list_arguments()

    def list_outputs(self):
        return self._inst.list_outputs()

    def infer_shape(self, in_shape):
        return self._inst.infer_shape(in_shape)

    def create_operator(self, ctx, in_shapes, in_dtypes):
        if isinstance(self._inst, NumpyOp):
            return _NumpyOpAdapter(self._inst)
        return _LegacyOpAdapter(self._inst)


class PythonOp(object):
    """Base of legacy python ops (reference operator.py:PythonOp)."""

    _legacy_count = [0]

    def __init__(self, need_top_grad=True):
        self.info_ = None
        self.need_top_grad_ = need_top_grad
        self._op_type = None

    def __call__(self, *args, **kwargs):
        return self.get_symbol(*args, **kwargs)

    def get_symbol(self, *args, **kwargs):
        from . import symbol as sym_mod
        if self._op_type is None:    # one registry entry per instance
            self._op_type = "_legacy_python_op_%d" % PythonOp._legacy_count[0]
            PythonOp._legacy_count[0] += 1
            inst = self
            _PROP_REGISTRY[self._op_type] = lambda **kw: _LegacyProp(inst)
        kwargs["op_type"] = self._op_type
        return sym_mod.Custom(*args, **kwargs)

    def forward(self, in_data, out_data):
        raise NotImplementedError()

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError()

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def assign(self, dst, req, src):
        _assign(dst, req, src)


class NumpyOp(PythonOp):
    """Legacy numpy custom op (reference operator.py:NumpyOp): forward and
    backward receive numpy arrays."""

    def __init__(self, need_top_grad=True):
        super().__init__(need_top_grad)


class NDArrayOp(PythonOp):
    """Legacy NDArray custom op (reference operator.py:NDArrayOp)."""

    def __init__(self, need_top_grad=True):
        super().__init__(need_top_grad)
