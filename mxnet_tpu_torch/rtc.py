"""Runtime kernel escape hatch — port of ``mxnet_tpu/rtc.py``.

The reference lets users hand-write CUDA at runtime and push it through
NVRTC (python/mxnet/rtc.py ``MXRtc``).  The JAX package's escape hatch is
a Pallas kernel body; this package's is a CUDA C++ body, the card's own
kernel language:

- :func:`elementwise_cuda_kernel` — wrap an elementwise CUDA C++ body
  (a statement over ``in`` that assigns ``out``) into ``fn(x) -> y``: the
  body is pasted into the template ``csrc/rtc_elementwise.cu``, built with
  ``nvcc`` at the first call on a CUDA tensor and launched on the current
  stream; it moves 16 bytes per load and store over the aligned body of
  the array, element by element over a scalar head and tail
  (:func:`vector_split`).  It replaces ``elementwise_pallas_kernel``
  (``mxnet_tpu/rtc.py:124-143``).  A CPU tensor takes the ``plain``
  callable the caller passes; a CUDA tensor always launches the kernel or
  raises.
- :func:`register_kernel` — register any callable over tensors as a
  framework op: it becomes ``mx.nd.<name>`` and ``mx.sym.<name>`` and
  runs in executors, ``SPMDTrainer`` and the Module stack; a ``vjp``
  makes it a ``torch.autograd.Function``.
- :class:`MXRtc` — the reference's class shape (name/inputs/outputs +
  ``push``), over a kernel callable.

The kernel is the registered op ``torch.ops.mxt.rtc_elementwise(Tensor
x, str key) -> Tensor`` (``kernels.define_op``).  Each
:class:`ElementwiseKernel` enters the process-wide table :data:`KERNELS`
under its key, the sha256 of its body text (:func:`body_key`); the op's
CUDA kernel launches the table's kernel for the key, its other devices
take that kernel's ``plain``, and a key the table lacks raises, naming
it.  So a ``torch.export`` program of a graph with an rtc op holds the op
and its key, and it loads only in a process that has registered the same
body: elsewhere ``serving/aot.AotStore.load`` warns, naming the key, and
returns nothing, and the daemon warms its executors the usual way — the
store's contract for a foreign artifact, not a kernel fallback (the
executors still launch the kernel).
"""
from __future__ import annotations

import ctypes
import hashlib
import inspect
import os

import torch

from .base import MXNetError
from .kernels import COUNT_LOCK, define_op, note_launch, portable
from .ops.registry import OP_REGISTRY, fn_signature_info, register

__all__ = ["register_kernel", "elementwise_cuda_kernel", "ElementwiseKernel",
           "MXRtc", "on_gpu", "render", "vector_split", "body_key",
           "LAUNCHES", "KERNELS", "VECTOR_BYTES"]

#: launches of rtc elementwise kernels since the process started (or the
#: caller last reset it); incremented only where a kernel is launched
LAUNCHES = 0

#: body key (:func:`body_key`) -> the :class:`ElementwiseKernel` that
#: ``torch.ops.mxt.rtc_elementwise`` runs for it in this process
KERNELS = {}

_TEMPLATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                         "rtc_elementwise.cu")
_MARKER = "/*@MXT_RTC_BODY@*/"
#: storage dtype -> the template's C entry for it
_ENTRIES = {torch.float32: "mxt_rtc_elementwise_f32",
            torch.bfloat16: "mxt_rtc_elementwise_bf16",
            torch.float16: "mxt_rtc_elementwise_f16",
            torch.float64: "mxt_rtc_elementwise_f64"}


#: bytes the kernel moves per vector load and store
VECTOR_BYTES = 16


def vector_split(address, n, itemsize):
    """``(head, vectors, tail)``: how the kernel covers ``n`` elements of
    ``itemsize`` bytes that start at byte ``address``.  ``head`` scalar
    elements run up to the first 16-byte boundary, ``vectors`` aligned
    16-byte vectors follow, and ``tail`` scalar elements end it (fewer
    than one vector's worth).  ``csrc/rtc_elementwise.cu`` takes this
    split and refuses any other."""
    per = VECTOR_BYTES // itemsize
    head = min((-address % VECTOR_BYTES) // itemsize, n)
    vectors = (n - head) // per
    return head, vectors, n - head - vectors * per


def _output_like(x):
    """An empty contiguous tensor of ``x``'s shape and dtype that starts
    at ``x``'s offset from a 16-byte boundary, so one :func:`vector_split`
    serves the input and the output: a fresh tensor when ``x`` is
    aligned, else a view into a buffer one vector longer."""
    es = x.element_size()
    lead = x.data_ptr() % VECTOR_BYTES
    if lead == 0:
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    buf = torch.empty(x.numel() + VECTOR_BYTES // es, dtype=x.dtype,
                      device=x.device)
    start = (lead - buf.data_ptr() % VECTOR_BYTES) % VECTOR_BYTES // es
    return buf[start:start + x.numel()].view(x.shape)


def render(body):
    """The template ``csrc/rtc_elementwise.cu`` with ``body`` pasted in
    place of its marker: the source ``nvcc`` builds for this body."""
    if not isinstance(body, str) or not body.strip():
        raise MXNetError("elementwise_cuda_kernel: the body must be a "
                         "non-empty CUDA C++ statement assigning `out`")
    with open(_TEMPLATE) as f:
        template = f.read()
    if template.count(_MARKER) != 1:
        raise MXNetError("%s: expected one body marker %s"
                         % (_TEMPLATE, _MARKER))
    return template.replace(_MARKER, body)


def body_key(body):
    """The key of an elementwise body in :data:`KERNELS` and in the
    ``torch.ops.mxt.rtc_elementwise`` calls of a stored program: the
    sha256 of its text."""
    return hashlib.sha256(body.encode()).hexdigest()


def _registered(key):
    kernel = KERNELS.get(key)
    if kernel is None:
        raise MXNetError(
            "rtc elementwise kernel %s is not registered in this process "
            "(make elementwise_cuda_kernel(body) of the same body first)"
            % key)
    return kernel


def _op_plain(x, key):
    return _registered(key)._plain(x)


def _op_cuda(x, key):
    return _registered(key)._launch(x)


def _op_fake(x, key):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


#: ``torch.ops.mxt.rtc_elementwise(x, key)``: the body registered under
#: ``key`` over ``x`` (see the module docstring)
define_op("rtc_elementwise(Tensor x, str key) -> Tensor", _op_plain,
          _op_cuda, _op_fake)


class _NoReverse(torch.autograd.Function):
    """The kernel's output for an input that requires grad: the forward
    is the kernel, the backward raises (a hand-written body has no reverse
    mode; register the op with ``vjp=``)."""

    @staticmethod
    def forward(ctx, x, kernel):
        return torch.ops.mxt.rtc_elementwise(x, kernel.key)

    @staticmethod
    def backward(ctx, g):
        raise MXNetError(
            "elementwise_cuda_kernel output is not differentiable: pair the "
            "kernel with a hand-written vjp (register_kernel(..., vjp=...))")


class ElementwiseKernel(object):
    """``fn(x) -> y`` over one elementwise CUDA C++ body; see
    :func:`elementwise_cuda_kernel`."""

    def __init__(self, body, plain=None):
        self.body = body
        self.plain = plain
        self.source = render(body)
        #: the library's name in ``kernels.build``/``load_library``; the
        #: library itself is keyed by a hash of the rendered source (the
        #: template's bytes and the body) and the nvcc flags
        self.key = body_key(body)
        self.name = "rtc_" + self.key[:12]
        #: seconds this kernel's build took (0.0: the library was already
        #: built or loaded), None until the first CUDA call
        self.build_seconds = None
        self._lib = None
        self._fns = {}
        # the newest kernel of a body with a plain version answers for it
        if plain is not None or self.key not in KERNELS:
            KERNELS[self.key] = self

    def build(self):
        """Build (or find) and load the library; returns the seconds the
        build took, 0.0 when it already existed."""
        from . import kernels
        if self._lib is None:
            built = kernels.build([self.name], {self.name: self.source})
            self._lib = kernels.load_library(self.name, self.source)
            self.build_seconds = built.get(self.name, 0.0)
        return self.build_seconds

    def _entry(self, dtype):
        fn = self._fns.get(dtype)
        if fn is None:
            self.build()
            fn = getattr(self._lib, _ENTRIES[dtype])
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + \
                [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fns[dtype] = fn
        return fn

    def _plain(self, x):
        """The op's kernel on a device other than CUDA: ``plain``."""
        if self.plain is None:
            raise MXNetError(
                "elementwise_cuda_kernel: a CPU call needs plain= (a "
                "function on tensors computing the body's function); "
                "the CUDA body runs only on a CUDA tensor")
        with torch.no_grad():
            y = self.plain(x)
        if tuple(y.shape) != tuple(x.shape):
            raise MXNetError("elementwise_cuda_kernel: plain returned "
                             "shape %s for input %s"
                             % (tuple(y.shape), tuple(x.shape)))
        y = y.to(x.dtype)
        # an op's output is never its input
        return y.clone() if y is x else y

    def _launch(self, x):
        """The op's CUDA kernel: launch the body on ``x`` and count it."""
        global LAUNCHES
        if x.dtype not in _ENTRIES:
            raise MXNetError("elementwise_cuda_kernel: dtype %s is not "
                             "supported (float32, bfloat16, float16, "
                             "float64)" % x.dtype)
        x = x.detach().contiguous()
        n = x.numel()
        if n == 0:
            return torch.empty_like(x)
        y = _output_like(x)
        head, vectors, _ = vector_split(x.data_ptr(), n, x.element_size())
        fn = self._entry(x.dtype)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), y.data_ptr(), n, head, vectors, stream)
        if err != 0:
            raise MXNetError("rtc elementwise kernel launch failed: CUDA "
                             "error %d" % err)
        with COUNT_LOCK:
            LAUNCHES += 1
        note_launch("rtc_elementwise", x)
        return y

    def __call__(self, x):
        """``y`` of ``x``'s shape and dtype, the body applied to each
        element.  A CUDA tensor launches the kernel (built on first use)
        on the current stream, or raises; a CPU tensor takes ``plain``.
        The output has no reverse mode: backpropagating through it raises
        (register the op with a ``vjp``).  Inside
        ``kernels.portable_trace()`` every tensor takes ``plain``."""
        if portable() or (self.plain is None and x.device.type == "cpu"):
            return self._plain(x)
        if torch.is_grad_enabled() and x.requires_grad:
            return _NoReverse.apply(x, self)
        return torch.ops.mxt.rtc_elementwise(x, self.key)


def elementwise_cuda_kernel(body, plain=None):
    """Wrap an elementwise CUDA C++ ``body`` into ``fn(x) -> y`` (the
    counterpart of the JAX package's ``elementwise_pallas_kernel``).

    ``body`` is a statement over ``in`` that assigns ``out``, both of the
    math type ``scalar_t`` (float for float32/bfloat16/float16 storage,
    double for float64), e.g. ``"out = in / (1.0f + expf(-in));"``.  It
    must be elementwise: unlike a Pallas body, it sees one element.  The
    output has the input's shape and dtype; other dtypes raise.

    ``plain`` is a function on tensors computing the same function; it
    is used for CPU tensors only, and a CPU call without it raises.  On a
    CUDA tensor the kernel is built with ``nvcc`` at the first call (a
    second kernel of the same body reuses the library) and always
    launched; a body that does not compile raises with ``nvcc``'s
    message.  Not differentiable on its own: pair it with a ``vjp`` in
    :func:`register_kernel`."""
    return ElementwiseKernel(body, plain)


def _inject(reg_name):
    """Make a freshly registered op callable as mx.nd.<name> and
    mx.sym.<name> (those modules are populated at import; later
    registrations inject themselves)."""
    from . import ndarray as nd_mod
    from . import symbol as sym_mod
    opdef = OP_REGISTRY[reg_name]
    if reg_name not in vars(sym_mod):
        vars(sym_mod)[reg_name] = sym_mod._make_symbol_function(opdef,
                                                                reg_name)
    if reg_name not in vars(nd_mod):
        vars(nd_mod)[reg_name] = nd_mod._make_ndarray_function(opdef,
                                                               reg_name)


def _vjp_function(f, vjp):
    """The ``torch.autograd.Function`` of ``f`` with the hand-written
    ``vjp``.  The op's attributes ride as one non-tensor argument of
    ``apply`` (its gradient is None) and reach both ``f`` and ``vjp``."""

    class RtcVjp(torch.autograd.Function):
        @staticmethod
        def forward(ctx, attrs, *arrays):
            ctx.attrs = attrs
            ctx.save_for_backward(*arrays)
            return f(*arrays, **attrs)

        @staticmethod
        def backward(ctx, *cotangents):
            grads = vjp(*ctx.saved_tensors, *cotangents, **ctx.attrs)
            if not isinstance(grads, (tuple, list)):
                grads = (grads,)
            return (None,) + tuple(grads)

    return RtcVjp


def register_kernel(name, fn=None, *, input_names=("data",), num_outputs=1,
                    infer_shape=None, needs_rng=False, vjp=None, **opdef_kw):
    """Register a callable over tensors as a framework op.

    Usable as a decorator::

        silu = mx.rtc.elementwise_cuda_kernel(
            "out = in / (1.0f + expf(-in));",
            plain=lambda x: x / (1 + torch.exp(-x)))

        @mx.rtc.register_kernel("my_silu", vjp=my_silu_vjp)
        def my_silu(data):
            return silu(data)

        y = mx.nd.my_silu(x)
        s = mx.sym.my_silu(mx.sym.Variable("data"))

    ``vjp``: optional ``vjp(primals..., cotangents..., **attrs) ->
    grads``; the op then is a ``torch.autograd.Function``.  Without it,
    torch autograd differentiates plain tensor code, but **a body that
    goes through** :func:`elementwise_cuda_kernel` **needs an explicit
    vjp**: the kernel has no reverse mode, so backpropagating through it
    raises (the JAX package's contract for pallas_call kernels).
    A name already registered raises."""
    def _do(f):
        if name in OP_REGISTRY:
            raise MXNetError("kernel/op %r already registered" % name)
        wrapped = f
        if vjp is not None:
            fn_cls = _vjp_function(f, vjp)

            def wrapped(*arrays, **attrs):
                return fn_cls.apply(attrs, *arrays)

            wrapped.__doc__ = f.__doc__
            # keep f's declared parameter surface for attr validation and
            # the executor's framework-attr filtering
            wrapped.__signature__ = inspect.signature(f)
        register(name, input_names=input_names, num_outputs=num_outputs,
                 infer_shape=infer_shape, needs_rng=needs_rng,
                 **opdef_kw)(wrapped)
        _inject(name)
        return f
    if fn is not None:
        return _do(fn)
    return _do


def on_gpu():
    """Whether a CUDA device is available — the counterpart of the JAX
    package's ``on_tpu()``: where an rtc kernel launches instead of taking
    its plain version."""
    return torch.cuda.is_available()


class MXRtc(object):
    """Reference-API-shaped runtime kernel (python/mxnet/rtc.py MXRtc).

    ``kernel`` is a callable over tensors (for example an
    :func:`elementwise_cuda_kernel`); ``push`` mirrors the reference's
    call shape and passes the grid/block dims to kernels that accept
    them."""

    def __init__(self, name, inputs, outputs, kernel):
        if isinstance(kernel, str):
            raise MXNetError(
                "MXRtc takes a kernel callable over tensors, not CUDA "
                "source; wrap an elementwise CUDA body with "
                "mx.rtc.elementwise_cuda_kernel(body, plain=...) and pass "
                "that")
        self.name = name
        self.input_names = [n for n, _ in inputs]
        self.output_names = [n for n, _ in outputs]
        self.kernel = kernel

    def push(self, inputs, outputs, grid_dims=None, block_dims=None):
        """Run the kernel: reads ``inputs`` NDArrays, writes ``outputs``
        (cast to each output's dtype, on its device)."""
        from .ndarray import NDArray, tensor_from_numpy
        arrays = [x._data if isinstance(x, NDArray) else
                  x if isinstance(x, torch.Tensor) else tensor_from_numpy(x)
                  for x in inputs]
        try:
            names, has_var_kw = fn_signature_info(self.kernel)
        except (TypeError, ValueError):   # no inspectable signature
            names, has_var_kw = frozenset(), False
        if has_var_kw or {"grid_dims", "block_dims"} & set(names):
            res = self.kernel(*arrays, grid_dims=grid_dims,
                              block_dims=block_dims)
        else:
            res = self.kernel(*arrays)
        if not isinstance(res, (tuple, list)):
            res = (res,)
        if len(res) != len(outputs):
            raise MXNetError("kernel %s returned %d outputs, expected %d"
                             % (self.name, len(res), len(outputs)))
        for out, r in zip(outputs, res):
            out._data = r.to(out._data.device, out._data.dtype)
