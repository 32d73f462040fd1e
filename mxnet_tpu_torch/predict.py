"""Standalone inference API (port of ``mxnet_tpu/predict.py``; reference
include/mxnet/c_predict_api.h: MXPredCreate / SetInput / Forward /
GetOutput / Reshape).

Create from a ``-symbol.json`` string (or a Symbol) and a ``.params``
blob (or a dict of NDArrays), set named inputs, run one inference-mode
forward, read outputs.  Auxiliary states come from the params and the
forward runs with ``is_train=False``.  The weights are moved to the
predictor's context once, at creation, and stay there.

:func:`export_compiled` writes the inference function, graph and weights,
as one portable ``torch.export`` archive that a process importing only
torch runs on the host or a card; :func:`load_compiled` reads it back.
"""
from __future__ import annotations

import io as _pyio

import numpy as np

from .base import MXNetError
from . import ndarray as nd
from . import symbol as sym
from .context import current_context

__all__ = ["Predictor", "load_ndarray_file", "create", "export_compiled",
           "load_compiled"]


def load_ndarray_file(blob, ctx=None):
    """Parse a ``.params``-format byte blob -> dict of NDArray."""
    fi = _pyio.BytesIO(blob if isinstance(blob, (bytes, bytearray))
                       else bytes(blob))
    names, arrays = nd._load_stream(fi, ctx)
    if names:
        return dict(zip(names, arrays))
    return {str(i): a for i, a in enumerate(arrays)}


def _strip_prefix(params):
    """Split a checkpoint dict with ``arg:``/``aux:`` prefixes into
    (args, auxs)."""
    args, auxs = {}, {}
    for k, v in params.items():
        if k.startswith("arg:"):
            args[k[4:]] = v
        elif k.startswith("aux:"):
            auxs[k[4:]] = v
        else:
            args[k] = v
    return args, auxs


def _on_ctx(v, ctx):
    if isinstance(v, nd.NDArray):
        return v.as_in_context(ctx)
    return nd.array(np.asarray(v), ctx=ctx, dtype=np.asarray(v).dtype)


class Predictor(object):
    """Inference-only executor with the MXPred lifecycle."""

    def __init__(self, symbol_json, param_blob, input_shapes, ctx=None,
                 output_name=None):
        if isinstance(symbol_json, sym.Symbol):
            net = symbol_json
        else:
            net = sym.load_json(symbol_json)
        if output_name is not None:
            # MXPredCreatePartialOut analog: predict up to a named output
            net = net.get_internals()[output_name]
        self._sym = net
        self._ctx = ctx if ctx is not None else current_context()
        if isinstance(param_blob, dict):
            params = param_blob
        else:
            params = load_ndarray_file(param_blob, self._ctx)
        args, auxs = _strip_prefix(params)
        self._arg_params = {k: _on_ctx(v, self._ctx) for k, v in args.items()}
        self._aux_params = {k: _on_ctx(v, self._ctx) for k, v in auxs.items()}
        self._inputs = {}
        self._exec = None
        self._exec_cache = {}  # shape signature -> bound Executor
        self.reshape(dict(input_shapes))

    def reshape(self, input_shapes):
        """Rebind for new input shapes (MXPredReshape).  Weights are
        shared; executors are cached per shape signature.  Staged inputs
        are cleared: inputs must be set again afterwards."""
        self._inputs = {}
        self._input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        signature = tuple(sorted(self._input_shapes.items()))
        cached = self._exec_cache.get(signature)
        if cached is not None:
            self._exec = cached
            return self
        arg_names = self._sym.list_arguments()
        unknown = [n for n in self._input_shapes if n not in arg_names]
        if unknown:
            raise MXNetError("input name(s) %s not in symbol arguments"
                             % (unknown,))
        arg_shapes, _, aux_shapes = self._sym.infer_shape(**self._input_shapes)
        args = {}
        for name, shape in zip(arg_names, arg_shapes):
            if name in self._input_shapes:
                args[name] = nd.zeros(shape, ctx=self._ctx)
            elif name in self._arg_params:
                if tuple(self._arg_params[name].shape) != tuple(shape):
                    raise MXNetError(
                        "param %s shape mismatch: file %s vs inferred %s"
                        % (name, self._arg_params[name].shape, shape))
                args[name] = self._arg_params[name]
            else:
                # args absent from the blob (loss labels at inference) are
                # allocated, not errors — c_predict_api.cc:190-196
                args[name] = nd.zeros(shape, ctx=self._ctx)
        auxs = {}
        for name, shape in zip(self._sym.list_auxiliary_states(), aux_shapes):
            if name in self._aux_params:
                auxs[name] = self._aux_params[name]
            else:
                auxs[name] = nd.zeros(shape, ctx=self._ctx)
        self._exec = self._sym.bind(self._ctx, args, args_grad=None,
                                    grad_req="null", aux_states=auxs)
        self._exec_cache[signature] = self._exec
        return self

    def set_params(self, param_blob):
        """Swap the parameter VALUES in place: every cached executor binds
        the very NDArrays held here, so the next forward of any bucket
        sees the new weights.  Names must be a subset of the loaded set
        and shapes/dtypes must match exactly."""
        params = param_blob if isinstance(param_blob, dict) \
            else load_ndarray_file(param_blob, self._ctx)
        new_args, new_auxs = _strip_prefix(params)
        for cur, new, what in ((self._arg_params, new_args, "arg"),
                               (self._aux_params, new_auxs, "aux")):
            for name, v in new.items():
                old = cur.get(name)
                if old is None:
                    raise MXNetError(
                        "set_params: unknown %s %r (not in the bound "
                        "parameter set)" % (what, name))
                new_nd = _on_ctx(v, self._ctx)
                if new_nd.shape != old.shape or new_nd.dtype != old.dtype:
                    raise MXNetError(
                        "set_params: %s %r is %s/%s, bound set holds "
                        "%s/%s — a shape/dtype change needs a rebind, "
                        "not a swap" % (what, name, new_nd.shape,
                                        new_nd.dtype, old.shape, old.dtype))
                old._data = new_nd._data
        return self

    def set_input(self, name, data):
        """MXPredSetInput: stage a named input for the next forward."""
        if name not in self._input_shapes:
            raise MXNetError("unknown input %r (declared: %s)"
                             % (name, sorted(self._input_shapes)))
        data = np.asarray(data, dtype=np.float32)
        if tuple(data.shape) != self._input_shapes[name]:
            raise MXNetError("input %r shape %s != declared %s"
                             % (name, data.shape, self._input_shapes[name]))
        self._inputs[name] = data
        return self

    def forward(self, **inputs):
        """MXPredForward: run one inference-mode forward pass."""
        for name, data in inputs.items():
            self.set_input(name, data)
        missing = set(self._input_shapes) - set(self._inputs)
        if missing:
            raise MXNetError("inputs not set: %s" % sorted(missing))
        self._exec.forward(is_train=False, **self._inputs)
        return self

    def get_output(self, index=0):
        """MXPredGetOutput: fetch output ``index`` as numpy (waits for the
        device)."""
        return self._exec.outputs[index].asnumpy()

    @property
    def output_names(self):
        return self._sym.list_outputs()


def create(symbol_json, param_blob, input_shapes, ctx=None,
           output_name=None):
    """MXPredCreate analog."""
    return Predictor(symbol_json, param_blob, input_shapes, ctx,
                     output_name)


# ---------------------------------------------------------------------------
# Portable compiled export — the amalgamation analog
# ---------------------------------------------------------------------------

#: the platforms one portable program serves by default: the counterpart
#: of the JAX package's ("cpu", "tpu")
PLATFORMS = ("cpu", "cuda")

#: the archive's own record of its calling convention
_EXPORT_INFO = "mxnet_export.json"

#: factory ops whose device literal becomes the first input's device
#: (``aten.new_*`` of that input)
_FACTORIES = {"zeros": "new_zeros", "ones": "new_ones", "empty": "new_empty",
              "full": "new_full"}


def _device_free(ep):
    """Make an exported graph name no device: drop the
    ``_assert_tensor_metadata`` checks that ``.to(dtype)`` leaves (each
    names the trace's device and computes nothing), and rebuild factory
    calls from the first input (``aten.new_zeros`` and kin; an
    ``arange(end)``, which the plain flash attention's positions make, as
    the running sum of ``new_ones`` less one, exact in its integer
    dtype), so the program runs wherever its inputs and buffers are.
    Any other node that names a device raises."""
    import torch
    graph = ep.graph_module.graph
    first = next(n for n in graph.nodes if n.op == "placeholder"
                 and n.name in ep.graph_signature.user_inputs)
    aten = torch.ops.aten
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is aten._assert_tensor_metadata.default:
            graph.erase_node(node)
            continue
        if "device" not in node.kwargs:
            continue
        base = getattr(getattr(node.target, "_overloadpacket", None),
                       "__name__", "")
        if node.target is aten.arange.default and \
                node.kwargs.get("dtype") in (None, torch.int64):
            with graph.inserting_before(node):
                ones = graph.call_function(
                    aten.new_ones.default, (first, [node.args[0]]),
                    {"dtype": torch.int64})
                total = graph.call_function(aten.cumsum.default, (ones, 0))
                repl = graph.call_function(aten.sub.Tensor, (total, 1))
            for made in (ones, total, repl):
                # each is the arange's shape and dtype
                made.meta = dict(node.meta)
            node.replace_all_uses_with(repl)
            graph.erase_node(node)
            continue
        if base not in _FACTORIES:
            raise MXNetError("export_compiled: node %s (%s) names the "
                             "device %s; the portable program must not"
                             % (node.name, node.target,
                                node.kwargs["device"]))
        kwargs = {k: v for k, v in node.kwargs.items()
                  if k in ("dtype", "layout", "pin_memory")}
        new = getattr(aten, _FACTORIES[base]).default
        with graph.inserting_before(node):
            repl = graph.call_function(new, (first,) + tuple(node.args),
                                       kwargs)
        repl.meta = dict(node.meta)
        node.replace_all_uses_with(repl)
        graph.erase_node(node)
    graph.lint()
    ep.graph_module.recompile()
    return ep


def export_compiled(symbol, arg_params, aux_params, input_shapes,
                    fname=None, platforms=None):
    """Serialize the inference function (graph + baked-in weights) as one
    portable ``torch.export`` archive.

    The reference ships models to phones/JS by amalgamating the predict
    path into one self-contained file (amalgamation/README.md:1-13).
    The port's analog: one archive holding the traced inference plan and
    the weights, loadable by any process with torch installed — no
    ``mxnet_tpu_torch`` needed (``torch.export.load(f).module()``, moved
    with ``.to(device)``; :func:`load_compiled` does that per input
    device).  On a card such a process turns TF32 off
    (``torch.backends.cudnn.allow_tf32``, ``torch.backends.cuda.matmul.
    allow_tf32``) for the port's float32 numerics.

    The trace runs on the host, with every kernel wrapper on its plain
    version (``kernels.portable_trace``), so the graph holds aten ops
    only; it names no device (:func:`_device_free`) and the weights are
    its buffers, so one archive serves every platform of ``platforms``
    (default ``("cpu", "cuda")``).  Arguments absent from the params and
    the inputs (loss labels) and missing aux states are zero-filled, the
    ``Predictor.reshape`` rule.  A graph with a ``Custom`` op raises
    :class:`MXNetError` naming it; an rtc op traces its ``plain``.

    input_shapes: {input_name: shape}.  Returns the bytes (also written
    to ``fname`` when given).

    CALLING CONVENTION: the program takes the inputs as positional
    float32 tensors in ``sorted(input_shapes)`` name order and returns a
    tuple of the symbol's outputs."""
    import json
    import torch
    from . import kernels
    from .executor import _build_eval
    from .serving import aot

    platforms = tuple(platforms) if platforms else PLATFORMS
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise MXNetError("export_compiled: platform(s) %s (known: %s)"
                         % (bad, list(PLATFORMS)))
    if not isinstance(symbol, sym.Symbol):
        symbol = sym.load_json(symbol)
    unknown = [n for n in input_shapes
               if n not in set(symbol.list_arguments())]
    if unknown:
        raise MXNetError("input name(s) %s not in symbol arguments"
                         % (unknown,))
    aot.refuse_unexportable(symbol, "export_compiled")
    host = torch.device("cpu")
    shapes = {k: tuple(int(d) for d in v) for k, v in input_shapes.items()}
    input_names = sorted(shapes)
    params = {k: aot.dev_array(v, host) for k, v in (arg_params or {}).items()}
    auxs = {k: aot.dev_array(v, host) for k, v in (aux_params or {}).items()}
    fills, aux_fills = aot.graph_fills(symbol, shapes, params, auxs)
    params.update({n: torch.zeros(s) for n, s in fills.items()})
    auxs.update({n: torch.zeros(s) for n, s in aux_fills.items()})
    eval_fn = _build_eval(symbol)
    pnames, anames = sorted(params), sorted(auxs)

    class Portable(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for i, n in enumerate(pnames):
                self.register_buffer("arg%d" % i, params[n])
            for i, n in enumerate(anames):
                self.register_buffer("aux%d" % i, auxs[n])

        def forward(self, *inputs):
            merged = {n: getattr(self, "arg%d" % i)
                      for i, n in enumerate(pnames)}
            merged.update(zip(input_names, inputs))
            aux = {n: getattr(self, "aux%d" % i)
                   for i, n in enumerate(anames)}
            outs, _ = eval_fn(merged, aux, False, 0, device=inputs[0].device)
            return tuple(outs)

    xs = tuple(torch.zeros(shapes[n]) for n in input_names)
    with torch.no_grad(), kernels.portable_trace(), aot.no_stack_traces():
        ep = torch.export.export(Portable(), xs, strict=False)
    _device_free(ep)
    if any(isinstance(v, torch.Tensor) for v in ep.constants.values()):
        raise MXNetError("export_compiled: the traced graph holds tensor "
                         "constants (%s), which .to(device) would not move"
                         % sorted(ep.constants))
    info = {"inputs": input_names, "outputs": symbol.list_outputs(),
            "platforms": list(platforms)}
    buf = _pyio.BytesIO()
    torch.export.save(aot.strip_example_inputs(ep), buf,
                      extra_files={_EXPORT_INFO: json.dumps(info)})
    blob = buf.getvalue()
    if fname:
        with open(fname, "wb") as f:
            f.write(blob)
    return blob


def load_compiled(blob_or_fname):
    """Load an :func:`export_compiled` archive -> ``callable(*inputs) ->
    tuple of tensors``, inputs positional in sorted-input-name order (the
    export contract): torch tensors, on any platform the archive was
    made for (the program is loaded once per input device and moved
    there at that device's first call; on a card float32 stays float32,
    ``context.pin_f32_numerics``), or numpy arrays (run on the host).

    Needs only torch: the archive holds the graph and the weights."""
    import json
    import os as _os
    import torch
    from .context import pin_f32_numerics
    if isinstance(blob_or_fname, (str, _os.PathLike)):
        with open(blob_or_fname, "rb") as f:
            blob = f.read()
    else:
        blob = bytes(blob_or_fname)
    def program():
        extra = {_EXPORT_INFO: ""}
        ep = torch.export.load(_pyio.BytesIO(blob), extra_files=extra)
        return ep.module(), json.loads(extra[_EXPORT_INFO] or "{}")

    module, info = program()
    platforms = info.get("platforms", list(PLATFORMS))
    by_device = {torch.device("cpu"): module}

    def call(*inputs):
        xs = [x if isinstance(x, torch.Tensor)
              else torch.from_numpy(np.ascontiguousarray(x, np.float32))
              for x in inputs]
        dev = xs[0].device if xs else torch.device("cpu")
        if dev.type not in platforms:
            raise MXNetError("load_compiled: the program was exported for "
                             "%s, not %s" % (platforms, dev.type))
        m = by_device.get(dev)
        if m is None:
            if dev.type == "cuda":
                pin_f32_numerics()
            m = by_device[dev] = program()[0].to(dev)
        with torch.no_grad():
            return tuple(m(*xs))

    call.info = info
    return call
