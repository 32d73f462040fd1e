"""AOT program store (port of ``mxnet_tpu/serving/aot.py``): one
serialized, weight-free forward per (model, bucket), so a fresh or
respawned replica loads its bucket programs instead of warming them.

The JAX package stores the compiled XLA executable
(``jax.experimental.serialize_executable``).  The port's forward is the
eager plan, so its counterpart is a ``torch.export`` ``ExportedProgram``
of that plan's inference path (:func:`build_forward`): the same aten ops
and the same kernel calls the ``Predictor`` runs — every forward kernel
appears as its registered op (``torch.ops.mxt.bn_act_fwd``,
``lstm_seq_fwd``, ``lstm_cell_fwd``, ``flash_attention_fwd``,
``rtc_elementwise``; ``kernels.define_op``) — so a loaded program
answers bit for bit as the eager plan does.
Nothing is compiled further (no Inductor, no CUDA graph): the arithmetic
stays the eager plan's.

Programs are WEIGHT-FREE: they take the parameters as call arguments
(``infer(param_list, aux_list, *inputs)``, params, auxs and inputs each
in sorted-name order) and the pool passes its one device-resident copy,
so a program is a few hundred KB whatever the model's size.  The
program's example inputs (the pool's weights at export) are dropped
before it is saved.  ``PooledModel.export_aot`` traces one program with
a symbolic batch dimension and writes it for every bucket (a loader
reads it once); a plan that fixes the batch gets one program a bucket.

Store layout (``<MXTPU_COMPILE_CACHE>/aot/``)::

    <model>.json            meta: sample shapes, dtype, param/aux names,
                            param digest, platform, runtime, buckets
    <model>-b<bucket>.exec  the program (``torch.export.save``)
    <model>-b<bucket>.tree  its call signature, JSON: param, aux, input
                            and output names

A meta mismatch (another model, dtype or parameter set, another card, a
JAX-built store: platform ``cpu``/``tpu`` and no ``runtime`` key) or an
artifact that does not load warns and returns nothing, and the daemon
warms the bucket executors the usual way.  The platform is
``cuda:<device name>`` or ``cpu``: a store built under the replicas'
device env loads on every replica of that fleet.  A graph with a
``Custom`` op (a host round trip) cannot be exported, as in the JAX
store (which cannot pickle a host callback): :func:`refuse_unexportable`
names its nodes and the exporters raise before anything is written.
Loading a store needs the ``mxt`` ops registered, which importing this
package does; a program that holds an rtc op loads only in a process
that has registered the same body (``rtc.KERNELS``): elsewhere
:meth:`AotStore.load` warns, naming the key, and returns nothing, and the
daemon warms its executors the usual way (a foreign artifact, not a
kernel fallback: the executors launch the kernel).
"""
from __future__ import annotations

import contextlib
import io
import json
import os

import numpy as np

from ..base import MXNetError

__all__ = ["AotStore", "aot_dir_for_cache", "build_forward", "dev_array",
           "graph_fills", "eval_closure", "refuse_unexportable",
           "unregistered_rtc_keys"]

_META_VERSION = 1

#: the runtime a store's artifacts are for; a JAX-built meta has none
RUNTIME = "mxnet_tpu_torch"


def aot_dir_for_cache(cache_dir):
    """The store's location inside a compile-cache directory."""
    return os.path.join(cache_dir, "aot")


def _log():
    import logging
    return logging.getLogger(__name__)


def platform_of(ctx):
    """The meta's platform for a context: ``cuda:<device name>`` on a
    card, ``cpu`` on the host."""
    if ctx is None or ctx.device_type == "cpu":
        return "cpu"
    import torch
    return "cuda:%s" % torch.cuda.get_device_name(ctx.device_id)


def dev_array(v, device):
    """NDArray -> its tensor, anything else -> a tensor of its values, on
    ``device`` (no copy when it is there already).  The one unwrap rule
    every serving forward builder shares."""
    import torch
    from ..ndarray import NDArray
    if isinstance(v, NDArray):
        return v._data.to(device)
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


def graph_fills(symbol, shapes, known_args, known_auxs):
    """The Predictor.reshape allocation rule, shared by every serving
    forward builder: args absent from the blob AND the inputs (loss
    labels at inference) and missing aux states are zero-filled at their
    inferred shapes.  Returns ``(fills, aux_fills)`` as ``{name: shape}``
    dicts."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    known = set(known_args) | set(shapes)
    fills = {n: tuple(s)
             for n, s in zip(symbol.list_arguments(), arg_shapes)
             if n not in known}
    aux_fills = {n: tuple(s)
                 for n, s in zip(symbol.list_auxiliary_states(),
                                 aux_shapes)
                 if n not in known_auxs}
    return fills, aux_fills


def eval_closure(eval_fn, fills, aux_fills, input_names, device):
    """The shared body of every serving forward: merge params +
    zero-filled args, zero-filled missing aux, run the eval graph in
    inference mode with rng 0 on ``device`` (the caller holds
    ``torch.no_grad()``: a grad-mode switch inside a traced program
    would become nodes of its own).  ``run(params_dict,
    aux_dict, inputs_tuple) -> tuple(outputs)``.  Stored bfloat16
    weights are upcast to float32 where the plan reads them, as the
    pool's bfloat16 ``Predictor`` path does.  The fills are made from the
    first input (``new_zeros``), so a traced program names no device for
    them."""
    import torch

    def served(d):
        return {k: (v.float() if v.dtype == torch.bfloat16 else v)
                for k, v in d.items()}

    def run(params, auxs, inputs):
        like = inputs[0]
        merged = served(params)
        merged.update({n: like.new_zeros(s, dtype=torch.float32)
                       for n, s in fills.items()})
        merged.update(zip(input_names, inputs))
        full_aux = served(auxs)
        full_aux.update({n: like.new_zeros(s, dtype=torch.float32)
                         for n, s in aux_fills.items()})
        outs, _ = eval_fn(merged, full_aux, False, 0, device=device)
        return tuple(outs)

    return run


def refuse_unexportable(symbol, what):
    """Raise :class:`MXNetError` naming the nodes no exported program can
    hold — ``Custom`` ops (the user's numpy code on the host) — before
    anything is traced or written."""
    bad = ["%s (%s)" % (node.name, node.op.name) for node in symbol._nodes()
           if node.op is not None and node.op.name == "Custom"]
    if bad:
        raise MXNetError("%s: the graph holds op(s) that cannot be exported "
                         "to a program: %s" % (what, ", ".join(bad)))


def unregistered_rtc_keys(program):
    """The ``torch.ops.mxt.rtc_elementwise`` keys an ``ExportedProgram``
    calls that this process has not registered (``rtc.KERNELS``)."""
    import torch
    from .. import rtc
    op = torch.ops.mxt.rtc_elementwise.default
    return sorted({n.args[1] for n in program.graph.nodes
                   if n.op == "call_function" and n.target is op
                   and n.args[1] not in rtc.KERNELS})


@contextlib.contextmanager
def no_stack_traces():
    """Trace without recording each node's Python stack
    (``torch.fx.config.do_not_emit_stack_traces``): a stored program
    does not need them, and recording them is a large share of an
    export's time."""
    import torch.fx.config as fx_config
    prev = getattr(fx_config, "do_not_emit_stack_traces", False)
    fx_config.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        fx_config.do_not_emit_stack_traces = prev


def strip_example_inputs(ep):
    """Drop a program's example inputs: ``torch.export.save`` would store
    them, and a weight-free program's are the weights."""
    ep._example_inputs = None
    return ep


def save_program(ep):
    """An ``ExportedProgram`` -> the bytes ``torch.export.save`` writes."""
    import torch
    buf = io.BytesIO()
    torch.export.save(strip_example_inputs(ep), buf)
    return buf.getvalue()


def load_program(blob):
    """:func:`save_program` bytes -> ``ExportedProgram``."""
    import torch
    return torch.export.load(io.BytesIO(blob))


class AotStore(object):
    """One directory of serialized forwards.  ``platform`` is what a
    loadable store must have been built for (the pool passes
    :func:`platform_of` its context); ``device`` is where
    :meth:`load` puts the program's tensors."""

    def __init__(self, directory, platform="cpu", device=None):
        self.dir = directory
        self.platform = platform
        self.device = device
        #: sha256 of an ``.exec`` -> its loaded module: buckets that hold
        #: one batch-dynamic program load it once
        self._loaded = {}

    def _base(self, model, bucket):
        return os.path.join(self.dir, "%s-b%d" % (model, int(bucket)))

    def _meta_path(self, model):
        return os.path.join(self.dir, "%s.json" % model)

    def meta(self, model):
        try:
            with open(self._meta_path(model)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def buckets(self, model):
        doc = self.meta(model)
        return sorted(int(b) for b in (doc or {}).get("buckets", []))

    # -- build side --------------------------------------------------------
    def save(self, model, bucket, blob, meta, signature):
        """Write one program (``.exec``: the bytes :func:`save_program`
        made) and its call ``signature`` (``.tree``), and record/refresh
        the model's meta doc (``meta``: sample_shapes/dtype/param_names/
        aux_names/param_digest)."""
        from ..resilience import atomic_write
        os.makedirs(self.dir, exist_ok=True)
        base = self._base(model, bucket)
        atomic_write(base + ".exec", blob)
        atomic_write(base + ".tree", json.dumps(signature, sort_keys=True))
        doc = self.meta(model) or {}
        doc.update(meta)
        doc["meta_version"] = _META_VERSION
        doc["platform"] = self.platform
        doc["runtime"] = RUNTIME
        buckets = set(int(b) for b in doc.get("buckets", []))
        buckets.add(int(bucket))
        doc["buckets"] = sorted(buckets)
        atomic_write(self._meta_path(model),
                     json.dumps(doc, indent=2, sort_keys=True))
        return base

    # -- load side ---------------------------------------------------------
    def verify(self, model, meta):
        """Does the store's meta match this pool entry on this platform
        and runtime?  Returns the meta doc on match, None (with a
        warning) otherwise — stale or foreign artifacts must fall back,
        never serve wrong math."""
        doc = self.meta(model)
        if doc is None:
            return None
        checks = dict(meta)
        checks["platform"] = self.platform
        checks["runtime"] = RUNTIME
        checks["meta_version"] = _META_VERSION
        for key, want in checks.items():
            got = doc.get(key)
            # JSON roundtrips tuples as lists
            norm = lambda v: json.loads(json.dumps(v))  # noqa: E731
            if norm(got) != norm(want):
                _log().warning(
                    "AOT store %s: meta mismatch for %r on %r "
                    "(store %r != pool %r) — falling back to "
                    "the bucket warmup", self.dir, model, key, got, want)
                return None
        return doc

    def load(self, model, bucket):
        """One program -> callable ``(param_list, aux_list, *inputs) ->
        tuple(outputs)`` on :attr:`device`, or None (missing, corrupt or
        foreign — an rtc body this process has not registered included:
        the caller falls back)."""
        import hashlib
        base = self._base(model, bucket)
        try:
            with open(base + ".tree") as f:
                json.load(f)
            with open(base + ".exec", "rb") as f:
                blob = f.read()
            digest = hashlib.sha256(blob).hexdigest()
            module = self._loaded.get(digest)
            if module is None:
                program = load_program(blob)
                missing = unregistered_rtc_keys(program)
                if missing:
                    raise MXNetError(
                        "the program calls rtc elementwise kernel(s) this "
                        "process has not registered: %s" % ", ".join(missing))
                module = program.module()
                if self.device is not None:
                    module = module.to(self.device)
                self._loaded[digest] = module
            return module
        except Exception as e:  # noqa: BLE001 — stale/foreign artifact
            _log().warning("AOT store %s: cannot load %s-b%d (%s: %s) — "
                           "falling back to the bucket warmup",
                           self.dir, model, int(bucket), type(e).__name__,
                           e)
            return None


def build_forward(symbol, arg_params, aux_params, sample_shapes, bucket,
                  device, dynamic_batch=False):
    """The canonical AOT forward for one bucket: a weight-free
    ``ExportedProgram`` of ``infer(param_list, aux_list, *inputs)``,
    params, auxs and inputs in sorted-name order, traced on ``device``
    with the params as example inputs (never as constants).  With
    ``dynamic_batch`` the inputs' batch dimension is symbolic (traced at
    ``bucket`` rows), so one program serves every bucket: the same aten
    ops on each bucket's concrete shapes.  Returns ``(program,
    (param_list, aux_list), signature)``.  The math is the same
    ``executor._build_eval`` inference plan the Predictor runs."""
    import torch
    from ..executor import _build_eval

    refuse_unexportable(symbol, "build_forward(bucket %d)" % int(bucket))
    eval_fn = _build_eval(symbol)
    pnames = sorted(arg_params)
    anames = sorted(aux_params)
    pv = [dev_array(arg_params[n], device) for n in pnames]
    av = [dev_array(aux_params[n], device) for n in anames]
    input_names = sorted(sample_shapes)
    shapes = {k: (int(bucket),) + tuple(s)
              for k, s in sample_shapes.items()}
    fills, aux_fills = graph_fills(symbol, shapes, arg_params, aux_params)
    run = eval_closure(eval_fn, fills, aux_fills, input_names, device)

    class Infer(torch.nn.Module):
        def forward(self, params, auxv, *inputs):
            return run(dict(zip(pnames, params)), dict(zip(anames, auxv)),
                       inputs)

    xs = tuple(torch.zeros(shapes[n], dtype=torch.float32, device=device)
               for n in input_names)
    dynamic = None
    if dynamic_batch:
        batch = torch.export.Dim("batch", min=1, max=1 << 16)
        dynamic = ([None] * len(pv), [None] * len(av),
                   tuple({0: batch} for _ in input_names))
    with torch.no_grad(), no_stack_traces():
        program = torch.export.export(Infer(), (pv, av) + xs,
                                      dynamic_shapes=dynamic, strict=False)
    signature = {"params": pnames, "auxs": anames, "inputs": input_names,
                 "outputs": symbol.list_outputs(),
                 "dynamic_batch": bool(dynamic_batch)}
    return program, (pv, av), signature


def _dtype_name(v):
    """The numpy name of a value's element type; the port's bfloat16
    arrays answer ``"bfloat16"`` (as ``ml_dtypes`` names it)."""
    dt = getattr(v, "dtype", np.float32)
    if isinstance(dt, str):
        return dt
    return np.dtype(dt).name


def entry_meta(entry):
    """The verification meta for one pool entry (shape/dtype/param-set
    identity — what must match for a stored executable to be THIS
    model's forward)."""
    if entry.sample_shapes is None:
        raise MXNetError("model %r has no declared sample_shapes — the "
                         "AOT store needs them" % entry.name)
    return {"sample_shapes": {k: list(v)
                              for k, v in sorted(
                                  entry.sample_shapes.items())},
            "dtype": entry.dtype or "float32",
            "param_names": sorted(entry.arg_params),
            "aux_names": sorted(entry.aux_params),
            "param_digest": params_digest(entry.arg_params,
                                          entry.aux_params)}


def params_digest(arg_params, aux_params):
    """Cheap shape/dtype digest of the parameter set (NOT a content
    hash — weights ride at call time, only the program signature must
    match)."""
    import hashlib
    h = hashlib.sha256()
    for prefix, d in (("arg", arg_params), ("aux", aux_params)):
        for k in sorted(d):
            v = d[k]
            h.update(("%s:%s:%s:%s;" % (
                prefix, k, tuple(int(n) for n in getattr(v, "shape", ())),
                _dtype_name(v))).encode())
    return h.hexdigest()[:16]
