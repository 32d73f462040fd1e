"""Executor — bound graph execution (port of ``mxnet_tpu/executor.py``
:58-280, 356-711).

The Symbol DAG becomes a node plan (:func:`_node_plan`), the mxfuse
passes fill its override slots, and ``forward`` interprets the plan
eagerly: one PyTorch call per node, on the bound context's device.  An
op that draws random numbers (Dropout, RNN's inter-layer dropout) gets a
``torch.Generator`` seeded from the forward's seed and the node's plan
position, the JAX package's ``fold_in(rng, rng_ix)``; each forward takes
a new seed from :func:`random.next_seed`.  The streams are not the JAX
package's.

Training is torch autograd over the same interpretation.
``forward(is_train=True)`` runs the plan with the arguments whose
``grad_req`` is not ``null`` (and that have a gradient array) as the
only leaves that require grad, applies the aux (BatchNorm moving-stat)
updates, and keeps the graph; ``backward()`` differentiates it with ones
head gradients (the loss-layer convention: SoftmaxOutput ignores them) or
with the given ``out_grads``, and writes or adds the gradients into
``grad_dict``.  Where the JAX package computes the gradients inside the
forward's one compiled program, the port computes them at the first
``backward()`` and keeps them, so a second ``backward()`` with no heads
writes the same gradients again.
"""
from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch
import torch.utils.checkpoint

from . import random as _random
from .base import MXNetError, get_env, register_env
from .context import Context
from .ndarray import NDArray, tensor_from_numpy, zeros as nd_zeros
from .ops.registry import fn_signature_info

__all__ = ["Executor", "mirror_segments_for"]

ENV_BACKWARD_DO_MIRROR = register_env(
    "MXNET_BACKWARD_DO_MIRROR", default=0,
    doc="1 = memory mirror mode: the backward recomputes activations per "
        "checkpoint segment instead of storing them")
ENV_MIRROR_SEGMENTS = register_env(
    "MXNET_MIRROR_SEGMENTS",
    doc="Segment count for mirror mode (default sqrt of op count)")


def _filter_attrs(op, attrs):
    """Keep only attrs the op function accepts (graph nodes also carry
    framework attrs like ctx_group / lr_mult)."""
    names, has_var_kw = fn_signature_info(op.fn)
    if has_var_kw:
        return dict(attrs)
    return {k: v for k, v in attrs.items() if k in names}


def _node_plan(symbol):
    """The per-node execution plan: ``(node, call_attrs, n_out,
    aux_var_names, rng_ix, override)`` in topological order — the JAX
    package's layout.  Slot 4 is the node's position, which offsets the
    forward's seed for a ``needs_rng`` op; slot 5 is the fusion override
    mxfuse fills, ``None`` here."""
    plan = []
    for ix, node in enumerate(symbol._nodes()):
        if node.is_variable:
            plan.append((node, None, None, None, ix, None))
            continue
        attrs = node.op.normalize_attrs(node.op_attrs())
        call_attrs = _filter_attrs(node.op, attrs)
        n_out = node.op.get_num_outputs(attrs)
        n_in = len(node.op.get_input_names(attrs))
        aux_names = node.op.get_aux_names(attrs)
        aux_var_names = []
        for k in range(len(aux_names)):
            if n_in + k < len(node.inputs):
                src, _ = node.inputs[n_in + k]
                aux_var_names.append(src.name if src.is_variable else None)
        plan.append((node, call_attrs, n_out, aux_var_names, ix, None))
    return plan


def mirror_segments_for(symbol, force=False):
    """Segment count for the memory-mirror mode (0 = off), as the JAX
    package counts it (``mxnet_tpu/executor.py:207-217``): on with
    ``MXNET_BACKWARD_DO_MIRROR=1`` or ``force`` (the trainer's
    ``remat=True``); about sqrt(op count) segments, which
    ``MXNET_MIRROR_SEGMENTS`` overrides."""
    if not force and str(get_env(ENV_BACKWARD_DO_MIRROR, "0")) != "1":
        return 0
    n_ops = sum(1 for node in symbol._nodes() if node.op is not None)
    return max(2, int(get_env(ENV_MIRROR_SEGMENTS,
                              int(np.sqrt(max(1, n_ops))))))


class _Segment(object):
    """One mirror segment of the training plan: its op ``entries``, the
    node ids whose outputs leave it (``live_out``), the merged-group
    memo keys it hands on (``memo_out``), both in a fixed order, and the
    ids of the variables its entries read (``reads``)."""
    __slots__ = ("entries", "live_out", "memo_out", "reads")

    def __init__(self, entries, live_out, memo_out, reads):
        self.entries = entries
        self.live_out = live_out
        self.memo_out = memo_out
        self.reads = frozenset(reads)


def _segments(entries, out_refs, n_segments):
    """Cut the op entries of a plan into ``n_segments`` runs of equal
    length.  Between segments only the live boundary values cross, as in
    the JAX package's ``_build_eval_segmented`` (:286-345), and so does a
    ``concat_fuse`` group's merged body when its members straddle a
    boundary: the segment that computes the body hands it on, so a
    recompute never finds it already made."""
    ops = [e for e in entries if e[0].op is not None]
    size = max(1, -(-len(ops) // max(1, n_segments)))
    chunks = [ops[i:i + size] for i in range(0, len(ops), size)]
    produced, last_use, groups = {}, {}, {}
    reads = [set() for _ in chunks]
    for ci, chunk in enumerate(chunks):
        for node, _a, _n, _x, _ix, override in chunk:
            produced[id(node)] = ci
            refs = list(node.inputs)
            if override is not None:
                refs += list(override[1])
                if getattr(override[0], "uses_memo", False):
                    groups.setdefault(override[0].group, []).append(ci)
            for src, _idx in refs:
                last_use[id(src)] = max(last_use.get(id(src), -1), ci)
                if src.op is None:
                    reads[ci].add(id(src))
    for nid, _i in out_refs:
        last_use[nid] = len(chunks)
    segs = []
    for ci, chunk in enumerate(chunks):
        live_out = [nid for nid, pc in produced.items()
                    if pc <= ci < last_use.get(nid, -1)]
        memo_out = [key for key, cis in groups.items()
                    if min(cis) <= ci < max(cis)]
        segs.append(_Segment(chunk, live_out, memo_out, reads[ci]))
    return segs


def _run_segments(segments, variables, out_refs, args, aux, rng, device,
                  segment_scope=None):
    """The training forward as checkpointed segments
    (``torch.utils.checkpoint``, non-reentrant): the backward recomputes
    each segment from its boundary values instead of keeping its
    activations.  Each segment's aux updates are the ones its first run
    returns; a recompute's are dropped with the rest of its return
    value.  Every run binds the variables its entries read from ``args``
    anew (a mapping may hand a recompute a re-gathered value instead of
    keeping the first run's alive).  ``segment_scope()``, where given, is
    called once a segment and returns None or an object whose
    ``scope()`` wraps every run of that segment (a mesh position's
    ``collectives.SegmentTape``, which the recompute replays)."""
    aux_updates = {}
    carry_ids, carry_vals, memo_keys, memo_vals = [], [], [], []
    for seg in segments:
        tape = segment_scope() if segment_scope is not None else None

        def run(vals, mvals, _seg=seg, _ids=carry_ids, _keys=memo_keys,
                _tape=tape):
            with _tape.scope() if _tape is not None else nullcontext():
                env = {id(node): (_bind_variable(node, args, aux),)
                       for node, *_rest in variables
                       if id(node) in _seg.reads}
                env.update(zip(_ids, vals))
                memo = {k: v for k, v in zip(_keys, mvals) if v is not None}
                seg_aux = {}
                _run_plan_nodes(_seg.entries, env, args, aux, True, seg_aux,
                                rng, device, memo=memo)
                return ([env[i] for i in _seg.live_out],
                        [memo.get(k) for k in _seg.memo_out], seg_aux)
        carry_vals, memo_vals, seg_aux = torch.utils.checkpoint.checkpoint(
            run, carry_vals, memo_vals, use_reentrant=False)
        aux_updates.update(seg_aux)
        carry_ids, memo_keys = seg.live_out, seg.memo_out
    env = dict(zip(carry_ids, carry_vals))
    wanted = {nid for nid, _i in out_refs}
    env.update((id(node), (_bind_variable(node, args, aux),))
               for node, *_rest in variables if id(node) in wanted)
    return [env[nid][i] for nid, i in out_refs], aux_updates


def tp_consumers(plan, name, is_train=True):
    """Where the variable ``name`` is read on one path of a fused plan:
    ``(node, input position or None, override)`` for each entry that
    reads it as an input or as an override's extra ref (None).  A
    ``bn_fold`` site's conv refs are read at inference only."""
    uses = []
    for node, _a, _n, _x, _ix, override in plan:
        if node.op is None:
            continue
        for pos, (src, _i) in enumerate(node.inputs):
            if src.op is None and src.name == name:
                uses.append((node, pos, override))
        if override is not None:
            if is_train and getattr(override[0], "folds_conv", False):
                continue
            for src, _i in override[1]:
                if src.op is None and src.name == name:
                    uses.append((node, None, override))
    return uses


def _apply_tp_forms(plan, tp_forms):
    """``plan`` with the column/row overrides of ``tp_forms`` (param ->
    (form, axis)) on the weights' consumer nodes."""
    from .ops.nn import tp_layer
    out = []
    for entry in plan:
        node, override = entry[0], entry[5]
        if node.op is not None and override is None and \
                node.op.name in ("FullyConnected", "Convolution") and \
                len(node.inputs) > 1 and node.inputs[1][0].op is None:
            got = tp_forms.get(node.inputs[1][0].name)
            if got is not None:
                entry = entry[:5] + ((tp_layer(node.op.name, *got), []),)
        out.append(entry)
    return out


def _build_eval(symbol, mirror_segments=0, tp_forms=None,
                segment_scope=None, placement=None):
    """Return ``eval_fn(args, aux, is_train, rng, device=None,
    monitor=None) -> (outputs, aux_updates)`` over name -> tensor dicts,
    interpreting the plan as the mxfuse passes rewrote it
    (``MXTPU_FUSED_KERNELS=0`` skips them).  ``rng`` is the forward's
    integer seed; ``device`` is where nodes without tensor inputs
    (``_zeros``, the samplers) create their results (default: the first
    argument's device).

    Each path interprets only its live entries (:func:`mxfuse.
    live_entries`, the port's stand-in for XLA's dead-code elimination):
    ``eval_fn.train_plan`` in training, ``eval_fn.infer_plan`` otherwise.
    With ``infer_trace`` enabled the inference path also starts past its
    bind-time constants (:func:`mxfuse.fold_constants`, folded once per
    device at the first forward there).

    ``mirror_segments`` > 1 runs the training path, when torch records a
    graph, as that many checkpointed segments (``eval_fn.segments``; the
    memory mirror mode), each run inside ``segment_scope`` as
    :func:`_run_segments` takes it.  A ``monitor(node, outputs)`` callback runs the
    plain, unfused plan (``eval_fn.plain_plan``, every node) and sees each
    node's outputs.

    ``tp_forms`` (param -> (form, axis)) gives the training path the
    tensor-parallel forms of ``ops.nn.tp_layer`` on those weights'
    consumers (``column`` and ``row``; a mesh position runs the plan).

    ``placement`` (id(node) -> :class:`Context`) is ``group2ctx`` model
    parallelism over several devices (``mxnet_tpu/executor.py:105-200``):
    every path interprets the plain plan node by node, each node's inputs
    moved to its group's device first (``Tensor.to``, whose backward
    carries the gradient back across the boundary), with no mxfuse pass,
    no constant folding and no mirror segments."""
    from . import mxfuse
    from .kernels import fused_enabled
    out_refs = [(id(n), i) for n, i in symbol._outputs]
    plain_plan = _node_plan(symbol)
    if placement:
        if mirror_segments and mirror_segments > 1:
            import logging
            logging.warning(
                "MXNET_BACKWARD_DO_MIRROR ignored: group2ctx placement "
                "runs per-op eagerly, which checkpointed segments cannot "
                "wrap")
        devices = {k: c.torch_device for k, c in placement.items()}

        def placed_fn(args, aux, is_train, rng, device=None, monitor=None):
            env, aux_updates = {}, {}
            _run_plan_nodes(plain_plan, env, args, aux, is_train,
                            aux_updates, rng, device, monitor=monitor,
                            placement=devices)
            return [env[nid][i] for nid, i in out_refs], aux_updates
        placed_fn.plan = placed_fn.plain_plan = plain_plan
        placed_fn.train_plan = placed_fn.infer_plan = plain_plan
        placed_fn.segments = None
        placed_fn.out_refs = out_refs
        return placed_fn
    fused_plan = mxfuse.optimize_plan(plain_plan, out_refs)
    if tp_forms:
        fused_plan = _apply_tp_forms(fused_plan, tp_forms)
    train_plan = mxfuse.live_entries(fused_plan, out_refs, is_train=True)
    infer_plan = mxfuse.live_entries(fused_plan, out_refs)
    segments = _segments(train_plan, out_refs, mirror_segments) \
        if mirror_segments and mirror_segments > 1 else None
    variables = [e for e in train_plan if e[0].op is None]
    fold = fused_enabled("infer_trace")
    folded = {}     # device -> (const_env, remaining entries)

    def eval_fn(args, aux, is_train, rng, device=None, monitor=None):
        env = {}
        aux_updates = {}
        if device is None:
            device = next((t.device for t in args.values()),
                          torch.device("cpu"))
        if monitor is not None:
            chunk = plain_plan
        elif is_train:
            if segments is not None and torch.is_grad_enabled():
                return _run_segments(segments, variables, out_refs, args,
                                     aux, rng, device, segment_scope)
            chunk = train_plan
        elif fold:
            if device not in folded:
                folded[device] = mxfuse.fold_constants(infer_plan, device)
            const_env, chunk = folded[device]
            env.update(const_env)
        else:
            chunk = infer_plan
        _run_plan_nodes(chunk, env, args, aux, is_train, aux_updates, rng,
                        device, monitor=monitor)
        return [env[nid][i] for nid, i in out_refs], aux_updates
    eval_fn.plan = fused_plan
    eval_fn.plain_plan = plain_plan
    eval_fn.train_plan = train_plan
    eval_fn.infer_plan = infer_plan
    eval_fn.segments = segments
    eval_fn.out_refs = out_refs
    return eval_fn


#: open node-range requests (running device profiles): while above 0,
#: every interpreted node runs inside
#: ``torch.profiler.record_function(node.name)`` — the port's counterpart
#: of the JAX executor's ``jax.named_scope(node.name)``, paid only while a
#: profile runs
_NODE_RANGES = [0]


def node_ranges(on):
    """Open (``True``) or close one request for per-node profiler ranges
    (:mod:`~mxnet_tpu_torch.profiler` does, around a device trace)."""
    _NODE_RANGES[0] = max(0, _NODE_RANGES[0] + (1 if on else -1))


def _bind_variable(node, args, aux):
    if node.name in args:
        return args[node.name]
    if node.name in aux:
        return aux[node.name]
    raise MXNetError("unbound variable %r" % node.name)


def _moved(x, dev):
    return x if x is None or x.device == dev else x.to(dev)


def _run_plan_nodes(chunk, env, args, aux, is_train, aux_updates, rng,
                    device, memo=None, monitor=None, placement=None):
    """Interpret a slice of the node plan against ``env`` (id -> outputs
    tuple); ``rng`` is the forward's integer seed, ``device`` the one
    nodes without tensor inputs create their results on.  An override
    that sets ``uses_memo`` gets the run's ``memo`` dict (a new one unless
    given), where a merged ``concat_fuse`` group keeps the body its
    members slice.  ``monitor(node, outputs)`` sees every op node's
    outputs.  ``placement`` (id(node) -> torch device) moves each
    variable and each op's inputs to that node's device first."""
    from .mxfuse import dead_inputs
    memo = {} if memo is None else memo
    for node, call_attrs, n_out, aux_var_names, ix, override in chunk:
        if node.op is None:
            val = _bind_variable(node, args, aux)
            if placement is not None:
                val = _moved(val, placement[id(node)])
            env[id(node)] = (val,)
            continue
        kw = {}
        if node.op.needs_is_train or override is not None:
            # override bodies ALWAYS receive is_train, whatever the
            # underlying op declares
            kw["is_train"] = is_train
        if override is not None:
            # fusion override: fn replaces the op, with the referenced
            # extra inputs appended (conv data/weights).  Inputs the
            # override declared dead on this path ride as None
            fn, extra_refs = override[0], override[1]
            dead = dead_inputs(override, is_train)
            if getattr(fn, "uses_memo", False):
                kw["memo"] = memo
            ins = [None if pos in dead else env[id(src)][idx]
                   for pos, (src, idx) in enumerate(node.inputs)]
            for src, idx in extra_refs:
                if id(src) not in env and src.op is None:
                    env[id(src)] = (_bind_variable(src, args, aux),)
                ins.append(env[id(src)][idx])
        else:
            fn = node.op.fn
            ins = [env[id(src)][idx] for src, idx in node.inputs]
        if placement is not None:
            device = placement[id(node)]
            ins = [_moved(x, device) for x in ins]
        if not ins or node.op.needs_rng:
            on = next((t.device for t in ins if t is not None), device)
            if not ins and "ctx" in fn_signature_info(fn)[0]:
                call_attrs = dict(call_attrs, ctx=on)
            if node.op.needs_rng:
                kw["rng"] = _random.node_generator(rng, ix, on)
        if _NODE_RANGES[0]:
            with torch.profiler.record_function(node.name):
                out = fn(*ins, **call_attrs, **kw)
        else:
            out = fn(*ins, **call_attrs, **kw)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        env[id(node)] = tuple(out[:n_out])
        for name, arr in zip(aux_var_names, out[n_out:]):
            if name is not None:
                aux_updates[name] = arr
        if monitor is not None:
            monitor(node, env[id(node)])


class Executor(object):
    """Bound executor (parity: python/mxnet/executor.py).

    Arrays given as NDArrays on the executor's context are bound as they
    are (shared with the caller, as in the JAX package); anything else is
    copied onto the context.

    ``group2ctx`` maps ``ctx_group`` attributes to contexts.  A map that
    places every node on the executor's own context binds a plain
    executor, as in the JAX package; one over several contexts
    (``cpu(0)`` and ``cpu(1)`` are two, as they are in the JAX package)
    places each node on its group's context and interprets the plain plan
    node by node (:func:`_build_eval`'s ``placement``); an output's
    NDArray carries its group's context.  ``shared_exec`` is taken and,
    as in the JAX package, shares nothing.  With
    ``MXNET_BACKWARD_DO_MIRROR=1`` the training forward runs as
    checkpointed segments (:func:`mirror_segments_for`)."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None, shared_exec=None):
        self._symbol = symbol
        self._ctx = Context(ctx) if not isinstance(ctx, Context) else ctx
        self._group2ctx = dict(group2ctx or {})
        self._placement = _placement(symbol, self._group2ctx, self._ctx)
        self._monitor_callback = None
        self._monitor_all = False
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        self.arg_dict = _to_dict("args", args, arg_names, self._ctx)
        self.aux_dict = _to_dict("aux_states", aux_states, aux_names,
                                 self._ctx, allow_missing=not aux_names)
        self.grad_req = _req_dict(grad_req, arg_names)
        if args_grad is None:
            self.grad_dict = {}
        else:
            self.grad_dict = _to_dict("args_grad", args_grad, arg_names,
                                      self._ctx, allow_missing=True)
        self._diff_names = tuple(
            n for n in arg_names
            if self.grad_req.get(n, "null") != "null" and n in self.grad_dict)
        self._eval = _build_eval(symbol,
                                 mirror_segments=mirror_segments_for(symbol),
                                 placement=self._placement)
        self._out_ctx = [self._placement.get(id(n), self._ctx)
                         for n, _i in symbol._outputs]
        self._outputs = None      # list[NDArray]
        self._graph = None        # (outputs, leaves) of the last train forward
        self._grads = None        # name -> gradient tensor, once computed
        self._last_rng = None     # the seed of the last forward

    # -- construction helpers --------------------------------------------
    @staticmethod
    def _simple_bind(symbol, ctx, grad_req="write", type_dict=None,
                     group2ctx=None, shared_exec=None, shapes=None):
        arg_shapes, _, aux_shapes = symbol.infer_shape(**(shapes or {}))
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        arg_types, _, aux_types = symbol.infer_type(**(type_dict or {}))
        args = {name: nd_zeros(shape, ctx=ctx, dtype=np.dtype(typ))
                for name, shape, typ in zip(arg_names, arg_shapes, arg_types)}
        aux = {name: nd_zeros(shape, ctx=ctx, dtype=np.dtype(typ))
               for name, shape, typ in zip(aux_names, aux_shapes, aux_types)}
        req = _req_dict(grad_req, arg_names)
        grads = {name: nd_zeros(shape, ctx=ctx)
                 for name, shape in zip(arg_names, arg_shapes)
                 if req.get(name, "null") != "null"}
        return Executor(symbol, ctx, args, args_grad=grads, grad_req=grad_req,
                        aux_states=aux, group2ctx=group2ctx,
                        shared_exec=shared_exec)

    # -- dict/list views ---------------------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._symbol.list_arguments()]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n)
                for n in self._symbol.list_arguments()]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._symbol.list_auxiliary_states()]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    # -- execution ---------------------------------------------------------
    @staticmethod
    def _raw(d):
        return {k: v._data for k, v in d.items()}

    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` are bound first (an NDArray's tensor
        is bound as it is, anything else is written into the bound array,
        ``arg_dict[k][:] = v``).  ``is_train=True`` also applies the aux
        updates and keeps the graph for :meth:`backward`."""
        self._check_open()
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown forward argument %r" % k)
            if isinstance(v, NDArray):
                self.arg_dict[k]._data = v.as_in_context(self._ctx)._data
            else:
                self.arg_dict[k][:] = v
        args, aux = self._raw(self.arg_dict), self._raw(self.aux_dict)
        self._graph = None
        self._grads = None
        rng = self._last_rng = _random.next_seed()
        taps = [] if self._monitor_callback is not None else None
        monitor = None
        if taps is not None:
            def monitor(node, outs):
                if len(outs) == 1:
                    names = [node.name + "_output"]
                else:
                    names = ["%s_output%d" % (node.name, i)
                             for i in range(len(outs))]
                taps.extend(zip(names, outs))
            if self._monitor_all:
                taps.extend({**aux, **args}.items())
        if is_train and self._diff_names:
            outs, leaves, auxu = self._train_forward(args, aux, rng, monitor)
            self._graph = (outs, leaves)
        else:
            with torch.no_grad():
                outs, auxu = self._eval(args, aux, is_train, rng,
                                        self._ctx.torch_device,
                                        monitor=monitor)
        self._set_outputs(outs)
        if is_train:
            self._apply_aux(auxu)
        for name, arr in taps or ():
            self._monitor_callback(
                name, NDArray._from_torch(arr.detach(), self._ctx))
        return self._outputs

    def _set_outputs(self, outs):
        self._outputs = [NDArray._from_torch(o.detach(), c)
                         for o, c in zip(outs, self._out_ctx)]

    def _train_forward(self, args, aux, rng, monitor=None):
        """The plan in train mode with the ``_diff_names`` arguments as
        the only leaves that require grad, drawing from seed ``rng``."""
        leaves = {k: args[k].detach().requires_grad_(True)
                  for k in self._diff_names}
        merged = {k: v.detach() for k, v in args.items()}
        merged.update(leaves)
        with torch.enable_grad():
            outs, auxu = self._eval(merged, aux, True, rng,
                                    self._ctx.torch_device, monitor=monitor)
        return outs, leaves, auxu

    @staticmethod
    def _ones_heads(outs):
        """Ones head gradients in each output's dtype (the JAX package's
        ``_ones_heads`` :516, which loss layers ignore)."""
        return [torch.ones_like(o) for o in outs]

    @staticmethod
    def _differentiate(graph, heads):
        """name -> gradient of every leaf; a leaf the outputs do not
        depend on (a ``fix_gamma`` gamma) gets zeros, as ``jax.vjp``
        gives."""
        outs, leaves = graph
        names = list(leaves)
        pairs = [(o, h.to(o.device, o.dtype)) for o, h in zip(outs, heads)
                 if o.requires_grad]
        grads = [None] * len(names)
        if pairs:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [leaves[n] for n in names],
                [h for _, h in pairs], allow_unused=True)
        return {n: (g if g is not None else torch.zeros_like(leaves[n]))
                for n, g in zip(names, grads)}

    def _apply_aux(self, auxu):
        for name, arr in auxu.items():
            if name in self.aux_dict:
                dst = self.aux_dict[name]
                dst._data = _moved(arr.detach(), dst._data.device)

    #: ops whose backward supplies its OWN head gradient (their backward
    #: ignores the incoming one) — loss layers, which need no entry in a
    #: user-passed out_grads list
    _SELF_GRAD_OPS = frozenset((
        "MakeLoss", "make_loss", "SoftmaxOutput", "softmax_output",
        "LinearRegressionOutput", "MAERegressionOutput",
        "LogisticRegressionOutput", "SVMOutput", "BlockGrad", "stop_gradient",
    ))

    def _pad_out_grads(self, heads):
        """Match user heads to outputs the way the JAX package does
        (:541-586): loss outputs (self-gradient ops, ``need_top_grad=
        False`` Customs included) are skipped; the
        given heads fill the remaining outputs in order; anything left
        unmatched gets zeros, silently."""
        n_out = len(self._symbol._outputs)
        if len(heads) == n_out:
            return heads
        # zero cotangents match each output's shape and dtype: the
        # freshest forward outputs, else inferred shapes at float32
        if self._outputs is not None and len(self._outputs) == n_out:
            out_avals = [(o._data.shape, o._data.dtype)
                         for o in self._outputs]
        else:
            _, out_shapes, _ = self._symbol.infer_shape_partial(
                **{k: v.shape for k, v in self.arg_dict.items()})
            out_avals = [(s or (), torch.float32) for s in out_shapes]
        device = self._ctx.torch_device
        it = iter(heads)
        full = []
        for (node, _idx), (shape, dtype) in zip(self._symbol._outputs,
                                                out_avals):
            op_name = getattr(node.op, "name", None) if node.op else None
            self_grad = op_name in self._SELF_GRAD_OPS
            if op_name == "Custom":
                # a need_top_grad=False Custom is a loss layer
                from .operator import _prop_for
                try:
                    self_grad = not _prop_for(node.attrs).need_top_grad_
                except MXNetError:      # unknown op_type
                    self_grad = False
            if self_grad:
                full.append(torch.zeros(shape, dtype=dtype, device=device))
            else:
                g = next(it, None)
                full.append(torch.zeros(shape, dtype=dtype, device=device)
                            if g is None else g)
        leftover = list(it)
        if leftover:
            raise MXNetError(
                "backward: %d out_grads given but only %d outputs "
                "accept head gradients" % (len(heads),
                                           len(heads) - len(leftover)))
        return full

    def backward(self, out_grads=None):
        """Write gradients into the grad arrays (``grad_req`` write or
        add).  Without ``out_grads`` the gradients of the last train
        forward, with ones heads, are computed once and kept; with
        ``out_grads`` they are computed anew for those heads (re-running
        the train forward with the last forward's seed, without its aux
        update, when its graph was already used)."""
        self._check_open()
        if not self._diff_names:
            return
        if out_grads is not None:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            heads = [g._data if isinstance(g, NDArray) else
                     g if isinstance(g, torch.Tensor) else
                     tensor_from_numpy(np.asarray(g)) for g in out_grads]
            heads = self._pad_out_grads(heads)
            graph = self._graph
            if graph is None:
                args, aux = self._raw(self.arg_dict), self._raw(self.aux_dict)
                if self._last_rng is None:
                    self._last_rng = _random.next_seed()
                outs, leaves, _auxu = self._train_forward(args, aux,
                                                          self._last_rng)
                self._set_outputs(outs)
                graph = (outs, leaves)
            self._grads = self._differentiate(graph, heads)
            self._graph = None
        if self._grads is None:
            graph = self._graph
            if graph is None:
                # forward(is_train=True) was not called — run it now
                args, aux = self._raw(self.arg_dict), self._raw(self.aux_dict)
                rng = self._last_rng = _random.next_seed()
                outs, leaves, auxu = self._train_forward(args, aux, rng)
                self._set_outputs(outs)
                self._apply_aux(auxu)
                graph = (outs, leaves)
            self._grads = self._differentiate(graph,
                                              self._ones_heads(graph[0]))
            self._graph = None
        for name in self._diff_names:
            garr = self.grad_dict[name]
            g = self._grads[name].to(garr._data.dtype)
            if self.grad_req[name] == "add":
                garr._data = garr._data + g
            else:
                garr._data = g

    @property
    def outputs(self):
        if self._outputs is None:
            self.forward()
        return self._outputs

    # -- monitor taps (mx.mon.Monitor) ---------------------------------------
    def set_monitor_callback(self, callback, monitor_all=False):
        """Install a per-node output tap (reference
        MXExecutorSetMonitorCallback; ``mxnet_tpu/executor.py:636-641``).
        While one is installed, forwards interpret the plain, unfused plan
        and call ``callback(name, NDArray)`` with each node's outputs as
        ``<node>_output`` (``<node>_output<i>``), after the args and aux
        states with ``monitor_all``.  A training forward keeps its graph
        for ``backward`` as an untapped one does."""
        self._monitor_callback = callback
        self._monitor_all = monitor_all

    # -- lifecycle ----------------------------------------------------------
    def _check_open(self):
        if self._eval is None:
            raise MXNetError("this executor is closed")

    def close(self):
        """Free what this executor owns: its outputs, the graph of a
        training forward not yet differentiated, the gradients it keeps
        and its plan with the constants folded into it
        (``mxnet_tpu/executor.py:759-804``).  The bound arg, grad and aux
        arrays are the caller's (they may be shared with other executors
        or be the caller's parameters): the executor only lets go of them.
        An output that is one of those arrays' tensors is left alone.  The
        executor is unusable afterwards; a second call does nothing."""
        bound = {id(arr._data)
                 for d in (self.arg_dict, self.aux_dict, self.grad_dict)
                 for arr in d.values()}
        for out in self._outputs or ():
            if id(out._data) not in bound:
                out._data = out._data.new_empty((0,))
        self._outputs = None
        self._graph = None
        self._grads = None
        self.arg_dict, self.aux_dict, self.grad_dict = {}, {}, {}
        self._eval = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
        return False

    # -- misc ---------------------------------------------------------------
    def debug_str(self):
        """The bound graph as text (``mxnet_tpu/executor.py:713``): the
        outputs, then each variable and op with its inputs."""
        lines = ["Symbol Outputs:"]
        for name in self._symbol.list_outputs():
            lines.append("\toutput[%s]" % name)
        for node in self._symbol._nodes():
            if node.is_variable:
                lines.append("Variable:%s" % node.name)
            else:
                ins = ", ".join(s.name for s, _ in node.inputs)
                lines.append("Op:%s, Name=%s\n\tInputs:\n\t\t%s"
                             % (node.op.name, node.name, ins))
        return "\n".join(lines)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                dst = self.arg_dict[name]
                dst._data = arr._data.to(dst._data.device, dst._data.dtype)
            elif not allow_extra_params:
                raise MXNetError("unknown argument %r" % name)
        if aux_params:
            for name, arr in aux_params.items():
                if name in self.aux_dict:
                    dst = self.aux_dict[name]
                    dst._data = arr._data.to(dst._data.device,
                                             dst._data.dtype)
                elif not allow_extra_params:
                    raise MXNetError("unknown aux state %r" % name)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **new_shapes):
        """A new executor for new input shapes, sharing the parameter
        arrays whose shapes stay (executor.py:reshape)."""
        arg_shapes, _, _ = self._symbol.infer_shape(**new_shapes)
        arg_names = self._symbol.list_arguments()
        new_args, new_grads = {}, {}
        for name, shape in zip(arg_names, arg_shapes):
            cur = self.arg_dict[name]
            if cur.shape == tuple(shape):
                new_args[name] = cur
                if name in self.grad_dict:
                    new_grads[name] = self.grad_dict[name]
            else:
                if name not in new_shapes and not partial_shaping:
                    raise MXNetError(
                        "reshape changes the shape of parameter %r from %s to "
                        "%s; pass partial_shaping=True to allow reallocating "
                        "it (contents are NOT preserved)"
                        % (name, cur.shape, tuple(shape)))
                new_args[name] = nd_zeros(shape, ctx=self._ctx)
                if name in self.grad_dict:
                    new_grads[name] = nd_zeros(shape, ctx=self._ctx)
        return Executor(self._symbol, self._ctx, new_args,
                        args_grad=new_grads or None, grad_req=self.grad_req,
                        aux_states=self.aux_dict, group2ctx=self._group2ctx)


def _placement(symbol, group2ctx, ctx):
    """id(node) -> the :class:`Context` of each node under ``group2ctx``
    (its ``ctx_group``'s, else the bind context ``ctx``), as the JAX
    executor resolves it (``mxnet_tpu/executor.py:382-395``); empty when
    every node lands on one context (a plain executor)."""
    if not group2ctx:
        return {}
    placement = {}
    for node in symbol._nodes():
        grp = node.attrs.get("ctx_group")
        c = group2ctx.get(grp) if grp else None
        placement[id(node)] = ctx if c is None else \
            (c if isinstance(c, Context) else Context(c))
    if len(set(placement.values())) <= 1:
        return {}
    return placement


def _as_bound(v, ctx):
    if isinstance(v, NDArray):
        return v.as_in_context(ctx)
    return NDArray(v, ctx=ctx)


def _to_dict(what, values, names, ctx, allow_missing=False):
    if values is None:
        if allow_missing:
            return {}
        raise MXNetError("%s must be provided" % what)
    if isinstance(values, dict):
        out = {}
        for name in names:
            if name in values:
                out[name] = _as_bound(values[name], ctx)
            elif not allow_missing:
                raise MXNetError("%s: missing entry %r" % (what, name))
        return out
    values = list(values)
    if len(values) != len(names):
        raise MXNetError("%s: length mismatch (%d given, %d needed: %s)"
                         % (what, len(values), len(names), names))
    return {n: _as_bound(v, ctx) for n, v in zip(names, values)
            if v is not None}


def _req_dict(grad_req, arg_names):
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    if isinstance(grad_req, dict):
        return {n: grad_req.get(n, "null") for n in arg_names}
    raise MXNetError("invalid grad_req %r" % (grad_req,))
