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

import numpy as np
import torch

from . import random as _random
from .base import MXNetError
from .context import Context
from .ndarray import NDArray, tensor_from_numpy, zeros as nd_zeros
from .ops.registry import fn_signature_info

__all__ = ["Executor"]


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


def _build_eval(symbol):
    """Return ``eval_fn(args, aux, is_train, rng, device=None) ->
    (outputs, aux_updates)`` over name -> tensor dicts, interpreting the
    plan as the mxfuse passes rewrote it (``MXTPU_FUSED_KERNELS=0`` skips
    them).  ``rng`` is the forward's integer seed; ``device`` is where
    nodes without tensor inputs (``_zeros``, the samplers) create their
    results (default: the first argument's device).

    Each path interprets only its live entries (:func:`mxfuse.
    live_entries`, the port's stand-in for XLA's dead-code elimination):
    ``eval_fn.train_plan`` in training, ``eval_fn.infer_plan`` otherwise.
    With ``infer_trace`` enabled the inference path also starts past its
    bind-time constants (:func:`mxfuse.fold_constants`, folded once per
    device at the first forward there)."""
    from . import mxfuse
    from .kernels import fused_enabled
    out_refs = [(id(n), i) for n, i in symbol._outputs]
    fused_plan = mxfuse.optimize_plan(_node_plan(symbol), out_refs)
    train_plan = mxfuse.live_entries(fused_plan, out_refs, is_train=True)
    infer_plan = mxfuse.live_entries(fused_plan, out_refs)
    fold = fused_enabled("infer_trace")
    folded = {}     # device -> (const_env, remaining entries)

    def eval_fn(args, aux, is_train, rng, device=None):
        env = {}
        aux_updates = {}
        if device is None:
            device = next((t.device for t in args.values()),
                          torch.device("cpu"))
        if is_train:
            chunk = train_plan
        elif fold:
            if device not in folded:
                folded[device] = mxfuse.fold_constants(infer_plan, device)
            const_env, chunk = folded[device]
            env.update(const_env)
        else:
            chunk = infer_plan
        _run_plan_nodes(chunk, env, args, aux, is_train, aux_updates, rng,
                        device)
        return [env[nid][i] for nid, i in out_refs], aux_updates
    eval_fn.plan = fused_plan
    eval_fn.train_plan = train_plan
    eval_fn.infer_plan = infer_plan
    eval_fn.out_refs = out_refs
    return eval_fn


def _bind_variable(node, args, aux):
    if node.name in args:
        return args[node.name]
    if node.name in aux:
        return aux[node.name]
    raise MXNetError("unbound variable %r" % node.name)


def _run_plan_nodes(chunk, env, args, aux, is_train, aux_updates, rng,
                    device):
    """Interpret a slice of the node plan against ``env`` (id -> outputs
    tuple); ``rng`` is the forward's integer seed, ``device`` the one
    nodes without tensor inputs create their results on.  An override
    that sets ``uses_memo`` gets this run's ``memo`` dict, where a merged
    ``concat_fuse`` group keeps the body its members slice."""
    from .mxfuse import dead_inputs
    memo = {}
    for node, call_attrs, n_out, aux_var_names, ix, override in chunk:
        if node.op is None:
            env[id(node)] = (_bind_variable(node, args, aux),)
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
        if not ins or node.op.needs_rng:
            on = next((t.device for t in ins if t is not None), device)
            if not ins and "ctx" in fn_signature_info(fn)[0]:
                call_attrs = dict(call_attrs, ctx=on)
            if node.op.needs_rng:
                kw["rng"] = _random.node_generator(rng, ix, on)
        out = fn(*ins, **call_attrs, **kw)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        env[id(node)] = tuple(out[:n_out])
        for name, arr in zip(aux_var_names, out[n_out:]):
            if name is not None:
                aux_updates[name] = arr


class Executor(object):
    """Bound executor (parity: python/mxnet/executor.py).

    Arrays given as NDArrays on the executor's context are bound as they
    are (shared with the caller, as in the JAX package); anything else is
    copied onto the context."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._symbol = symbol
        self._ctx = Context(ctx) if not isinstance(ctx, Context) else ctx
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
        self._eval = _build_eval(symbol)
        self._outputs = None      # list[NDArray]
        self._graph = None        # (outputs, leaves) of the last train forward
        self._grads = None        # name -> gradient tensor, once computed
        self._last_rng = None     # the seed of the last forward

    # -- construction helpers --------------------------------------------
    @staticmethod
    def _simple_bind(symbol, ctx, grad_req="write", type_dict=None,
                     shapes=None):
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
                        aux_states=aux)

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
        if is_train and self._diff_names:
            outs, leaves, auxu = self._train_forward(args, aux, rng)
            self._graph = (outs, leaves)
        else:
            with torch.no_grad():
                outs, auxu = self._eval(args, aux, is_train, rng,
                                        self._ctx.torch_device)
        self._set_outputs(outs)
        if is_train:
            self._apply_aux(auxu)
        return self._outputs

    def _set_outputs(self, outs):
        self._outputs = [NDArray._from_torch(o.detach(), self._ctx)
                         for o in outs]

    def _train_forward(self, args, aux, rng):
        """The plan in train mode with the ``_diff_names`` arguments as
        the only leaves that require grad, drawing from seed ``rng``."""
        leaves = {k: args[k].detach().requires_grad_(True)
                  for k in self._diff_names}
        merged = dict(args)
        merged.update(leaves)
        with torch.enable_grad():
            outs, auxu = self._eval(merged, aux, True, rng,
                                    self._ctx.torch_device)
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
                self.aux_dict[name]._data = arr.detach()

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
        (:541-586): loss outputs (self-gradient ops) are skipped; the
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
            if op_name in self._SELF_GRAD_OPS:
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

    # -- misc ---------------------------------------------------------------
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
                        aux_states=self.aux_dict)


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
