"""Symbol — declarative graph construction (port of ``mxnet_tpu/symbol.py``).

A Symbol is a list of (node, output_index) heads over a DAG of ``_Node``
objects.  The JSON form is the JAX package's, byte for byte, so a graph
built or saved by either package loads in the other.  Shape inference of
ops without their own ``infer_shape`` runs the op on ``device="meta"``
tensors, where the JAX package used ``jax.eval_shape``.
"""
from __future__ import annotations

import builtins
import json

import numpy as np
import torch

from . import attribute, name as _name_mod
from .base import MXNetError, attr_to_string, parse_attr_value
from .ops.registry import OP_REGISTRY, fn_signature_info, get_op

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "pow", "maximum", "minimum"]

# attrs that belong to the framework, not to the op's kernel
_RESERVED_ATTRS = frozenset((
    "ctx_group", "lr_mult", "wd_mult", "force_mirroring", "__shape__",
    "__dtype__", "__init__",
))


class _Node(object):
    __slots__ = ("op", "name", "attrs", "inputs")

    def __init__(self, op, name, attrs=None, inputs=None):
        self.op = op          # OpDef or None for variables
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        self.inputs = list(inputs) if inputs else []  # [(node, out_idx)]

    @property
    def is_variable(self):
        return self.op is None

    def op_attrs(self):
        """Attrs passed to the op function (reserved/meta attrs stripped)."""
        return {k: v for k, v in self.attrs.items()
                if k not in _RESERVED_ATTRS and not k.startswith("__")}

    def num_outputs(self):
        if self.is_variable:
            return 1
        return self.op.get_num_outputs(self.op.normalize_attrs(self.op_attrs()))


def _topo_sort(heads):
    """Post-order DFS over the DAG."""
    visited = set()
    order = []
    stack = [(h, False) for h in reversed(heads)]
    while stack:
        node, processed = stack.pop()
        if processed:
            order.append(node)
            continue
        if id(node) in visited:
            continue
        visited.add(id(node))
        stack.append((node, True))
        for src, _idx in reversed(node.inputs):
            if id(src) not in visited:
                stack.append((src, False))
    return order


class Symbol(object):
    __slots__ = ("_outputs",)

    def __init__(self, outputs):
        self._outputs = list(outputs)  # [(node, out_idx)]

    # -- introspection ----------------------------------------------------
    def _nodes(self):
        return _topo_sort([n for n, _ in self._outputs])

    def _aux_var_names(self):
        """Variable names that feed aux-state slots of ops."""
        aux = set()
        for node in self._nodes():
            if node.is_variable:
                continue
            attrs = node.op.normalize_attrs(node.op_attrs())
            n_in = len(node.op.get_input_names(attrs))
            aux_names = node.op.get_aux_names(attrs)
            for k, (src, _idx) in enumerate(node.inputs):
                if n_in <= k < n_in + len(aux_names) and src.is_variable:
                    aux.add(src.name)
        return aux

    def _variables(self, want_aux):
        aux = self._aux_var_names()
        out, seen = [], set()
        for node in self._nodes():
            if node.is_variable and (node.name in aux) == want_aux \
                    and node.name not in seen:
                seen.add(node.name)
                out.append(node.name)
        return out

    def list_arguments(self):
        return self._variables(want_aux=False)

    def list_auxiliary_states(self):
        return self._variables(want_aux=True)

    def list_outputs(self):
        names = []
        for node, idx in self._outputs:
            if node.is_variable:
                names.append(node.name)
                continue
            attrs = node.op.normalize_attrs(node.op_attrs())
            out_names = node.op.get_output_names(attrs)
            if node.num_outputs() == 1:
                names.append(node.name + "_output")
            else:
                names.append("%s_%s" % (node.name, out_names[idx]))
        return names

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def attr(self, key):
        """The string value of attribute ``key`` of this (single-output)
        symbol's node, or None."""
        if len(self._outputs) == 1:
            v = self._outputs[0][0].attrs.get(key)
            return attr_to_string(v) if v is not None else None
        return None

    def list_attr(self):
        """This (single-output) symbol's node attributes as strings."""
        if len(self._outputs) == 1:
            return {k: attr_to_string(v)
                    for k, v in self._outputs[0][0].attrs.items()}
        return {}

    def attr_dict(self):
        """``{node name: {attr: string value}}`` for every node with attrs
        (the optimizer reads ``lr_mult``/``wd_mult`` here)."""
        out = {}
        for node in self._nodes():
            if node.attrs:
                out[node.name] = {k: attr_to_string(v)
                                  for k, v in node.attrs.items()}
        return out

    def _set_attr(self, **kwargs):
        for node, _ in self._outputs:
            node.attrs.update(kwargs)

    def get_internals(self):
        outs = []
        for node in self._nodes():
            for i in range(node.num_outputs()):
                outs.append((node, i))
        return Symbol(outs)

    def get_children(self):
        """The inputs of this (single-output) symbol's node as one
        grouped symbol, or None for a variable."""
        if len(self._outputs) != 1:
            return None
        node = self._outputs[0][0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("cannot find output %r; outputs=%s" % (index, names))
            index = names.index(index)
        if isinstance(index, builtins.slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        for i in range(len(self._outputs)):
            yield self[i]

    def __repr__(self):
        if len(self._outputs) == 1:
            return "<Symbol %s>" % self._outputs[0][0].name
        return "<Symbol group [%s]>" % ", ".join(self.list_outputs())

    # -- composition ------------------------------------------------------
    def __call__(self, **kwargs):
        """Compose: replace variables by other symbols."""
        mapping = {}
        for k, v in kwargs.items():
            if not isinstance(v, Symbol):
                raise TypeError("compose expects Symbols")
            mapping[k] = v._outputs[0]
        memo = {}

        def rewrite_pair(node, idx):
            if node.is_variable and node.name in mapping:
                return mapping[node.name]
            if id(node) not in memo:
                new = _Node(node.op, node.name, node.attrs, [])
                memo[id(node)] = new
                new.inputs = [rewrite_pair(s, i) for s, i in node.inputs]
            return (memo[id(node)], idx)

        return Symbol([rewrite_pair(n, i) for n, i in self._outputs])

    # -- arithmetic (the JAX package's :227-291) -------------------------
    def _binary(self, other, op_name, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _create(op_name, [a, b], {})
        if isinstance(other, (int, float, np.number)):
            return _create(scalar_op, [self], {"scalar": float(other)})
        return NotImplemented

    def __add__(self, o):
        return self._binary(o, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "elemwise_sub", "_rminus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __div__(self, o):
        return self._binary(o, "elemwise_div", "_div_scalar")

    __truediv__ = __div__

    def __rdiv__(self, o):
        return self._binary(o, "elemwise_div", "_rdiv_scalar", reverse=True)

    __rtruediv__ = __rdiv__

    def __pow__(self, o):
        return self._binary(o, "_power", "_power_scalar")

    def __neg__(self):
        return _create("_mul_scalar", [self], {"scalar": -1.0})

    def __eq__(self, o):
        if isinstance(o, (Symbol, int, float)):
            return self._binary(o, "broadcast_equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (Symbol, int, float)):
            return self._binary(o, "broadcast_not_equal",
                                "_not_equal_scalar")
        return NotImplemented

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

    # -- shape inference --------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        arg_shapes, out_shapes, aux_shapes = self.infer_shape_partial(*args, **kwargs)
        if arg_shapes is not None and any(s is None for s in arg_shapes):
            unknown = [n for n, s in zip(self.list_arguments(), arg_shapes)
                       if s is None]
            raise MXNetError(
                "InferShape incomplete: cannot infer shapes of %s" % unknown)
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        if args:
            kwargs = dict(zip(self.list_arguments(), args))
            kwargs = {k: v for k, v in kwargs.items() if v is not None}
        known = {k: tuple(v) for k, v in kwargs.items() if v is not None}
        shapes = {}   # id(node) -> list of output shapes
        nodes = self._nodes()
        for node in nodes:
            if node.is_variable:
                s = known.get(node.name)
                if s is None and "__shape__" in node.attrs:
                    s = tuple(parse_attr_value(node.attrs["__shape__"]))
                shapes[id(node)] = [tuple(s) if s is not None else None]
                continue
            attrs = node.op.normalize_attrs(node.op_attrs())
            in_shapes = [shapes[id(src)][idx] for src, idx in node.inputs]
            new_in, out_sh = _infer_node(node, attrs, in_shapes)
            # back-fill variable shapes learned by the op's shape function
            for (src, _idx), s in zip(node.inputs, new_in):
                if s is not None and src.is_variable and shapes[id(src)][0] is None:
                    shapes[id(src)][0] = tuple(s)
                    known[src.name] = tuple(s)
            shapes[id(node)] = list(out_sh)
        by_name = {n.name: shapes[id(n)][0] for n in nodes if n.is_variable}
        arg_shapes = [by_name.get(n) for n in self.list_arguments()]
        aux_shapes = [by_name.get(n) for n in self.list_auxiliary_states()]
        out_shapes = [shapes[id(n)][i] for n, i in self._outputs]
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """Basic dtype inference, as in the JAX package: float32 unless a
        hint or a ``Variable(dtype=...)`` declaration says otherwise."""
        if args:
            kwargs = dict(zip(self.list_arguments(), args))
        dt = {k: np.dtype(v) for k, v in kwargs.items() if v is not None}
        for node in self._nodes():
            if node.is_variable and "__dtype__" in node.attrs:
                dt.setdefault(node.name, np.dtype(str(node.attrs["__dtype__"])))
        arg_types = [np.dtype(dt.get(n, np.float32)).type
                     for n in self.list_arguments()]
        aux_types = [np.float32 for _ in self.list_auxiliary_states()]
        out_types = [np.float32 for _ in self._outputs]
        return arg_types, out_types, aux_types

    # -- serialization ----------------------------------------------------
    def tojson(self):
        nodes = self._nodes()
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        arg_nodes = []
        for i, node in enumerate(nodes):
            if node.is_variable:
                arg_nodes.append(i)
            jnodes.append({
                "op": "null" if node.is_variable else node.op.name,
                "name": node.name,
                "attrs": {k: attr_to_string(v) for k, v in node.attrs.items()},
                "inputs": [[nid[id(s)], idx, 0] for s, idx in node.inputs],
            })
        heads = [[nid[id(n)], idx, 0] for n, idx in self._outputs]
        # the version tag is the JAX package's, so both write the same text
        return json.dumps({
            "nodes": jnodes, "arg_nodes": arg_nodes, "heads": heads,
            "attrs": {"mxnet_tpu_version": "0.1.0"},
        }, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- binding ----------------------------------------------------------
    def simple_bind(self, ctx, grad_req="write", type_dict=None, **kwargs):
        """Bind with every argument, gradient and aux state allocated
        (zeros) from the shapes in ``kwargs``."""
        from .executor import Executor
        return Executor._simple_bind(self, ctx, grad_req=grad_req,
                                     type_dict=type_dict, shapes=kwargs)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None):
        from .executor import Executor
        return Executor(self, ctx, args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states)

    def grad(self, wrt):
        """Not available, as in the JAX package (:390-392): bind and call
        ``backward()``."""
        raise NotImplementedError(
            "Symbol.grad: use bind(...).backward() or autograd")

    # -- eval convenience -------------------------------------------------
    def eval(self, ctx=None, **kwargs):
        """Bind the arguments in ``kwargs`` (no gradients) and run one
        forward; returns the outputs (a list of NDArrays)."""
        from .context import current_context
        ctx = ctx or current_context()
        return self.bind(ctx, kwargs).forward()


def _infer_node(node, attrs, in_shapes):
    """Shape inference for one node: the op's own function, else the op
    run on ``meta`` tensors (shapes only, no data, no device)."""
    op = node.op
    if op.infer_shape is not None:
        new_in, out_sh, _aux = op.infer_shape(attrs, in_shapes)
        # custom infers cover declared inputs; aux inputs trail
        n_declared = len(new_in)
        full_in = list(new_in) + list(in_shapes[n_declared:])
        if _aux:
            n_in = len(op.get_input_names(attrs))
            for k, s in enumerate(_aux):
                if n_in + k < len(full_in) and full_in[n_in + k] is None:
                    full_in[n_in + k] = s
        return full_in, out_sh
    if any(s is None for s in in_shapes):
        return in_shapes, [None] * op.get_num_outputs(attrs)
    names, has_var_kw = fn_signature_info(op.fn)
    call_attrs = dict(attrs) if has_var_kw else \
        {k: v for k, v in attrs.items() if k in names}
    kw = {"is_train": False} if op.needs_is_train else {}
    if op.needs_rng:
        kw["rng"] = None
    if not in_shapes and "ctx" in names:
        call_attrs["ctx"] = torch.device("meta")
    metas = [torch.empty(s, dtype=torch.float32, device="meta")
             for s in in_shapes]
    try:
        out = op.fn(*metas, **call_attrs, **kw)
    except Exception as e:  # noqa: BLE001 — any op failure is a shape error
        raise MXNetError("InferShape failed for op %s(%s): %s"
                         % (op.name, node.name, e)) from e
    if not isinstance(out, (tuple, list)):
        out = (out,)
    n_out = op.get_num_outputs(attrs)
    return in_shapes, [tuple(o.shape) for o in out][:n_out]


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------

def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs):
    """Create a variable symbol."""
    attrs = attribute.current().get(attr)
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        attrs["__dtype__"] = str(np.dtype(dtype))
    if lr_mult is not None:
        attrs["lr_mult"] = str(lr_mult)
    if wd_mult is not None:
        attrs["wd_mult"] = str(wd_mult)
    attrs.update({k: str(v) for k, v in kwargs.items()})
    return Symbol([(_Node(None, name, attrs), 0)])


var = Variable


def Group(symbols):
    """One symbol whose outputs are all the given symbols' outputs."""
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def _create(op_name, input_syms, attrs, name=None, extra_attr=None,
            named_inputs=None):
    """Create an op node.  ``input_syms`` are positional inputs (all of a
    ``variable_inputs`` op's); ``named_inputs`` maps input-name -> Symbol.
    Missing parameter/aux inputs are auto-created as Variables named
    ``{node}_{input}``."""
    op = get_op(op_name)
    op.validate_attrs(attrs, where="symbol")
    norm = op.normalize_attrs(attrs)
    hint = op.name.lstrip("_").lower()
    node_name = _name_mod.current().get(name, hint)
    node_attrs = dict(attrs)
    if extra_attr:
        node_attrs.update(extra_attr)
    for k, v in attribute.current().get(None).items():
        node_attrs.setdefault(k, v)

    def head(s):
        if len(s._outputs) != 1:
            raise MXNetError("op %s input must be single-output symbol" % op_name)
        return s._outputs[0]

    in_names = op.get_input_names(norm)
    aux_names = op.get_aux_names(norm)
    if op.variable_inputs:
        inputs = [head(s) for s in input_syms]
        for nm in list(in_names)[len(inputs):]:
            inputs.append(Variable("%s_%s" % (node_name, nm))._outputs[0])
        node = _Node(op, node_name, node_attrs, inputs)
        return Symbol([(node, i) for i in range(node.num_outputs())])
    by_name = dict(named_inputs or {})
    for nm, s in zip(in_names, input_syms):
        if nm in by_name:
            raise MXNetError(
                "op %s: input %r given both positionally and by keyword"
                % (op_name, nm))
        by_name[nm] = s
    unknown = set(by_name) - set(in_names) - set(aux_names)
    if unknown:
        raise MXNetError("op %s: unknown input name(s) %s; inputs are %s"
                         % (op_name, sorted(unknown),
                            list(in_names) + list(aux_names)))
    inputs = []
    for nm in list(in_names) + list(aux_names):
        if nm in by_name:
            inputs.append(head(by_name[nm]))
        else:
            inputs.append(Variable("%s_%s" % (node_name, nm))._outputs[0])
    node = _Node(op, node_name, node_attrs, inputs)
    n_out = node.num_outputs()
    return Symbol([(node, i) for i in range(n_out)])


def _make_symbol_function(opdef, func_name):
    def creator(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        sym_kwargs = {}
        attrs = {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                sym_kwargs[k] = v
            else:
                attrs[k] = v
        if opdef.variable_inputs:
            inputs = [a for a in args if isinstance(a, Symbol)]
            if not inputs and sym_kwargs:
                inputs = list(sym_kwargs.values())
            attrs.setdefault("num_args", len(inputs))
            sym_kwargs = None
        else:
            for a in args:
                if not isinstance(a, Symbol):
                    raise TypeError(
                        "positional args to sym.%s must be Symbols"
                        % func_name)
            inputs = list(args)
        extra = attribute.current().get(attr)
        return _create(opdef.name, inputs, attrs, name=name,
                       extra_attr=extra, named_inputs=sym_kwargs)

    creator.__name__ = func_name
    creator.__doc__ = opdef.doc
    return creator


def _init_symbol_module():
    """One creator per registered op name: ``sym.Convolution`` etc."""
    module = globals()
    for reg_name, opdef in list(OP_REGISTRY.items()):
        if reg_name not in module:
            module[reg_name] = _make_symbol_function(opdef, reg_name)


# ---------------------------------------------------------------------------
# JSON load
# ---------------------------------------------------------------------------

def load_json(json_str):
    data = json.loads(json_str)
    jnodes = data["nodes"]
    nodes = []
    for jn in jnodes:
        attrs = jn.get("attrs", jn.get("attr", jn.get("param", {}))) or {}
        op = None if jn["op"] == "null" else get_op(jn["op"])
        nodes.append(_Node(op, jn["name"], attrs))
    for jn, node in zip(jnodes, nodes):
        node.inputs = [(nodes[i[0]], i[1]) for i in jn["inputs"]]
    heads = data.get("heads")
    if not heads:
        heads = [[len(nodes) - 1, 0, 0]]
    return Symbol([(nodes[h[0]], h[1]) for h in heads])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def pow(base, exp):  # noqa: A001 - parity with mx.sym.pow
    return base ** exp


def maximum(left, right):
    if isinstance(left, Symbol) and isinstance(right, Symbol):
        return _create("_maximum", [left, right], {})
    if isinstance(left, Symbol):
        return _create("_maximum_scalar", [left], {"scalar": float(right)})
    return _create("_maximum_scalar", [right], {"scalar": float(left)})


def minimum(left, right):
    if isinstance(left, Symbol) and isinstance(right, Symbol):
        return _create("_minimum", [left, right], {})
    if isinstance(left, Symbol):
        return _create("_minimum_scalar", [left], {"scalar": float(right)})
    return _create("_minimum_scalar", [right], {"scalar": float(left)})
