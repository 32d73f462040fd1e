"""Operator registry — the single source of truth for the port's ops.

Port of ``mxnet_tpu/ops/registry.py:48-201``.  Each op is a plain function
over ``torch.Tensor``s; the executor interprets the Symbol DAG by calling
them in topological order.

Op conventions (unchanged from the JAX package)
-----------------------------------------------
``fn(*inputs, **attrs)`` -> Tensor | tuple of Tensors
  - inputs are the op's data+parameter inputs, in ``input_names`` order,
    followed by aux states in ``aux_names`` order (BatchNorm moving stats).
  - if ``needs_is_train``: fn must accept keyword ``is_train`` (bool).
  - if ``needs_rng``: fn must accept keyword ``rng``, a ``torch.Generator``
    on the op's device (the JAX package passes a PRNG key).
  - ``variable_inputs`` ops (Concat) take their inputs positionally, as
    many as the ``num_args`` attr says; ``hidden`` ops (``_FusedLSTMCell``)
    are emitted by the framework, not written by users.
  - ops with aux states return outputs + updated aux concatenated in one
    flat tuple; the executor splits on ``num_outputs``.
"""
from __future__ import annotations

import difflib
import functools
import inspect

from ..base import MXNetError, parse_attr_value

__all__ = ["OpDef", "register", "get_op", "list_ops", "OP_REGISTRY",
           "fn_signature_info", "FRAMEWORK_ATTRS"]

OP_REGISTRY = {}

# attrs the framework itself attaches to nodes (AttrScope / optimizer
# multipliers / graph plumbing) — always allowed alongside op params
FRAMEWORK_ATTRS = frozenset({
    "ctx_group", "lr_mult", "wd_mult", "force_mirroring", "mirror_stage",
    "num_args",
})


@functools.lru_cache(maxsize=2048)
def fn_signature_info(fn):
    """(keyword-accepting param names, has **kwargs) of a lowering fn —
    shared by attr validation here and executor._filter_attrs."""
    params = inspect.signature(fn).parameters
    has_var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                     for p in params.values())
    names = frozenset(p.name for p in params.values()
                      if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                                    inspect.Parameter.KEYWORD_ONLY))
    return names, has_var_kw


class OpDef(object):
    __slots__ = (
        "name", "fn", "input_names", "aux_names", "num_outputs",
        "infer_shape", "needs_is_train", "needs_rng", "variable_inputs",
        "aliases", "output_names", "hidden", "doc", "_accepted",
    )

    def __init__(self, name, fn, input_names=("data",), aux_names=(),
                 num_outputs=1, infer_shape=None, needs_is_train=False,
                 needs_rng=False, variable_inputs=False, aliases=(),
                 output_names=None, hidden=False):
        self.name = name
        self.fn = fn
        self.input_names = input_names          # tuple | callable(attrs)->tuple
        self.aux_names = aux_names              # tuple | callable(attrs)->tuple
        self.num_outputs = num_outputs          # int | callable(attrs)->int
        self.infer_shape = infer_shape          # optional custom shape inference
        self.needs_is_train = needs_is_train
        self.needs_rng = needs_rng
        self.variable_inputs = variable_inputs
        self.aliases = tuple(aliases)
        self.output_names = output_names        # tuple | callable(attrs)->tuple
        self.hidden = hidden
        self._accepted = None                   # lazy cache for accepted_attrs()
        self.doc = fn.__doc__

    # -- resolved-per-attrs accessors ------------------------------------
    def get_input_names(self, attrs):
        names = self.input_names
        return tuple(names(attrs)) if callable(names) else tuple(names)

    def get_aux_names(self, attrs):
        names = self.aux_names
        return tuple(names(attrs)) if callable(names) else tuple(names)

    def get_num_outputs(self, attrs):
        n = self.num_outputs
        return n(attrs) if callable(n) else n

    def get_output_names(self, attrs):
        if self.output_names is None:
            n = self.get_num_outputs(attrs)
            if n == 1:
                return ("output",)
            return tuple("output%d" % i for i in range(n))
        names = self.output_names
        return tuple(names(attrs)) if callable(names) else tuple(names)

    def normalize_attrs(self, attrs):
        """Parse string attr values into typed python values."""
        return {k: parse_attr_value(v) for k, v in attrs.items()}

    def accepted_attrs(self):
        """The op's declared parameter surface (the lowering function's
        kwargs minus tensor inputs/aux and the is_train/rng specials), or
        None when the function takes **kwargs."""
        if self._accepted is None:
            names, has_var_kw = fn_signature_info(self.fn)
            if has_var_kw:
                self._accepted = "any"
            else:
                drop = {"is_train", "rng"}
                drop |= set(self.get_input_names({}))
                drop |= set(self.get_aux_names({}))
                self._accepted = frozenset(names - drop)
        return None if self._accepted == "any" else self._accepted

    def validate_attrs(self, attrs, where="op call"):
        """Reject unknown parameters instead of silently dropping them —
        dmlc::Parameter semantics.  Framework attrs and ``__dunder__``
        user attrs always pass."""
        accepted = self.accepted_attrs()
        if accepted is None:
            return
        bad = [k for k in attrs
               if k not in accepted and k not in FRAMEWORK_ATTRS
               and not (k.startswith("__") and k.endswith("__"))]
        if bad:
            hints = []
            for k in bad:
                close = difflib.get_close_matches(k, sorted(accepted), n=1)
                hints.append("%r%s" % (k, (" (did you mean %r?)" % close[0])
                                       if close else ""))
            raise MXNetError(
                "%s %s: unknown parameter(s) %s; accepted parameters: %s"
                % (self.name, where, ", ".join(hints),
                   ", ".join(sorted(accepted))))

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name, **kwargs):
    """Decorator registering a torch function as an op."""
    def _reg(fn):
        opdef = OpDef(name, fn, **kwargs)
        if name in OP_REGISTRY:
            raise MXNetError("op %r registered twice" % name)
        OP_REGISTRY[name] = opdef
        for alias in opdef.aliases:
            OP_REGISTRY[alias] = opdef
        return fn
    return _reg


def get_op(name):
    try:
        return OP_REGISTRY[name]
    except KeyError:
        raise MXNetError("operator %r is not registered" % (name,)) from None


def list_ops():
    """Distinct canonical op names, hidden ops included (MXListAllOpNames
    analog; ``mxnet_tpu/ops/registry.py:199-201``)."""
    return sorted({op.name for op in OP_REGISTRY.values()})
