"""mx.contrib.ndarray — _contrib_* ops under short names, called
imperatively on NDArrays.

The port has no general imperative op surface yet (``mx.nd.<op>`` comes
with the op-library slice), so each contrib op's function is made here:
NDArray inputs, positional or by input name, and the op's attributes as
keywords; the result lies on the first input's context.
"""
from ..base import MXNetError
from ..ndarray import NDArray
from ..ops.registry import OP_REGISTRY as _REG


def _make_function(opdef, func_name):
    def fn(*args, **kwargs):
        kwargs.pop("name", None)
        inputs = list(args)
        for nm in opdef.get_input_names(kwargs):
            if nm in kwargs:
                inputs.append(kwargs.pop(nm))
        if not inputs or not all(isinstance(a, NDArray) for a in inputs):
            raise MXNetError("%s: inputs must be NDArrays" % func_name)
        opdef.validate_attrs(kwargs, where="imperative call")
        attrs = opdef.normalize_attrs(kwargs)
        if opdef.needs_is_train:
            attrs.setdefault("is_train", False)
        out = opdef.fn(*(a._data for a in inputs), **attrs)
        ctx = inputs[0].context
        if isinstance(out, (tuple, list)):
            return [NDArray._from_torch(o, ctx) for o in out]
        return NDArray._from_torch(out, ctx)

    fn.__name__ = func_name
    fn.__doc__ = opdef.doc
    return fn


def _populate():
    g = globals()
    for name, opdef in list(_REG.items()):
        if name.startswith("_contrib_"):
            g[name[len("_contrib_"):]] = _make_function(opdef, name)


_populate()
