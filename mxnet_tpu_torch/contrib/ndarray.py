"""mx.contrib.ndarray — _contrib_* ops under short names, called
imperatively on NDArrays through the general invoker of ``mx.nd``
(``ndarray._make_ndarray_function``)."""
from ..ndarray import _make_ndarray_function
from ..ops.registry import OP_REGISTRY as _REG


def _populate():
    g = globals()
    for name, opdef in list(_REG.items()):
        if name.startswith("_contrib_"):
            g[name[len("_contrib_"):]] = _make_ndarray_function(opdef, name)


_populate()
