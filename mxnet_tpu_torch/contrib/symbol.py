"""mx.contrib.symbol — _contrib_* ops under short names."""
from ..ops.registry import OP_REGISTRY as _REG
from .. import symbol as _symbol


def _populate():
    g = globals()
    for name in list(_REG):
        if name.startswith("_contrib_"):
            creator = getattr(_symbol, name, None)
            if creator is not None:
                g[name[len("_contrib_"):]] = creator


_populate()
