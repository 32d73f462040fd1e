"""contrib namespace (port of ``mxnet_tpu/contrib``): ``mx.contrib.symbol``
and ``mx.contrib.ndarray`` expose the ``_contrib_*`` ops under their short
names (``mx.contrib.symbol.Attention``); the package ``__init__`` also
hangs them on ``mx.sym.contrib`` / ``mx.nd.contrib``.
``mx.contrib.autograd`` is ``mx.autograd`` at the reference's path.
"""
from . import autograd
from . import symbol
from . import symbol as sym
from . import ndarray
from . import ndarray as nd

__all__ = ["autograd", "symbol", "sym", "ndarray", "nd"]
