"""contrib namespace (port of ``mxnet_tpu/contrib``): ``mx.contrib.symbol``
and ``mx.contrib.ndarray`` expose the ``_contrib_*`` ops under their short
names (``mx.contrib.symbol.Attention``); the package ``__init__`` also
hangs them on ``mx.sym.contrib`` / ``mx.nd.contrib``.
``mx.contrib.autograd`` is ``mx.autograd`` at the reference's path;
``mx.contrib.tensorboard`` logs metrics as TensorBoard events and
``mxnet_tpu_torch.contrib.flops`` counts a graph's model FLOPs.
"""
from . import autograd
from . import symbol
from . import symbol as sym
from . import ndarray
from . import ndarray as nd
from . import tensorboard

__all__ = ["autograd", "symbol", "sym", "ndarray", "nd", "tensorboard"]
