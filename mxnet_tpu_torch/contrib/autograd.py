"""Alias of ``mxnet_tpu_torch.autograd`` at the reference's import path
(python/mxnet/contrib/autograd.py)."""
from ..autograd import *          # noqa: F401,F403
from ..autograd import __all__    # noqa: F401
