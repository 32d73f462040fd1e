"""Operator registry and op implementations (PyTorch lowerings)."""
from .registry import OP_REGISTRY, OpDef, get_op, register  # noqa: F401
from . import tensor  # noqa: F401 — registers tensor ops
from . import nn      # noqa: F401 — registers neural layer ops
from . import contrib  # noqa: F401 — registers the contrib ops
from . import image_io  # noqa: F401 — imdecode, imresize, copyMakeBorder
