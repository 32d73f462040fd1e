"""Operator registry and op implementations (PyTorch lowerings)."""
from .registry import OP_REGISTRY, OpDef, get_op, register  # noqa: F401
from . import tensor  # noqa: F401 — registers tensor ops
from . import nn      # noqa: F401 — registers neural layer ops
from . import vision  # noqa: F401 — ROIPooling/SpatialTransformer/...
from . import contrib  # noqa: F401 — MultiBox/Proposal/fft/count_sketch
from . import image_io  # noqa: F401 — imdecode, imresize, copyMakeBorder
from . import ctc     # noqa: F401 — WarpCTC/ctc_loss
