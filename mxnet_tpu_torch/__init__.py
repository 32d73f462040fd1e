"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for an NVIDIA H100.

``import mxnet_tpu_torch as mx`` gives the same surface as ``mxnet_tpu``
for what has been ported: ``mx.nd``, ``mx.sym``, ``mx.predict``,
``mx.model``, ``mx.models``, ``mx.kernels``, ``mx.optimizer``,
``mx.initializer``, ``mx.lr_scheduler``, ``mx.random``, ``mx.distributed``
(the process group: one rank a device), ``mx.io`` (with
the RecordIO image iterators), ``mx.recordio``, ``mx.image`` (``mx.img``),
``mx.image_det``, ``mx.dataflow`` (``mx.DevicePrefetchIter``), ``mx.engine``,
``mx.resilience`` (with ``mx.CheckpointManager``, ``mx.PreemptionHandler``,
``mx.StepWatchdog``), ``mx.serving`` (``ModelPool``, ``ServingFrontend``,
the batcher and hot swap), ``mx.fleet`` (replica daemons behind one
router),
``mx.parallel``, ``mx.rnn``, ``mx.contrib`` (also as ``mx.sym.contrib`` /
``mx.nd.contrib``), ``mx.rtc``, ``mx.mod`` (``mx.module``), ``mx.kv``
(``mx.kvstore``), ``mx.metric``, ``mx.callback``, ``mx.cpu()``,
``mx.gpu(i)``, ``mx.current_context()``, ``mx.num_gpus()``, the tools
(``mx.profiler`` with ``mx.profiler_set_config`` /
``mx.profiler_set_state`` / ``mx.dump_profile``, ``mx.viz``
(``mx.visualization``), ``mx.test_utils``, ``mx.libinfo``,
``mx.analysis``, the linter; ``mxnet_tpu_torch.notebook`` and
``mxnet_tpu_torch.contrib.flops`` on import), and the
classes ``mx.NDArray``, ``mx.Symbol``, ``mx.Executor``, ``mx.Optimizer``.
This package imports ``torch``, ``numpy`` and
the standard library only; it never imports ``jax`` or ``mxnet_tpu``.

Its entry points run on ``gpu(0)`` unless the caller passes ``mx.cpu()``;
without CUDA a gpu context raises instead of running on the host.
"""
from __future__ import annotations

from .base import MXNetError
from . import resilience
from .resilience import CheckpointManager, PreemptionHandler, StepWatchdog
from .context import (Context, cpu, current_context, gpu, num_gpus,
                      num_tpus, tpu)
# Join the process group at import under tools/launch.py (the MXTPU_*
# envs are set): each rank then owns one device, which becomes its
# default context.  The analog of the reference consulting DMLC_ROLE at
# import (python/mxnet/kvstore_server.py:58-68); a no-op unlaunched.
from . import distributed
distributed.initialize()
from . import ops  # noqa: F401 — registers the ops before sym is built
from . import operator  # registers Custom
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from . import kernels
from . import mxfuse
from . import executor
from .executor import Executor
from . import model
from .model import FeedForward
from . import models
from . import predict
from . import convert
from . import name
from . import attribute
from .attribute import AttrScope
from . import random
from . import random as rnd
from . import io
from . import engine
from . import recordio
from . import image
from . import image as img
from . import image_det
# the reference registers its C++ image iterators under mx.io
io.ImageRecordIter = image.ImageRecordIter
io.ImageRecordUInt8Iter = image.ImageRecordUInt8Iter
io.ImageDetRecordIter = image_det.ImageDetRecordIter
from . import dataflow
from .dataflow import DevicePrefetchIter
from . import lr_scheduler
from . import optimizer
from .optimizer import Optimizer
from . import initializer
from .initializer import init_registry
from . import parallel
from . import rnn
from . import executor_manager
from . import kvstore
from . import kvstore as kv
from . import metric
from . import callback
from . import module
from . import module as mod
from . import rtc

symbol._init_symbol_module()
ndarray._init_ndarray_module()

from . import autograd  # noqa: E402
from . import contrib  # noqa: E402 — after the symbol creators exist
# both addressing styles work: mx.contrib.symbol.X and mx.sym.contrib.X
symbol.contrib = contrib.symbol
ndarray.contrib = contrib.ndarray
from . import monitor  # noqa: E402
from . import monitor as mon  # noqa: E402
from .monitor import Monitor  # noqa: E402
from . import torch_bridge  # noqa: E402
from .torch_bridge import th  # noqa: E402
from . import serving  # noqa: E402
# the multi-replica serving fleet (torch-free; imported for the env
# registry's completeness, like serving)
from . import fleet  # noqa: E402
from . import profiler  # noqa: E402
from .profiler import (profiler_set_config, profiler_set_state,  # noqa: E402
                       dump_profile)
from . import visualization  # noqa: E402
from . import visualization as viz  # noqa: E402
from . import libinfo  # noqa: E402
from . import test_utils  # noqa: E402
from . import analysis  # noqa: E402

__version__ = "0.1.0"

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "NDArray", "Symbol", "Executor", "Optimizer", "nd",
           "ndarray", "sym", "symbol", "kernels", "mxfuse", "executor",
           "model", "models", "predict", "convert", "name", "attribute",
           "random", "io", "engine", "recordio", "image", "img",
           "image_det", "dataflow", "DevicePrefetchIter", "lr_scheduler",
           "optimizer", "initializer", "parallel", "rnn", "contrib", "rtc", "mod", "module", "kv",
           "distributed",
           "kvstore", "metric", "callback", "executor_manager", "serving",
           "fleet", "profiler", "profiler_set_config", "profiler_set_state",
           "dump_profile", "visualization", "viz", "libinfo", "test_utils",
           "analysis"]
