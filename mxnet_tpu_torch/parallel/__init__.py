"""Parallel training (port of ``mxnet_tpu/parallel``): ``SPMDTrainer`` on
one device, and ``ring_attention`` (``ring_attention_fn``), which runs
single-device attention without a mesh.  Meshes, zero/zero3, the ring
over ``sp``, the planner and the other parallel modules come with the
multi-GPU slice."""
from .trainer import SPMDTrainer, SUPPORTED_OPTIMIZERS
from . import ring_attention
from .ring_attention import ring_attention as ring_attention_fn

__all__ = ["SPMDTrainer", "SUPPORTED_OPTIMIZERS", "ring_attention",
           "ring_attention_fn"]
