"""Parallel training (port of ``mxnet_tpu/parallel``): ``SPMDTrainer`` on
one device.  Meshes, zero/zero3, the planner and the other parallel
modules come with the multi-GPU slice."""
from .trainer import SPMDTrainer, SUPPORTED_OPTIMIZERS

__all__ = ["SPMDTrainer", "SUPPORTED_OPTIMIZERS"]
