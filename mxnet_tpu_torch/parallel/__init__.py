"""Parallel training (port of ``mxnet_tpu/parallel``).

- mesh.py: meshes over the process group (the ``dp`` axis)
- planner.py: mxplan — the sharding planner and the serializable
  ShardingPlan checkpoints persist for elastic resume
- trainer.py: SPMDTrainer — the fused step on one device or data-parallel
  across processes (allreduce / zero / zero3)
- zero3.py: grouped gathers, backward re-gather, reduce-scatter gradients
- spmd_module.py: SPMDModule — the Module API over SPMDTrainer
- ring_attention.py: single-device attention without a mesh
  (``ring_attention_fn``); the ring over ``sp`` comes with the
  model-parallel axes, as do pipeline.py and moe.py
"""
from .mesh import build_mesh, default_mesh, local_mesh
from .trainer import SPMDTrainer, SUPPORTED_OPTIMIZERS
from . import zero3  # noqa: F401 — registers MXTPU_ZERO3_*
from . import planner  # noqa: F401 — registers MXTPU_PLAN_*
from .planner import ShardingPlan
from .spmd_module import SPMDModule
from . import ring_attention
from .ring_attention import ring_attention as ring_attention_fn

__all__ = ["SPMDTrainer", "SUPPORTED_OPTIMIZERS", "build_mesh",
           "default_mesh", "local_mesh", "ShardingPlan", "SPMDModule",
           "zero3", "planner", "ring_attention", "ring_attention_fn"]
