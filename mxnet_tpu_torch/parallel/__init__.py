"""Parallel training (port of ``mxnet_tpu/parallel``).

- mesh.py: meshes over the process group's ranks, a context list inside
  one process, or (rank, Context) pairs (any of dp/tp/sp/pp/ep)
- collectives.py: shards and explicit, differentiable collectives
  between a mesh's positions (one thread a position in the process that
  holds it; one exchange a collective across ranks)
- compat.py: ``shard_map`` over a mesh
- planner.py: mxplan — the sharding planner and the serializable
  ShardingPlan checkpoints persist for elastic resume
- trainer.py: SPMDTrainer — the fused step on one device, data-parallel
  across processes (allreduce / zero / zero3), or over a dp x tp mesh of
  positions, in one process or across ranks (``param_shardings`` rules)
- zero3.py: grouped gathers, backward re-gather, reduce-scatter gradients
- spmd_module.py: SPMDModule — the Module API over SPMDTrainer
- ring_attention.py: attention, the ring over ``sp`` on a mesh
  (``ring_attention_fn``)
- pipeline.py: the microbatch pipeline over ``pp``
- moe.py: top-2 mixture-of-experts with the experts over ``ep``
"""
from .compat import HAS_SHARD_MAP
from .mesh import build_mesh, default_mesh, local_mesh
from .trainer import SPMDTrainer, SUPPORTED_OPTIMIZERS
from . import zero3  # noqa: F401 — registers MXTPU_ZERO3_*
from . import planner  # noqa: F401 — registers MXTPU_PLAN_*
from .planner import ShardingPlan
from .spmd_module import SPMDModule
from . import ring_attention
from .ring_attention import ring_attention as ring_attention_fn
from . import collectives
from . import pipeline
from .pipeline import pipeline_apply, stack_stage_params
from . import moe
from .moe import moe_ffn, moe_init, moe_shardings

__all__ = ["SPMDTrainer", "SUPPORTED_OPTIMIZERS", "build_mesh",
           "default_mesh", "local_mesh", "ShardingPlan", "SPMDModule",
           "zero3", "planner", "ring_attention", "ring_attention_fn",
           "HAS_SHARD_MAP", "collectives", "pipeline", "pipeline_apply",
           "stack_stage_params", "moe", "moe_ffn", "moe_init",
           "moe_shardings"]
