"""SPMDTrainer — the fused training step, on one device or data-parallel
across processes (port of ``mxnet_tpu/parallel/trainer.py:79-1314``).

One :meth:`SPMDTrainer.step` runs forward, backward (torch autograd over
the executor's fused plan, the parameters the only leaves), the all-finite
guard and the optimizer update (the registered update ops of
``ops/tensor.py``) on the trainer's device, with no host read inside the
step.  The guard's skip counters live on the device as one int32[3]
tensor and are read one step late, at the next step's entry
(:meth:`flush_step_guard`), as in the JAX package.

Numerics match the JAX package's: gradients are summed over the batch
(pass ``rescale_grad=1/batch``, the global batch under a mesh), weight
decay follows the optimizer's per-name multipliers (gammas keep it),
Adam's bias correction uses the applied-update count.  A batch reaches
the device through pinned memory on the trainer's side stream
(``dataflow.Uploader``); ``stage_batch`` does that ahead of the step,
and ``step``/``eval_step``/``forward_only`` take the
:class:`~mxnet_tpu_torch.io.StagedBatch` it makes without a copy.  The
step runs eagerly and writes each carry's new value into the carry's own
storage (params, aux, optimizer state, the guard counters and a deferred
metric's accumulators keep their ``data_ptr`` across steps), the port's
counterpart of the JAX package's donation.  :meth:`SPMDTrainer.analyze`
lints one step's dispatched work (``analysis/graph_lint.py``), and
``MXTPU_ANALYZE=1`` / ``strict`` runs that lint at the first step of each
input signature.

A ``mesh`` (``parallel/mesh.py``: the process group's ranks on a ``dp``
axis, one device a rank) makes the step data-parallel: every rank feeds
its process-local batch, outputs stay process-local, and
``grad_sync`` picks how parameters and gradients live:

- ``allreduce``: replicated parameters, the gradients summed over ranks
  in one bucketed all-reduce;
- ``zero``: master parameters and optimizer state sharded over ``dp`` on
  their first divisible dimension (indivisible ones stay replicated),
  one gather block at step start, gradients reduce-scattered, each rank
  updating its shard;
- ``zero3``: the same shards, gathered a group at a time, re-gathered in
  the backward instead of kept, gradients reduce-scattered per group
  (``parallel/zero3.py``, the JAX package's ``manual`` tier).

Under ``allreduce`` and ``zero`` BatchNorm normalises with the global
batch's statistics, as the JAX package's global program does
(``distributed.batch_stats``); under ``zero3`` each rank uses its own
rows and the moving statistics are averaged over ranks, the JAX manual
tier's semantics.  A stochastic op gives each rank its rows of the
global batch's draw.  The guard's finite flag and a deferred metric's
sums agree across ranks.

``remat=True`` (or ``MXNET_BACKWARD_DO_MIRROR=1``) runs the step's
forward as checkpointed segments that the backward recomputes.

Resilience (``mxnet_tpu/parallel/trainer.py``'s): a deferred metric's
``(sum, count)`` accumulates on the device inside the step
(:meth:`SPMDTrainer.install_metric`; guard-skipped steps add nothing)
and the guard counters are then read every ``flush_interval`` steps
only; a :class:`~mxnet_tpu_torch.resilience.StepWatchdog` is armed
around each step (:meth:`SPMDTrainer.install_watchdog`); the fault
points ``poison_grad`` (NaN in the first floating input) and
``hang_step`` fire here; :meth:`SPMDTrainer.save_checkpoint` (gathered,
or sharded-native under ``MXTPU_CKPT_SHARDED=1``) and
:meth:`SPMDTrainer.restore` (re-sharding at any world) go through a
:class:`~mxnet_tpu_torch.resilience.CheckpointManager`.

Any other mesh (``build_mesh`` over a context list, repeats allowed; or
over ranks and ``(rank, Context)`` pairs with a ``tp`` axis or ``tp``
rules, several positions a rank) runs the step on every position, one
thread a position in the process that holds it
(``parallel/collectives.py``; the positions' step): the batch splits
over ``dp``, each
``param_shardings`` rule over the ``tp`` axis places the param's shards
and their optimizer state on their positions (``trainer.params[name]``
is a ``collectives.Sharded`` reporting its spec), and the consumer of a
ruled weight takes a tensor-parallel form (``ops.nn.tp_layer``; the
plan's choice is in :attr:`SPMDTrainer.tp_forms` and the sharding plan's
decisions): column-parallel for a weight split on dim 0, row-parallel
for dim 1, otherwise the weight is gathered before use.  The positions'
losses go into one backward; every param's gradient is then summed over
``dp`` (a ``tp`` shard keeps its own).  ``get_params``, ``eval_step``
and the gathered checkpoints give the whole arrays.

``zero`` and ``zero3`` on an in-process mesh shard every otherwise
replicated param over the positions of ``dp`` (an explicit ``tp`` rule
keeps its spec): each position gathers its groups as one bucketed
``collectives.all_gather`` a group, whose transpose hands each position
its shard of the dp-summed gradient (one reduce-scatter a group), and
updates its shard.  ``zero3_tier`` is the JAX package's choice:
``manual`` on a pure-``dp`` mesh, where BatchNorm uses each position's
rows and the moving statistics are averaged over ``dp`` (the JAX
package's ``shard_map`` body), and ``gspmd`` with a ``tp`` axis, where
statistics are the global batch's, as under ``allreduce`` and ``zero``.
Under zero3 the backward re-gathers (``zero3.MeshRegather``).
``remat``, ``analyze``, ``MXTPU_ANALYZE`` and sharded-native
checkpoints (one blob a ``dp`` shard) work there too.

Where the positions' mesh spans ranks, rank 0's initial values win
(``init_params`` and ``set_params`` broadcast them), each rank's
``step`` takes its LOCAL rows: the rows of its positions' ``dp``
coordinates, in coordinate order (ranks whose positions share a ``dp``
coordinate must be fed the same rows), and returns the outputs of those
rows.  The collectives join the ranks (``collectives._exchange``), so
the step computes what the in-process mesh of the same shape does, bit
for bit; the guard's flag and a deferred metric's sums span every rank,
``get_params``, ``get_states`` and the checkpoints are collective
(every rank calls them) and rank 0 writes.
"""
from __future__ import annotations

import logging
import math
import pickle
import re
from contextlib import nullcontext

import numpy as np
import torch

from .. import optimizer as opt_mod
from .. import random as _random
from ..base import (ENV_MAX_BAD_STEPS, ENV_STEP_GUARD, MXNetError, get_env,
                    register_env)
from ..context import Context, cpu, current_context
from ..executor import (ENV_BACKWARD_DO_MIRROR, _build_eval,
                        mirror_segments_for)
from ..io import DataDesc
from ..ndarray import NDArray, tensor_from_numpy, zeros as nd_zeros
from ..ops import tensor as T
from .zero3 import Regather

__all__ = ["SPMDTrainer", "SUPPORTED_OPTIMIZERS", "UPDATE_RANGE",
           "GRAD_SYNC_RANGE", "DEFAULT_GUARD_FLUSH_INTERVAL",
           "diff_param_sets"]

#: the ``torch.profiler.record_function`` range around each step's
#: guard + optimizer update + aux merge
UPDATE_RANGE = "SPMDTrainer.update"
#: the range around a data-parallel step's gradient all-reduce
GRAD_SYNC_RANGE = "SPMDTrainer.grad_sync"

#: optimizers with an in-step update rule (_apply_update)
SUPPORTED_OPTIMIZERS = ("sgd", "ccsgd", "adam", "rmsprop")

ENV_GRAD_SYNC = register_env(
    "MXNET_GRAD_SYNC", default="allreduce",
    doc="Gradient sync for the fused dp step: allreduce (replicated "
        "params), zero (sharded master and optimizer state, one gather "
        "block at step start) or zero3 (fully sharded: grouped gathers, "
        "backward re-gather, reduce-scatter gradients)")
#: guard-counter read cadence (steps) while a deferred metric is
#: installed and sets no interval of its own
DEFAULT_GUARD_FLUSH_INTERVAL = 25

_LOG = logging.getLogger(__name__)


def _spec_for(name, shape, rules):
    """A parameter's spec (a tuple of axis names or None) from regex
    rules; default replicated (the empty tuple)."""
    for pattern, spec in (rules or {}).items():
        if re.match(pattern, name):
            spec = (spec,) if isinstance(spec, str) else tuple(spec)
            if len(spec) > len(shape):
                raise MXNetError(
                    "sharding spec %s has more axes than param %s%s"
                    % (spec, name, shape))
            return spec
    return ()


def diff_param_sets(saved_params, current_names, kind="parameter"):
    """Problems list for a save->resume param-set change over names only
    (``planner.diff_param_sets`` on ``{name: {}}``): a param ADDED to the
    model since the save or REMOVED from it must fail the resume with
    names, never silently misload."""
    from .planner import diff_param_sets as _diff
    return _diff({n: {} for n in (saved_params or ())}, set(current_names),
                 kind=kind)


class _PositionParts(object):
    """Mesh position ``index``'s parts of a dict of ``Sharded`` values
    (or of tuples of them, as optimizer state is), read and written by
    name as the one-device step reads and writes its dicts."""

    def __init__(self, tree, index):
        self.tree = tree
        self.index = index

    def __getitem__(self, name):
        v = self.tree[name]
        if isinstance(v, tuple):
            return tuple(x.parts[self.index] for x in v)
        return v.parts[self.index]

    def __setitem__(self, name, value):
        v = self.tree[name]
        if isinstance(v, tuple):
            for x, part in zip(v, value):
                x.parts[self.index] = part
        else:
            v.parts[self.index] = value


class SPMDTrainer(object):
    """Fused training step for a Symbol + Optimizer, on one device or over
    a ``dp`` mesh of processes.

    ``ctx`` is the device (the current context: ``gpu(0)`` by default,
    this rank's device under a process group); ``input_transforms`` maps
    an input name to a torch function applied to the batch inside the
    step; ``plan`` is a :class:`~mxnet_tpu_torch.parallel.planner.
    ShardingPlan` (or its doc) whose grad_sync, rules and compute dtype
    apply where the arguments leave them unset."""

    def __init__(self, symbol, optimizer="sgd", optimizer_params=None,
                 mesh=None, data_axis="dp", param_shardings=None,
                 compute_dtype=None, remat=None, input_transforms=None,
                 grad_sync=None, step_guard=None,
                 max_consecutive_bad_steps=None, plan=None, ctx=None):
        from .. import distributed
        # a plan supplies the policy; the derived artifacts (per-param
        # specs, gather groups) are recomputed at bind() for this mesh,
        # so a plan written at another world consumes cleanly
        self._given_plan = None
        self.sharding_plan = None   # descriptive plan, built at bind()
        if plan is not None:
            from .planner import ShardingPlan
            if isinstance(plan, dict):
                plan = ShardingPlan.from_doc(plan)
            self._given_plan = plan
            if grad_sync is None:
                grad_sync = plan.grad_sync
            if param_shardings is None and plan.param_shardings:
                param_shardings = plan.param_shardings
            if compute_dtype is None and plan.compute_dtype:
                compute_dtype = plan.compute_dtype
        if grad_sync is None:
            grad_sync = get_env(ENV_GRAD_SYNC, "allreduce")
        if grad_sync not in ("allreduce", "zero", "zero3"):
            raise MXNetError(
                "grad_sync must be 'allreduce', 'zero' or 'zero3', "
                "got %r" % (grad_sync,))
        self.param_shardings = dict(param_shardings or {})
        world = 1
        self._tp_axis = "tp"
        if mesh is not None and data_axis not in mesh.shape:
            raise MXNetError("mesh %s has no data axis %r"
                             % (dict(mesh.shape), data_axis))
        # the positions' step: any mesh but the one-rank-a-position
        # data-parallel form (ranks, no other axis, no rule beyond dp)
        self._inproc = mesh is not None and not (
            getattr(mesh, "over_ranks", False)
            and all(size == 1 for name, size in mesh.shape.items()
                    if name != data_axis)
            and all(a in (None, data_axis) for spec in
                    self.param_shardings.values() for a in
                    ((spec,) if isinstance(spec, str) else tuple(spec))))
        self._spans = self._inproc and getattr(mesh, "spans_ranks", False)
        self._dp = 1                # the dp axis's size (positions' step)
        self._local_dp = [0]        # this process's dp coordinates
        self.tp_forms = {}          # ruled param -> column / row / gather
        if self._spans and mesh.ranks != list(range(
                distributed.num_workers())):
            raise MXNetError(
                "SPMDTrainer: the mesh's ranks %s are not the process "
                "group's %d" % (mesh.ranks, distributed.num_workers()))
        if self._inproc:
            for name, size in mesh.shape.items():
                if name not in (data_axis, self._tp_axis) and size > 1:
                    raise MXNetError(
                        "SPMDTrainer on an in-process mesh splits the batch "
                        "over %r and params over %r; axis %r (size %d) has "
                        "no role in the step (ring_attention, "
                        "pipeline_apply and moe_ffn run the other axes)"
                        % (data_axis, self._tp_axis, name, size))
            self._dp = int(mesh.shape[data_axis])
            self._local_dp = sorted({mesh.coords(i)[data_axis]
                                     for i in mesh.local})
        elif mesh is not None:
            world = int(mesh.shape[data_axis])
            if world != distributed.num_workers():
                raise MXNetError(
                    "SPMDTrainer: the mesh's %r axis has %d ranks but the "
                    "process group has %d (one rank a device: launch with "
                    "tools/launch.py -n %d)" % (data_axis, world,
                                               distributed.num_workers(),
                                               world))
        self.mesh = mesh
        self.grad_sync = grad_sync
        self.data_axis = data_axis
        self._world = world
        self._rank = distributed.rank() if world > 1 or self._spans else 0
        # _zero: sharded master params and optimizer state (zero and
        # zero3 share the placement and the gathering path)
        self._zero = grad_sync in ("zero", "zero3") and self._dp_world > 1
        self._zero3 = grad_sync == "zero3" and self._zero
        self.zero3_tier = None      # 'manual' / 'gspmd' at bind() (zero3)
        self._zero3_dims = {}       # param -> dp-sharded dim (zero, zero3)
        self._zero3_groups = []     # plan-ordered gather groups
        self._layouts = []          # one zero3.GatherLayout a group
        self._gather = None         # shards -> full, differentiable
        if remat is None:
            remat = str(get_env(ENV_BACKWARD_DO_MIRROR, "0")) == "1"
        self.remat = bool(remat)
        self.symbol = symbol
        if ctx is None and self._inproc:
            ctx = mesh.contexts[mesh.local[0]]
        self._ctx = Context(ctx) if ctx is not None else current_context()
        self._device = self._ctx.torch_device
        self.input_transforms = dict(input_transforms or {})
        self.compute_dtype = None
        if compute_dtype is not None:
            from ..ndarray import _torch_dtype
            self.compute_dtype = _torch_dtype(compute_dtype)
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        kind = type(optimizer).__name__.lower()
        if kind not in SUPPORTED_OPTIMIZERS:
            raise MXNetError(
                "SPMDTrainer: in-step rule for optimizer %r not implemented "
                "(sgd/adam/rmsprop supported)" % kind)
        self.optimizer = optimizer
        # remat: the step's forward as checkpointed segments, recomputed
        # by the backward (the memory mirror mode)
        self._eval = _build_eval(
            symbol,
            mirror_segments=mirror_segments_for(symbol, force=self.remat))
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()

        # NaN/Inf step guard: an all-finite check over the gradients on
        # the device; a non-finite step applies NO update (params, aux and
        # optimizer state pass through unchanged by torch.where) and
        # counts itself in the device-side (total, consecutive, trips)
        # int32[3] counters, which the host reads one step late
        if step_guard is None:
            step_guard = str(get_env(ENV_STEP_GUARD, "1")) != "0"
        self.step_guard = bool(step_guard)
        if max_consecutive_bad_steps is None:
            max_consecutive_bad_steps = int(get_env(ENV_MAX_BAD_STEPS, "10"))
        self.max_consecutive_bad_steps = int(max_consecutive_bad_steps)
        self._skipped_steps = 0           # total guarded skips, ever
        self._consecutive_bad_steps = 0   # current bad-step run length
        self._skip_base = 0               # host total when counters placed
        self._guard_acc = None            # device (total, consec, trips) i32
        self._guard_pending = False       # unread counters in flight
        self._trips_seen = 0              # abort events already raised
        self.last_step_skipped = False    # most recently FLUSHED step
        # deferred metrics: a (sum, count) float32 pair on the device,
        # added to inside the step (install_metric); fetch_metric reads
        # and re-zeroes it, so a window spans at most flush_interval steps
        # and float32 stays exact for integer sums
        self._metric_fn = None
        self._metric_key = None
        self._metric_acc = None
        # guard-counter read cadence: 1 = at every step entry (one-deep
        # pipeline); > 1 = every that-many steps (deferred-metric runs)
        self.flush_interval = 1
        self._steps_since_flush = 0
        # optional hung-step watchdog (resilience.StepWatchdog), armed
        # around every step (fit wires it through install_watchdog)
        self.watchdog = None
        self.params = None        # dict name -> tensor (float32 master)
        self.aux = None
        self.opt_state = None
        self._num_update = 0
        self._outputs = None
        self._uploader = None     # dataflow.Uploader, made at first upload
        # MXTPU_ANALYZE: input signatures already linted, strict-mode
        # refusals (sticky per signature), and the cached "off" answer
        self._analyzed_keys = set()
        self._refused = {}
        self._analyze_off = False

    @property
    def _dp_world(self):
        """The data axis's size: its positions on the positions' step, its
        ranks on the one-rank-a-position data-parallel step."""
        return self._dp if self._inproc else self._world

    # -- setup ------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None):
        data_shapes = [d if isinstance(d, DataDesc) else DataDesc(d[0], d[1])
                       for d in data_shapes]
        label_shapes = [l if isinstance(l, DataDesc) else DataDesc(l[0], l[1])
                        for l in (label_shapes or [])]
        self.data_names = [d.name for d in data_shapes]
        self.label_names = [l.name for l in label_shapes]
        self.input_names = self.data_names + self.label_names
        unknown_tf = set(self.input_transforms) - set(self.input_names)
        if unknown_tf:
            raise MXNetError(
                "input_transforms keys %s are not bound inputs %s"
                % (sorted(unknown_tf), self.input_names))
        shapes = {d.name: d.shape for d in data_shapes + label_shapes}
        arg_shapes, out_shapes, aux_shapes = self.symbol.infer_shape(**shapes)
        self.arg_shapes = dict(zip(self.arg_names, arg_shapes))
        self.aux_shapes = dict(zip(self.aux_names, aux_shapes))
        self.out_shapes = out_shapes
        self.param_names = [n for n in self.arg_names
                            if n not in self.input_names]
        self.batch_size = data_shapes[0].shape[0]
        # the batch every rank feeds, summed over the data axis (the
        # positions' step: this process's rows of its dp coordinates)
        self.global_batch_size = self.batch_size * self._world if \
            not self._inproc else \
            self.batch_size // len(self._local_dp) * self._dp
        # seed the per-name wd/lr multipliers now that param names are
        # known (zero wd for biases and betas), keeping multipliers the
        # user already set
        self.optimizer.idx2name = dict(enumerate(self.param_names))
        user_lr = dict(getattr(self.optimizer, "lr_mult", {}) or {})
        user_wd = dict(getattr(self.optimizer, "wd_mult", {}) or {})
        self.optimizer.set_wd_mult({})
        self.optimizer.set_lr_mult({})
        self.optimizer.lr_mult.update(user_lr)
        self.optimizer.wd_mult.update(user_wd)
        if self._zero:
            self._plan_zero()
        if self._inproc:
            self._bind_inproc()
            if self._zero3:
                # the JAX package's choice (trainer.py:346-348): manual on
                # a pure-dp mesh with batch-leading outputs
                leading = all(sh and sh[0] == self.batch_size
                              for sh in self.out_shapes)
                self.zero3_tier = "manual" if (
                    tuple(self.mesh.axis_names) == (self.data_axis,)
                    and leading and self._zero3_dims) else "gspmd"
        # the descriptive plan: what this trainer executes (world, mesh
        # axes, per-param placement, gather groups); save_checkpoint
        # persists it in the manifest
        from .planner import ShardingPlan
        self.sharding_plan = ShardingPlan.from_trainer(self)
        return self

    def _bind_inproc(self):
        """The positions' bind: this process's rows must split over its
        ``dp`` coordinates, the rules may name ``tp`` only, and each ruled
        weight's consumer
        takes its tensor-parallel form (column / row where the weight's
        one training use is a plain FullyConnected or Convolution, gather
        otherwise); the training plan is rebuilt with those forms."""
        from ..executor import tp_consumers
        if self.batch_size % len(self._local_dp):
            raise MXNetError(
                "SPMDTrainer: batch %d does not split over the %d "
                "coordinates of the %r axis this process holds"
                % (self.batch_size, len(self._local_dp), self.data_axis))
        tp, tp_size = self._tp_axis, self.mesh.shape.get(self._tp_axis, 1)
        forms, self._tp_dims = {}, {}
        for name in self.param_names:
            spec = _spec_for(name, self.arg_shapes[name],
                             self.param_shardings)
            axes = [tuple(e) if isinstance(e, (tuple, list)) else
                    ((e,) if e is not None else ()) for e in spec]
            if any(a != tp for ax in axes for a in ax):
                raise MXNetError(
                    "param_shardings rule %s for %s on a mesh of positions "
                    "(rules name the %r axis)" % (spec, name, tp))
            dims = [i for i, ax in enumerate(axes) if ax]
            if not dims or tp_size == 1:
                continue
            if len(dims) > 1:
                raise MXNetError("spec %s shards %s over %r twice"
                                 % (spec, name, tp))
            self._tp_dims[name] = dims[0]
            uses = tp_consumers(self._eval.train_plan, name)
            form = "gather"
            if len(uses) == 1:
                node, pos, override = uses[0]
                attrs = node.op_attrs() if node.op is not None else {}
                if pos == 1 and override is None and \
                        node.op.name in ("FullyConnected", "Convolution") \
                        and int(attrs.get("num_group", 1)) == 1 and \
                        dims[0] in (0, 1):
                    form = ("column", "row")[dims[0]]
            forms[name] = form
        self.tp_forms = forms
        from .collectives import segment_tape
        self._eval = _build_eval(
            self.symbol, tp_forms={n: (f, tp) for n, f in forms.items()
                                   if f != "gather"},
            mirror_segments=mirror_segments_for(self.symbol,
                                                force=self.remat),
            segment_scope=segment_tape)
        self._eval_plain = _build_eval(self.symbol)

    def _param_spec(self, name, shape):
        """A master param's (and its optimizer state's) spec: an explicit
        rule wins; under zero/zero3 an otherwise replicated param shards
        its first dp-divisible dimension over the data axis (indivisible
        ones stay replicated)."""
        spec = _spec_for(name, shape, self.param_shardings)
        if self._zero and spec == ():
            dp = self._dp_world
            for i, d in enumerate(shape):
                if d % dp == 0 and d >= dp:
                    axes = [None] * len(shape)
                    axes[i] = self.data_axis
                    return tuple(axes)
        return spec

    def _plan_zero(self):
        """The sharded params (each with its dp dimension) and their
        gather groups (bind time): zero3 gathers group by group in plan
        order (``_choose_gather_groups``), zero in one block.  On an
        in-process mesh each group is one ``zero3.GatherLayout`` that a
        position gathers over ``dp`` (``gather_mesh``)."""
        from . import zero3 as z3
        shardable = {}
        for name in self.param_names:
            entries = self._param_spec(name, self.arg_shapes[name])
            dims = [i for i, e in enumerate(entries) if e == self.data_axis]
            if len(dims) == 1:
                shardable[name] = dims[0]
        self._zero3_dims = shardable
        if self._zero3:
            self._zero3_groups = self._choose_gather_groups(shardable)
            self.zero3_tier = "manual"
        else:
            self._zero3_groups = []
        groups = self._zero3_groups if self._zero3 else (
            [[n for g in z3.plan_gather_groups(self.symbol,
                                               sorted(shardable))
              for n in g]] if shardable else [])
        shapes = {n: tuple(self.arg_shapes[n]) for n in shardable}
        if self._inproc:
            self._layouts = [z3.GatherLayout(g, shardable, shapes, self._dp)
                             for g in groups]
            return
        self._layouts, self._gather = z3.make_manual_gather(
            groups, shardable, shapes, self._world)

    def _choose_gather_groups(self, shardable):
        """zero3's gather groups: under ``MXTPU_ZERO3_GATHER_GROUP=auto``
        a consumed plan's groups when they match this bind exactly, else
        the planner's first-consumer/bucket-merged grouping; a number is
        the manual override (N layers a group), which warns when the
        planned grouping Pareto-dominates it on the memory model."""
        from . import planner
        from . import zero3 as z3
        from .zero3 import ENV_ZERO3_GATHER_GROUP
        names = sorted(shardable)
        if not names:
            return []
        comm_itemsize = self.compute_dtype.itemsize \
            if self.compute_dtype is not None else 4
        shapes = {n: tuple(self.arg_shapes[n]) for n in names}
        raw = str(get_env(ENV_ZERO3_GATHER_GROUP, "auto") or
                  "auto").strip().lower()
        given = self._given_plan
        if raw in ("", "auto") and given is not None and \
                given.gather_groups and given.world == self._dp_world and \
                sorted(n for g in given.gather_groups for n in g) == names:
            return [list(g) for g in given.gather_groups]
        planned = planner.derive_gather_groups(
            self.symbol, names, shapes, itemsize=comm_itemsize)
        if raw in ("", "auto"):
            return planned
        try:
            group_layers = int(raw)
        except (TypeError, ValueError):
            _LOG.warning("MXTPU_ZERO3_GATHER_GROUP=%r is neither 'auto' nor "
                         "an integer — using the planned grouping", raw)
            return planned
        manual = z3.plan_gather_groups(self.symbol, names, group_layers)
        sizes = {n: int(np.prod(shapes[n])) * comm_itemsize for n in names}
        mc = planner.group_cost(manual, sizes)
        pc = planner.group_cost(planned, sizes)
        if planner.dominates(pc, mc):
            _LOG.warning(
                "MXTPU_ZERO3_GATHER_GROUP=%d loses to the planned grouping "
                "on the memory model: manual = %d collectives / %d peak "
                "gathered bytes, planned = %d / %d — unset the knob (or set "
                "it to 'auto') to take the planner's grouping",
                group_layers, mc[0], mc[1], pc[0], pc[1])
        return manual

    def init_params(self, initializer, arg_params=None, aux_params=None):
        """Allocate params and aux on the trainer's device: from
        ``arg_params``/``aux_params`` (NDArrays or numpy) where given,
        else from ``initializer``; then zero optimizer state.  Across
        ranks rank 0's values win (the reference's init-push), and a
        sharded param keeps this rank's shard."""
        params, aux = {}, {}
        for name in self.param_names:
            arr = nd_zeros(self.arg_shapes[name], ctx=self._ctx)
            if arg_params and name in arg_params:
                arr[:] = arg_params[name]
            elif initializer is not None:
                initializer(name, arr)
            params[name] = arr._data
        for name in self.aux_names:
            arr = nd_zeros(self.aux_shapes[name], ctx=self._ctx)
            if aux_params and name in aux_params:
                arr[:] = aux_params[name]
            elif initializer is not None:
                initializer(name, arr)
            aux[name] = arr._data
        params = self._broadcast(params)
        self.params = {n: self._shard(n, v) for n, v in params.items()}
        self.aux = self._broadcast(aux)
        if self._inproc:
            self.aux = {n: self._place(n, v, param=False)
                        for n, v in self.aux.items()}
        self.opt_state = self._init_opt_state()

    def _broadcast(self, values):
        """``{name: tensor}`` with rank 0's values on every rank."""
        if self._world == 1 and not self._spans:
            return dict(values)
        from .. import distributed
        names = list(values)
        out = distributed.broadcast_tensors([values[n] for n in names])
        return {n: t.contiguous() for n, t in zip(names, out)}

    def _place(self, name, full, param=True):
        """A whole value laid over the in-process mesh: a ruled param (or
        its optimizer slot) by its rule, a zero/zero3 param over ``dp``
        on its shard dimension, anything else replicated, each position's
        part in its own storage."""
        from . import collectives as C
        spec = C.P()
        dims = ((self._tp_dims, self._tp_axis),
                (self._zero3_dims, self.data_axis))
        for where, axis in dims if param else ():
            if name in where:
                axes = [None] * full.dim()
                axes[where[name]] = axis
                spec = C.P(*axes)
        return C.shard(full, self.mesh, spec)

    def _shard(self, name, full):
        """This rank's shard of a full master value (the full value for a
        replicated param); on an in-process mesh, the value laid over
        the positions."""
        if self._inproc:
            return self._place(name, full)
        d = self._zero3_dims.get(name)
        if d is None:
            return full
        per = full.shape[d] // self._world
        return full.narrow(d, self._rank * per, per).clone()

    def _full(self, name, value):
        """The full value of one master param or optimizer slot from this
        rank's shard: one all-gather (every rank calls it together), or
        the parts of an in-process mesh's positions put together."""
        from .collectives import Sharded
        if isinstance(value, Sharded):
            return value.full()
        d = self._zero3_dims.get(name)
        if d is None:
            return value
        from .. import distributed
        g = distributed.all_gather(value.detach().movedim(d, 0).contiguous())
        return g.movedim(0, d).contiguous()

    def resident_bytes(self, position=None, names=None):
        """``{"params", "opt_state", "aux"}``: bytes this rank holds for
        each carry (a zero/zero3 rank holds about 1/world of the first
        two); on the positions' step, the storage bytes of ``position``'s
        parts (this process's first position by default; a ``tp`` shard
        is 1/tp of its param).  ``names`` limits the count to those
        params (and their slots)."""
        from .collectives import Sharded
        if position is None:
            position = self.mesh.local[0] if self._inproc else 0

        def nbytes(ts):
            total = 0
            for t in ts:
                if isinstance(t, Sharded):
                    t = t.parts[position]
                    total += t.untyped_storage().nbytes()
                else:
                    total += t.numel() * t.element_size()
            return int(total)
        if names is not None:
            return {"params": nbytes(self.params[n] for n in names),
                    "opt_state": nbytes(t for n in names
                                        for t in self.opt_state[n]),
                    "aux": 0}
        return {"params": nbytes(self.params.values()),
                "opt_state": nbytes(t for s in self.opt_state.values()
                                    for t in s),
                "aux": nbytes(self.aux.values())}

    def _init_opt_state(self):
        """Zero optimizer slots a param (momentum; Adam's mean and var;
        RMSProp's n), laid out as the param is."""
        from .collectives import Sharded
        kind = type(self.optimizer).__name__.lower()
        if kind in ("sgd", "ccsgd"):
            n = 1 if getattr(self.optimizer, "momentum", 0.0) else 0
        else:
            n = {"adam": 2, "rmsprop": 1}.get(kind, 0)

        def zeros(p):
            if isinstance(p, Sharded):
                return Sharded([None if t is None else torch.zeros_like(t)
                                for t in p.parts], p.mesh, p.spec, p.shape)
            return torch.zeros_like(p)
        return {name: tuple(zeros(self.params[name]) for _ in range(n))
                for name in self.param_names}

    # -- the fused step ----------------------------------------------------
    def _apply_update(self, name, p, g, s, lr, wd, t):
        """The optimizer rule for one parameter (same ops as the
        reference's server-side update, optimizer_op.cc)."""
        o = self.optimizer
        clip = o.clip_gradient if o.clip_gradient is not None else -1.0
        rescale = o.rescale_grad
        lr = lr * o.lr_mult.get(name, 1.0)
        wd = wd * o.wd_mult.get(name, 1.0)
        kind = type(o).__name__.lower()
        if kind in ("sgd", "ccsgd"):
            if s:
                w, m = T.sgd_mom_update(p, g, s[0], lr=lr,
                                        momentum=o.momentum, wd=wd,
                                        rescale_grad=rescale,
                                        clip_gradient=clip)
                return w, (m,)
            return T.sgd_update(p, g, lr=lr, wd=wd, rescale_grad=rescale,
                                clip_gradient=clip), ()
        if kind == "adam":
            coef1 = 1.0 - o.beta1 ** t
            coef2 = 1.0 - o.beta2 ** t
            lr_t = lr * math.sqrt(coef2) / coef1
            w, mean, var = T.adam_update(p, g, s[0], s[1], lr=lr_t,
                                         beta1=o.beta1, beta2=o.beta2,
                                         epsilon=o.epsilon, wd=wd,
                                         rescale_grad=rescale,
                                         clip_gradient=clip)
            return w, (mean, var)
        if kind == "rmsprop":
            w, n = T.rmsprop_update(p, g, s[0], lr=lr, gamma1=o.gamma1,
                                    epsilon=o.epsilon, wd=wd,
                                    rescale_grad=rescale, clip_gradient=clip,
                                    clip_weights=-1.0)
            return w, (n,)
        raise MXNetError("SPMDTrainer: in-step rule for optimizer %r not "
                         "implemented (sgd/adam/rmsprop supported)" % kind)

    def _cast(self, params):
        """The compute-dtype copy of the float32 master, made per step."""
        if self.compute_dtype is None:
            return params
        return {k: v.to(self.compute_dtype) if v.is_floating_point() else v
                for k, v in params.items()}

    def _xform(self, data):
        tf = self.input_transforms
        return {k: (tf[k](v) if k in tf else v) for k, v in data.items()}

    def _step_tail(self, outs, positions, lr, wd, t, data):
        """The epilogue of the step (the JAX package's :665-757): the
        all-finite guard over the gradients, the optimizer update, the aux
        merge, the stacked int32[3] skip counters and a deferred metric's
        (sum, count), which a guard-skipped step leaves as they were —
        device work only.  ``positions`` holds one ``(params, opt_state,
        aux, grads, auxu, device)`` a position updated (one off a mesh
        inside the process); the guard's flag covers them all.  Across
        ranks the finite flag is ANDed where each rank checked only its
        shards (zero, zero3), a metric's deltas are summed (each rank saw
        its rows), and under zero3 the per-rank BatchNorm moving
        statistics are averaged."""
        from .. import distributed
        guard = self.step_guard
        dp = self._world > 1
        auxu = positions[0][4]
        if self._zero3 and auxu and dp:
            names = list(auxu)
            flat = distributed.all_reduce(torch.cat(
                [auxu[n].reshape(-1) for n in names])) / self._world
            off = 0
            for n in names:
                k = auxu[n].numel()
                auxu[n] = flat[off:off + k].reshape(auxu[n].shape)
                off += k
        finite = None
        if guard:
            flags = [torch.isfinite(torch.cat(
                [pos[3][n].reshape(-1) for n in self.param_names])).all()
                for pos in positions]
            finite = flags[0] if len(flags) == 1 else torch.stack(
                [f.to(self._device) for f in flags]).all()
            if (dp and self._zero) or self._spans:
                n = distributed.num_workers()
                finite = distributed.all_reduce(
                    finite.to(torch.int32).reshape(1))[0] == n
        # non-finite step: params, optimizer state and aux (BN moving
        # stats from a poisoned batch) pass through unchanged
        for params, opt_state, aux, grads, auxu, device in positions:
            fin = None if finite is None else finite.to(device)
            for name in self.param_names:
                g = grads[name].to(params[name].dtype)
                w, s = self._apply_update(name, params[name], g,
                                          opt_state[name], lr, wd, t)
                params[name] = self._carry(params[name], w, fin)
                opt_state[name] = tuple(self._carry(so, sn, fin)
                                        for sn, so in zip(s, opt_state[name]))
            for name, v in auxu.items():
                aux[name] = self._carry(aux[name], v, fin)
        if guard:
            self._count_guard(finite)
        outs = [o.detach() for o in outs]
        if self._metric_fn is not None:
            ds, dc = self._metric_fn(outs, data) if self._owns_rows() \
                else (0.0, 0.0)
            if dp or self._spans:
                ds, dc = distributed.all_reduce(torch.stack(
                    [torch.as_tensor(v, dtype=torch.float32,
                                     device=self._device)
                     for v in (ds, dc)]))
            s_acc, c_acc = self._metric_acc
            # a guard-skipped step adds nothing
            self._metric_acc = (self._carry(s_acc, s_acc + ds, finite),
                                self._carry(c_acc, c_acc + dc, finite))
        return outs

    def _owns_rows(self):
        """Whether this process's rows count in a deferred metric: on a
        rank-spanning mesh its ``dp`` coordinates' rows count on the
        lowest rank that holds them (a mesh whose ranks share a
        coordinate holds them alike on each)."""
        if not self._spans:
            return True
        mesh, axis = self.mesh, self.data_axis
        first = {}
        for i in range(mesh.size):
            d = mesh.coords(i)[axis]
            first[d] = min(first.get(d, mesh.rank_of[i]), mesh.rank_of[i])
        mine = [first[d] == self._rank for d in self._local_dp]
        if any(mine) and not all(mine):
            raise MXNetError(
                "SPMDTrainer: a deferred metric on a mesh whose ranks hold "
                "some dp coordinates alike and others apart")
        return all(mine)

    def _count_guard(self, finite):
        """The int32[3] skip counters after a step whose gradients were
        ``finite`` (a 0-d bool on the device), in their own storage."""
        acc = self._guard_acc
        total, consec, trips = acc[0], acc[1], acc[2]
        new_consec = torch.where(finite, torch.zeros_like(consec),
                                 consec + 1)
        if self.max_consecutive_bad_steps > 0:
            trips = trips + (new_consec == self.max_consecutive_bad_steps
                             ).to(trips.dtype)
        else:
            # stack's out= refuses an input that is a view of it
            trips = trips.clone()
        # the counters' own storage (the port's counterpart of the
        # JAX package's donated carries)
        torch.stack([torch.where(finite, total, total + 1), new_consec,
                     trips], out=acc)

    def _carry(self, old, new, finite):
        """One carry's value after the step: ``new``, or ``old`` where the
        guard found the step non-finite (``finite`` is None without the
        guard), written into ``old``'s storage (the port's counterpart of
        the JAX package's ``DONATE_ARGNUMS``) unless the value changes the
        carry's dtype or shape.  With the guard that is the one
        ``where(..., out=old)`` kernel; without it, one copy a carry."""
        if finite is not None:
            fits = torch.result_type(new, old) == old.dtype and \
                torch.broadcast_shapes(new.shape, old.shape) == old.shape
            return torch.where(finite, new, old, out=old) if fits \
                else torch.where(finite, new, old)
        if new.dtype == old.dtype and new.shape == old.shape:
            return old.copy_(new)
        return new

    def stage_batch(self, *batch_arrays):
        """Place one batch (data and labels in ``input_names`` order:
        NDArrays, tensors or numpy) on the device ahead of its step: the
        copy and the compute-dtype cast that ``step`` would do.  Host
        tensors go through pinned memory on the trainer's side stream
        (``dataflow.Uploader``), cast there; tensors already on the device
        pass through, cast on the caller's stream.  Returns the ``{name:
        device tensor}`` dict (a ``dataflow.Staged``, whose ``event`` marks
        the end of the side-stream copies) that a
        :class:`~mxnet_tpu_torch.io.StagedBatch` holds; safe to call from a
        background thread (``dataflow.DevicePrefetchIter``), which is how
        the upload of batch N+1 overlaps the step of batch N."""
        from ..dataflow import Staged, Uploader
        if len(batch_arrays) != len(self.input_names):
            raise MXNetError("step: %d arrays given for inputs %s"
                             % (len(batch_arrays), self.input_names))
        if self._uploader is None:
            self._uploader = Uploader(self._device)
        tensors = []
        for v in batch_arrays:
            if isinstance(v, NDArray):
                v = v._data
            elif not isinstance(v, torch.Tensor):
                v = tensor_from_numpy(np.asarray(v))
            tensors.append(v)
        cdt = self.compute_dtype

        def cast(t):
            return t.to(cdt) if cdt is not None and t.is_floating_point() \
                else t

        on_device = [t.device == self._device for t in tensors]
        moved, event = self._uploader.upload(
            [t for t, d in zip(tensors, on_device) if not d], cast)
        moved = iter(moved)
        out = Staged()
        for name, t, d in zip(self.input_names, tensors, on_device):
            out[name] = cast(t) if d else next(moved)
        out.event = event
        return out

    def _resolve_batch(self, batch_arrays, train=False):
        """The input dict of one step or forward on the caller's stream: a
        single :class:`~mxnet_tpu_torch.io.StagedBatch` gives its staged
        tensors (the caller's stream waits on their copies' event); other
        arrays are staged now.  On a train step an armed ``poison_grad``
        fault re-stages from poisoned host copies, a staged batch's too."""
        from ..dataflow import wait
        from ..io import StagedBatch
        from ..resilience import faults
        poison = train and faults.is_armed("poison_grad")
        if len(batch_arrays) == 1 and isinstance(batch_arrays[0],
                                                 StagedBatch):
            b = batch_arrays[0]
            if poison:
                batch_arrays = tuple(list(b.data) + list(b.label or []))
            else:
                data, event = dict(b.staged), b.event
                wait(list(data.values()), event)
                return data
        if poison:
            batch_arrays = self._poison_batch(batch_arrays)
        staged = self.stage_batch(*batch_arrays)
        data, event = dict(staged), staged.event
        wait(list(data.values()), event)
        return data

    def _poison_batch(self, batch_arrays):
        """Fault-injection hook: NaN out the first floating input so the
        step's gradients go non-finite deterministically (coverage of the
        guard without waiting for a real divergence)."""
        from ..resilience import faults
        out = list(batch_arrays)
        for i, v in enumerate(out):
            if isinstance(v, NDArray):
                v = v._data
            host = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
            if np.issubdtype(host.dtype, np.floating):
                if faults.consume("poison_grad"):
                    out[i] = np.full_like(host, np.nan)
                break
        return tuple(out)

    # -- public API --------------------------------------------------------
    def step(self, *batch_arrays, key=None):
        """One training step on data+labels in ``input_names`` order
        (numpy, NDArrays, or tensors already on the device).  Returns the
        outputs as tensors on the device.  ``key`` is the integer seed of
        the step's random draws (dropout masks), a new one from
        :func:`random.next_seed` when None: a caller that previewed the
        step with ``forward_only(key=k)`` passes the same ``k`` so both
        passes draw the same masks."""
        from contextlib import nullcontext
        from ..resilience import faults
        wd = self.watchdog
        with wd.armed("fused step %d" % (self._num_update + 1)) \
                if wd is not None else nullcontext():
            # deterministic hang injection (the watchdog drill): stalls
            # here, inside the armed window, like a wedged device would
            faults.maybe_hang("hang_step")
            return self._step_impl(batch_arrays, key)

    def _step_impl(self, batch_arrays, key):
        # consume the PREVIOUS steps' guard counters before dispatching
        # this one: a one-deep pipeline by default (the device runs step N
        # while the host prepares N+1); with flush_interval > 1 (deferred
        # metrics) the read happens every that-many steps only
        self._steps_since_flush += 1
        if self._steps_since_flush >= max(1, self.flush_interval):
            self.flush_step_guard()
        if self._zero3:
            self._check_zero3_batch(batch_arrays)
        data = self._resolve_batch(batch_arrays, train=True)
        if key is None:
            key = _random.next_seed()
        if not self._analyze_off:
            # MXTPU_ANALYZE: lint each new input signature BEFORE its
            # first step — strict mode must refuse to train a step that
            # violates the graph invariants
            self._maybe_env_analyze(data, key)
        self._num_update += 1
        return self._dispatch(data, key)

    def _check_zero3_batch(self, batch_arrays):
        """grad_sync='zero3' shards the global batch evenly over the dp
        axis: ranks whose batches differ in rows (an unpadded final
        batch) fail with guidance before any collective of the step (one
        host all-gather of the row count a step)."""
        from .. import distributed
        from ..io import StagedBatch
        arrays = batch_arrays
        if len(arrays) == 1 and isinstance(arrays[0], StagedBatch):
            arrays = tuple(arrays[0].staged.values())
        rows = [int(np.shape(v)[0]) if np.ndim(v) else 0 for v in arrays]
        if self._inproc:
            n = rows[0] if rows else 0
            k = len(self._local_dp)
            if n % k:
                raise MXNetError(
                    "grad_sync='zero3': batch dim %d does not divide over "
                    "the %d coordinates of the dp axis this process holds "
                    "— pad the final batch (iterator default) or use "
                    "grad_sync='zero'" % (n, k))
            return
        every = distributed.all_gather_object(rows[0] if rows else 0)
        n = sum(every)
        if len(set(every)) > 1 or n % self._world:
            raise MXNetError(
                "grad_sync='zero3': batch dim %d does not divide this "
                "process's share (%d) of the dp axis (%d) — pad the final "
                "batch (iterator default) or use grad_sync='zero' (rows per "
                "rank: %s)" % (n, max(every) if every else 0, self._world,
                               every))

    def _ensure_accumulators(self):
        """The device-side guard counters and metric accumulators, made
        at the first step (and after a metric fetch) — carries from then
        on."""
        if self.step_guard and self._guard_acc is None:
            self._guard_acc = torch.zeros(3, dtype=torch.int32,
                                          device=self._device)
            self._trips_seen = 0
        if self._metric_fn is not None and self._metric_acc is None:
            self._metric_acc = tuple(
                torch.zeros((), dtype=torch.float32, device=self._device)
                for _ in range(2))

    def _dispatch(self, data, key):
        """The step window: the device work of one step on a resolved
        batch (forward, backward, gradient sync, guard, update, aux
        merge, metric) — what :meth:`analyze` records.  The guard
        counters' one-step-late read and the batch's upload lie outside
        it."""
        from .. import distributed
        lr = self.optimizer.lr if self.optimizer.lr_scheduler is None else \
            self.optimizer.lr_scheduler(self._num_update)
        self._ensure_accumulators()
        if self._inproc:
            return self._dispatch_inproc(data, key, lr)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self.params.items()}
        regather = None
        with torch.enable_grad(), distributed.dp_scope(
                self._world, self._rank, sync_stats=not self._zero3):
            merged = self._xform(data)
            # cast the shards to the compute dtype before they gather,
            # so the collectives move compute-dtype bytes
            full = dict(self._cast(leaves))
            if self._zero:
                shards = {n: full[n] for n in self._zero3_dims}
                gathered = self._gather(shards)
                if self._zero3:
                    regather = Regather(self._layouts, shards, gathered)
                full.update(gathered)
                del shards, gathered
            merged.update(full)
            del full
            with regather.hooks() if regather is not None \
                    else nullcontext():
                outs, auxu = self._eval(merged, self.aux, True, key)
            # no gathered value outlives the forward but through
            # autograd's saved tensors (re-gathered there under zero3)
            del merged
            diff = [o for o in outs if o.requires_grad]
            grads = [None] * len(self.param_names)
            if diff:
                grads = torch.autograd.grad(
                    diff, [leaves[n] for n in self.param_names],
                    [torch.ones_like(o) for o in diff], allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(leaves[n]))
                 for n, g in zip(self.param_names, grads)}
        if self._world > 1:
            with torch.no_grad(), \
                    torch.profiler.record_function(GRAD_SYNC_RANGE):
                self._sync_replicated_grads(grads)
        # the named range lets a profile attribute the update's kernels
        with torch.no_grad(), torch.profiler.record_function(UPDATE_RANGE):
            outs = self._step_tail(
                outs, [(self.params, self.opt_state, self.aux, grads, auxu,
                        self._device)],
                lr, self.optimizer.wd, self._num_update, data)
        if self.step_guard:
            self._guard_pending = True
        self._outputs = outs
        return outs

    # -- the step on an in-process mesh --------------------------------------
    def _position_scope(self, index):
        """The data-parallel scope of one mesh position: BatchNorm's
        statistics psum'd over ``dp`` (float64 sums), except on zero3's
        manual tier, where each position uses its own rows; a stochastic
        op's rows of the global draw."""
        from .. import distributed
        from . import collectives as C
        axis = self.data_axis
        return distributed.dp_scope(
            self._dp, self.mesh.coords(index)[axis],
            sync_stats=self.zero3_tier != "manual",
            allreduce=lambda t: C.psum(t, axis))

    def _split_batch(self, data):
        """``{name: [part a position]}``: this process's rows split over
        its ``dp`` coordinates in order, each local position's block in
        its own storage (None for another rank's positions)."""
        from .collectives import _fresh
        mesh, k = self.mesh, len(self._local_dp)
        devs = mesh.torch_devices
        out = {}
        for name, v in data.items():
            rows = v.shape[0] // k
            parts = [None] * mesh.size
            for i in mesh.local:
                j = self._local_dp.index(mesh.coords(i)[self.data_axis])
                parts[i] = _fresh(v.narrow(0, j * rows, rows),
                                  devs[i]).contiguous()
            out[name] = parts
        return out

    def _row_owners(self):
        """The position whose outputs stand for each of this process's dp
        coordinates: coordinate 0 of every other axis where it is local,
        else the lowest local position (the tp copies agree)."""
        mesh, axis = self.mesh, self.data_axis
        picks = []
        for d in self._local_dp:
            held = [i for i in mesh.local if mesh.coords(i)[axis] == d]
            zero = [i for i in held if not any(
                v for a, v in mesh.coords(i).items() if a != axis)]
            picks.append((zero or held)[0])
        return picks

    def _global_outputs(self, results):
        """This process's rows' outputs: its ``dp`` coordinates' blocks in
        order (on a mesh inside one process, the global batch's)."""
        picks = [results[i][0] for i in self._row_owners()]
        dev = self._device
        return [torch.cat([o[k].to(dev) for o in picks], 0)
                if len(picks) > 1 else picks[0][k].to(dev)
                for k in range(len(picks[0]))]

    def _position_params(self, i, params):
        """Position ``i``'s whole params for its forward from its parts
        ``params`` (compute dtype): ``tp`` gather forms gathered over
        ``tp``, and under zero/zero3 each group's ``dp`` shards gathered
        by one collective.  Returns ``(full, shards)``, ``shards`` the
        cast dp shards the groups were gathered from."""
        from . import collectives as C
        full = dict(self._cast(params))
        for nm, form in self.tp_forms.items():
            if form == "gather":
                full[nm] = C.gather_from(full[nm], self._tp_axis,
                                         self._tp_dims[nm])
        shards = {nm: full[nm] for nm in self._zero3_dims}
        for lay in self._layouts:
            full.update(lay.gather_mesh(shards, self.data_axis))
        return full, shards

    def _segment_reads(self):
        """{param: how many checkpointed segments read it} (remat)."""
        segs = getattr(self._eval, "segments", None) or ()
        ids = {id(e[0]): e[0].name for e in self._eval.train_plan
               if e[0].op is None}
        out = {}
        for seg in segs:
            for nid in seg.reads:
                if nid in ids:
                    out[ids[nid]] = out.get(ids[nid], 0) + 1
        return out

    def _dispatch_inproc(self, data, key, lr):
        """One step of the positions: every local position's forward in
        its own thread (collectives.run), ONE backward over the sum of
        the positions' outputs (with the exchanges' last token on a
        rank-spanning mesh), the gradients summed over ``dp`` (in
        position order: a tp shard's over its dp group, a replicated
        param's likewise; its tp copies agree; under zero/zero3 a dp
        shard's arrives reduce-scattered by its group's all-gather), then
        each position updates its parts.  Under zero3 the backward
        re-gathers the groups whose values it saved
        (``zero3.MeshRegather``), and on the manual tier the BatchNorm
        moving statistics are averaged over ``dp``.  The guard's finite
        flag covers every position."""
        from . import collectives as C
        from .zero3 import MeshRegather
        mesh, n = self.mesh, self.mesh.size
        local = mesh.local
        batch = self._split_batch(data)
        leaves = [None] * n
        aux = [None] * n
        for i in local:
            leaves[i] = {k: v.parts[i].detach().requires_grad_(True)
                         for k, v in self.params.items()}
            aux[i] = {k: v.parts[i] for k, v in self.aux.items()}
        regather = MeshRegather(self._layouts, mesh, self.data_axis,
                                self._segment_reads()) \
            if self._zero3 and self._layouts else None

        def position(i):
            with self._position_scope(i):
                merged = self._xform({k: v[i] for k, v in batch.items()})
                full, shards = self._position_params(i, leaves[i])
                merged.update(full)
                del full
                if regather is None:
                    return self._eval(merged, aux[i], True, key)
                regather.register(i, shards, merged)
                merged = regather.args(i, merged)
                with regather.hooks(i):
                    res = self._eval(merged, aux[i], True, key)
                # no gathered value outlives the forward but as a handle
                merged.drop()
                return res

        with torch.enable_grad(), C.chain(mesh):
            results = C.run(mesh, position, [(i,) for i in range(n)])
            roots = [o for i in local for o in results[i][0]
                     if o.requires_grad]
            token = C.last_token(mesh)
            if token is not None:
                # every rank's backward runs the exchanges in one order
                roots.append(token)
            flat = [leaves[i][nm] for i in local for nm in self.param_names]
            grads = [None] * len(flat)
            if roots:
                grads = torch.autograd.grad(
                    roots, flat, [torch.ones_like(o) for o in roots],
                    allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(v)
                 for g, v in zip(grads, flat)]
        k = len(self.param_names)
        per = [None] * n
        for j, i in enumerate(local):
            per[i] = dict(zip(self.param_names, grads[j * k:(j + 1) * k]))
        with torch.no_grad(), \
                torch.profiler.record_function(GRAD_SYNC_RANGE):
            self._sum_over_dp(per, [nm for nm in self.param_names
                                    if nm not in self._zero3_dims])
            auxu = [None if r is None else r[1] for r in results]
            if self.zero3_tier == "manual":
                # each position saw its own rows: the moving statistics
                # are the positions' mean (the JAX manual tier's pmean)
                names = list(auxu[local[0]])
                auxu = [None if a is None else {nm: v / self._dp for nm, v
                                                in a.items()} for a in
                        self._sum_over_dp([None if a is None else dict(a)
                                           for a in auxu], names)]
        outs = self._global_outputs(results)
        with torch.no_grad(), torch.profiler.record_function(UPDATE_RANGE):
            devs = mesh.torch_devices
            outs = self._step_tail(
                outs, [(_PositionParts(self.params, i),
                        _PositionParts(self.opt_state, i),
                        _PositionParts(self.aux, i), per[i], auxu[i],
                        devs[i]) for i in local],
                lr, self.optimizer.wd, self._num_update, data)
        if self.step_guard:
            self._guard_pending = True
        self._outputs = outs
        return outs

    def _sum_over_dp(self, values, names):
        """Every local position's ``{name: tensor}`` in ``values`` (a list
        a position, None for another rank's) with ``names`` summed over
        its ``dp`` group, in place: one flat bucket a position, added in
        coordinate order."""
        from . import collectives as C
        if self._dp == 1 or not names:
            return values
        flats = [None if v is None else
                 torch.cat([v[nm].reshape(-1) for nm in names])
                 for v in values]
        sums = C.psum_positions(flats, self.mesh, self.data_axis)
        for v, mine in zip(values, sums):
            if v is None:
                continue
            off = 0
            for nm in names:
                size = v[nm].numel()
                v[nm] = mine[off:off + size].reshape(v[nm].shape)
                off += size
        return values

    def _sync_replicated_grads(self, grads):
        """Sum the replicated params' gradients over ranks in one bucket a
        dtype (the sharded ones arrived reduce-scattered)."""
        from .. import distributed
        names = [n for n in self.param_names if n not in self._zero3_dims]
        by_dtype = {}
        for n in names:
            by_dtype.setdefault(grads[n].dtype, []).append(n)
        for dtype in sorted(by_dtype, key=str):
            group = by_dtype[dtype]
            flat = distributed.all_reduce(torch.cat(
                [grads[n].reshape(-1) for n in group]))
            off = 0
            for n in group:
                k = grads[n].numel()
                grads[n] = flat[off:off + k].reshape(grads[n].shape)
                off += k

    @property
    def skipped_steps(self):
        """Total guard-skipped updates (flushes the in-flight counters)."""
        self.flush_step_guard()
        return self._skipped_steps

    @property
    def consecutive_bad_steps(self):
        """Current run of guard-skipped updates (flushes)."""
        self.flush_step_guard()
        return self._consecutive_bad_steps

    def flush_step_guard(self):
        """Fold the device-side skip counters into host state: ONE
        device->host read of the int32[3] stack, which waits for the last
        dispatched step.  Called at step() entry, at get_params/set_params
        and by the counter properties (every ``flush_interval`` steps at
        step entry).  A skipped step rolls the update counter back, so lr
        schedules and Adam's bias correction see only applied steps.
        Raises the consecutive-bad-steps abort when the flushed run
        reached the limit."""
        self._steps_since_flush = 0
        if not self._guard_pending:
            return
        self._guard_pending = False
        acc = self._guard_acc.cpu().numpy()
        total, consec, trips = int(acc[0]), int(acc[1]), int(acc[2])
        total += self._skip_base
        delta = total - self._skipped_steps
        self.last_step_skipped = consec > 0
        self._consecutive_bad_steps = consec
        if delta > 0:
            self._num_update -= delta
            self._skipped_steps = total
            _LOG.warning(
                "step guard: non-finite gradients — %d update(s) skipped "
                "(%d consecutive, %d total)", delta,
                self._consecutive_bad_steps, self._skipped_steps)
        if trips > self._trips_seen and self.max_consecutive_bad_steps > 0:
            self._trips_seen = trips
            raise MXNetError(
                "step guard: %d consecutive steps produced non-finite "
                "gradients — model has diverged (raise MXTPU_MAX_BAD_STEPS "
                "or set MXTPU_STEP_GUARD=0 to disable the guard)"
                % self.max_consecutive_bad_steps)

    # -- deferred on-device metrics ----------------------------------------
    def install_metric(self, graph_fn, flush_interval=0, key=None):
        """Fold a metric's (sum, count) accumulation into the step.

        ``graph_fn(outs, data) -> (sum, count)`` is a torch rule over the
        step's device tensors (``EvalMetric.graph_update``); the step then
        adds to a float32 pair on the device and ``EvalMetric.update``
        needs no copy to the host: the host reads the totals with
        :meth:`fetch_metric` every ``MXTPU_METRIC_INTERVAL`` updates or on
        a read.  Guard-skipped steps add nothing, as the blocking path
        drops them too.  ``graph_fn=None`` removes the rule; ``key``
        names an equivalent rule, whose re-install (a second fit with the
        same metric) only starts a fresh window.  The guard's
        ``flush_interval`` rises with it, so the skip-counter read stops
        forcing a copy every step (staleness bounded by that interval)."""
        if graph_fn is None and self._metric_fn is None:
            return
        if graph_fn is not None and key is not None and \
                key == self._metric_key:
            self._metric_acc = None
            return
        self._metric_fn = graph_fn
        self._metric_key = key if graph_fn is not None else None
        self._metric_acc = None
        if graph_fn is not None:
            self.flush_interval = int(flush_interval) if flush_interval \
                and int(flush_interval) > 0 else DEFAULT_GUARD_FLUSH_INTERVAL
        else:
            self.flush_interval = 1

    def fetch_metric(self):
        """(sum, count) accumulated on the device since the last fetch (one
        device-to-host read of both scalars; waits for the last step),
        then zeroed: bounded windows keep float32 exact for integer
        sums."""
        if self._metric_acc is None:
            return 0.0, 0.0
        s, c = torch.stack([v.float() for v in self._metric_acc]).cpu()
        self._metric_acc = None     # fresh zeros at the next step
        return float(s), float(c)

    def reset_metric(self):
        """Zero the device accumulators (epoch start)."""
        self._metric_acc = None

    # -- static analysis (mxlint graph level) ------------------------------
    def _carries(self):
        """The step's carries, as the graph lint compares them."""
        return {"params": self.params, "aux": self.aux,
                "opt_state": self.opt_state,
                "extras": {"guard": self._guard_acc,
                           "metric": self._metric_acc}}

    def _lint(self, data, key, inputs=(), min_donate_bytes=0):
        """Record one step window on the resolved batch ``data`` and lint
        it, then put every carry back as it was (values, storage and the
        update counter): analysing a step trains nothing."""
        from ..analysis import graph_lint
        from .collectives import Sharded
        carries = self._carries()
        saved = [(t, t.clone()) for _, t in graph_lint._flatten(carries)]
        held = (dict(self.params), dict(self.aux), dict(self.opt_state),
                self._guard_acc, self._metric_acc)
        # an in-process mesh's carries: every position's part list
        parts = [(v, list(v.parts)) for d in held[:3] for vs in d.values()
                 for v in (vs if isinstance(vs, tuple) else (vs,))
                 if isinstance(v, Sharded)]
        state = (self._num_update, self._guard_pending, self._outputs)

        def window():
            self._num_update += 1
            return self._dispatch(data, key)

        try:
            rec = graph_lint.record_step(window, carries=self._carries,
                                         inputs=list(inputs))
        finally:
            for d, old in zip((self.params, self.aux, self.opt_state),
                              held[:3]):
                d.clear()
                d.update(old)
            self._guard_acc, self._metric_acc = held[3], held[4]
            for v, old in parts:
                v.parts[:] = old
            with torch.no_grad():
                for t, v in saved:
                    t.copy_(v)
            self._num_update, self._guard_pending, self._outputs = state
        param_bytes = sum(int(np.prod(v.shape)) * v.dtype.itemsize
                          for v in self.params.values())
        gather, owed = self._zero3_schedule_bytes()
        report = graph_lint.lint_record(
            rec, compute_dtype=self.compute_dtype, param_bytes=param_bytes,
            expect_allgather=self._zero, min_donate_bytes=min_donate_bytes,
            schedule="zero3-%s" % self.zero3_tier if self._zero3 else None,
            expect_gather_bytes=gather if self._zero3 else None,
            expect_groups=len(self._zero3_groups) if self._zero3 else None,
            platform=self._device.type,
            data_axes=(self.data_axis,) if self._inproc else None,
            allreduce_bytes=owed)
        # plan-fusion-parity: the mxfuse rewrite this step runs must keep
        # the plain-plan monitored path intact
        report.merge(graph_lint.audit_plan_fusion(self.symbol))
        return report

    def _zero3_expected_gather_bytes(self):
        """The gather traffic a correct zero3 forward moves
        (:meth:`_zero3_schedule_bytes`); None off zero3."""
        return self._zero3_schedule_bytes()[0] if self._zero3 else None

    def _zero3_schedule_bytes(self):
        """``(gather, owed all-reduce)`` bytes of a correct zero3 step, in
        one pass over the base rules and shapes (never ``_param_spec``, so
        a broken sharding cannot lower the bar it is held to).  A param
        that no rule names and that has a dp-divisible dimension is
        gathered: its full bytes count in the compute dtype.  Any other
        param's gradient is summed over ``dp`` by design on an in-process
        mesh: its float32 master's bytes at its per-position size count
        as owed (0 across processes, where the schedule rule owes
        nothing beyond the gathers)."""
        if not self._zero3:
            return 0, 0
        dp = self._dp_world
        master = 4      # the masters and their gradients are float32
        comm = self.compute_dtype.itemsize \
            if self.compute_dtype is not None else master
        gather = owed = 0
        for name in self.param_names:
            shape = self.arg_shapes[name]
            size = int(np.prod(shape))
            spec = _spec_for(name, shape, self.param_shardings)
            if spec == () and any(d % dp == 0 and d >= dp for d in shape):
                gather += size * comm
            elif self._inproc:
                split = 1
                for entry in spec:
                    for a in ((entry,) if isinstance(entry, str) else
                              tuple(entry or ())):
                        split *= int(self.mesh.shape.get(a, 1))
                owed += size * master // split
        return gather, owed

    def analyze(self, *batch_arrays, min_donate_bytes=0):
        """Lint one step on an example batch (arrays in ``input_names``
        order, or a StagedBatch) and return the
        :class:`~mxnet_tpu_torch.analysis.report.Report`.

        Runs one step window under the recorder
        (``analysis.graph_lint.record_step``) and restores every carry
        afterwards.  Checks: every param/opt-state/aux/guard/metric carry
        keeps its storage (``min_donate_bytes=0`` — every carry, whatever
        its size), no host sync inside the step, no hand-written kernel
        outside an autograd.Function on a grad path, the collective audit
        (``report.stats['collectives']``, zeros on one device), and dtype
        drift under ``compute_dtype``.  The guard counters' one-step-late
        read happens first, outside the window, as the JAX host's read
        sits outside its jitted program."""
        if self.params is None:
            raise MXNetError(
                "SPMDTrainer.analyze: bind() and init_params() first")
        self.flush_step_guard()
        self._ensure_accumulators()
        data = self._resolve_batch(batch_arrays)
        return self._lint(data, _random.peek_seed(),
                          self._held_tensors(batch_arrays),
                          min_donate_bytes=min_donate_bytes)

    @staticmethod
    def _held_tensors(batch_arrays):
        out = []
        for v in batch_arrays:
            if isinstance(v, NDArray):
                v = v._data
            if isinstance(v, torch.Tensor):
                out.append(v)
        return out

    def _maybe_env_analyze(self, data, key):
        """MXTPU_ANALYZE=1|strict: graph-lint the step the first dispatch
        of each input signature is about to run.  Findings log as
        warnings; ``strict`` raises instead, refusing to train on a step
        that leaks a host sync or a fresh carry buffer into every
        iteration.  A refusal is sticky: a retry of the same signature
        raises again."""
        from ..analysis import ENV_ANALYZE
        mode = str(get_env(ENV_ANALYZE, "") or "").strip().lower()
        if mode in ("", "0", "off", "false", "no"):
            # cache the "off" answer: the per-step signature hashing and
            # env read are not worth paying when analysis is disabled
            self._analyze_off = True
            return
        sig = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                           for k, v in data.items()))
        if sig in self._refused:
            raise MXNetError(self._refused[sig])
        if sig in self._analyzed_keys:
            return
        self._ensure_accumulators()
        report = self._lint(data, key)
        if report.ok:
            self._analyzed_keys.add(sig)
            _LOG.info("MXTPU_ANALYZE: fused step is clean (%d ops, "
                      "collectives %s)", report.stats["dispatched_ops"],
                      report.stats.get("collectives"))
            return
        if mode == "strict":
            msg = ("MXTPU_ANALYZE=strict: the fused step violates graph "
                   "invariants:\n%s" % report.format_text())
            self._refused[sig] = msg
            raise MXNetError(msg)
        self._analyzed_keys.add(sig)
        _LOG.warning("MXTPU_ANALYZE: fused step has %d finding(s):\n%s",
                     len(report.findings), report.format_text())

    def install_watchdog(self, watchdog):
        """Arm ``watchdog`` (``resilience.StepWatchdog``) around every step
        and give its hang report this trainer's context.  None detaches
        (and clears the info hook, which would otherwise pin this trainer
        and stamp a later run's report with its context)."""
        if watchdog is None and self.watchdog is not None:
            self.watchdog.info = None
        self.watchdog = watchdog
        if watchdog is not None:
            def _info(_self=self):
                mesh = _self.mesh
                return ("trainer: step %d, grad_sync=%r, mesh=%s, device=%s"
                        % (_self._num_update, _self.grad_sync,
                           "none" if mesh is None else dict(mesh.shape),
                           _self._device))
            watchdog.info = _info
        return watchdog

    def _forward(self, batch_arrays, is_train, key):
        from .. import distributed
        data = self._resolve_batch(batch_arrays)
        if self._inproc:
            return self._forward_inproc(data, is_train, key)
        with torch.no_grad(), distributed.dp_scope(
                self._world, self._rank, sync_stats=not self._zero3):
            merged = self._xform(data)
            full = dict(self._cast(self.params))
            if self._zero:
                full.update(self._gather(
                    {n: full[n] for n in self._zero3_dims}))
            merged.update(full)
            outs, _ = self._eval(merged, self.aux, is_train, key)
        return outs

    def _forward_inproc(self, data, is_train, key):
        """A forward of the positions with every param gathered whole on
        each (the plain plan: bn_fold and the other passes see whole
        weights); outputs of this process's rows."""
        from . import collectives as C
        mesh, n = self.mesh, self.mesh.size
        batch = self._split_batch(data)
        tp = self._tp_axis

        def position(i):
            with self._position_scope(i):
                merged = self._xform({k: v[i] for k, v in batch.items()})
                full = self._cast({k: p.parts[i] for k, p in
                                   self.params.items()})
                for nm in self._tp_dims:
                    full[nm] = C.gather_from(full[nm], tp, self._tp_dims[nm])
                for lay in self._layouts:
                    full.update(lay.gather_mesh(full, self.data_axis))
                merged.update(full)
                return self._eval_plain(
                    merged, {k: a.parts[i] for k, a in self.aux.items()},
                    is_train, key)
        with torch.no_grad():
            results = C.run(mesh, position, [(i,) for i in range(n)])
        return self._global_outputs(results)

    def eval_step(self, *batch_arrays):
        """Inference-mode forward; outputs as tensors on the device."""
        return self._forward(batch_arrays, False, _random.next_seed())

    def forward_only(self, *batch_arrays, key=None):
        """Train-mode forward without the update (and without the aux
        update), for looking at outputs between steps.  With no ``key``
        it draws with the seed the next ``step`` will take (peeked, not
        taken), so stochastic layers give that step's masks."""
        if key is None:
            key = _random.peek_seed()
        return self._forward(batch_arrays, True, key)

    @property
    def outputs(self):
        return [NDArray._from_torch(o, self._ctx)
                for o in (self._outputs or [])]

    def get_params(self):
        """Copies of params and aux as host NDArrays (cpu context).  Under
        zero/zero3 a sharded param is gathered one at a time: every rank
        calls this together."""
        self.flush_step_guard()
        host = cpu()

        def _copy(d):
            return {k: NDArray._from_torch(
                self._full(k, v).detach().to("cpu", copy=True), host)
                for k, v in d.items()}
        return _copy(self.params), _copy(self.aux)

    def set_params(self, arg_params, aux_params):
        """Replace parameter values, keeping optimizer state; names
        missing from the given dicts keep their values.  Across ranks
        rank 0's given values win (every rank calls this together), and
        a sharded param keeps this rank's shard."""
        self.flush_step_guard()
        for current, given, is_param in ((self.params, arg_params, True),
                                         (self.aux, aux_params, False)):
            placed = {}
            for name, v in (given or {}).items():
                if name not in current:
                    continue
                if isinstance(v, NDArray):
                    v = v._data
                elif not isinstance(v, torch.Tensor):
                    v = tensor_from_numpy(np.asarray(v))
                cur = current[name]
                placed[name] = v.to(cur.device, cur.dtype, copy=True)
            placed = self._broadcast(placed)
            for name, v in placed.items():
                if is_param:
                    current[name] = self._shard(name, v)
                else:
                    current[name] = self._place(name, v, param=False) \
                        if self._inproc else v

    def get_states(self):
        """Serialized optimizer state (the ``Updater.get_states`` analog):
        a pickle of ``{"num_update", "states": {name: (numpy, ...)}}``, the
        JAX package's format, gathered under zero/zero3 (collective)."""
        self.flush_step_guard()
        host = {k: tuple(self._full(k, v).cpu().numpy() for v in s)
                for k, s in self.opt_state.items()}
        return pickle.dumps({"num_update": self._num_update,
                             "states": host})

    def set_states(self, blob):
        """Restore optimizer state from :meth:`get_states`'s format, or
        from an ``Updater`` blob (``{index_or_name: state}``, what the
        executor route of a Module saves), so a checkpoint resumes across
        the two routes; a sharded param's slots keep this rank's shard.
        Restored state opens a fresh guard window: the pending counters
        and the consecutive-bad count are dropped, the lifetime skip
        total is kept."""
        self._guard_pending = False
        self._guard_acc = None
        self._skip_base = self._skipped_steps
        self._consecutive_bad_steps = 0
        payload = pickle.loads(blob)
        if isinstance(payload, dict) and "states" in payload \
                and "num_update" in payload:
            states = payload["states"]
            self._num_update = payload["num_update"]
            # this format records every param's slot tuple: a missing
            # param means the blob belongs to a different model
            missing = sorted(set(self.params) - set(states))
            if missing:
                raise MXNetError(
                    "optimizer-state blob has no entry for parameter(s) "
                    "%s — the checkpoint belongs to a different model"
                    % ", ".join(missing))
        else:
            idx2name = getattr(self.optimizer, "idx2name", {}) or {}
            states = {}
            for k, v in payload.items():
                name = idx2name.get(k, k)
                if v is None:
                    states[name] = ()
                elif isinstance(v, (tuple, list)):
                    states[name] = tuple(np.asarray(x) for x in v)
                else:
                    states[name] = (np.asarray(v),)
        placed = {}
        for name, s in states.items():
            if name not in self.params:
                raise MXNetError(
                    "optimizer state for unknown parameter %r" % (name,))
            p = self.params[name]
            placed[name] = tuple(
                self._shard(name, tensor_from_numpy(np.asarray(x)).to(
                    p.device, p.dtype)) for x in s)
        for name in self.param_names:
            placed.setdefault(name, self.opt_state[name])
        self.opt_state = placed

    # -- checkpoints --------------------------------------------------------
    def snapshot_params(self):
        """Checkpoint-ready host copies: ``(arg, aux)`` dicts of
        ``resilience._HostSnapshot`` values, one device-to-host copy per
        tensor (sharded params gathered one at a time: collective), which
        ``resilience.snapshot_params`` adopts without another copy."""
        from ..resilience import _HostSnapshot
        self.flush_step_guard()
        arg = {k: _HostSnapshot(self._full(k, v).detach().to("cpu",
                                                             copy=True))
               for k, v in self.params.items()}
        aux = {k: _HostSnapshot(self._full(k, v).detach().to("cpu",
                                                             copy=True))
               for k, v in self.aux.items()}
        return arg, aux

    def save_checkpoint(self, manager, step, blocking=None):
        """Checkpoint params and optimizer state through a
        :class:`~mxnet_tpu_torch.resilience.CheckpointManager` as epoch
        ``step``.  Every rank calls it: sharded params are gathered on
        every rank (gather-on-save) and rank 0 writes.  ``blocking=None``
        follows ``MXTPU_CKPT_ASYNC``: the async path stalls the caller
        for the host copies only.  Under ``MXTPU_CKPT_SHARDED=1`` a
        zero/zero3 trainer writes sharded-native blobs instead
        (:meth:`save_checkpoint_sharded`, blocking by design)."""
        from ..resilience import ENV_CKPT_SHARDED
        sharded = str(get_env(ENV_CKPT_SHARDED, "0")).strip().lower() in \
            ("1", "true", "yes", "on")
        if sharded and self._zero and hasattr(manager, "save_sharded"):
            return self.save_checkpoint_sharded(manager, step)
        arg_params, aux_params = self.snapshot_params()
        states = self.get_states()
        plan_doc = self.sharding_plan.to_doc() \
            if self.sharding_plan is not None else None
        return manager.save(step, self.symbol, arg_params, aux_params,
                            optimizer_states=states, blocking=blocking,
                            plan=plan_doc)

    def _sharded_ckpt_dims(self):
        """param -> dp-shard dim of the sharded-native layout, or None for
        a param that travels whole in shard 0's blob."""
        return {name: self._zero3_dims.get(name)
                for name in self.param_names}

    def save_checkpoint_sharded(self, manager, step):
        """Sharded-native checkpoint: each rank writes its own blob
        (``prefix-0007.params.s001-of-002``) straight from its shards, no
        gather; replicated params and the aux states ride in shard 0's
        blob.  The blobs' payloads and names are the JAX package's, so
        either package restores them at any world.  Peers write first,
        then rank 0 writes its blob and publishes the manifest; every
        rank returns after the publish.  On an in-process mesh one blob
        a ``dp`` shard (``world`` the dp size), each from the parts of
        the position at that ``dp`` coordinate and coordinate 0 of every
        other axis; a ``tp``-ruled param travels whole in shard 0's."""
        from .. import distributed
        self.flush_step_guard()
        world, me = self._dp_world, self._rank
        dims = self._sharded_ckpt_dims()
        plan_doc = self.sharding_plan.to_doc() \
            if self.sharding_plan is not None else None

        def host(t):
            return np.array(t.detach().cpu().numpy(), copy=True)

        # the whole values travel in shard 0's blob: gathered here, on
        # every rank in one order (collective on a rank-spanning mesh)
        whole, aux = {}, None
        if self._inproc:
            for name, v in self.params.items():
                if dims[name] is None:
                    whole[name] = self._full(name, v)
                    for j, x in enumerate(self.opt_state[name]):
                        whole[(name, j)] = self._full(name, x)
            aux = {n: host(self._full(n, v)) for n, v in self.aux.items()}
        source = self.mesh.groups(self.data_axis)[0] if self._inproc \
            else None

        def value(name, v, k, j=None):
            if not self._inproc:
                return v
            if dims[name] is None:
                return whole[name if j is None else (name, j)]
            return v.parts[source[k]]

        def payload(k):
            if not self._inproc and k != me:
                return None
            if self._inproc and \
                    self.mesh.rank_of[source[k]] != distributed.rank():
                return None
            out = {"epoch": int(step), "shard": int(k),
                   "world": int(world), "dims": dims,
                   "num_update": self._num_update, "args": {}, "opt": {}}
            for name, v in self.params.items():
                if dims[name] is not None or k == 0:
                    out["args"][name] = host(value(name, v, k))
                    out["opt"][name] = tuple(
                        host(value(name, x, k, j))
                        for j, x in enumerate(self.opt_state[name]))
            if k == 0:
                out["aux"] = aux if aux is not None else {
                    n: host(self._full(n, v)) for n, v in self.aux.items()}
            return pickle.dumps(out, protocol=4)

        if self._inproc and not self._spans:
            manager.save_sharded(step, self.symbol, payload, world=world,
                                 plan=plan_doc, rank=0)
            return int(step)
        if me != 0:
            manager.save_sharded(step, self.symbol, payload, world=world,
                                 plan=plan_doc, rank=me)
        distributed.barrier("ckpt_sharded_blobs")
        if me == 0:
            manager.save_sharded(step, self.symbol, payload, world=world,
                                 plan=plan_doc, rank=0)
        distributed.barrier("ckpt_sharded_publish")
        return int(step)

    def restore(self, manager, epoch=None):
        """Resume params and optimizer state (with the update counter,
        inside the states blob) from the manager's newest (or given)
        checkpoint; returns the restored epoch.  Elastic: a checkpoint
        written at another world (gathered or sharded-native) re-shards
        through ``set_params``.  The parameter set must match exactly: a
        parameter added or removed between save and resume raises with
        names (use ``set_params`` for a deliberate partial restore)."""
        _, arg_params, aux_params, states, epoch = manager.restore(epoch)
        problems = diff_param_sets(arg_params, self.param_names)
        problems += diff_param_sets(aux_params, self.aux_names,
                                    kind="aux state")
        if problems:
            raise MXNetError(
                "restore: checkpoint epoch %d does not match this "
                "model's parameter set:\n  %s\n(a param added/removed "
                "between save and resume — fix the symbol, or load "
                "deliberately with set_params)"
                % (epoch, "\n  ".join(problems)))
        saved_plan = manager.plan(epoch) if hasattr(manager, "plan") \
            else None
        if saved_plan is not None and self.sharding_plan is not None:
            saved_world = int(saved_plan.get("world", 1))
            if saved_world != self.sharding_plan.world:
                _LOG.info(
                    "elastic resume: checkpoint epoch %d was written at "
                    "world=%d (grad_sync=%r), restoring at world=%d — "
                    "params re-shard through set_params placement",
                    epoch, saved_world, saved_plan.get("grad_sync"),
                    self.sharding_plan.world)
        self.set_params(arg_params, aux_params)
        if states is not None:
            self.set_states(states)
        return epoch

    # -- lifecycle --------------------------------------------------------
    def close(self):
        """Drop this trainer's tensors (params, aux, optimizer state,
        outputs, counters); the trainer is unusable afterwards."""
        for attr in ("params", "aux", "opt_state", "_outputs", "_guard_acc",
                     "_metric_acc"):
            setattr(self, attr, None)
        self._guard_pending = False
        self._eval = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
        return False
