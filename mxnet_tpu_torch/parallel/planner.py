"""mxplan — the automatic sharding planner + elastic-resume artifact (port
of ``mxnet_tpu/parallel/planner.py``; the ``dp`` axis: a plan that needs
``tp`` raises, naming the item that brings it).

ZeRO-3 (zero3.py) made fully-sharded training WORK; this module makes it
CHOSEN.  Every run used to hand-pick its mesh, its param rules and the
``MXTPU_ZERO3_GATHER_GROUP`` knob, and a checkpoint was welded to the
world size that wrote it.  The planner closes both gaps with ONE
artifact, the :class:`ShardingPlan`:

- **prescriptive** (:func:`plan`): given a symbol graph, the device
  inventory and an HBM budget, choose the mesh shape, the gradient-sync
  strategy (replicate / dp-shard / zero3 — the cheapest-comm strategy
  whose modeled per-device bytes fit the budget) and the per-param
  sharding actions.  ``SPMDTrainer(plan=...)`` / ``SPMDModule(plan=...)``
  consume it instead of ad-hoc arguments.
- **derived gather groups** (:func:`derive_gather_groups`): zero3 gather
  groups come from the executor plan's first-consumer order, merged
  toward a target bucket size (``MXTPU_PLAN_GATHER_BUCKET``) — this is
  the ``MXTPU_ZERO3_GATHER_GROUP=auto`` default; a numeric override
  still wins but warns when it loses to the planned grouping on the
  memory model (:func:`group_cost`).
- **descriptive** (:meth:`ShardingPlan.from_trainer`): every bound
  trainer records the plan it actually executes;
  ``SPMDTrainer.save_checkpoint`` persists it in the checkpoint
  manifest, so a resume — on ANY world size — knows exactly what wrote
  the bytes.  :func:`check_inventory` is the pre-resume gate
  (``tools/plan_explain.py --check``, ``tools/ckpt_fsck.py --devices``):
  world-size changes are a NOTE (gather-on-save checkpoints re-shard
  elastically through ``set_params``), unsatisfiable mesh axes, a
  batch the new dp axis cannot shard, or a blown HBM budget are
  PROBLEMS.
- **explainable**: :meth:`ShardingPlan.explain` renders every decision
  with the byte model behind it — "annotate the graph, let the planner
  pick" is only trustworthy when the pick can be audited.

Everything here except :func:`plan`'s symbol-shape inference and
:meth:`from_trainer` is pure-dict math, and a plan's JSON equals the JAX
package's byte for byte given the same inputs.  The inventory of
:func:`plan` is the process group's world, and the per-device memory
``torch.cuda.mem_get_info`` on the card (or ``MXTPU_PLAN_HBM_BUDGET``).
"""
from __future__ import annotations

import hashlib
import json
import re

from ..base import MXNetError, get_env, register_env

__all__ = ["PLAN_VERSION", "ShardingPlan", "plan", "derive_gather_groups",
           "group_cost", "check_inventory", "diff_param_sets",
           "ENV_PLAN_GATHER_BUCKET", "ENV_PLAN_HBM_BUDGET"]

#: manifest/file schema version of a serialized ShardingPlan
PLAN_VERSION = 1

ENV_PLAN_GATHER_BUCKET = register_env(
    "MXTPU_PLAN_GATHER_BUCKET", default=str(4 << 20),
    doc="mxplan: target bytes per zero3 gather group under "
        "MXTPU_ZERO3_GATHER_GROUP=auto — consecutive plan-order layers "
        "merge into one bucketed collective until the group's gathered "
        "bytes would exceed this (bigger = fewer dispatches, less "
        "gather/compute overlap and a higher replicated peak)")

ENV_PLAN_HBM_BUDGET = register_env(
    "MXTPU_PLAN_HBM_BUDGET", default="0",
    doc="mxplan: per-device HBM budget in bytes for planner.plan()'s "
        "strategy choice when the caller passes none (0 = unconstrained "
        "— the planner keeps params replicated and says so in the plan's "
        "decisions)")

#: optimizer kind -> in-graph state slots per parameter (mirrors
#: SPMDTrainer._init_opt_state; the byte model prices opt state with it
#: — use :func:`_opt_slots_of`, which also handles momentum-less sgd
#: allocating ZERO slots)
_OPT_SLOTS = {"sgd": 1, "ccsgd": 1, "adam": 2, "rmsprop": 1}


def _opt_slots_of(kind, momentum=None):
    """State slots per parameter, exactly as _init_opt_state allocates
    them: sgd/ccsgd carry a slot only when momentum is engaged."""
    slots = _OPT_SLOTS.get(kind, 0)
    if kind in ("sgd", "ccsgd") and not momentum:
        slots = 0
    return slots

_DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
                "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
                "bool": 1}


def _nelem(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _itemsize(dtype):
    return _DTYPE_BYTES.get(str(dtype), 4)


def _dtype_name(dtype):
    """A torch or numpy dtype's plain name (``float32``), as the JAX
    package's docs spell it."""
    return str(dtype).replace("torch.", "")


def _pbytes(rec):
    """Full-size bytes of one plan param record."""
    return _nelem(rec["shape"]) * _itemsize(rec.get("dtype", "float32"))


# ---------------------------------------------------------------------------
# gather-group derivation + the memory model (the =auto default)
# ---------------------------------------------------------------------------

def group_cost(groups, sizes):
    """The memory model one grouping is judged by: ``(collectives,
    peak_bytes)`` — the manual tier issues ONE bucketed collective per
    group, and one group's gathered (replicated) bytes is the step's
    transient parameter peak.  Fewer collectives cost less dispatch;
    a smaller peak costs less HBM.  A grouping that is worse on BOTH
    axes is Pareto-dominated (``_plan_zero3`` warns when a manual
    ``MXTPU_ZERO3_GATHER_GROUP`` value loses to the planned grouping
    this way)."""
    if not groups:
        return (0, 0)
    peak = max(sum(int(sizes.get(n, 0)) for n in g) for g in groups)
    return (len(groups), peak)


def dominates(a, b):
    """True when cost ``a`` Pareto-dominates ``b``: no worse on both
    axes, strictly better on at least one."""
    return a[0] <= b[0] and a[1] <= b[1] and a != b


def resolve_bucket(bucket_bytes=None):
    """The effective gather-bucket target: the explicit value, or
    ``MXTPU_PLAN_GATHER_BUCKET`` (garbage degrades to the default)."""
    if bucket_bytes is None:
        try:
            bucket_bytes = int(
                get_env(ENV_PLAN_GATHER_BUCKET, str(4 << 20)) or (4 << 20))
        except (TypeError, ValueError):
            bucket_bytes = 4 << 20
    return max(1, int(bucket_bytes))


def derive_gather_groups(symbol, param_names, shapes, itemsize=4,
                         bucket_bytes=None):
    """The planner's gather grouping (``MXTPU_ZERO3_GATHER_GROUP=auto``).

    Layer-granularity groups come from the executor plan's
    first-consumer order (zero3.plan_gather_groups at group size 1 — a
    pure function of the graph, identical across processes), then
    consecutive layers greedy-merge while the merged group's gathered
    bytes stay within ``bucket_bytes`` (default
    ``MXTPU_PLAN_GATHER_BUCKET``).  Small layers (biases, norms) fuse
    into their neighbors' collectives; a layer bigger than the bucket
    keeps its own group — the bucket bounds merging, not splitting.

    ``itemsize``: bytes per element on the wire (the comm dtype —
    compute_dtype for floating params under mixed precision).
    """
    from . import zero3 as z3
    if not param_names:
        return []
    bucket_bytes = resolve_bucket(bucket_bytes)
    layers = z3.plan_gather_groups(symbol, param_names, 1)
    sizes = {n: _nelem(shapes[n]) * int(itemsize) for n in param_names}
    groups, cur, cur_bytes = [], [], 0
    for layer in layers:
        lb = sum(sizes[n] for n in layer)
        if cur and cur_bytes + lb > bucket_bytes:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.extend(layer)
        cur_bytes += lb
    if cur:
        groups.append(cur)
    return groups


# ---------------------------------------------------------------------------
# the byte model (what "fits" means)
# ---------------------------------------------------------------------------

def _strategy_bytes(param_bytes, opt_bytes, comm_bytes, max_group_bytes,
                    world):
    """Modeled steady-state per-device parameter-side bytes of each
    strategy (activations ride on top of all three equally, so they
    cancel out of the comparison):

    - ``allreduce``: replicated f32 master + opt state + one comm-dtype
      gradient set.
    - ``zero``: 1/world shards of master+opt, but the step's gather
      block replicates ALL params in comm dtype at once (plus the
      gradients before their reduce-scatter).
    - ``zero3``: 1/world shards; only ONE gather group is replicated at
      a time (backward re-gather), and gradients reduce-scatter as they
      are produced — the transient is ~2 groups (one live, one in
      flight under the latency-hiding scheduler).
    """
    w = max(1, int(world))
    return {
        "allreduce": param_bytes + opt_bytes + comm_bytes,
        "zero": (param_bytes + opt_bytes) // w + 2 * comm_bytes,
        "zero3": (param_bytes + opt_bytes) // w + 2 * max_group_bytes,
    }


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------

class ShardingPlan(object):
    """One serializable, explainable sharding decision.

    Wraps the plain-JSON ``doc`` (the form persisted in checkpoint
    manifests and plan files); every accessor is a dict read, so a plan
    loaded from a file behaves identically to one built from a live
    trainer."""

    def __init__(self, doc):
        if not isinstance(doc, dict):
            raise MXNetError("ShardingPlan: doc must be a dict, got %r"
                             % type(doc).__name__)
        version = int(doc.get("version", 0))
        if version != PLAN_VERSION:
            raise MXNetError(
                "ShardingPlan: unsupported plan version %r (this build "
                "understands %d) — re-plan on the writing side or "
                "upgrade this one" % (doc.get("version"), PLAN_VERSION))
        self.doc = doc

    # -- construction -------------------------------------------------------
    @classmethod
    def from_doc(cls, doc):
        return cls(doc)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls(json.load(f))

    @classmethod
    def from_trainer(cls, trainer):
        """The DESCRIPTIVE plan: what a bound SPMDTrainer actually
        executes — world, mesh axes, per-param resolved placement,
        zero3 gather groups.  ``save_checkpoint`` persists this doc in
        the manifest so a resume on a different inventory knows the
        writing run's layout."""
        mesh = trainer.mesh
        mesh_axes = {str(k): int(v) for k, v in mesh.shape.items()} \
            if mesh is not None else {}
        world = mesh_axes.get(trainer.data_axis, 1)
        params = {}
        for name in trainer.param_names:
            shape = tuple(int(d) for d in trainer.arg_shapes[name])
            spec = trainer._param_spec(name, shape)
            entries = tuple(spec)
            dims = [i for i, e in enumerate(entries)
                    if e == trainer.data_axis]
            dim = dims[0] if len(dims) == 1 and all(
                e in (None, trainer.data_axis) for e in entries) else None
            dtype = "float32"
            if trainer.params and name in trainer.params:
                dtype = _dtype_name(trainer.params[name].dtype)
            params[name] = {
                "shape": list(shape), "dtype": dtype,
                "spec": [None if e is None else str(e) for e in entries],
                "action": ("shard" if any(entries) else "replicate"),
                "dim": dim,
            }
        kind = type(trainer.optimizer).__name__.lower()
        comm_itemsize = _itemsize(_dtype_name(trainer.compute_dtype)) \
            if trainer.compute_dtype is not None else 4
        bucket = resolve_bucket()
        doc = {
            "version": PLAN_VERSION,
            "source": "trainer",
            "world": int(world),
            "mesh_axes": mesh_axes,
            "data_axis": trainer.data_axis,
            "batch_size": int(getattr(trainer, "global_batch_size",
                                      trainer.batch_size)),
            "grad_sync": trainer.grad_sync,
            "zero3_tier": trainer.zero3_tier,
            "compute_dtype": (_dtype_name(trainer.compute_dtype)
                              if trainer.compute_dtype is not None
                              else None),
            "optimizer": kind,
            "opt_slots": _opt_slots_of(
                kind, getattr(trainer.optimizer, "momentum", None)),
            "comm_itemsize": int(comm_itemsize),
            "gather_bucket": bucket,
            "hbm_budget": 0,
            "param_shardings": {
                str(k): [None if e is None else str(e) for e in
                         (tuple(v) if not isinstance(v, str) else (v,))]
                for k, v in (trainer.param_shardings or {}).items()},
            "params": params,
            "gather_groups": [list(g) for g in trainer._zero3_groups],
            "decisions": ["recorded from a bound trainer (grad_sync=%r, "
                          "mesh=%s)" % (trainer.grad_sync,
                                        mesh_axes or "none")],
        }
        if trainer._zero and trainer.param_shardings:
            # explicit rules survive zero/zero3: the step does NOT widen
            # these params to replicated (the silent-widening fix) —
            # record each kept spec so plan_explain shows the decision
            from .trainer import _spec_for
            for name in trainer.param_names:
                spec = _spec_for(name, trainer.arg_shapes[name],
                                 trainer.param_shardings)
                if tuple(spec):
                    doc["decisions"].append(
                        "%s: explicit shard spec %s kept under "
                        "grad_sync=%r (not widened to replicated)"
                        % (name,
                           [None if e is None else str(e)
                            for e in tuple(spec)],
                           trainer.grad_sync))
        # an in-process mesh: the tensor-parallel form each rule took
        for name, form in sorted(getattr(trainer, "tp_forms", {}).items()):
            doc["decisions"].append(
                "%s: tp form %s (ops.nn.tp_layer)" % (name, form))
        p = cls(doc)
        doc["bytes"] = p._byte_model()
        return p

    # -- accessors ----------------------------------------------------------
    @property
    def world(self):
        return int(self.doc.get("world", 1))

    @property
    def mesh_axes(self):
        return dict(self.doc.get("mesh_axes") or {})

    @property
    def data_axis(self):
        return self.doc.get("data_axis", "dp")

    @property
    def grad_sync(self):
        return self.doc.get("grad_sync", "allreduce")

    @property
    def batch_size(self):
        return int(self.doc.get("batch_size", 0))

    @property
    def params(self):
        return dict(self.doc.get("params") or {})

    @property
    def gather_groups(self):
        return [list(g) for g in (self.doc.get("gather_groups") or [])]

    @property
    def param_shardings(self):
        """The POLICY rules (regex -> axes tuple) a consuming trainer
        re-applies; derived per-param specs stay descriptive."""
        return {k: tuple(v) for k, v in
                (self.doc.get("param_shardings") or {}).items()}

    @property
    def compute_dtype(self):
        return self.doc.get("compute_dtype")

    @property
    def decisions(self):
        return list(self.doc.get("decisions") or [])

    # -- serialization ------------------------------------------------------
    def to_doc(self):
        return json.loads(self.to_json())

    def to_json(self):
        return json.dumps(self.doc, indent=2, sort_keys=True)

    def save(self, path):
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    def digest(self):
        """Stable content digest (sha256 of the canonical JSON) — two
        plans with the same decisions have the same digest regardless
        of which process serialized them."""
        return hashlib.sha256(
            json.dumps(self.doc, sort_keys=True,
                       separators=(",", ":")).encode()).hexdigest()

    # -- the byte model -----------------------------------------------------
    def _byte_model(self, world=None):
        params = self.params
        pb = sum(_pbytes(r) for r in params.values())
        comm_itemsize = int(self.doc.get("comm_itemsize", 4))
        cb = sum(_nelem(r["shape"]) * comm_itemsize
                 for r in params.values())
        ob = int(self.doc.get("opt_slots", 0)) * pb
        sizes = {n: _nelem(r["shape"]) * comm_itemsize
                 for n, r in params.items()}
        groups = self.gather_groups
        _, peak = group_cost(groups, sizes)
        if not groups and params:
            # no recorded groups (non-zero3 plan): model zero3 at layer
            # granularity as the largest single param
            peak = max(sizes.values())
        w = self.world if world is None else int(world)
        return {
            "param": pb, "opt": ob, "comm": cb,
            "max_group": peak,
            "per_device": _strategy_bytes(pb, ob, cb, peak, w),
        }

    # -- gates --------------------------------------------------------------
    def check_inventory(self, ndevices, hbm_bytes=None):
        """Does this plan still fit ``ndevices`` (and optionally a
        per-device ``hbm_bytes`` budget)?  Returns ``(problems,
        notes)``: problems are hard misfits a resume must not walk onto
        (unsatisfiable mesh axes, a batch the dp axis cannot shard, a
        blown byte budget); notes are survivable differences the
        operator should know about (a world-size change — gather-on-save
        checkpoints re-shard elastically through ``set_params``)."""
        problems, notes = [], []
        ndevices = int(ndevices)
        if ndevices <= 0:
            return (["device inventory is empty (%d devices)"
                     % ndevices], notes)
        other = 1
        for axis, size in self.mesh_axes.items():
            if axis != self.data_axis:
                other *= int(size)
        if other > 1 and ndevices % other:
            problems.append(
                "mesh axes %s need a multiple of %d devices; inventory "
                "has %d" % (self.mesh_axes, other, ndevices))
            return (problems, notes)
        dp = max(1, ndevices // other)
        if self.batch_size and self.batch_size % dp:
            # EVERY strategy dp-shards the batch over the mesh (the
            # placement layer rejects an indivisible one), and the
            # zero3 manual tier additionally shard_maps the step
            problems.append(
                "batch %d does not divide the %d-way dp axis a resume "
                "would build on %d devices — pad the batch (iterator "
                "default) or change it"
                % (self.batch_size, dp, ndevices))
        budget = hbm_bytes
        if budget is None:
            budget = int(self.doc.get("hbm_budget", 0) or 0)
        if budget:
            model = self._byte_model(world=dp)
            need = model["per_device"].get(self.grad_sync, 0)
            if need > budget:
                problems.append(
                    "modeled per-device bytes at world=%d under %r "
                    "(%d) exceed the HBM budget (%d) — re-plan on this "
                    "inventory" % (dp, self.grad_sync, need, budget))
        if dp != self.world:
            notes.append(
                "elastic re-shard required: plan was written at "
                "world=%d, inventory gives dp=%d — gather-on-save "
                "checkpoints restore through set_params re-sharding "
                "(docs/how_to/planner.md)" % (self.world, dp))
        return (problems, notes)

    # -- explanation --------------------------------------------------------
    def explain(self):
        """Human-readable walkthrough of the plan (the
        ``tools/plan_explain.py`` body)."""
        d = self.doc
        model = d.get("bytes") or self._byte_model()
        lines = []
        lines.append("ShardingPlan v%d (%s)" % (PLAN_VERSION,
                                                d.get("source", "?")))
        lines.append("  mesh: %s  (world=%d over axis %r, batch %d)"
                     % (self.mesh_axes or "single device", self.world,
                        self.data_axis, self.batch_size))
        lines.append("  strategy: grad_sync=%r%s  compute_dtype=%s"
                     % (self.grad_sync,
                        (" tier=%s" % d["zero3_tier"])
                        if d.get("zero3_tier") else "",
                        d.get("compute_dtype") or "float32"))
        params = self.params
        sharded = sorted(n for n, r in params.items()
                         if r.get("action") == "shard")
        repl = sorted(set(params) - set(sharded))
        pb, ob = model.get("param", 0), model.get("opt", 0)
        lines.append("  params: %d total, %d bytes master + %d bytes "
                     "optimizer state" % (len(params), pb, ob))
        lines.append("    sharded (%d): %s" % (len(sharded),
                                               ", ".join(sharded) or "-"))
        lines.append("    replicated (%d): %s" % (len(repl),
                                                  ", ".join(repl) or "-"))
        per = model.get("per_device", {})
        for strat in ("allreduce", "zero", "zero3"):
            mark = " <= chosen" if strat == self.grad_sync else ""
            lines.append("  modeled bytes/device [%s]: %d%s"
                         % (strat, per.get(strat, 0), mark))
        groups = self.gather_groups
        if groups:
            comm_itemsize = int(d.get("comm_itemsize", 4))
            lines.append("  gather groups (%d, first-consumer order, "
                         "bucket target %s bytes):"
                         % (len(groups),
                            d.get("gather_bucket", "default")))
            for i, g in enumerate(groups):
                gb = sum(_nelem(params[n]["shape"]) * comm_itemsize
                         for n in g if n in params)
                lines.append("    [%d] %s (%d bytes)"
                             % (i, ", ".join(g), gb))
        for dec in self.decisions:
            lines.append("  decision: %s" % dec)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# prescriptive planning
# ---------------------------------------------------------------------------

def plan(symbol, data_shapes, label_shapes=None, world=None, devices=None,
         hbm_budget=None, optimizer="sgd", optimizer_params=None,
         compute_dtype=None, param_shardings=None, grad_sync=None,
         gather_bucket=None):
    """Choose a sharding plan for ``symbol`` on the given inventory.

    ``world``/``devices``: the device inventory (one of them; with
    neither, the process group's world, and on the card its memory;
    ``devices`` may be contexts, ranks or ``(rank, Context)`` pairs: the
    inventory is ranks x contexts, and rules may name any axis over
    it).  ``hbm_budget``: per-device byte budget (default
    ``MXTPU_PLAN_HBM_BUDGET``; 0 = unconstrained).  ``grad_sync``
    pins the strategy and the planner only derives mesh/rules/groups.

    The strategy choice walks allreduce -> zero -> zero3 (cheapest
    communication first) and takes the first whose modeled per-device
    bytes (:func:`_strategy_bytes`) fit the budget; when nothing fits,
    it raises with the numbers — an impossible plan must fail at
    planning time, not as an OOM three hours into the run.
    """
    decisions = []
    query_device = False
    if world is None:
        if devices is not None:
            world = len(devices)
        else:
            from .. import distributed
            world = distributed.num_workers()
            query_device = True
            decisions.append("inventory from the process group: %d"
                             % world)
    world = int(world)
    if world <= 0:
        raise MXNetError("planner.plan: empty device inventory")
    if hbm_budget is None:
        try:
            hbm_budget = int(get_env(ENV_PLAN_HBM_BUDGET, "0") or 0)
        except (TypeError, ValueError):
            hbm_budget = 0
        if hbm_budget:
            decisions.append("HBM budget from MXTPU_PLAN_HBM_BUDGET: %d"
                             % hbm_budget)
    if not hbm_budget and query_device:
        # best effort: this rank's card advertises its memory
        from .. import distributed
        dev = distributed.device()
        if dev is not None and dev.type == "cuda":
            import torch
            hbm_budget = int(torch.cuda.mem_get_info(dev)[1])
            decisions.append("HBM budget from torch.cuda.mem_get_info: %d"
                             % hbm_budget)
    hbm_budget = int(hbm_budget or 0)

    # shapes come from the graph, exactly as bind() infers them
    from ..io import DataDesc
    data_shapes = [d if isinstance(d, DataDesc) else DataDesc(d[0], d[1])
                   for d in data_shapes]
    label_shapes = [l if isinstance(l, DataDesc) else DataDesc(l[0], l[1])
                    for l in (label_shapes or [])]
    shapes = {d.name: d.shape for d in data_shapes + label_shapes}
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    arg_names = symbol.list_arguments()
    input_names = set(shapes)
    param_shapes = {n: tuple(int(x) for x in s)
                    for n, s in zip(arg_names, arg_shapes)
                    if n not in input_names}
    batch_size = int(data_shapes[0].shape[0])

    comm_itemsize = _itemsize(compute_dtype) if compute_dtype else 4
    kind = str(optimizer).lower()
    opt_slots = _opt_slots_of(kind,
                              (optimizer_params or {}).get("momentum"))
    gather_bucket = resolve_bucket(gather_bucket)

    # per-param action under dp sharding (mirrors _param_spec's rule:
    # explicit regex rules win, otherwise shard the first dp-divisible
    # dimension)
    rules = dict(param_shardings or {})
    params = {}
    for name in sorted(param_shapes):
        shape = param_shapes[name]
        spec = None
        for pattern, axes in rules.items():
            if re.match(pattern, name):
                spec = [None if a is None else str(a)
                        for a in (axes if not isinstance(axes, str)
                                  else (axes,))]
                break
        rec = {"shape": list(shape), "dtype": "float32"}
        if spec is not None:
            rec["spec"] = spec
            rec["action"] = "shard" if any(spec) else "replicate"
            rec["dim"] = None
            rec["rule"] = "explicit"
        else:
            dim = None
            for i, d in enumerate(shape):
                if d % world == 0 and d >= world:
                    dim = i
                    break
            if dim is None:
                rec["spec"] = [None] * len(shape)
                rec["action"] = "replicate"
                rec["dim"] = None
                rec["rule"] = "indivisible"
            else:
                rec["spec"] = ["dp" if i == dim else None
                               for i in range(len(shape))]
                rec["action"] = "shard"
                rec["dim"] = dim
                rec["rule"] = "dp"
        params[name] = rec

    groups = derive_gather_groups(
        symbol, sorted(n for n, r in params.items()
                       if r.get("rule") == "dp"),
        {n: tuple(r["shape"]) for n, r in params.items()},
        itemsize=comm_itemsize, bucket_bytes=gather_bucket)

    doc = {
        "version": PLAN_VERSION,
        "source": "planner",
        "world": world,
        "mesh_axes": {"dp": world},
        "data_axis": "dp",
        "batch_size": batch_size,
        "grad_sync": grad_sync or "allreduce",
        "zero3_tier": None,
        "compute_dtype": str(compute_dtype) if compute_dtype else None,
        "optimizer": kind,
        "opt_slots": opt_slots,
        "comm_itemsize": comm_itemsize,
        "gather_bucket": gather_bucket,
        "hbm_budget": hbm_budget,
        "param_shardings": {
            str(k): [None if a is None else str(a) for a in
                     (tuple(v) if not isinstance(v, str) else (v,))]
            for k, v in rules.items()},
        "params": params,
        "gather_groups": [list(g) for g in groups],
        "decisions": decisions,
    }
    p = ShardingPlan(doc)
    model = p._byte_model()
    doc["bytes"] = model

    if grad_sync is not None:
        decisions.append("grad_sync pinned by caller: %r" % grad_sync)
    elif not hbm_budget:
        doc["grad_sync"] = "allreduce"
        decisions.append(
            "no HBM budget: params assumed to fit replicated "
            "(grad_sync='allreduce'); pass hbm_budget= or set "
            "MXTPU_PLAN_HBM_BUDGET to engage sharding")
    else:
        chosen = None
        for strat in ("allreduce", "zero", "zero3"):
            need = model["per_device"][strat]
            if need <= hbm_budget:
                chosen = strat
                decisions.append(
                    "%r fits: %d modeled bytes/device <= %d budget "
                    "(cheapest-communication strategy that fits)"
                    % (strat, need, hbm_budget))
                break
            decisions.append("%r does not fit: %d modeled bytes/device "
                             "> %d budget" % (strat, need, hbm_budget))
        if chosen is None:
            raise MXNetError(
                "planner.plan: no strategy fits %d bytes/device on %d "
                "devices (modeled: %s) — more devices, a bigger budget, "
                "or a smaller model" % (hbm_budget, world,
                                        model["per_device"]))
        doc["grad_sync"] = chosen
    if world > 1 and batch_size % world:
        raise MXNetError(
            "planner.plan: batch %d does not divide the %d-way dp axis "
            "the data shards over — pad the batch (iterator default) "
            "or change it" % (batch_size, world))
    return p


# ---------------------------------------------------------------------------
# module-level gates (what tools/plan_explain.py and tools/ckpt_fsck.py call)
# ---------------------------------------------------------------------------

def check_inventory(doc, ndevices, hbm_bytes=None):
    """``(problems, notes)`` for a plain plan doc against ``ndevices``.  An unreadable/unversioned doc is itself a problem
    (a resume must not trust bytes it cannot interpret)."""
    try:
        p = ShardingPlan(doc)
    except MXNetError as e:
        return ([str(e)], [])
    return p.check_inventory(ndevices, hbm_bytes=hbm_bytes)


def diff_param_sets(saved_params, current_names, kind="parameter"):
    """Problems list for a save->resume param-set change: a param
    ADDED to the model since the save, REMOVED from it, or RESHAPED
    must fail the resume with names — never silently misload.
    ``saved_params``: the plan doc's params dict (or any
    ``{name: {"shape": [...]}}``); ``current_names``: either a name
    iterable or a ``{name: shape}`` dict (shapes then compared too)."""
    saved = dict(saved_params or {})
    shapes = None
    if isinstance(current_names, dict):
        shapes = {n: tuple(int(d) for d in s)
                  for n, s in current_names.items()}
        current = set(shapes)
    else:
        current = set(current_names)
    problems = []
    added = sorted(current - set(saved))
    removed = sorted(set(saved) - current)
    if added:
        problems.append(
            "%s(s) %s exist in the model but not in the checkpoint "
            "(added since the save)" % (kind, ", ".join(added)))
    if removed:
        problems.append(
            "%s(s) %s exist in the checkpoint but not in the model "
            "(removed since the save)" % (kind, ", ".join(removed)))
    if shapes:
        for name in sorted(current & set(saved)):
            rec = saved[name]
            want = tuple(int(d) for d in (rec.get("shape") or ())) \
                if isinstance(rec, dict) else tuple(rec)
            if want and shapes[name] != want:
                problems.append(
                    "%s %s changed shape: checkpoint %s vs model %s"
                    % (kind, name, list(want), list(shapes[name])))
    return problems
