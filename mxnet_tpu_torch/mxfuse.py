"""mxfuse — the plan-level graph optimizer (port of ``mxnet_tpu/mxfuse.py``).

The executor's node plan (:func:`executor._node_plan`) is a topological
list of ``(node, call_attrs, n_out, aux_var_names, rng_ix, override)``
entries.  A pass never adds or removes entries: it only fills the
``override`` slot (and :meth:`PlanView.apply` re-sorts the entries when an
override reads a value produced later in symbol order), so
``MXTPU_FUSED_KERNELS=0`` restores the exact pre-fusion program.

An override is ``(fn, extra_refs, eval_dead_ins, train_dead_ins)``:

- ``fn`` replaces the node's op; the interpreter appends the values of
  ``extra_refs`` (``(src_node, idx)`` pairs) to the node's own inputs.
- ``eval_dead_ins`` names input positions the override ignores on the
  inference path, ``train_dead_ins`` those it ignores in training; the
  interpreter passes None there.  (The JAX package's override has the
  first three slots; the fourth is the port's, see :func:`live_entries`.)

A **passthrough** override (identity on input 0) marks a node whose work
another override absorbed.  Its value may be WRONG (an elementwise-chain
intermediate carries the chain's input), so no extra ref may read such a
node, and every plain reader must be an override that knows it
(checked at :meth:`PlanView.apply`).

Pass pipeline (:data:`PASSES`, in the JAX package's order):

1. ``concat_fuse`` — sibling conv→BN(→act) tower heads sharing one input
   (or one geometry and width over independent inputs) merge into ONE
   conv over concatenated filters (or one grouped conv), each member
   slicing its channel range; the merged body runs once per forward
   (:mod:`.kernels.concat_fuse`).
2. ``pool_act`` — act→max-pool reorders to pool-first; pool→act pairs
   collapse to one entry; other Pooling entries take the routed lowering
   (:mod:`.kernels.pool_act`).
3. ``bn_act`` / ``bn_fold`` — BatchNorm+activation through the ``bn_act``
   CUDA kernel, and conv-BN folding at inference.
4. ``eltwise_chain`` — runs of private elementwise ops collapse into one
   entry at the chain tail (:mod:`.kernels.eltwise_chain`).

**Liveness.**  :func:`live_entries` is the port's replacement for XLA's
dead-code elimination, which the JAX package relies on under ``jit``: the
executor interprets, on each path, only the entries whose values a live
entry, an output or (in training) an aux update reads, with the override's
ignored inputs on that path not counted as reads.  So a fold's original
conv (dead at inference) and a merged group's member convs (dead on both
paths) never run.  It runs whatever ``MXTPU_FUSED_KERNELS`` says (a plan
without overrides has no dead entry); the ``infer_trace`` name enables,
as in the JAX package, bind-time constant folding over the pruned
inference plan (:func:`fold_constants`).
"""
from __future__ import annotations

import heapq

import torch

from .base import MXNetError

__all__ = ["PlanView", "optimize_plan", "live_entries", "fold_constants",
           "pass_concat_fuse", "pass_pool_act", "pass_bn",
           "pass_eltwise_chain", "bn_sites", "bn_act_calls", "plan_report",
           "output_shapes",
           "dead_inputs", "PASSES",
           "MONOTONE_ACTS", "FUSABLE_ACTS"]

#: activation types the BatchNorm+activation fusion accepts
FUSABLE_ACTS = ("relu", "sigmoid", "tanh", "softrelu", "softsign")

#: monotone NON-DECREASING activations — exactly the set that commutes with
#: max pooling bit for bit (the pooled maximum is one of the inputs, and a
#: non-decreasing f keeps the argmax).  Every registered Activation type.
MONOTONE_ACTS = frozenset(FUSABLE_ACTS)


def _identity(data, *_rest, **_kw):
    """Passthrough override body: forward input 0."""
    return data


class PlanView(object):
    """Mutable match-and-rewrite view over one node plan.

    Passes query structure (consumers, outputs, claims) and record
    overrides; :meth:`apply` emits the rewritten plan (slot 5 is the only
    slot that changes).
    """

    def __init__(self, plan, out_refs):
        self.plan = plan
        self.entry_of = {id(e[0]): e for e in plan}
        self.consumers = {}      # (id(src), idx) -> [(consumer, pos)]
        for e in plan:
            node = e[0]
            if node.op is None:
                continue
            for pos, (src, idx) in enumerate(node.inputs):
                self.consumers.setdefault((id(src), idx), []) \
                    .append((node, pos))
        self.out_ids = {(nid, i) for nid, i in out_refs}
        self.overrides = {}      # id(node) -> (fn, extras, eval, train dead)
        #: passthroughs whose env value is NOT the node's true output;
        #: readers of these must all be overrides that know it
        self.wrong_valued = set()
        self.extra_targets = set()

    # -- queries -----------------------------------------------------------
    def users(self, node, idx=0):
        return self.consumers.get((id(node), idx), [])

    def is_output(self, node, idx=0):
        return (id(node), idx) in self.out_ids

    def claimed(self, node):
        return id(node) in self.overrides

    def sole_user(self, node, idx=0):
        """The one (consumer, pos) reading this output — or None when it
        has several readers or is a graph output."""
        if self.is_output(node, idx):
            return None
        users = self.users(node, idx)
        return users[0] if len(users) == 1 else None

    def locked(self, node):
        """Is this node pinned by an existing override's extra refs (so a
        pass must not turn it into a value-rewriting passthrough)?"""
        return id(node) in self.extra_targets

    # -- rewrites ----------------------------------------------------------
    def override(self, node, fn, extra_refs=(), eval_dead_ins=(),
                 train_dead_ins=()):
        if id(node) in self.overrides:
            raise MXNetError("mxfuse: node %r rewritten twice" % node.name)
        self.overrides[id(node)] = (fn, list(extra_refs),
                                    frozenset(eval_dead_ins),
                                    frozenset(train_dead_ins))
        self.extra_targets.update(id(src) for src, _ in extra_refs)

    def passthrough(self, node, value_preserving=False):
        """Mark ``node`` as absorbed: its entry becomes identity on input
        0.  ``value_preserving=True`` says the forwarded value IS the
        node's true output; otherwise every reader must be an override."""
        self.override(node, _identity, ())
        if not value_preserving:
            if id(node) in self.extra_targets:
                raise MXNetError(
                    "mxfuse: node %r is read by an override's extra refs "
                    "and cannot become a value-rewriting passthrough"
                    % node.name)
            self.wrong_valued.add(id(node))

    def apply(self):
        """The rewritten plan (the ORIGINAL list object when no pass
        matched).  Overrides may read values produced LATER in symbol
        order (a grouped merge reads every member's input), so the entries
        are re-sorted into a stable topological order of the post-override
        dependencies (:func:`_topo_sort`); each entry keeps its own RNG
        position (slot 4)."""
        if not self.overrides:
            return self.plan
        for _nid, override in self.overrides.items():
            for src, _idx in override[1]:
                if id(src) in self.wrong_valued:
                    raise MXNetError(
                        "mxfuse: override extra ref reads passthrough "
                        "node %r — its env value is not the node's "
                        "output" % src.name)
        for nid in self.wrong_valued:
            node = self.entry_of[nid][0]
            for i in range(self.entry_of[nid][2] or 1):
                for user, _pos in self.users(node, i):
                    if id(user) not in self.overrides:
                        raise MXNetError(
                            "mxfuse: plain node %r reads rewritten "
                            "passthrough %r" % (user.name, node.name))
        entries = [e if id(e[0]) not in self.overrides
                   else e[:5] + (self.overrides[id(e[0])],)
                   for e in self.plan]
        return _topo_sort(entries)


def _topo_sort(entries):
    """Stable topological re-sort of a rewritten plan: dependency = the
    node's own inputs plus its override's extra refs.  When the original
    order is already valid this returns it verbatim; a dependency cycle (a
    pass merged two mutually dependent stacks) raises."""
    index = {id(e[0]): i for i, e in enumerate(entries)}
    deps = [set() for _ in entries]
    rdeps = [[] for _ in entries]
    for i, e in enumerate(entries):
        node, override = e[0], e[5]
        refs = list(node.inputs or ())
        if override is not None:
            refs += list(override[1])
        for src, _idx in refs:
            j = index.get(id(src))
            if j is not None and j != i:
                deps[i].add(j)
    for i, dd in enumerate(deps):
        for j in dd:
            rdeps[j].append(i)
    ready = [i for i, dd in enumerate(deps) if not dd]
    heapq.heapify(ready)
    order = []
    remaining = [len(dd) for dd in deps]
    while ready:
        i = heapq.heappop(ready)
        order.append(i)
        for k in rdeps[i]:
            remaining[k] -= 1
            if remaining[k] == 0:
                heapq.heappush(ready, k)
    if len(order) != len(entries):
        raise MXNetError("mxfuse: rewritten plan has a dependency cycle — "
                         "a pass merged mutually dependent nodes")
    if order == list(range(len(entries))):
        return entries
    return [entries[i] for i in order]


# ---------------------------------------------------------------------------
# pass 1: concat_fuse — merge sibling conv→BN(→act) tower heads
# ---------------------------------------------------------------------------

def _conv_geometry(attrs):
    """The merge key: everything about a Convolution EXCEPT how many
    filters it has."""
    return tuple(sorted((k, tuple(v) if isinstance(v, (list, tuple))
                         else v)
                        for k, v in attrs.items() if k != "num_filter"))


def _bn_sig(attrs):
    return tuple(sorted((k, v) for k, v in attrs.items()
                        if k != "output_mean_var"))


def _collect_conv_bn_stacks(view):
    """Every unclaimed private conv→BN(→act) stack in the plan, as
    ``(conv, conv_entry, bn, bn_entry, act_node, act_type)``."""
    stacks = []
    for e in view.plan:
        conv = e[0]
        if conv.op is None or conv.op.name != "Convolution" \
                or e[2] != 1 or view.claimed(conv):
            continue
        conv_attrs = e[1] or {}
        if int(conv_attrs.get("num_group", 1)) != 1 \
                or "num_filter" not in conv_attrs:
            continue
        user = view.sole_user(conv)
        if user is None:
            continue
        bn, pos = user
        if bn.op is None or bn.op.name != "BatchNorm" or pos != 0 \
                or view.claimed(bn) or view.is_output(bn):
            continue
        bn_entry = view.entry_of[id(bn)]
        if bn_entry[2] != 1 or len(bn.inputs) != 5 \
                or len(bn_entry[3] or ()) != 2 \
                or None in (bn_entry[3] or ()):
            continue
        # an optional private Activation to bake into the merged body
        act_node, act_type = None, None
        act_user = view.sole_user(bn)
        if act_user is not None:
            u, upos = act_user
            if u.op is not None and u.op.name == "Activation" \
                    and upos == 0 and len(u.inputs) == 1 \
                    and not view.claimed(u):
                at = str((view.entry_of[id(u)][1] or {})
                         .get("act_type", "relu"))
                if at in FUSABLE_ACTS:
                    act_node, act_type = u, at
        stacks.append((conv, e, bn, bn_entry, act_node, act_type))
    return stacks


def _rewrite_group(view, members, grouped, do_fold):
    """Install the merged-body overrides for one sibling group.

    ``grouped=False``: every member shares ONE input — one wider conv.
    ``grouped=True``: inputs differ — channel-concatenate them and run a
    grouped conv (``num_group=len(members)``); needs equal ``num_filter``
    (the caller's group key) and equal input channels (checked by the
    override at run time, which falls back to the member's own math).
    """
    from .kernels import concat_fuse as CF
    acts = {m[5] for m in members}
    bake_act = acts.pop() if len(acts) == 1 else None
    widths = [int(m[1][1]["num_filter"]) for m in members]
    offsets = [0]
    for w in widths:
        offsets.append(offsets[-1] + w)
    has_bias = not bool(members[0][1][1].get("no_bias", False))
    if grouped:
        refs = [m[0].inputs[0] for m in members]
    else:
        refs = [members[0][0].inputs[0]]
    for conv, _e, bn, _bne, _a, _t in members:
        refs.extend(conv.inputs[1:])      # weight (+ bias)
        refs.extend(bn.inputs[1:])        # gamma, beta, mm, mv
    conv_attrs = dict(members[0][1][1])
    key = ("concat_fuse", id(members[0][2]))
    for ix, (conv, _e, bn, _bne, act_node, _t) in enumerate(members):
        fn = CF.make_group_member(
            ix, len(members), conv_attrs, bake_act, offsets,
            has_bias, do_fold, grouped=grouped, key=key)
        # the override consumes ONLY the extra refs, on both paths: the
        # original per-branch conv (input 0) and the per-member BN vectors
        # (inputs 1-4, re-read through extras) go dead
        dead = range(len(bn.inputs))
        view.override(bn, fn, refs, eval_dead_ins=dead, train_dead_ins=dead)
        if bake_act is not None and act_node is not None:
            # the forwarded value IS the true post-activation slice
            view.passthrough(act_node, value_preserving=True)


def _ancestors_of(start_refs):
    """Transitive producer set (node ids) above ``start_refs``."""
    out = set()
    stack = [src for src, _idx in start_refs]
    while stack:
        node = stack.pop()
        nid = id(node)
        if nid in out:
            continue
        out.add(nid)
        stack.extend(src for src, _idx in (node.inputs or ()))
    return out


def _closes_cycle(view, group):
    """Would merging this grouped group close a dependency cycle with the
    overrides already installed?  Each member's override reads every
    member's input, so two grouped merges whose towers feed each other
    (inception-v3's factorized 7x1/1x7 towers) can depend on each other
    although each group's members are independent.  The JAX package's
    independence check looks within one group only and raises at
    :func:`_topo_sort` for such a graph; the port skips the merge that
    would close the cycle and keeps the members unmerged."""
    new_refs = {id(m[2]): [m[0].inputs[0] for m in group] for m in group}
    deps = {}
    for e in view.plan:
        node = e[0]
        refs = list(node.inputs or ())
        override = view.overrides.get(id(node))
        if override is not None:
            refs += override[1]
        refs += new_refs.get(id(node), [])
        deps[id(node)] = {id(src) for src, _ in refs if id(src) != id(node)}
    state = {}      # id -> 1 on the stack, 2 done
    for root in deps:
        if root in state:
            continue
        stack = [(root, iter(deps[root]))]
        state[root] = 1
        while stack:
            nid, it = stack[-1]
            nxt = next(it, None)
            if nxt is None:
                state[nid] = 2
                stack.pop()
            elif nxt in deps and state.get(nxt) == 1:
                return True
            elif nxt in deps and nxt not in state:
                state[nxt] = 1
                stack.append((nxt, iter(deps[nxt])))
    return False


def pass_concat_fuse(view):
    """Merge sibling conv→BN(→act) tower heads (inception's parallel
    branches) so the card runs ONE wide convolution instead of N narrow
    ones.  Two shapes:

    - **shared input** (the 1x1 branch + reduce layers over one tensor):
      one conv over concatenated filters.
    - **sibling inputs** (parallel 3x3 convs over different tensors):
      channel-concatenate the inputs and merge as a GROUPED conv.  Members
      must be dependency-independent (one's input must not derive from
      another's output) — checked here, and a group whose merge would
      close a cycle with the groups merged before it is skipped
      (:func:`_closes_cycle`); :meth:`PlanView.apply` re-sorts.

    Each member's override slices its channel range of the group's merged
    body, which the first member reached computes once per forward
    (:mod:`.kernels.concat_fuse`).  Per-member aux updates are slices of
    the merged statistics.
    """
    from .kernels import fused_enabled
    do_fold = fused_enabled("bn_fold")
    stacks = _collect_conv_bn_stacks(view)

    # phase 1: shared-input groups (no width constraint)
    shared = {}
    for s in stacks:
        conv, e = s[0], s[1]
        src, idx = conv.inputs[0]
        key = ((id(src), idx), _conv_geometry(e[1]),
               _bn_sig(s[3][1] or {}),
               bool(e[1].get("no_bias", False)), s[5])
        shared.setdefault(key, []).append(s)
    merged_ids = set()
    for members in shared.values():
        if len(members) >= 2:
            _rewrite_group(view, members, grouped=False, do_fold=do_fold)
            merged_ids.update(id(m[0]) for m in members)

    # phase 2: equal-width sibling groups with DIFFERENT inputs -> grouped
    # conv (num_filter joins the key: grouped outputs split evenly)
    siblings = {}
    for s in stacks:
        if id(s[0]) in merged_ids:
            continue
        e = s[1]
        key = (_conv_geometry(e[1]), int(e[1]["num_filter"]),
               _bn_sig(s[3][1] or {}),
               bool(e[1].get("no_bias", False)), s[5])
        siblings.setdefault(key, []).append(s)
    for cands in siblings.values():
        if len(cands) < 2:
            continue
        # greedy independence partition: a member may not (transitively)
        # feed another member's input
        groups = []
        for s in cands:
            own = {id(s[0]), id(s[2])} | \
                ({id(s[4])} if s[4] is not None else set())
            anc = _ancestors_of([s[0].inputs[0]])
            placed = False
            for g in groups:
                if any(nid in anc for _s in g for nid in _s[6]) or \
                        any(nid in _s[7] for _s in g for nid in own):
                    continue
                g.append(s + (own, anc))
                placed = True
                break
            if not placed:
                groups.append([s + (own, anc)])
        for g in groups:
            if len(g) >= 2 and not _closes_cycle(view, g):
                _rewrite_group(view, [m[:6] for m in g], grouped=True,
                               do_fold=do_fold)


# ---------------------------------------------------------------------------
# pass 2: pool_act — act→max-pool reorder and pool→act collapse
# ---------------------------------------------------------------------------

def _tag(fn, kind):
    fn.pass_kind = kind
    return fn


def pass_pool_act(view):
    """Three shapes:

    - ``act → Pooling(max)``: reorder to pool-first.  Monotone
      non-decreasing activations commute with max bit for bit, and the
      activation then runs on the pooled (stride²-smaller) tensor.  Only
      under the default ``valid`` convention.
    - ``Pooling → act``: collapse to one entry at the act node.
    - every remaining Pooling entry routes through
      :func:`kernels.pool_act.pooling_opt` (same math; the shifted-slice
      form where its device's gate allows).
    """
    from .kernels import pool_act as PA
    for e in view.plan:
        node = e[0]
        if node.op is None or view.claimed(node):
            continue
        if node.op.name == "Activation" and e[2] == 1 \
                and len(node.inputs) == 1:
            act_type = str((e[1] or {}).get("act_type", "relu"))
            if act_type not in MONOTONE_ACTS:
                continue
            user = view.sole_user(node)
            if user is None:
                continue
            pool, pos = user
            if pool.op is None or pool.op.name != "Pooling" or pos != 0 \
                    or view.claimed(pool) or len(pool.inputs) != 1:
                continue
            pool_attrs = view.entry_of[id(pool)][1] or {}
            if str(pool_attrs.get("pool_type", "max")) != "max" \
                    or str(pool_attrs.get("pooling_convention",
                                          "valid")) != "valid" \
                    or view.locked(node):
                continue
            view.passthrough(node)
            view.override(pool, _tag(PA.make_act_then_maxpool(act_type),
                                     "reorder"))
        elif node.op.name == "Pooling" and e[2] == 1 \
                and len(node.inputs) == 1:
            user = view.sole_user(node)
            if user is None:
                continue
            act, pos = user
            if act.op is None or act.op.name != "Activation" \
                    or pos != 0 or view.claimed(act) \
                    or len(act.inputs) != 1 or view.locked(node):
                continue
            view.passthrough(node)
            view.override(act, _tag(PA.make_pool_then_act(dict(e[1] or {})),
                                    "collapse"))
    # remaining standalone Pooling entries: routed lowering only
    for e in view.plan:
        node = e[0]
        if node.op is None or node.op.name != "Pooling" \
                or e[2] != 1 or view.claimed(node) \
                or len(node.inputs) != 1:
            continue
        view.override(node, _tag(PA.make_pool_opt(), "routed"))


# ---------------------------------------------------------------------------
# pass 3: bn_act / bn_fold
# ---------------------------------------------------------------------------

def _make_fused_bn_fn(act_type, conv_attrs):
    """The override body for one fused BatchNorm site.

    Inference with a private Conv producer (``conv_attrs`` not None): BN
    folds into the conv weights (the original conv result arrives as None
    and its entry is not run).
    Otherwise: :func:`kernels.bn_act.fused_bn_act`, the CUDA kernel on a
    CUDA tensor.
    """
    def fused(data, gamma, beta, moving_mean, moving_var, *conv_ins,
              is_train=False, **bn_attrs):
        from .kernels import bn_act as _ba
        bn_attrs.pop("output_mean_var", None)   # fusion requires False
        if conv_ins and not is_train:
            cdata, w = conv_ins[0], conv_ins[1]
            cbias = conv_ins[2] if len(conv_ins) > 2 else None
            from .ops.nn import activation, convolution
            w2, b2 = _ba.fold_bn_into_conv(
                w, cbias, gamma, beta, moving_mean, moving_var,
                eps=bn_attrs.get("eps", 0.001),
                fix_gamma=bn_attrs.get("fix_gamma", True))
            out = convolution(cdata, w2, b2,
                              **{k: v for k, v in conv_attrs.items()
                                 if k != "no_bias"})
            if act_type:
                out = activation(out, act_type=act_type)
            return out, moving_mean, moving_var
        return _ba.fused_bn_act(data, gamma, beta, moving_mean,
                                moving_var, act_type=act_type,
                                is_train=is_train, **bn_attrs)
    fused.folds_conv = conv_attrs is not None
    return fused


def pass_bn(view):
    """The BatchNorm fusions (``bn_act``/``bn_fold``):

    - a BatchNorm whose single consumer is an Activation gets the fused
      one-pass kernel; the Activation entry becomes a passthrough.
    - a BatchNorm whose data producer is a private Convolution
      additionally folds into the conv weights on the inference path.
    """
    from .kernels import fused_enabled
    do_act = fused_enabled("bn_act")
    do_fold = fused_enabled("bn_fold")
    for e in view.plan:
        node, n_out = e[0], e[2]
        if node.op is None or node.op.name != "BatchNorm" \
                or n_out != 1 or view.claimed(node):
            continue
        act_node, act_type = None, None
        if do_act:
            user = view.sole_user(node)
            if user is not None:
                u, pos = user
                if u.op is not None and u.op.name == "Activation" \
                        and pos == 0 and len(u.inputs) == 1 \
                        and not view.claimed(u):
                    at = str((view.entry_of[id(u)][1] or {})
                             .get("act_type", "relu"))
                    if at in FUSABLE_ACTS:
                        act_node, act_type = u, at
        conv_node = None
        if do_fold and node.inputs:
            src, idx = node.inputs[0]
            if src.op is not None and src.op.name == "Convolution" \
                    and idx == 0 and not view.claimed(src) \
                    and view.sole_user(src) is not None:
                conv_node = src
        if act_node is None and conv_node is None:
            continue
        conv_attrs = dict(view.entry_of[id(conv_node)][1]) if conv_node \
            else None
        extra = list(conv_node.inputs) if conv_node is not None else []
        view.override(node, _make_fused_bn_fn(act_type, conv_attrs), extra,
                      eval_dead_ins=(0,) if conv_node is not None else ())
        if act_node is not None:
            # the BN override bakes the activation in, so the act entry
            # forwards the TRUE post-activation value
            view.passthrough(act_node, value_preserving=True)


# ---------------------------------------------------------------------------
# pass 4: eltwise_chain — collapse private elementwise runs
# ---------------------------------------------------------------------------

def pass_eltwise_chain(view):
    """Maximal runs of ≥2 private elementwise ops (the catalog in
    :data:`kernels.eltwise_chain.ELTWISE_OPS`) linked through input 0
    collapse into ONE override at the chain tail; intermediates become
    passthroughs.  Side inputs (the other operand of a binary op) ride as
    extra refs.  The composed function applies the same op sequence, so
    values and gradients are the plain plan's."""
    from .kernels import eltwise_chain as EC

    def chainable(node):
        if node.op is None or node.op.name not in EC.ELTWISE_OPS:
            return False
        e = view.entry_of[id(node)]
        if e[2] != 1 or e[3]:
            return False
        op = node.op
        return not (op.needs_rng or op.needs_is_train
                    or getattr(op, "no_jit", False)) \
            and not view.claimed(node) and not view.locked(node)

    in_chain = set()
    for e in view.plan:
        head = e[0]
        if id(head) in in_chain or not chainable(head):
            continue
        # only start at a true head: the producer of input 0 must not
        # itself extend the chain backwards
        src0 = head.inputs[0][0] if head.inputs else None
        if src0 is not None and chainable(src0) \
                and id(src0) not in in_chain \
                and view.sole_user(src0) == (head, 0):
            continue
        chain = [head]
        while True:
            user = view.sole_user(chain[-1])
            if user is None:
                break
            nxt, pos = user
            if pos != 0 or not chainable(nxt) or id(nxt) in in_chain:
                break
            chain.append(nxt)
        if len(chain) < 2:
            continue
        in_chain.update(id(n) for n in chain)
        stages = []
        extra_refs = []
        for n in chain:
            ne = view.entry_of[id(n)]
            stages.append((n.op.fn, dict(ne[1] or {}),
                           len(n.inputs) - 1))
            if n is not chain[-1]:
                extra_refs.extend(n.inputs[1:])
        view.override(chain[-1], EC.make_chain_fn(stages), extra_refs)
        for n in chain[:-1]:
            view.passthrough(n)


#: the pipeline, in priority order; each entry is (enabling kernel names,
#: pass fn) — a pass runs when ANY of its names is enabled
PASSES = (
    (frozenset(("concat_fuse",)), pass_concat_fuse),
    (frozenset(("pool_act",)), pass_pool_act),
    (frozenset(("bn_act", "bn_fold")), pass_bn),
    (frozenset(("eltwise_chain",)), pass_eltwise_chain),
)


def optimize_plan(plan, out_refs):
    """Run every enabled pass over ``plan`` and return the rewritten plan
    — or ``plan`` itself (same object) when nothing matched or nothing
    is enabled."""
    from .kernels import enabled_kernels
    enabled = enabled_kernels()
    active = [fn for names, fn in PASSES if names & enabled]
    if not active:
        return plan
    view = PlanView(plan, out_refs)
    for fn in active:
        fn(view)
    return view.apply()


# ---------------------------------------------------------------------------
# liveness (the port's stand-in for XLA's dead-code elimination) and
# infer_trace's constant folding
# ---------------------------------------------------------------------------

def dead_inputs(override, is_train):
    """Input positions ``override`` ignores on the given path."""
    if override is None:
        return frozenset()
    slot = 3 if is_train else 2
    return override[slot] if len(override) > slot else frozenset()


def live_entries(plan, out_refs, is_train=False):
    """The subset of ``plan`` whose values the outputs need on one path:
    reached from the graph outputs (and, in training, from every entry
    that updates an aux state, whose update the executor writes back)
    through node inputs — minus the override's dead inputs on that path —
    and override extra refs.  Entries keep their order and contents; the
    dead ones are simply not interpreted.  This replaces XLA's dead-code
    elimination, which the JAX package's jitted programs get for free:
    without it the eager port would run, for instance, the original conv
    of every ``bn_fold`` site at inference and every merged
    ``concat_fuse`` member's own conv on both paths."""
    entry_of = {id(e[0]): e for e in plan}
    live = set()
    stack = [nid for nid, _i in out_refs]
    if is_train:
        stack += [id(e[0]) for e in plan
                  if e[3] and any(n is not None for n in e[3])]
    while stack:
        nid = stack.pop()
        if nid in live or nid not in entry_of:
            continue
        live.add(nid)
        node, override = entry_of[nid][0], entry_of[nid][5]
        dead = dead_inputs(override, is_train)
        for pos, (src, _idx) in enumerate(node.inputs or ()):
            if pos not in dead:
                stack.append(id(src))
        if override is not None:
            for src, _idx in override[1]:
                stack.append(id(src))
    return [e for e in plan if id(e[0]) in live]


def fold_constants(entries, device=None):
    """Bind-time constant folding over an (already pruned) entry list:
    deterministic ops whose transitive inputs are all themselves foldable
    — seeded by zero-input generator ops, created on ``device`` — are
    evaluated ONCE here and served from a constant env.  Returns
    ``(const_env, remaining)``.  Ops with RNG, train-mode branches, aux
    updates or overrides never fold."""
    from .ops.registry import fn_signature_info
    const_env = {}
    remaining = []
    for e in entries:
        node, call_attrs, n_out, aux_names, _rng_ix, override = e
        op = node.op
        if op is None or override is not None or aux_names \
                or op.needs_rng or op.needs_is_train \
                or getattr(op, "no_jit", False):
            remaining.append(e)
            continue
        if node.inputs and not all(id(src) in const_env
                                   for src, _ in node.inputs):
            remaining.append(e)
            continue
        if not node.inputs and not getattr(op, "variable_inputs", False) \
                and len(op.get_input_names(call_attrs or {})) > 0:
            # an op that EXPECTS inputs but the node has none recorded —
            # malformed; leave it to fail loudly at run time
            remaining.append(e)
            continue
        attrs = dict(call_attrs or {})
        if not node.inputs and device is not None \
                and "ctx" in fn_signature_info(op.fn)[0]:
            attrs["ctx"] = device
        try:
            ins = [const_env[id(src)][idx] for src, idx in node.inputs]
            with torch.no_grad():
                out = op.fn(*ins, **attrs)
        except Exception:  # noqa: BLE001 — fold is best-effort
            remaining.append(e)
            continue
        if not isinstance(out, (tuple, list)):
            out = (out,)
        const_env[id(node)] = tuple(out[:n_out])
    return const_env, remaining


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

def bn_sites(plan):
    """Where the BatchNorm entries of a rewritten plan go:
    ``{"bn_act": [nodes], "bn_fold": [nodes], "concat": [[nodes], ...]}``.
    ``bn_act`` entries call :func:`kernels.bn_act.fused_bn_act` on both
    paths; ``bn_fold`` entries fold into their conv at inference and call
    it in training; each ``concat`` list is one merged ``concat_fuse``
    group's member BatchNorms, whose merged body calls it once per
    training forward (and at inference when ``bn_fold`` is off)."""
    sites = {"bn_act": [], "bn_fold": [], "concat": []}
    groups = {}
    for e in plan:
        override = e[5]
        if e[0].op is None or e[0].op.name != "BatchNorm" or override is None:
            continue
        fn = override[0]
        key = getattr(fn, "group", None)
        if key is not None:
            if key not in groups:
                groups[key] = []
                sites["concat"].append(groups[key])
            groups[key].append(e[0])
        else:
            sites["bn_fold" if fn.folds_conv else "bn_act"].append(e[0])
    return sites


def output_shapes(symbol, **data_shapes):
    """``(id(node), idx) -> shape`` of every node output of ``symbol``
    for the given input shapes (for :func:`plan_report`)."""
    internals = symbol.get_internals()
    _, out_shapes, _ = internals.infer_shape(**data_shapes)
    return {(id(n), i): tuple(s) for (n, i), s in
            zip(internals._outputs, out_shapes)}


def _input_ref(node, pos=0):
    src, idx = node.inputs[pos]
    return (id(src), idx)


def _group_shapes(fn, members, shapes):
    """The data shapes one merged group's body hands ``fused_bn_act`` per
    forward: the merged conv's output (one call), or each member's conv
    output where a grouped merge is shape-ineligible (its members' input
    channel counts differ) and the members run their own math."""
    outs = [shapes[_input_ref(bn)] for bn in members]
    if fn.grouped and len({shapes[_input_ref(bn.inputs[0][0])][1]
                           for bn in members}) > 1:
        return outs
    return [outs[0][:1] + (sum(o[1] for o in outs),) + outs[0][2:]]


def _override_fn(plan, node):
    return next(e[5][0] for e in plan if e[0] is node)


def bn_act_calls(plan, shapes, is_train):
    """The data shape of every ``fused_bn_act`` call one forward of the
    rewritten plan makes on one path — one ``bn_act`` kernel launch each
    on the card for the kernel's activations (none, relu, sigmoid, tanh).
    ``shapes`` is :func:`output_shapes`' map."""
    sites = bn_sites(plan)
    calls = [shapes[_input_ref(n)] for n in sites["bn_act"]]
    if is_train:
        calls += [shapes[_input_ref(n)] for n in sites["bn_fold"]]
    for members in sites["concat"]:
        fn = _override_fn(plan, members[0])
        if is_train or not fn.folds_conv:
            calls += _group_shapes(fn, members, shapes)
    return calls


def plan_report(plan, out_refs, shapes=None):
    """Counts of what the passes and liveness did to one rewritten plan:
    merged groups (and how many of them grouped convs) and their members,
    pool rewrites by kind, BN sites by kind, chains and the ops they hold,
    the entries liveness drops on each path, and per forward on each path
    the convolutions run (``conv_calls_*``: live Convolution entries, one
    per fold site at inference, one per merged group; ``concat_merged``
    groups run a merged body) and, given
    ``shapes`` (:func:`output_shapes`), the ``fused_bn_act`` calls
    (``bn_act_calls_*``, :func:`bn_act_calls`).  ``shapes`` also tells
    which grouped merges are shape-eligible; one that is not runs its
    members' own math, a convolution each.  Without ``shapes`` every
    merge counts as eligible."""
    sites = bn_sites(plan)
    kinds = {}
    chains, chain_ops = 0, 0
    grouped = set()
    for e in plan:
        override = e[5]
        if override is None:
            continue
        fn = override[0]
        if getattr(fn, "pass_kind", None):
            kinds[fn.pass_kind] = kinds.get(fn.pass_kind, 0) + 1
        if getattr(fn, "n_stages", None):
            chains += 1
            chain_ops += fn.n_stages
        if getattr(fn, "grouped", False):
            grouped.add(fn.group)
    group_convs, merged = 0, 0
    for members in sites["concat"]:
        n = 1 if shapes is None else len(_group_shapes(
            _override_fn(plan, members[0]), members, shapes))
        group_convs += n
        merged += n == 1
    infer = live_entries(plan, out_refs)
    train = live_entries(plan, out_refs, is_train=True)
    report = {
        "entries": len(plan),
        "concat_groups": len(sites["concat"]),
        "concat_grouped": len(grouped),
        "concat_merged": merged,
        "concat_members": sum(len(g) for g in sites["concat"]),
        "pool_reorder": kinds.get("reorder", 0),
        "pool_collapse": kinds.get("collapse", 0),
        "pool_routed": kinds.get("routed", 0),
        "bn_act": len(sites["bn_act"]),
        "bn_fold": len(sites["bn_fold"]),
        "chains": chains,
        "chain_ops": chain_ops,
        "convs": _op_count(plan, "Convolution"),
        "dropped_infer": len(plan) - len(infer),
        "dropped_train": len(plan) - len(train),
        "conv_calls_infer": _op_count(infer, "Convolution")
        + len(sites["bn_fold"]) + group_convs,
        "conv_calls_train": _op_count(train, "Convolution") + group_convs,
    }
    if shapes is not None:
        report["bn_act_calls_infer"] = len(bn_act_calls(plan, shapes, False))
        report["bn_act_calls_train"] = len(bn_act_calls(plan, shapes, True))
    return report


def _op_count(entries, name):
    return sum(1 for e in entries if e[0].op is not None
               and e[0].op.name == name)
