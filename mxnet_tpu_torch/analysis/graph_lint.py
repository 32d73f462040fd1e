"""Level-1 static analysis: lint one step's dispatched work (port of
``mxnet_tpu/analysis/graph_lint.py``).

The JAX package lints the artifacts of one jitted step: its jaxpr, the
lowering's donation metadata and the compiled HLO module.  The port runs
its step eagerly, so the artifact here is a **record of one step's
dispatched work**: every ATen op the step dispatches (a
``TorchDispatchMode``, which also sees the backward on autograd's
threads), every hand-written kernel launch (the launch wrappers report
them: ``kernels.note_launch``), and the storage of the step's carries
before and after it.  The rule ids are the JAX package's:

- ``graph-callback``: a host sync inside the step window — a scalar read
  (``aten::_local_scalar_dense``: ``.item()``, ``float()``, ``bool()`` on
  a tensor), ``aten::is_nonzero``, or a copy from the device to the CPU.
  Each one stalls the host until the device drains, every step.  A
  collective's own transport copies (gloo's staging of CUDA tensors
  through host memory, a cross-rank exchange's header read:
  ``distributed.transport_scope``) are counted apart, in
  ``stats["transport_syncs"]``.
- ``graph-donation-missing``: a carry (params, aux, optimizer state, the
  guard counters, the metric accumulators) whose value after the step
  lives in other storage than before it — the step allocated a fresh
  buffer and dropped the old one, the port's counterpart of an
  un-donated XLA argument: two copies live at once, an extra allocation
  every step.  ``min_donate_bytes`` filters small carries.
- ``graph-donation-unused``: the step wrote in place into an input that
  is not a carry (a batch tensor the caller still holds).
- ``graph-dtype-drift``: a matmul/conv op (``mm``, ``bmm``, ``addmm``,
  ``convolution`` and its backward, ``linear``) whose inputs are wider
  floats than the declared ``compute_dtype``.
- ``graph-pallas-no-vjp``: a hand-written kernel launched while grad mode
  is on with an input that requires grad — outside a
  ``torch.autograd.Function`` (whose ``forward`` runs with grad mode
  off), so autograd has no backward for it.
- ``graph-collective-allgather``: all-gather traffic (``c10d`` ops in the
  record, and the collectives of a mesh of positions, inside one
  process or across ranks, which report to
  ``parallel.collectives.COLLECTIVE_HOOKS``: one position's bytes a
  collective, forward and backward; a rank-spanning collective's
  exchange is also in the record as the ``all_gather`` it dispatches)
  in a step that declared
  replicated parameters; ``stats["collectives"]`` carries ``{count,
  bytes}`` for every kind, 0 on one device.
- ``graph-collective-schedule``: under a declared zero3 schedule the
  recorded step must really be sharded: its all-gathers move the
  sharded params' bytes (once in the forward, again where the backward
  re-gathers), its gradients leave as reduce-scatters (one a group), and
  no param-scale all-reduce appears.
- ``plan-fusion-parity``: :func:`audit_plan_fusion` runs the port's plan
  optimizer (``mxfuse.optimize_plan``, ``live_entries``) over a symbol's
  node plan with the JAX package's four checks.

All torch imports are function-local so importing this module costs
nothing in host-only contexts (the AST level and the CLI).
"""
from __future__ import annotations

import os

from .report import Finding, Report

__all__ = ["StepRecord", "record_step", "find_callbacks", "audit_dtype",
           "audit_donation", "find_unprotected_kernels", "collective_stats",
           "audit_collectives", "audit_collective_schedule",
           "audit_plan_fusion", "lint_record", "lint_step",
           "SYNC_OPS", "COMPUTE_OPS", "COLLECTIVE_OPS"]

#: ATen ops that read a device value on the host (the step waits)
SYNC_OPS = frozenset(("_local_scalar_dense", "is_nonzero"))

#: ATen ops whose input dtype decides the matmul/conv arithmetic
COMPUTE_OPS = frozenset(("mm", "bmm", "addmm", "baddbmm", "linear",
                         "convolution", "convolution_backward"))

#: the JAX package's collective kinds (the HLO instruction names)
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

#: c10d op-name fragments -> collective kind
_C10D_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
               ("reduce_scatter", "reduce-scatter"),
               ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
               ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
               ("send", "collective-permute"),
               ("recv", "collective-permute"))

_C10D_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

_WIDER_THAN = {
    "bfloat16": ("float32", "float64"),
    "float16": ("float32", "float64"),
    "float32": ("float64",),
}

def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def _user_frame():
    """(file, line) of the innermost frame outside torch and this module:
    the code that dispatched a flagged op (diagnostics only)."""
    import traceback
    here = os.path.abspath(__file__)
    for frame in reversed(traceback.extract_stack()):
        f = os.path.abspath(frame.filename)
        if f == here or os.sep + "torch" + os.sep in f:
            continue
        return frame.filename, frame.lineno
    return None, None


class StepRecord(object):
    """What one step dispatched: ``ops`` (``[(op, [input dtypes])]`` for
    the compute ops), ``syncs`` (``[(what, file, line)]``), ``launches``
    (``[(kernel, grad_enabled, requires_grad)]``), ``collectives``
    (``{kind: {count, bytes}}``), ``by_axis`` (the same tally a tuple of
    mesh axes, for the collectives of a mesh inside one process),
    ``n_ops`` (every dispatched op), the step's ``result``, and the
    carries' and inputs' storage before and after (``donation``)."""

    def __init__(self):
        self.ops = []
        self.syncs = []
        self.transport_syncs = []
        self.launches = []
        self.collectives = _tally()
        self.by_axis = {}
        self.n_ops = 0
        self.result = None
        self.donation = []
        self.written_inputs = []


def _tally():
    return {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_OPS}


def _flatten(obj, path=""):
    """``[(path, tensor)]`` over nested dicts/tuples/lists of tensors, with
    ``keystr``-like paths (``['params']['fc1_weight']``, ``[0]``); a
    value laid over a mesh (``collectives.Sharded``) gives its local
    positions' parts (another rank's hold None)."""
    import torch
    if isinstance(obj, torch.Tensor):
        return [(path, obj)]
    out = []
    parts = getattr(obj, "parts", None)
    if isinstance(parts, list):
        for i, v in enumerate(parts):
            out += _flatten(v, "%s.parts[%d]" % (path, i))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            out += _flatten(v, "%s[%r]" % (path, k))
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            out += _flatten(v, "%s[%d]" % (path, i))
    return out


def _storage(t):
    return (t.device, t.untyped_storage().data_ptr(), t.data_ptr())


def _nbytes(t):
    return t.numel() * t.element_size()


def _make_mode(rec):
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from ..distributed import in_transport

    cpu = torch.device("cpu")

    def tensors(xs):
        for x in xs:
            if isinstance(x, torch.Tensor):
                yield x
            elif isinstance(x, (tuple, list)):
                yield from tensors(x)

    class _Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            rec.n_ops += 1
            ns = func.namespace
            name = func._schema.name.split("::")[-1]
            if ns == "aten":
                if name in SYNC_OPS:
                    rec.syncs.append((name,) + _user_frame())
                elif name in ("_to_copy", "copy_", "to"):
                    ins = list(tensors(args[:1] if name != "copy_"
                                       else args[1:2]))
                    dst = list(tensors([out]))
                    if ins and dst and ins[0].device != cpu and \
                            dst[0].device == cpu:
                        what = ("copy %s->cpu" % ins[0].device,) + \
                            _user_frame()
                        if in_transport():
                            rec.transport_syncs.append(what)
                        else:
                            rec.syncs.append(what)
                elif name in COMPUTE_OPS:
                    rec.ops.append((name, sorted({
                        _dtype_name(t.dtype) for t in tensors(args)
                        if t.is_floating_point()})))
            elif ns in _C10D_NAMESPACES:
                kind = next((k for frag, k in _C10D_KINDS if frag in name),
                            None)
                if kind is not None:
                    slot = rec.collectives[kind]
                    slot["count"] += 1
                    slot["bytes"] += sum(_nbytes(t) for t in tensors([out]))
            return out

    return _Recorder()


def record_step(fn, *args, carries=None, inputs=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the recorder and return its
    :class:`StepRecord`.

    ``carries``: the step's carries — a mapping re-read after the step (a
    step that rebinds an entry is seen), or a callable returning the
    current carries; nested dicts/tuples of tensors.  ``inputs``: the
    non-carry tensors the caller holds (default: the tensors in
    ``args``); the step must not write into them."""
    import torch
    from .. import kernels
    from ..parallel import collectives

    rec = StepRecord()

    def read():
        if carries is None:
            return {}
        return carries() if callable(carries) else carries

    before = [(p, t, _storage(t)) for p, t in _flatten(read())]
    carry_ptrs = {s[1] for _, _, s in before}
    held = _flatten(list(args) if inputs is None else inputs)
    held = [(p, t, t._version) for p, t in held
            if _storage(t)[1] not in carry_ptrs]

    def hook(name, grad_enabled, requires_grad):
        rec.launches.append((name, grad_enabled, requires_grad))

    def on_collective(kind, nbytes, axes):
        for slots in (rec.collectives,
                      rec.by_axis.setdefault(axes, _tally())):
            slots[kind]["count"] += 1
            slots[kind]["bytes"] += nbytes

    kernels.LAUNCH_HOOKS.append(hook)
    collectives.COLLECTIVE_HOOKS.append(on_collective)
    try:
        with _make_mode(rec):
            rec.result = fn(*args, **kwargs)
        for t in _flatten(rec.result):
            if t[1].is_cuda:
                torch.cuda.synchronize(t[1].device)
                break
    finally:
        kernels.LAUNCH_HOOKS.remove(hook)
        collectives.COLLECTIVE_HOOKS.remove(on_collective)
    after = dict((p, t) for p, t in _flatten(read()))
    for path, t, storage in before:
        now = after.get(path)
        rec.donation.append((path, t, storage,
                             None if now is None else _storage(now)))
    rec.written_inputs = [(p, t) for p, t, v in held if t._version != v]
    return rec


def find_callbacks(rec):
    """``graph-callback`` findings for every host sync in the record."""
    out = []
    for what, fname, line in rec.syncs:
        out.append(Finding(
            "graph-callback",
            "host sync %r inside the step — the host waits for the "
            "device every step (move it out of the step or behind a "
            "deferred metric/guard carry)" % what,
            file=fname, line=line))
    return out


def find_unprotected_kernels(rec):
    """``graph-pallas-no-vjp``: a hand-written kernel launched with grad
    mode on and an input that requires grad — not inside a
    ``torch.autograd.Function`` (its ``forward`` runs with grad mode off),
    so autograd records nothing for it and the step's gradients silently
    stop at the kernel.  Pair the launch with a backward kernel in an
    ``autograd.Function`` (``rtc.register_kernel(vjp=...)``, the
    ``kernels/`` pattern)."""
    out = []
    for name, grad_enabled, requires_grad in rec.launches:
        if grad_enabled and requires_grad:
            out.append(Finding(
                "graph-pallas-no-vjp",
                "kernel %r launched on an input that requires grad "
                "outside a torch.autograd.Function — autograd has no "
                "backward for it, so differentiation silently stops "
                "there; pair the forward kernel with a backward kernel "
                "in an autograd.Function (rtc.register_kernel(vjp=...), "
                "kernels/ pattern)" % name))
    return out


def audit_dtype(rec, compute_dtype):
    """``graph-dtype-drift``: compute ops whose inputs are wider floats
    than the declared compute dtype.  Returns (findings, tally) where
    tally maps op name -> {dtype_name: count} for reporting."""
    tally = {}
    offenders = []
    name = _dtype_name(compute_dtype) if compute_dtype is not None else None
    wider = _WIDER_THAN.get(name, ()) if name else ()
    for op, in_dtypes in rec.ops:
        slot = tally.setdefault(op, {})
        for d in in_dtypes:
            slot[d] = slot.get(d, 0) + 1
        if wider and any(d in wider for d in in_dtypes):
            offenders.append((op, in_dtypes))
    findings = []
    if offenders:
        findings.append(Finding(
            "graph-dtype-drift",
            "%d matmul/conv op(s) compute in %s inside a "
            "compute_dtype=%s step (first: %s) — a widening cast "
            "upstream is defeating the mixed-precision path"
            % (len(offenders),
               "/".join(sorted({d for _, ds in offenders
                                for d in ds if d in wider})),
               name, offenders[0][0]),
            data={"offending_eqns": len(offenders)}))
    return findings, tally


def audit_donation(rec, min_bytes=1 << 20):
    """Donation findings from the record's storage comparison: a carry at
    or above ``min_bytes`` whose value after the step lives in other
    storage (``graph-donation-missing``), and an input the caller holds
    that the step wrote in place (``graph-donation-unused``)."""
    findings = []
    for path, t, before, after in rec.donation:
        nbytes = _nbytes(t)
        if nbytes < min_bytes or after == before:
            continue
        findings.append(Finding(
            "graph-donation-missing",
            "carry %s (%s%s, %d bytes) %s — the step allocates a new "
            "buffer every step and holds two copies live; write the new "
            "value into the carry's storage (copy_)"
            % (path, _dtype_name(t.dtype), list(t.shape), nbytes,
               "was dropped by the step" if after is None else
               "lives in new storage after the step")))
    for path, t in rec.written_inputs:
        findings.append(Finding(
            "graph-donation-unused",
            "input %s (%s%s, %d bytes) is not a carry but the step wrote "
            "into it in place — the caller's tensor changed under it"
            % (path or "[0]", _dtype_name(t.dtype), list(t.shape),
               _nbytes(t))))
    return findings


def collective_stats(rec, axes=None):
    """``{kind: {"count": n, "bytes": b}}`` for every collective kind
    (zeros included): the c10d ops the step dispatched, bytes summed over
    their outputs, and an in-process mesh's collectives; with ``axes``
    (a tuple of mesh axes), only the in-process collectives over those
    axes."""
    tally = rec.collectives if axes is None else \
        rec.by_axis.get(tuple(axes), _tally())
    return {k: dict(v) for k, v in tally.items()}


def audit_collectives(stats, param_bytes=None, expect_allgather=False,
                      allgather_fraction=0.5):
    """``graph-collective-allgather``: all-gather traffic in a step that
    declared replicated parameters.  With ``param_bytes`` given, only
    traffic >= ``allgather_fraction`` of it flags; without it, any
    all-gather flags."""
    if expect_allgather:
        return []
    ag = stats.get("all-gather", {"count": 0, "bytes": 0})
    if not ag["count"]:
        return []
    if param_bytes and ag["bytes"] < allgather_fraction * param_bytes:
        return []
    detail = "%d all-gather(s), %d bytes/step" % (ag["count"], ag["bytes"])
    if param_bytes:
        detail += " (params total %d bytes)" % param_bytes
    return [Finding(
        "graph-collective-allgather",
        "unexpected all-gather under a sharding that declares replicated "
        "parameters: %s — a full-parameter regather erases the point of "
        "dp sharding" % detail,
        data={"all_gather": ag, "param_bytes": param_bytes})]


def audit_collective_schedule(stats, schedule, expect_gather_bytes=None,
                              tolerance=0.25, platform=None,
                              expect_groups=None, allreduce_bytes=0):
    """``graph-collective-schedule``: under a DECLARED fully-sharded
    strategy the recorded step must actually be sharded (the JAX
    package's rule, read from the dispatch record: the
    ``_c10d_functional`` ops across processes, the data axis's
    collectives on a mesh inside one process).

    ``schedule`` is ``'zero3-manual'`` or ``'zero3-gspmd'`` (None
    disables the rule; both tiers of the port write the gradients'
    reduce-scatter explicitly, so both owe one on every platform);
    ``expect_gather_bytes`` is the full compute-dtype bytes of every
    dp-sharded parameter (the trainer computes it from base rules and
    shapes); ``expect_groups`` the gather groups; ``allreduce_bytes``
    the gradient bytes the declared plan all-reduces by design (params
    that explicit rules or indivisible shapes keep out of the dp shards,
    from the same base rules).  The forward gathers every group once and
    the backward re-gathers the groups whose values it saved, so
    checks:

    - all-gather bytes within ``tolerance`` of one to two times the
      expected bytes — less means params were left replicated (the
      sharding never happened), more means gathers beyond the schedule;
    - with ``expect_groups``: between one and two all-gathers a group,
      and one reduce-scatter a group;
    - no stray full all-reduce: all-reduce bytes beyond
      ``allreduce_bytes`` at or above half the expected gather bytes
      mean gradients left the backward as a full all-reduce instead of
      reduce-scatter;
    - at least one reduce-scatter.
    """
    if not schedule:
        return []
    findings = []
    ag = stats.get("all-gather", {"count": 0, "bytes": 0})
    rs = stats.get("reduce-scatter", {"count": 0, "bytes": 0})
    ar = stats.get("all-reduce", {"count": 0, "bytes": 0})
    expect = int(expect_gather_bytes or 0)
    owes_rs = schedule in ("zero3-manual", "zero3-gspmd")
    if expect and ag["bytes"] < (1.0 - tolerance) * expect:
        findings.append(Finding(
            "graph-collective-schedule",
            "declared %s but the recorded step all-gathers only %d "
            "bytes/step of the >= %d expected for its sharded "
            "parameters — the params were left replicated; the sharding "
            "silently never happened" % (schedule, ag["bytes"], expect),
            data={"all_gather": ag, "expect_gather_bytes": expect}))
    if expect and ag["bytes"] > (2.0 + tolerance) * expect:
        findings.append(Finding(
            "graph-collective-schedule",
            "declared %s but the recorded step all-gathers %d bytes/step, "
            "more than a forward gather and a backward re-gather of the "
            "%d sharded bytes" % (schedule, ag["bytes"], expect),
            data={"all_gather": ag, "expect_gather_bytes": expect}))
    if expect_groups:
        if not expect_groups <= ag["count"] <= 2 * expect_groups:
            findings.append(Finding(
                "graph-collective-schedule",
                "declared %s over %d gather groups but the recorded step "
                "issued %d all-gathers (one a group in the forward, at "
                "most one more in the backward)"
                % (schedule, expect_groups, ag["count"]),
                data={"all_gather": ag, "groups": expect_groups}))
        if owes_rs and rs["count"] and rs["count"] != expect_groups:
            findings.append(Finding(
                "graph-collective-schedule",
                "declared %s over %d gather groups but the gradients left "
                "in %d reduce-scatters (one a group)"
                % (schedule, expect_groups, rs["count"]),
                data={"reduce_scatter": rs, "groups": expect_groups}))
    if expect and ar["bytes"] - int(allreduce_bytes or 0) >= 0.5 * expect \
            and owes_rs:
        findings.append(Finding(
            "graph-collective-schedule",
            "declared %s but a param-scale all-reduce (%d bytes/step) is "
            "in the recorded schedule — gradients are leaving the "
            "backward as a full all-reduce instead of reduce-scatter"
            % (schedule, ar["bytes"]),
            data={"all_reduce": ar, "expect_gather_bytes": expect,
                  "platform": platform}))
    if owes_rs and expect and not rs["count"]:
        findings.append(Finding(
            "graph-collective-schedule",
            "declared %s but the recorded step contains no reduce-scatter "
            "— the manual tier emits one per gather group by "
            "construction, so the step was not built from the declared "
            "formulation" % schedule,
            data={"reduce_scatter": rs, "platform": platform}))
    return findings


def audit_plan_fusion(symbol):
    """The ``plan-fusion-parity`` rule: run the port's mxfuse pipeline
    over ``symbol``'s node plan (under the CURRENT
    ``MXTPU_FUSED_KERNELS``) and verify every override kept the
    plain-plan monitored contract — the JAX package's four checks:

    1. the pipeline neither raises nor mutates the plain plan — the
       monitored path interprets that exact object;
    2. the rewritten plan is a PERMUTATION of the plain entries (none
       added or dropped) with identical slots 0-4, in an order that is
       topologically valid for the post-override dependency graph;
    3. every override is ``(callable, [(plan-node, int)], ...)`` whose
       extra refs name nodes of the plan;
    4. pruning (``live_entries``) keeps every graph output and every
       extra-ref producer interpretable.

    Returns a :class:`Report`; violations are rule
    ``plan-fusion-parity``.
    """
    import copy

    from .. import mxfuse
    from ..executor import _node_plan

    rep = Report(tool="mxlint.graph")

    def flag(msg):
        rep.add("plan-fusion-parity", msg)

    plan = _node_plan(symbol)
    out_refs = [(id(n), i) for n, i in symbol._outputs]
    before = [(id(e[0]),) + tuple(copy.deepcopy(e[1:5])) for e in plan]
    try:
        fused = mxfuse.optimize_plan(plan, out_refs)
    except Exception as e:  # noqa: BLE001 — a broken pass IS the finding
        flag("pass pipeline raised %s: %s" % (type(e).__name__, e))
        return rep
    after = [(id(e[0]),) + tuple(e[1:5]) for e in plan]
    if before != after:
        flag("pass pipeline MUTATED the plain plan — monitored runs "
             "interpret that object verbatim")
    if fused is plan:
        rep.stats["plan_fusion"] = {"overrides": 0,
                                    "entries": len(plan)}
        return rep
    if len(fused) != len(plan):
        flag("rewritten plan has %d entries, plain plan %d — passes "
             "must never add or drop entries (per-node RNG fold "
             "constants travel with them)" % (len(fused), len(plan)))
        return rep
    plain_of = {id(e[0]): e for e in plan}
    if {id(e[0]) for e in fused} != set(plain_of):
        flag("rewritten plan is not a permutation of the plain "
             "entries — nodes were substituted")
        return rep
    n_overrides = 0
    seen = set()
    for fe in fused:
        pe = plain_of[id(fe[0])]
        if tuple(fe[1:5]) != tuple(pe[1:5]):
            flag("entry %r changed outside the override slot"
                 % fe[0].name)
        ov = fe[5]
        if ov is None:
            continue
        n_overrides += 1
        if not callable(ov[0]) or not isinstance(ov[1], (list, tuple)):
            flag("override at %r is not (callable, refs, ...)"
                 % fe[0].name)
            continue
        for ref in ov[1]:
            if id(ref[0]) not in plain_of:
                flag("override at %r references a node outside the "
                     "plan" % fe[0].name)
    # interpretation-order validity: an entry's op-node dependencies
    # (inputs + override extra refs) must already be interpreted when
    # it runs; variables bind lazily
    for fe in fused:
        node, ov = fe[0], fe[5]
        refs = list(node.inputs or ())
        if ov is not None:
            refs += list(ov[1])
        for src, _idx in refs:
            if id(src) in plain_of and src.op is not None \
                    and id(src) not in seen:
                flag("entry %r runs before its dependency %r — the "
                     "rewritten order is not topologically valid"
                     % (node.name, src.name))
                return rep
        seen.add(id(node))
    live = mxfuse.live_entries(fused, out_refs)
    live_ids = {id(e[0]) for e in live}
    for nid, _i in out_refs:
        if nid not in live_ids:
            flag("inference-trace pruning dropped a graph output")
    for e in live:
        ov = e[5]
        if ov is None:
            continue
        for src, _idx in ov[1]:
            if id(src) not in live_ids and src.op is not None:
                flag("pruned eval plan drops op node %r that an "
                     "override's extra refs read" % src.name)
    rep.stats["plan_fusion"] = {"overrides": n_overrides,
                                "entries": len(plan),
                                "eval_live": len(live)}
    return rep


def lint_record(rec, compute_dtype=None, param_bytes=None,
                expect_allgather=True, schedule=None,
                expect_gather_bytes=None, min_donate_bytes=1 << 20,
                platform=None, expect_groups=None, data_axes=None,
                allreduce_bytes=0):
    """Run every graph rule against one :class:`StepRecord`.  Returns a
    :class:`Report` whose ``stats["collectives"]`` always carries the
    audit tally, and ``stats["dispatched_ops"]``, ``stats["host_syncs"]``
    and ``stats["kernel_launches"]`` the record's counts.  With
    ``data_axes`` (a mesh of positions, inside one process or across
    ranks) the all-gather and schedule rules read the collectives over
    those axes only
    (``stats["data_axis_collectives"]``): a ``tp`` form's activation
    collectives are no parameter traffic."""
    rep = Report(tool="mxlint.graph")
    rep.extend(audit_donation(rec, min_bytes=min_donate_bytes))
    rep.extend(find_callbacks(rec))
    rep.extend(find_unprotected_kernels(rec))
    if compute_dtype is not None:
        findings, tally = audit_dtype(rec, compute_dtype)
        rep.extend(findings)
        rep.stats["compute_eqn_dtypes"] = tally
    stats = collective_stats(rec)
    rep.stats["collectives"] = stats
    rep.stats["dispatched_ops"] = rec.n_ops
    rep.stats["host_syncs"] = len(rec.syncs)
    rep.stats["transport_syncs"] = len(rec.transport_syncs)
    launches = {}
    for name, _g, _r in rec.launches:
        launches[name] = launches.get(name, 0) + 1
    rep.stats["kernel_launches"] = dict(sorted(launches.items()))
    sched = stats
    if data_axes is not None:
        sched = collective_stats(rec, data_axes)
        rep.stats["data_axis_collectives"] = sched
    rep.extend(audit_collectives(sched, param_bytes=param_bytes,
                                 expect_allgather=expect_allgather))
    rep.extend(audit_collective_schedule(
        sched, schedule, expect_gather_bytes, platform=platform,
        expect_groups=expect_groups, allreduce_bytes=allreduce_bytes))
    if schedule:
        rep.stats["schedule"] = {
            "declared": schedule,
            "expect_gather_bytes": int(expect_gather_bytes or 0),
            "platform": platform}
    return rep


def lint_step(fn, *args, carries=None, inputs=None, compute_dtype=None,
              param_bytes=None, expect_allgather=True,
              min_donate_bytes=1 << 20, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the recorder and lint what
    it dispatched — the port's ``lint_jit``.  ``carries`` names the
    step's carries (see :func:`record_step`).  Example::

        params = {"w": w}
        report = lint_step(step, params, batch, carries=params,
                           expect_allgather=False)
        assert report.ok, report.format_text()
    """
    rec = record_step(fn, *args, carries=carries, inputs=inputs, **kwargs)
    return lint_record(rec, compute_dtype=compute_dtype,
                       param_bytes=param_bytes,
                       expect_allgather=expect_allgather,
                       min_donate_bytes=min_donate_bytes)
