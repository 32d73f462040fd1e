"""Level-3 static analysis, pass 2: wire-contract drift lint (port of
``mxnet_tpu/analysis/contract_lint.py``; the same rule and messages, over
a registry of the port's own files).

Every nontrivial outage the chaos drills have surfaced lately was a
*wire-contract drift*: one side of a cross-process JSON surface changed
shape and the other side kept reading the old keys.  The fleet's
``view_export`` drift was the textbook case — the sharded front end's
``FleetRouter.view_export`` silently dropped the controller's
supervision fields, so a worker-served ``/stats`` table lost
``state/pid/restarts/last_rc`` and the region kill-replica drill went
deterministic-red.  A dynamic test only catches that when a drill
happens to traverse the exact payload path; this pass catches it at
lint time.

Rule ``wire-contract-drift``, driven by a *declared registry* of the
repo's wire surfaces (:func:`repo_registry`).  Each
:class:`Surface` names its producer and consumer functions; the pass
extracts the produced key set (dict literals, ``x[k] =`` stores,
``.update({...})``, ``dict(k=...)``, ``setdefault``, dict comprehensions
over constant tuples) and the consumed key set (``x["k"]`` loads,
``.get("k")``/``.pop("k")``, ``for k in ("a", "b"): ... x[k]`` loops —
including tuples resolved through class constants like
``RegionSpec.FIELDS``) and flags:

- **consumer-read-never-produced** (error): a consumer reads a key no
  producer of any of its surfaces writes — the ``view_export`` drift's shape.
- **producer-key-never-read** (warning): a produced key no declared
  consumer reads — dead wire weight, or a consumer the registry is
  missing.

Three surface kinds cover the repo's wire formats:

- ``kind="keys"`` — JSON dict payloads (the default).
- ``kind="attrs"`` — attribute contracts like :class:`RegionSpec`:
  produced = ``self.X`` assigns in ``__init__`` plus class-level
  constant tuples (``FIELDS``); consumed = ``<base>.X`` attribute reads.
- ``kind="faults"`` — the fault-point namespace: every static
  ``faults.arm(...)``/``arm_hang`` name must resolve to a production
  ``maybe_fail``/``maybe_trip``/``maybe_hang``/``consume`` site
  (extends :func:`ast_lint.collect_fault_points`).

Design notes:

- Consumer checks run per consumer *function* against the UNION of the
  produced keys of every surface that names it — a function like
  ``FleetRouter.stats_payload`` legitimately reads the fleet view, the
  replica ``/stats`` payload and the router's own snapshot in one body,
  and splitting the check per surface would drown it in cross-surface
  noise.  Keys the function itself produces are always allowed (reading
  back your own store is not drift).
- The registry is part of the contract: a producer/consumer reference
  that no longer resolves (file gone, function renamed) is itself an
  error, so the registry cannot rot silently.
- ``extra_keys`` declares keys produced dynamically (merged sub-dicts,
  ``**kwargs``) that extraction cannot see; ``unread_ok`` documents
  produced keys that are debugging/forensic surface with no in-repo
  reader.  Both are the reviewed escape valves, same spirit as
  ``# mxlint: disable=`` (which also works, per line).
"""
from __future__ import annotations

import ast

import os

from .report import Report
from .ast_lint import collect_fault_points, load_modules

#: where repo-relative registry paths resolve when the scanned set does
#: not already include them (this file lives at
#: <root>/mxnet_tpu_torch/analysis/contract_lint.py)
_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

__all__ = ["Surface", "repo_registry", "lint_modules", "lint_paths",
           "RULES"]

RULES = ("wire-contract-drift",)

_RULE = "wire-contract-drift"


class Surface(object):
    """One declared cross-process wire surface.

    ``producers`` / ``consumers`` are ``(repo-relative-file, qualname)``
    pairs; ``qualname`` is ``func`` or ``Class.method``, or ``"*"`` for
    a whole module (attrs mode, where reads are recognizable anywhere by
    the ``attr_base`` receiver name).
    """

    def __init__(self, name, doc, producers=(), consumers=(),
                 kind="keys", attr_base=None, extra_keys=(),
                 unread_ok=()):
        if kind not in ("keys", "attrs", "faults"):
            raise ValueError("unknown surface kind %r" % (kind,))
        self.name = name
        self.doc = doc
        self.producers = tuple(producers)
        self.consumers = tuple(consumers)
        self.kind = kind
        self.attr_base = attr_base
        self.extra_keys = frozenset(extra_keys)
        self.unread_ok = frozenset(unread_ok)


# ---------------------------------------------------------------------------
# key extraction
# ---------------------------------------------------------------------------

def _const_str(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _str_tuple(node):
    """``("a", "b")`` / ``["a", "b"]`` -> the strings, else None."""
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)) and node.elts:
        out = [_const_str(e) for e in node.elts]
        if all(s is not None for s in out):
            return out
    return None


def _module_tuples(mod):
    """Constant string-tuple assignments, module level and class level
    (both ``FIELDS`` and ``RegionSpec.FIELDS`` spellings resolve off the
    bare attribute name — unique enough at this repo's scale)."""
    out = {}

    def scan(body):
        for node in body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                keys = _str_tuple(node.value)
                if keys:
                    out[node.targets[0].id] = keys

    scan(mod.tree.body)
    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef):
            scan(node.body)
    return out


def _resolve_tuple(node, tuples):
    keys = _str_tuple(node)
    if keys is not None:
        return keys
    if isinstance(node, ast.Name):
        return tuples.get(node.id)
    if isinstance(node, ast.Attribute):        # self.FIELDS / Spec.FIELDS
        return tuples.get(node.attr)
    return None


def _is_environ(node):
    """``os.environ[...]`` — an env read, not a wire surface."""
    return isinstance(node, ast.Attribute) and node.attr == "environ"


def _is_self_receiver(node):
    """``self.<attr>`` — a read off the object's own state (``self.sups
    ["trainer"]``, ``self._recon["base"]``) is internal bookkeeping,
    not a wire payload; counting it would demand every in-memory dict
    key be declared on some surface."""
    return isinstance(node, ast.Attribute) and \
        isinstance(node.value, ast.Name) and node.value.id == "self"


def _scan_keys(fn, tuples):
    """``(produced {key: line}, read {key: line}, comp_keys)`` for one
    function (nested defs and lambdas included — they are part of its
    logic).  ``comp_keys`` marks keys produced only by dict
    comprehensions over key tuples: those FORWARD another payload's
    keys (``{k: ent[k] for k in (...)}``) rather than originate them,
    so they must not self-exempt the reads they wrap — that exemption
    would have hidden the view_export revert."""
    produced, read, comp_keys = {}, {}, set()
    bound = {}                        # loop var -> constant key tuple
    for node in ast.walk(fn):
        gens = []
        if isinstance(node, ast.For):
            gens.append((node.target, node.iter))
        elif isinstance(node, (ast.DictComp, ast.ListComp, ast.SetComp,
                               ast.GeneratorExp)):
            gens.extend((g.target, g.iter) for g in node.generators)
        for target, it in gens:
            keys = _resolve_tuple(it, tuples)
            if keys and isinstance(target, ast.Name):
                bound[target.id] = keys

    def keys_of(node):
        s = _const_str(node)
        if s is not None:
            return [s]
        if isinstance(node, ast.Name):
            return bound.get(node.id)
        return None

    def note(table, keys, line):
        for k in keys:
            table.setdefault(k, line)

    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:               # None key = ** spread
                s = _const_str(k)
                if s is not None:
                    produced.setdefault(s, node.lineno)
        elif isinstance(node, ast.DictComp):
            keys = keys_of(node.key)
            if keys:
                note(produced, keys, node.lineno)
                comp_keys.update(keys)
        elif isinstance(node, ast.Subscript) and not _is_environ(node.value):
            keys = keys_of(node.slice)
            if keys:
                if isinstance(node.ctx, ast.Store):
                    note(produced, keys, node.lineno)
                elif not _is_self_receiver(node.value):
                    note(read, keys, node.lineno)  # Load / Del
        elif isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and node.args:
                keys = keys_of(node.args[0])
                if keys and func.attr in ("get", "pop") and \
                        not _is_self_receiver(func.value):
                    note(read, keys, node.lineno)
                elif keys and func.attr == "setdefault":
                    note(produced, keys, node.lineno)
            elif isinstance(func, ast.Name) and func.id == "dict":
                for kw in node.keywords:
                    if kw.arg is not None:
                        produced.setdefault(kw.arg, node.lineno)
        # membership tests (`"k" in x`) are deliberately NOT counted as
        # reads: `in` on a *string* receiver is substring search, and
        # the AST cannot tell the two apart — the subscript inside the
        # guarded branch is counted instead
    return produced, read, comp_keys


def _scan_attr_producer(mod, class_name):
    """Attrs-mode producer: ``self.X =`` in ``__init__`` plus class-level
    constant string tuples (the ``FIELDS`` declaration)."""
    produced = {}
    for node in mod.tree.body:
        if not (isinstance(node, ast.ClassDef) and node.name == class_name):
            continue
        for sub in node.body:
            if isinstance(sub, ast.Assign):
                keys = _str_tuple(sub.value)
                if keys:
                    for k in keys:
                        produced.setdefault(k, sub.lineno)
            elif isinstance(sub, ast.FunctionDef) and \
                    sub.name == "__init__":
                for inner in ast.walk(sub):
                    if isinstance(inner, ast.Assign):
                        for tgt in inner.targets:
                            if isinstance(tgt, ast.Attribute) and \
                                    isinstance(tgt.value, ast.Name) and \
                                    tgt.value.id == "self":
                                produced.setdefault(tgt.attr, inner.lineno)
        return produced, node
    return None, None


def _scan_attr_reads(tree, base):
    """Attrs-mode consumer: ``<base>.X`` / ``anything.<base>.X`` loads,
    method calls excluded (``spec.as_dict()`` is not a field read)."""
    read = {}
    called = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            called.add(id(node.func))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.ctx, ast.Load) and id(node) not in called:
            v = node.value
            if (isinstance(v, ast.Name) and v.id == base) or \
                    (isinstance(v, ast.Attribute) and v.attr == base):
                read.setdefault(node.attr, node.lineno)
    return read


# ---------------------------------------------------------------------------
# registry resolution
# ---------------------------------------------------------------------------

def _functions(mod):
    """``qualname -> def node`` (module level and one class level)."""
    out = {}
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out["%s.%s" % (node.name, sub.name)] = sub
    return out


class _Index(object):
    """Per-run resolution cache over the loaded modules."""

    def __init__(self, modules):
        self._by_suffix = {}
        for mod in modules:
            self._by_suffix[mod.path.replace("\\", "/")] = mod
        self._functions = {}
        self._tuples = {}

    def module(self, relpath):
        for path, mod in self._by_suffix.items():
            if path == relpath or path.endswith("/" + relpath):
                return mod
        return None

    def function(self, mod, qualname):
        if mod.path not in self._functions:
            self._functions[mod.path] = _functions(mod)
        return self._functions[mod.path].get(qualname)

    def tuples(self, mod):
        if mod.path not in self._tuples:
            self._tuples[mod.path] = _module_tuples(mod)
        return self._tuples[mod.path]


# ---------------------------------------------------------------------------
# the lint
# ---------------------------------------------------------------------------

def _add(report, mod, line, message, severity="error"):
    if mod is not None and mod.suppressed(line, _RULE):
        return
    report.add(_RULE, message, file=mod.path if mod else None,
               line=line, severity=severity)


def _lint_surfaces(surfaces, index, report):
    produced_by_surface = {}     # id(surface) -> {key: (mod, line)}
    consumers = {}               # entry key -> consumer record

    def resolve(surface, relpath, qualname, role):
        mod = index.module(relpath)
        if mod is None:
            report.add(_RULE,
                       "surface %r %s %s:%s references a file the lint "
                       "did not load — fix the registry in "
                       "analysis/contract_lint.py" %
                       (surface.name, role, relpath, qualname),
                       file=relpath)
            return None, None
        if qualname == "*":
            return mod, mod.tree
        fn = index.function(mod, qualname)
        if fn is None:
            report.add(_RULE,
                       "surface %r %s %s:%s no longer resolves (renamed "
                       "or deleted?) — update the registry in "
                       "analysis/contract_lint.py" %
                       (surface.name, role, relpath, qualname),
                       file=mod.path)
            return mod, None
        return mod, fn

    for surface in surfaces:
        if surface.kind == "faults":
            continue
        produced = {}
        for relpath, qualname in surface.producers:
            if surface.kind == "attrs":
                mod = index.module(relpath)
                keys = _scan_attr_producer(mod, qualname)[0] \
                    if mod is not None else None
                if keys is None:
                    report.add(_RULE,
                               "surface %r producer class %s:%s not "
                               "found — update the registry in "
                               "analysis/contract_lint.py"
                               % (surface.name, relpath, qualname),
                               file=mod.path if mod else relpath)
                    continue
            else:
                mod, fn = resolve(surface, relpath, qualname, "producer")
                if fn is None:
                    continue
                keys = _scan_keys(fn, index.tuples(mod))[0]
            for k, line in keys.items():
                produced.setdefault(k, (mod, line))
        produced_by_surface[id(surface)] = produced

        for relpath, qualname in surface.consumers:
            mod, fn = resolve(surface, relpath, qualname, "consumer")
            if fn is None:
                continue
            entry = (mod.path, qualname, surface.kind, surface.attr_base)
            rec = consumers.get(entry)
            if rec is None:
                if surface.kind == "attrs":
                    reads, self_produced = \
                        _scan_attr_reads(fn, surface.attr_base), set()
                else:
                    made, reads, comp = _scan_keys(fn, index.tuples(mod))
                    self_produced = set(made) - comp
                rec = consumers[entry] = {
                    "mod": mod, "qualname": qualname, "reads": reads,
                    "self": self_produced, "surfaces": [],
                    # a keys-mode whole-module consumer is a *read
                    # sink*: it proves keys are read (tests, drill
                    # harnesses) but is too coarse for the missing-key
                    # check — a test module legitimately reads many
                    # surfaces at once.  attrs-mode wildcards stay
                    # precise (reads are receiver-name filtered).
                    "sink": qualname == "*" and surface.kind == "keys"}
            rec["surfaces"].append(surface)

    # consumer-read-never-produced: one check per consumer function,
    # against the union of everything its surfaces produce
    for rec in consumers.values():
        if rec["sink"]:
            continue
        allowed = set(rec["self"])
        names = []
        for surface in rec["surfaces"]:
            names.append(surface.name)
            allowed |= set(produced_by_surface[id(surface)])
            allowed |= surface.extra_keys
        for key, line in sorted(rec["reads"].items()):
            if key in allowed:
                continue
            _add(report, rec["mod"], line,
                 "%s reads %r but no producer of surface(s) %s writes "
                 "it — wire-contract drift (the view_export bug "
                 "shape); produce the key, or fix the registry in "
                 "analysis/contract_lint.py (see docs/how_to/"
                 "static_analysis.md level 3)"
                 % (rec["qualname"], key, "/".join(sorted(names))))

    # producer-key-never-read: per surface, against all its consumers
    for surface in surfaces:
        if surface.kind == "faults":
            continue
        read = set()
        for rec in consumers.values():
            if surface in rec["surfaces"]:
                read |= set(rec["reads"])
        for key, (mod, line) in sorted(produced_by_surface[id(surface)]
                                       .items()):
            if key in read or key in surface.unread_ok:
                continue
            _add(report, mod, line,
                 "surface %r produces %r but no declared consumer reads "
                 "it — dead wire weight, or a missing consumer in the "
                 "registry; read it, drop it, or list it in unread_ok "
                 "with a why" % (surface.name, key),
                 severity="warning")


def _lint_faults(surfaces, paths, cache, report):
    """Fault-point namespace check: every statically armed name must hit
    a production injection site (typo'd armings silently never fire)."""
    if not any(s.kind == "faults" for s in surfaces):
        return
    points = set(collect_fault_points(paths, cache=cache))
    arms = collect_fault_points(paths, arms=True, cache=cache)
    for surface in surfaces:
        if surface.kind != "faults":
            continue
        for name, sites in sorted(arms.items()):
            if name in points or name in surface.extra_keys:
                continue
            for path, line, via in sites:
                report.add(_RULE,
                           "%s arms fault point %r but no production "
                           "site reads it (known points: mxlint_main.py "
                           "--list-faults) — the arming silently never "
                           "fires" % (via, name),
                           file=path, line=line)


def lint_modules(modules, surfaces=None, select=None):
    """Run the contract rule over pre-parsed modules.  ``surfaces``
    defaults to the repo registry; pass a custom list for fixtures.
    (Faults surfaces need path context — see :func:`lint_paths`.)"""
    rules = set(RULES if select is None else select) & set(RULES)
    report = Report(tool="mxlint.contract")
    report.files_scanned = len(modules)
    if not rules:
        return report
    if surfaces is None:
        surfaces = repo_registry()
    _lint_surfaces(surfaces, _Index(modules), report)
    return report


def lint_paths(paths, surfaces=None, select=None, cache=None,
               overrides=None):
    """Load ``paths`` and run :func:`lint_modules`, plus the
    fault-namespace check (which needs path context).  ``overrides``
    maps file paths to replacement source — how the view_export regression
    fixture replays the broken ``view_export`` against today's
    registry."""
    modules, broken = load_modules(paths, cache=cache,
                                   overrides=overrides)
    if surfaces is None:
        surfaces = repo_registry()
    # the registry is repo-global: pull in referenced files the scan
    # set missed (e.g. `--changed` touched only one side of a surface,
    # or a drill-harness consumer lives under tests/)
    index = _Index(modules)
    extra = []
    for surface in surfaces:
        for relpath, _q in tuple(surface.producers) + tuple(
                surface.consumers):
            full = os.path.join(_REPO_ROOT, relpath)
            if index.module(relpath) is None and relpath not in extra \
                    and os.path.isfile(full):
                extra.append(relpath)
    if extra:
        more, broken2 = load_modules(
            [os.path.join(_REPO_ROOT, p) for p in extra],
            cache=cache, overrides=overrides)
        modules = list(modules) + list(more)
        broken = list(broken) + list(broken2)
    report = lint_modules(modules, surfaces=surfaces, select=select)
    if RULES[0] in (set(RULES if select is None else select)):
        _lint_faults(surfaces, paths, cache if not overrides else None,
                     report)
    for path, err in broken:
        report.add("parse-error", "cannot parse: %s" % (err,), file=path)
    return report


# ---------------------------------------------------------------------------
# the repo's declared wire surfaces
# ---------------------------------------------------------------------------

def repo_registry():
    """The declared registry of the port's cross-process JSON surfaces:
    the JAX package's registry with its files replaced by the port's
    (``mxnet_tpu_torch/...``, the fleet CLI ``fleet/fleet_main.py``, the
    region drill ``region/region_main.py`` with its trainer
    ``region/trainer_main.py``, the port's parity tests
    ``tests/test_torch_*.py``).  The trainer's status file is a real
    producer here (``trainer_main.write_status``), where the JAX package's
    trainer is a generated script whose keys the registry declares.

    Declaring a new surface: name the producer and consumer functions as
    ``(repo-relative file, qualname)`` pairs, run
    ``mxnet_tpu_torch/analysis/mxlint_main.py``, and tune ``extra_keys``
    (dynamically produced keys extraction cannot see) / ``unread_ok``
    (forensic keys with no in-repo reader, each needs a why) until the
    findings are the real ones.
    """
    P = "mxnet_tpu_torch/"
    R = P + "fleet/router.py"
    V = P + "fleet/view.py"
    F = P + "serving/frontend.py"
    RES = P + "resilience.py"
    CLI = P + "fleet/fleet_main.py"
    REG = P + "region/region_main.py"
    TRN = P + "region/trainer_main.py"
    T_REGION = "tests/test_torch_region.py"
    T_FLEET = "tests/test_torch_fleet.py"
    T_DRILL = "tests/test_torch_fleet_drill.py"
    T_SERVE = "tests/test_torch_serving.py"
    T_DAEMON = "tests/test_torch_serving_daemon.py"
    T_RES = "tests/test_torch_resilience.py"
    SMOKE = "chip_smoke.py"
    return [
        Surface(
            "fleet-view-doc",
            "The published fleet-view snapshot document "
            "(run/fleet-view.json): controller-side publisher -> "
            "router workers.",
            producers=[(V, "FleetViewPublisher.publish_once")],
            consumers=[(V, "FleetViewReader.doc"),
                       (V, "FleetViewReader.age_s"),
                       (V, "FleetViewReader.replicas"),
                       (V, "FleetViewReader.fenced"),
                       (R, "FleetRouter._sync_view"),
                       (R, "FleetRouter.stats_payload"),
                       (T_FLEET, "*")],
            # the doc doubles as a live debugging surface (`cat
            # run/fleet-view.json`); these two annotate it for humans.
            # `models` names what the front end routes for that reader
            # too (the JAX package's fleet tests assert it; no port code
            # routes by it)
            unread_ok=("heartbeat_s", "evict_s", "models"),
        ),
        Surface(
            "fleet-view-replica",
            "One replica entry inside the view's `replicas` map "
            "(FleetRouter.view_export) — the drift site: the supervision "
            "fields must travel with the view so a sharded worker's "
            "/stats table matches the controller-side one.",
            producers=[(R, "FleetRouter.view_export")],
            consumers=[(V, "FleetViewReader.replicas"),
                       (R, "FleetRouter._sync_view"),
                       (R, "FleetRouter.stats_payload"),
                       (T_FLEET, "*")],
            # the view file doubles as `cat run/fleet-view.json`
            # forensics; per-replica forward_errors travels for that
            unread_ok=("forward_errors",),
        ),
        Surface(
            "worker-stats-dump",
            "Per-worker counter dump next to the view file "
            "(rworker-*.stats.json): any worker answers /stats for the "
            "whole front end by merging the sibling dumps.",
            producers=[(R, "FleetRouter.dump_worker_stats")],
            consumers=[(R, "FleetRouter._merged_worker_stats")],
        ),
        Surface(
            "router-snapshot",
            "The Stats snapshot/export/merge shapes shared by the "
            "serving front end and the fleet router tier.",
            producers=[(F, "Stats.snapshot"), (F, "Stats.export"),
                       (F, "Stats.merged_snapshot")],
            consumers=[(F, "Stats.merged_snapshot"),
                       (R, "FleetRouter.stats_payload"),
                       (T_SERVE, "*"), (T_DAEMON, "*"), (T_FLEET, "*"),
                       (SMOKE, "*")],
            # batches.avg_ms is a human gauge next to the machine-read
            # fill_ratio/count fields; p99_recent travels on the
            # router's OWN snapshot only because the one snapshot shape
            # serves both tiers — its machine reader (the outlier
            # detector) consumes it from replica /stats, not here.
            # p99 is the JAX package's bench.py metric; the port has no
            # benchmark harness yet
            unread_ok=("avg_ms", "p99_recent", "p99"),
        ),
        Surface(
            "replica-stats",
            "A serving replica's /stats payload: what the fleet "
            "router's prober stores as view.stats and the routing/"
            "autoscale/rollout policies read.",
            producers=[(F, "ServingFrontend.stats_payload"),
                       (F, "Stats.snapshot"),
                       (P + "serving/deploy.py", "CheckpointWatcher.stats"),
                       (P + "serving/deploy.py",
                        "CheckpointWatcher.__init__")],
            consumers=[(R, "FleetRouter.stats_payload"),
                       (R, "FleetRouter._load"),
                       (R, "FleetRouter._update_outliers"),
                       (R, "FleetRouter.pressure_ms"),
                       (R, "FleetRouter._flooder_tenant"),
                       (P + "fleet/autoscale.py", "Autoscaler._pressure_ms"),
                       (P + "fleet/deploy.py", "RollingSwap._replica_epoch"),
                       (T_SERVE, "*"), (T_DAEMON, "*"), (T_FLEET, "*"),
                       (SMOKE, "*")],
            # the watcher deploy block is promote forensics (which
            # model/dir, last outcome, error counters) for operators
            # reading /stats; draining is mirrored machine-readably on
            # /healthz (what the router prober actually uses)
            unread_ok=("avg_ms", "directory", "draining",
                       "last_outcome", "model", "poll_s", "polls",
                       "swap_errors", "watching"),
        ),
        Surface(
            "router-stats",
            "The fleet front end's /stats payload (single-process and "
            "sharded): what the drills poll and read replica pids from.",
            producers=[(R, "FleetRouter.stats_payload"),
                       (P + "fleet/deploy.py", "RollingSwap.stats"),
                       (P + "fleet/deploy.py", "RollingSwap.__init__")],
            consumers=[(REG, "Region._poll_once"),
                       (REG, "Region._fire"),
                       (REG, "Region.stats_payload"),
                       (REG, "Region._replica_epochs"),
                       (T_FLEET, "*"), (T_DRILL, "*"), (T_REGION, "*"),
                       (SMOKE, "*")],
            # the per-replica table and view block are the operator's
            # triage surface (why is this replica slow/evicted/dead);
            # machine consumers key off healthy/epochs/restarts instead.
            # the brownout block (slo_ms/pressure_ms next to the
            # machine-read `active` bit) shows an operator how close
            # the fleet is to shedding — and WHY it already is.  The
            # model table, the per-model queue depth and the rollout's
            # `watching` flag are operator forensics too (the JAX
            # package's chaos and fleet tests assert them; the port's
            # drills and the region gate on epochs, restarts and the
            # rollout counters instead)
            unread_ok=("age_s", "draining", "est_wait_ms",
                       "forward_errors", "heartbeat_age_s", "inflight",
                       "last_rc", "probe_retries", "read_errors",
                       "replicas_total", "pressure_ms", "slo_ms",
                       "watching", "queue_depth", "models"),
        ),
        Surface(
            "fleet-manifest",
            "The fleet manifest file: `serve` writes it, every replica "
            "and router worker process re-reads it.",
            producers=[(P + "fleet/manifest.py", "FleetManifest.to_doc")],
            consumers=[(P + "fleet/manifest.py", "FleetManifest.from_file"),
                       (P + "fleet/manifest.py", "FleetManifest.__init__"),
                       (P + "fleet/manifest.py", "FleetManifest.serve_argv"),
                       (CLI, "_cmd_serve"),
                       (CLI, "_serve_sharded")],
        ),
        Surface(
            "trainer-status",
            "The region trainer's status file (REGION_STATUS_FILE): "
            "written by trainer_main.write_status after every publish, "
            "read by the region daemon.",
            producers=[(TRN, "write_status")],
            consumers=[(REG, "Region._trainer_status"),
                       (REG, "Region._reconnect_total"),
                       (REG, "Region.stats_payload"),
                       (T_REGION, "*")],
        ),
        Surface(
            "region-spec",
            "RegionSpec: the declarative region topology every "
            "region_main.py phase reads.",
            kind="attrs", attr_base="spec",
            producers=[(REG, "RegionSpec")],
            consumers=[(REG, "*")],
        ),
        Surface(
            "region-stats",
            "The region daemon's /region/stats payload: the drill "
            "scoreboard (consumed by the drill tests, the chip smoke "
            "and operators).",
            producers=[(REG, "Region.stats_payload")],
            consumers=[(REG, "Region.report"), (T_REGION, "*"),
                       (SMOKE, "*")],
            # /region/stats IS the drill scoreboard: the composed-drill
            # report embeds it wholesale and operators read it raw; the
            # harness asserts only the gating keys (trainer progress,
            # served epochs, rollout verdicts)
            unread_ok=("batches", "data_reconnects", "fired", "fleet",
                       "first_served_epoch", "healthy", "labels",
                       "polls", "published_epoch", "roles", "rollouts",
                       "scheduled", "storm", "window_s"),
        ),
        Surface(
            "ckpt-manifest",
            "Checkpoint manifest entries, formats 1 (whole-blob) and 2 "
            "(sharded, incl. the per-shard blob docs): trainer-side "
            "save -> restore/promotion/fsck readers in other processes.",
            producers=[(RES, "CheckpointManager.save"),
                       (RES, "CheckpointManager.save_sharded"),
                       (RES, "CheckpointManager._write_checkpoint"),
                       (RES, "CheckpointManager._shard_parts"),
                       (RES, "CheckpointManager._scan_directory")],
            consumers=[(RES, "CheckpointManager.entry"),
                       (RES, "CheckpointManager.restore"),
                       (RES, "CheckpointManager._restore_from_shards"),
                       (RES, "CheckpointManager._delete_entry_files"),
                       (RES, "verify_promotion"),
                       (RES, "publish_mark"),
                       ("tools/ckpt_fsck.py", "_check_entry"),
                       ("tools/ckpt_fsck.py", "_check_file"),
                       ("tools/ckpt_fsck.py", "audit"),
                       (T_RES, "*")],
            # the manifest header names its own prefix so a bare
            # `cat manifest.json` identifies the checkpoint family;
            # readers re-derive it from their own config
            unread_ok=("prefix",),
        ),
        Surface(
            "fault-points",
            "The fault-injection namespace: armed names must resolve "
            "to production injection sites.",
            kind="faults",
        ),
    ]
