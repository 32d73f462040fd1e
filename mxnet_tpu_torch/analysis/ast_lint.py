"""Level-2 static analysis: AST rules encoding this repo's invariants
(port of ``mxnet_tpu/analysis/ast_lint.py``: the same rule ids, messages
and suppression syntax).

Pure stdlib (``ast``) — no torch, no package imports — so the CLI can
lint the tree in milliseconds and run where no accelerator runtime
exists.

Rules (ids are what ``# mxlint: disable=<rule>`` names, inline or on the
line above):

- ``traced-host-call``: ``float()``/``bool()``/``.item()``/
  ``time.time()`` & friends inside a function that a capture takes:
  passed to ``jax.jit`` or ``torch.compile`` (or decorated with one),
  passed to ``torch.cuda.make_graphed_callables``, or called inside a
  ``with torch.cuda.graph(...)`` block.  On a captured value these force
  a device sync (a capture error inside a CUDA graph), and even when they
  "work" they freeze a runtime value at capture time.
- ``lock-order``: the acquisition graph over the repo's known lock set
  (``threading.Lock``/``RLock`` attributes and module globals) contains
  a cycle — two code paths that take the same pair of locks in opposite
  orders will eventually deadlock a background thread.  Edges come from
  lexically nested ``with`` blocks plus one level of same-class method
  calls made while a lock is held.
- ``bare-except``: a bare ``except:`` swallows device errors,
  ``KeyboardInterrupt`` and watchdog/preemption ``SystemExit`` alike;
  catch a concrete type (``Exception`` at the broadest).
- ``env-direct-read``: an ``MXTPU_*``/``MXNET_*`` env var read through
  ``os.environ``/``os.getenv`` instead of ``base.get_env`` — bypasses
  the registry, so typos and undocumented knobs go unnoticed.
- ``env-unregistered``: a ``get_env`` read of a framework-prefixed name
  that no ``register_env`` call in the scanned tree (or the provided
  registry) declares — either a typo'd knob silently yielding its
  default, or a new knob missing its catalog row (and docs table).
"""
from __future__ import annotations

import ast
import os
import re

from .report import Finding, Report

__all__ = ["lint_paths", "collect_env_reads", "collect_registered",
           "collect_fault_points", "iter_py_files", "load_modules",
           "RULES", "ENV_PREFIXES"]

ENV_PREFIXES = ("MXTPU_", "MXNET_")

RULES = ("traced-host-call", "lock-order", "bare-except",
         "env-direct-read", "env-unregistered")

#: host calls that must not run on traced values
_HOST_CASTS = ("float", "bool")
_HOST_CLOCKS = ("time", "monotonic", "perf_counter", "process_time")

_SUPPRESS_RE = re.compile(
    r"#\s*mxlint:\s*disable(?:=([A-Za-z0-9_,\- ]+))?")

_ALL = object()


def iter_py_files(paths):
    """Expand files/directories into a sorted list of .py files."""
    out = []
    for path in paths:
        path = os.fspath(path)
        if os.path.isfile(path):
            out.append(path)
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__"
                                 and not d.startswith("."))
            for name in sorted(filenames):
                if name.endswith(".py"):
                    out.append(os.path.join(dirpath, name))
    return sorted(dict.fromkeys(out))


#: functions whose import aliases must be tracked (``from .base import
#: register_env as _register_env`` — metric.py's idiom — must still
#: register, and aliased get_env reads must still count as reads)
_TRACKED_FUNCS = ("register_env", "get_env", "getenv")


class _Module(object):
    """One parsed file plus its suppression map and import aliases."""

    def __init__(self, path, source):
        self.path = path
        self.tree = ast.parse(source, filename=path)
        self.suppress = {}
        for lineno, line in enumerate(source.splitlines(), 1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = m.group(1)
            self.suppress[lineno] = _ALL if rules is None else \
                {r.strip() for r in rules.split(",") if r.strip()}
        # canonical function name -> local names it is bound to here
        self.aliases = {name: {name} for name in _TRACKED_FUNCS}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    if alias.name in self.aliases and alias.asname:
                        self.aliases[alias.name].add(alias.asname)

    def is_func(self, node, name):
        """Does a call's ``func`` node refer to tracked function
        ``name`` — directly, via attribute, or via an import alias?"""
        if isinstance(node, ast.Name):
            return node.id in self.aliases.get(name, (name,))
        return isinstance(node, ast.Attribute) and node.attr == name

    def suppressed(self, line, rule):
        """True when ``rule`` is disabled on ``line`` (comment inline or
        on the line directly above)."""
        for ln in (line, (line or 0) - 1):
            rules = self.suppress.get(ln)
            if rules is _ALL or (rules is not None and rule in rules):
                return True
        return False


def _is_name_or_attr(node, name):
    return (isinstance(node, ast.Name) and node.id == name) or \
        (isinstance(node, ast.Attribute) and node.attr == name)


# ---------------------------------------------------------------------------
# pass 1: cross-file constant / registration tables
# ---------------------------------------------------------------------------

def _collect_constants(modules):
    """``NAME -> "MXTPU_..."`` for module-level string assignments and
    ``NAME = register_env("MXTPU_...")`` forms, keyed by the bare name so
    ``resilience.ENV_RESUME``-style attribute references resolve too
    (env constant names are unique across this repo)."""
    consts = {}
    registered = set()
    for mod in modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and \
                    mod.is_func(node.func, "register_env") and \
                    node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                registered.add(node.args[0].value)
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target = node.targets[0]
            if not isinstance(target, ast.Name):
                continue
            value = node.value
            if isinstance(value, ast.Constant) and \
                    isinstance(value.value, str):
                consts[target.id] = value.value
            elif isinstance(value, ast.Call) and \
                    mod.is_func(value.func, "register_env") and \
                    value.args and \
                    isinstance(value.args[0], ast.Constant) and \
                    isinstance(value.args[0].value, str):
                consts[target.id] = value.args[0].value
    return consts, registered


def _resolve_env_name(node, consts):
    """Best-effort string value of an env-name argument."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, ast.Attribute):
        return consts.get(node.attr)
    return None


# ---------------------------------------------------------------------------
# env rules
# ---------------------------------------------------------------------------

def _is_environ(node):
    """``os.environ`` (or ``environ`` imported bare)."""
    return _is_name_or_attr(node, "environ")


def _env_reads(mod, consts):
    """Yield (name, line, via) for every env read in one module:
    via='get_env' for registry-routed reads, 'direct' for
    os.environ/os.getenv."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            func = node.func
            if mod.is_func(func, "get_env") and node.args:
                name = _resolve_env_name(node.args[0], consts)
                if name:
                    yield name, node.lineno, "get_env"
            elif mod.is_func(func, "getenv") and node.args:
                name = _resolve_env_name(node.args[0], consts)
                if name:
                    yield name, node.lineno, "direct"
            elif isinstance(func, ast.Attribute) and \
                    func.attr in ("get", "setdefault") and \
                    _is_environ(func.value) and node.args:
                name = _resolve_env_name(node.args[0], consts)
                if name:
                    yield name, node.lineno, "direct"
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load) and \
                _is_environ(node.value):
            name = _resolve_env_name(node.slice, consts)
            if name:
                yield name, node.lineno, "direct"


def _lint_env(mod, consts, registered, report):
    for name, line, via in _env_reads(mod, consts):
        if not name.startswith(ENV_PREFIXES):
            continue
        if via == "direct":
            if not mod.suppressed(line, "env-direct-read"):
                report.add("env-direct-read",
                           "%s read through os.environ — route it "
                           "through base.get_env so the registry (and "
                           "docs/env_vars.md sync) sees it" % name,
                           file=mod.path, line=line)
            continue
        if name not in registered and \
                not mod.suppressed(line, "env-unregistered"):
            report.add("env-unregistered",
                       "get_env(%r) reads a knob no register_env() "
                       "declares — typo, or missing from the "
                       "base.ENV_REGISTRY catalog (and docs/"
                       "env_vars.md)" % name,
                       file=mod.path, line=line)


# ---------------------------------------------------------------------------
# traced-host rule
# ---------------------------------------------------------------------------

def _is_jit(node):
    return _is_name_or_attr(node, "jit")


def _capture_of(node):
    """How a callable node captures the function handed to it: the
    phrase the finding names, or None.  ``jax.jit`` stays recognised in
    source text (shared fixtures lint alike in both packages); the port's
    own capture forms are ``torch.compile`` and
    ``torch.cuda.make_graphed_callables``."""
    if _is_jit(node):
        return "passed to jax.jit"
    if isinstance(node, ast.Attribute) and node.attr == "compile" and \
            _is_name_or_attr(node.value, "torch"):
        return "passed to torch.compile"
    if _is_name_or_attr(node, "make_graphed_callables"):
        return "passed to torch.cuda.make_graphed_callables"
    return None


def _is_cuda_graph(node):
    """``torch.cuda.graph(g)`` (or a bare ``graph(g)`` imported from
    ``torch.cuda``) as a ``with`` item."""
    return isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Attribute) and \
        node.func.attr == "graph" and _is_name_or_attr(node.func.value,
                                                      "cuda")


def _decorator_capture(node):
    for dec in node.decorator_list:
        how = _capture_of(dec)
        if how is None and isinstance(dec, ast.Call):
            how = _capture_of(dec.func)
            if how is None and _is_name_or_attr(dec.func, "partial") and \
                    dec.args:
                how = _capture_of(dec.args[0])
        if how is not None:
            return how
    return None


def _captured_function_names(tree):
    """``name -> phrase`` for every function a capture takes: passed by
    name to ``jax.jit``/``torch.compile``, decorated with one, or called
    by name inside a ``with torch.cuda.graph(...)`` block."""
    names = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Name):
            how = _capture_of(node.func)
            if how is not None:
                names.setdefault(node.args[0].id, how)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            how = _decorator_capture(node)
            if how is not None:
                names.setdefault(node.name, how)
        if isinstance(node, ast.With) and any(
                _is_cuda_graph(item.context_expr) for item in node.items):
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) and \
                            isinstance(sub.func, ast.Name):
                        names.setdefault(sub.func.id,
                                         "run under torch.cuda.graph")
    return names


def _lint_traced_host(mod, report):
    captured = _captured_function_names(mod.tree)
    if not captured:
        return
    # class METHODS are referenced as self.x / obj.x, never as the bare
    # Name a `jit(step, ...)` call passes — a method that merely shares
    # a jitted closure's name (SPMDTrainer.step vs the inner fused
    # `step`) must not be scanned.  Methods captured via their own
    # decorator are still covered by _decorator_capture below.
    methods = {fn for node in ast.walk(mod.tree)
               if isinstance(node, ast.ClassDef)
               for fn in node.body
               if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        how = _decorator_capture(node)
        if how is None:
            if node.name not in captured or node in methods:
                continue
            how = captured[node.name]
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            bad = None
            if isinstance(func, ast.Name) and func.id in _HOST_CASTS \
                    and sub.args and not isinstance(sub.args[0],
                                                    ast.Constant):
                bad = "%s() forces a traced value to the host" % func.id
            elif isinstance(func, ast.Attribute) and \
                    func.attr == "item" and not sub.args:
                bad = ".item() forces a device sync"
            elif isinstance(func, ast.Attribute) and \
                    func.attr in _HOST_CLOCKS and \
                    _is_name_or_attr(func.value, "time"):
                bad = "time.%s() reads the host clock at trace time " \
                    "(a constant in the compiled step)" % func.attr
            if bad and not mod.suppressed(sub.lineno,
                                          "traced-host-call"):
                report.add("traced-host-call",
                           "inside %r (%s): %s" % (node.name, how, bad),
                           file=mod.path, line=sub.lineno)


# ---------------------------------------------------------------------------
# lock-order rule
# ---------------------------------------------------------------------------

_LOCK_TYPES = ("Lock", "RLock")


def _is_lock_ctor(node):
    return isinstance(node, ast.Call) and any(
        _is_name_or_attr(node.func, t) for t in _LOCK_TYPES)


class _LockScan(object):
    """Per-module lock definitions and acquisition edges.

    Lock identity: ``(module, class, attr)`` for ``self.X`` locks,
    ``(module, None, name)`` for module globals.  Edges are added for a
    ``with`` nested (lexically) under another ``with``, and — one level
    deep — for same-class method calls made while a lock is held, using
    each method's transitive same-class acquisition set.
    """

    def __init__(self, mod):
        self.mod = mod
        base = os.path.basename(mod.path)
        self.modkey = base
        self.locks = set()
        self.method_acquires = {}   # (class, method) -> set(lock ids)
        self.method_calls = {}      # (class, method) -> set(method names)
        self.edges = {}             # (a, b) -> (file, line)
        self._collect_defs()

    def _lock_id(self, cls, attr):
        return "%s::%s.%s" % (self.modkey, cls or "<module>", attr)

    def _collect_defs(self):
        for node in self.mod.tree.body:
            if isinstance(node, ast.Assign) and \
                    len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    _is_lock_ctor(node.value):
                self.locks.add(self._lock_id(None, node.targets[0].id))
            if isinstance(node, ast.ClassDef):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Assign) and \
                            len(sub.targets) == 1 and \
                            isinstance(sub.targets[0], ast.Attribute) and \
                            isinstance(sub.targets[0].value, ast.Name) and \
                            sub.targets[0].value.id == "self" and \
                            _is_lock_ctor(sub.value):
                        self.locks.add(
                            self._lock_id(node.name, sub.targets[0].attr))

    def _resolve(self, expr, cls):
        """Lock id for a with-item context expression, or None."""
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and cls is not None:
            lid = self._lock_id(cls, expr.attr)
            return lid if lid in self.locks else None
        if isinstance(expr, ast.Name):
            lid = self._lock_id(None, expr.id)
            return lid if lid in self.locks else None
        return None

    def scan(self):
        for node in self.mod.tree.body:
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef):
                        self._scan_function(item, node.name)
            elif isinstance(node, ast.FunctionDef):
                self._scan_function(node, None)
        self._expand_method_calls()
        return self.edges

    def _scan_function(self, fn, cls):
        acquires = set()
        calls = set()

        def walk(node, held):
            if isinstance(node, ast.With):
                got = []
                for item in node.items:
                    lid = self._resolve(item.context_expr, cls)
                    if lid is None:
                        continue
                    # a multi-item ``with a, b:`` acquires sequentially —
                    # locks earlier in the SAME statement are already
                    # held when this one is taken
                    for h in held + got:
                        if h != lid:
                            self.edges.setdefault(
                                (h, lid),
                                (self.mod.path, node.lineno))
                    got.append(lid)
                    acquires.add(lid)
                held = held + got
                for child in node.body:
                    walk(child, held)
                return
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "self":
                calls.add((node.func.attr, node.lineno, tuple(held)))
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    # nested defs run later (threads/callbacks) — their
                    # acquisitions are not nested under the current hold
                    walk_body_fresh(child)
                    continue
                walk(child, held)

        def walk_body_fresh(fn_node):
            for child in fn_node.body:
                walk(child, [])

        walk_body_fresh(fn)
        if cls is not None:
            self.method_acquires[(cls, fn.name)] = acquires
            self.method_calls[(cls, fn.name)] = calls

    def _transitive_acquires(self, cls, name, seen):
        key = (cls, name)
        if key in seen:
            return set()
        seen.add(key)
        out = set(self.method_acquires.get(key, ()))
        for callee, _line, _held in self.method_calls.get(key, ()):
            out |= self._transitive_acquires(cls, callee, seen)
        return out

    def _expand_method_calls(self):
        for (cls, name), calls in self.method_calls.items():
            for callee, line, held in calls:
                if not held:
                    continue
                for lid in self._transitive_acquires(cls, callee, set()):
                    for h in held:
                        if h != lid:
                            self.edges.setdefault(
                                (h, lid), (self.mod.path, line))


def _find_cycles(edges):
    """Cycles in the acquisition digraph, deduped by node set."""
    graph = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    cycles = []
    seen_sets = set()

    def dfs(node, path, on_path):
        for nxt in graph.get(node, ()):
            if nxt in on_path:
                cyc = path[path.index(nxt):] + [nxt]
                key = frozenset(cyc)
                if key not in seen_sets:
                    seen_sets.add(key)
                    cycles.append(cyc)
                continue
            dfs(nxt, path + [nxt], on_path | {nxt})

    for start in sorted(graph):
        dfs(start, [start], {start})
    return cycles


def _lint_locks(modules, report):
    edges = {}
    for mod in modules:
        edges.update(_LockScan(mod).scan())
    for cyc in _find_cycles(edges):
        first_edge = (cyc[0], cyc[1]) if len(cyc) > 1 else None
        file, line = edges.get(first_edge, (None, None))
        mod = next((m for m in modules if m.path == file), None)
        if mod is not None and mod.suppressed(line, "lock-order"):
            continue
        report.add("lock-order",
                   "lock acquisition cycle: %s — two threads taking "
                   "these in opposite orders will deadlock"
                   % " -> ".join(cyc),
                   file=file, line=line)


# ---------------------------------------------------------------------------
# bare-except rule
# ---------------------------------------------------------------------------

def _lint_bare_except(mod, report):
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None \
                and not mod.suppressed(node.lineno, "bare-except"):
            report.add("bare-except",
                       "bare 'except:' swallows device errors, "
                       "KeyboardInterrupt and watchdog SystemExit — "
                       "catch a concrete type",
                       file=mod.path, line=node.lineno)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _load_modules(paths, cache=None, overrides=None):
    """Parse every .py file under ``paths`` into :class:`_Module`\\ s.

    ``cache`` (``{abspath: _Module}``) is shared across the lint passes
    so the CLI parses each file exactly once per run.  ``overrides``
    maps paths to replacement SOURCE TEXT — the contract-lint regression
    fixtures use it to lint a file "as if" an old bug were still there
    without touching the tree.
    """
    modules, broken = [], []
    overrides = {os.path.abspath(p): src
                 for p, src in (overrides or {}).items()}
    for path in iter_py_files(paths):
        full = os.path.abspath(path)
        if cache is not None and path in cache and full not in overrides:
            modules.append(cache[path])
            continue
        try:
            if full in overrides:
                modules.append(_Module(path, overrides[full]))
                continue
            with open(path, "r", encoding="utf-8") as f:
                mod = _Module(path, f.read())
            modules.append(mod)
            if cache is not None:
                cache[path] = mod
        except (OSError, SyntaxError) as e:
            broken.append((path, e))
    return modules, broken


#: public names for the machinery the whole-repo passes (race_lint,
#: contract_lint) build on — one parser, one suppression syntax, one
#: lock model across every level
load_modules = _load_modules
Module = _Module
LockScan = _LockScan
collect_constants = _collect_constants
resolve_const_string = _resolve_env_name


def collect_registered(paths, cache=None):
    """Env names declared by ``register_env`` calls under ``paths`` —
    the purely static registry (what the CLI uses instead of importing
    the package)."""
    modules, _ = _load_modules(paths, cache=cache)
    return _collect_constants(modules)[1]


def collect_env_reads(paths):
    """``name -> [(file, line, via)]`` for every resolvable
    ``MXTPU_*``/``MXNET_*`` env read under ``paths`` (the doc-sync
    oracle used by tests and the registry audit)."""
    modules, _ = _load_modules(paths)
    consts, _ = _collect_constants(modules)
    out = {}
    for mod in modules:
        for name, line, via in _env_reads(mod, consts):
            if name.startswith(ENV_PREFIXES):
                out.setdefault(name, []).append((mod.path, line, via))
    return out


#: ``resilience.FaultInjector`` consume methods — a call
#: ``faults.<method>("<point>")`` IS a production fault site
_FAULT_READS = ("maybe_fail", "maybe_trip", "maybe_hang", "consume")
#: arming entry points (tests/tools side of the contract)
_FAULT_ARMS = ("arm", "arm_hang")


def _param_string_defaults(node, name):
    """String defaults of parameters called ``name`` on a function def
    (``atomic_path(path, fault_point="checkpoint_write")``)."""
    out = []
    a = node.args
    positional = list(a.posonlyargs) + list(a.args)
    for param, default in zip(positional[len(positional)
                                         - len(a.defaults):], a.defaults):
        if param.arg == name and isinstance(default, ast.Constant) \
                and isinstance(default.value, str):
            out.append((default.value, default.lineno))
    for param, default in zip(a.kwonlyargs, a.kw_defaults):
        if default is not None and param.arg == name and \
                isinstance(default, ast.Constant) and \
                isinstance(default.value, str):
            out.append((default.value, default.lineno))
    return out


def collect_fault_points(paths, arms=False, cache=None):
    """``point -> [(file, line, via)]`` for every statically resolvable
    fault-injection site under ``paths`` — the mechanical registry that
    ``analysis/mxlint_main.py --list-faults`` prints and the docs-sync test
    asserts against ``docs/how_to/fault_tolerance.md``.

    A site is a ``faults.maybe_fail/maybe_trip/maybe_hang/consume`` call
    whose point resolves statically (string literal, or a module-level
    string constant like ``SERVE_FORWARD_FAULT``), plus the
    ``fault_point=`` routing idiom of ``resilience.atomic_path`` /
    ``atomic_write`` (both the call-site keyword strings and the
    parameter defaults).  With ``arms=True`` it instead collects
    ``faults.arm``/``arm_hang`` call points — the test/tool side, used
    to catch typo'd armings that would silently never fire.
    """
    modules, _ = _load_modules(paths, cache=cache)
    consts, _ = _collect_constants(modules)
    methods = _FAULT_ARMS if arms else _FAULT_READS
    out = {}

    def add(name, mod, line, via):
        out.setdefault(name, []).append((mod.path, line, via))

    for mod in modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                func = node.func
                if isinstance(func, ast.Attribute) and \
                        func.attr in methods and node.args:
                    name = _resolve_env_name(node.args[0], consts)
                    if name:
                        add(name, mod, node.lineno, func.attr)
                if not arms:
                    for kw in node.keywords:
                        if kw.arg == "fault_point" and \
                                isinstance(kw.value, ast.Constant) and \
                                isinstance(kw.value.value, str):
                            add(kw.value.value, mod, node.lineno,
                                "fault_point=")
            elif not arms and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for name, line in _param_string_defaults(
                        node, "fault_point"):
                    add(name, mod, line, "fault_point=")
    return out


def lint_paths(paths, env_registry=None, select=None, cache=None):
    """Run every AST rule over ``paths`` (files or directories).

    ``env_registry``: extra registered env names to union with the
    ``register_env`` calls found statically in the scanned tree (pass
    ``set(mxnet_tpu.base.ENV_REGISTRY)`` when linting files outside the
    package, e.g. tools/).  ``select``: restrict to a subset of RULES.
    ``cache``: shared ``{path: _Module}`` parse cache (see
    :func:`load_modules`).
    """
    rules = set(RULES if select is None else select)
    report = Report(tool="mxlint.ast")
    modules, broken = _load_modules(paths, cache=cache)
    report.files_scanned = len(modules)
    for path, err in broken:
        report.add("parse-error", "cannot parse: %s" % (err,), file=path)
    consts, registered = _collect_constants(modules)
    if env_registry:
        registered |= set(env_registry)
    for mod in modules:
        if "env-direct-read" in rules or "env-unregistered" in rules:
            _lint_env(mod, consts, registered, report)
        if "traced-host-call" in rules:
            _lint_traced_host(mod, report)
        if "bare-except" in rules:
            _lint_bare_except(mod, report)
    if "lock-order" in rules:
        _lint_locks(modules, report)
    if select is not None:
        report.findings = [f for f in report.findings
                           if f.rule in rules or f.rule == "parse-error"]
    return report
