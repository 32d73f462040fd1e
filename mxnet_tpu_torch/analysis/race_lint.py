"""Level-3 static analysis, pass 1: whole-repo shared-mutation lint (port
of ``mxnet_tpu/analysis/race_lint.py``, rule for rule and message for
message).

The fleet/serving/resilience tier is a dozen modules of threads mutating
shared dicts, and until now only lock-order *cycles* were linted — not
lock *coverage*.  This pass closes that gap with two rules (pure stdlib,
same CLI/suppression discipline as :mod:`ast_lint`):

- ``repo-shared-mutation``: for every class that owns a thread root
  (``threading.Thread(target=self.m)``, ``Timer``, an HTTP handler
  method calling into it, a ``Supervisor`` callback), compute which
  ``self.<attr>`` each concurrency domain COMPOUND-mutates (``+=``,
  ``d[k] = v``, ``.append``/``.update``/``.pop``/...), intersect the
  domains, and flag any mutation not covered by a held lock.  Plain
  rebinds (``self.x = expr``) are exempt — a single reference store is
  atomic under the GIL; it is the read-modify-write forms that interleave.
- ``repo-check-then-act``: ``if k in self.d: ... self.d[k]`` sequences
  on a shared attr outside a lock — the gap between the test and the
  act is where another thread deletes the key.

Design notes (what keeps the pass honest on this tree):

- **Aliases**: ``view = self._views.get(rid)`` followed by
  ``view.probes += 1`` mutates ``self._views``'s contents; a per-
  function alias map tracks one level of derivation (subscript,
  ``.get``, ``for ... in self.d.items()``), so the router's per-replica
  counter bumps are seen.
- **Transitive lock coverage**: ``check_once`` doing ``with self._lock:
  return self._check_locked(...)`` protects every mutation inside
  ``_check_locked`` (and its callees) — a private method is *protected*
  when every same-class call site holds a lock or sits in a protected
  method (a fixed point, same spirit as ``_LockScan``'s transitive
  acquisition sets).
- **Thread-safe types are not shared state**: attrs initialized to
  ``threading.Event``/``Condition``/``Semaphore``/``queue.Queue`` (and
  the locks themselves) are internally synchronized and never flagged.
"""
from __future__ import annotations

import ast

from .report import Report
from .ast_lint import load_modules

__all__ = ["lint_modules", "lint_paths", "RULES"]

RULES = ("repo-shared-mutation", "repo-check-then-act")

#: container methods that mutate the receiver in place
_MUTATORS = frozenset((
    "append", "appendleft", "add", "insert", "extend", "update",
    "pop", "popitem", "remove", "discard", "clear", "setdefault",
    "sort", "reverse",
))

#: constructors whose instances synchronize internally (never "shared
#: mutable state" for this rule); Lock/RLock/Condition double as locks
_SAFE_CTORS = frozenset((
    "Lock", "RLock", "Event", "Condition", "Semaphore",
    "BoundedSemaphore", "Barrier", "local", "Queue", "LifoQueue",
    "PriorityQueue", "SimpleQueue",
))
_LOCK_CTORS = frozenset(("Lock", "RLock", "Condition"))

#: keyword names whose ``self.m`` value is a callback invoked from a
#: foreign thread (Thread/Timer targets, Supervisor's on_exit, ...)
_CALLBACK_KWARGS = frozenset(("target", "function", "on_exit",
                              "callback", "cb"))


def _callee_name(func):
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _is_self_attr(node):
    return isinstance(node, ast.Attribute) and \
        isinstance(node.value, ast.Name) and node.value.id == "self"


class _ClassInfo(object):
    """One class's methods, locks, and thread-safe attrs."""

    def __init__(self, mod, node):
        self.mod = mod
        self.node = node
        self.name = node.name
        self.methods = {}
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[item.name] = item
        self.locks = set()
        self.safe_attrs = set()
        for sub in ast.walk(node):
            if not (isinstance(sub, ast.Assign) and
                    len(sub.targets) == 1 and
                    _is_self_attr(sub.targets[0])):
                continue
            value = sub.value
            if isinstance(value, ast.Call):
                ctor = _callee_name(value.func)
                if ctor in _LOCK_CTORS:
                    self.locks.add(sub.targets[0].attr)
                if ctor in _SAFE_CTORS:
                    self.safe_attrs.add(sub.targets[0].attr)
            elif isinstance(value, (ast.List, ast.Tuple, ast.ListComp)):
                # a container OF synchronized objects (the prefetcher's
                # [threading.Event() ...] handshake lists) is itself
                # only ever indexed, each element synchronizing
                elts = [value.elt] if isinstance(value, ast.ListComp) \
                    else value.elts
                if elts and all(
                        isinstance(e, ast.Call) and
                        _callee_name(e.func) in _SAFE_CTORS
                        for e in elts):
                    self.safe_attrs.add(sub.targets[0].attr)

    def is_handler(self):
        """An HTTP request handler: its do_* methods run on server
        threads and whatever they call into runs there too."""
        for base in self.node.bases:
            name = _callee_name(base) or ""
            if name.endswith("HTTPRequestHandler"):
                return True
        return False


class _Facts(object):
    """What one function does: mutations, reads, same-class calls,
    check-then-act sites — each tagged with whether a lock was held."""

    __slots__ = ("mutations", "reads", "calls", "cta")

    def __init__(self):
        self.mutations = []   # (attr, line, locked, how)
        self.reads = set()    # attr names touched (read OR written)
        self.calls = []       # (method name, line, locked)
        self.cta = []         # (attr, line, locked)

    @property
    def touched(self):
        return self.reads | {m[0] for m in self.mutations}


def _lockish(expr, cls):
    """Is a ``with`` context expression a lock?  ``self.X`` for a known
    class lock, else any name/attr that *looks* like one (``_lock``,
    ``router._lock`` — cross-object locking is deliberate in this tree
    and still counts as "a lock is held")."""
    e = expr
    if isinstance(e, ast.Call):
        e = e.func
    if _is_self_attr(e) and e.attr in cls.locks:
        return True
    if isinstance(e, ast.Attribute):
        return "lock" in e.attr.lower() or e.attr in ("mu", "mutex")
    if isinstance(e, ast.Name):
        return "lock" in e.id.lower() or e.id in ("mu", "mutex")
    return False


def _scan_function(fn, cls, skip_defs, aliases=None):
    """Collect :class:`_Facts` for one function body.

    ``skip_defs``: nested defs that are thread roots — scanned
    separately as their own domains, not as part of this body.
    ``aliases`` seeds the alias map (a nested root inherits its
    enclosing function's aliases — closure variables still refer to the
    same objects on the new thread).
    """
    facts = _Facts()
    aliases = dict(aliases or {})
    fresh = set()   # attrs (re)constructed in THIS function: stores
    #                 that follow are initialization, not sharing

    def base_attr(expr):
        """The ``self`` attr an expression reads from / derives from:
        ``self.a``/``self.a[k]``/``self.a.b``/``alias[k]`` -> ``a``.
        Calls are only peeled through element ACCESSORS (``.get``,
        ``.items``, ...) — an arbitrary method call returns a fresh
        object, not a view into the attr."""
        e = expr
        chain = []
        while True:
            if isinstance(e, ast.Subscript):
                e = e.value
            elif isinstance(e, ast.Call):
                func = e.func
                if isinstance(func, ast.Name) and \
                        func.id in ("list", "tuple", "sorted") and \
                        e.args:
                    # element-preserving wrappers: list(d.items())
                    # still yields the live values
                    e = e.args[0]
                    continue
                if not (isinstance(func, ast.Attribute) and func.attr
                        in ("get", "setdefault", "items", "values",
                            "keys")):
                    return None
                e = func
            elif isinstance(e, ast.Attribute):
                chain.append(e.attr)
                e = e.value
            else:
                break
        if isinstance(e, ast.Name):
            if e.id == "self" and chain:
                return chain[-1]
            if e.id in aliases:
                return aliases[e.id]
        return None

    def bind_names(target, attr):
        for node in ast.walk(target):
            if isinstance(node, ast.Name):
                aliases[node.id] = attr

    def note_reads(node):
        for sub in ast.walk(node):
            if _is_self_attr(sub):
                facts.reads.add(sub.attr)

    def mutation(attr, node, locked, how):
        if attr is not None and attr not in fresh:
            facts.mutations.append((attr, node.lineno, locked, how))

    def scan_if(node, locked):
        """``if k in self.d: ... self.d[k] ...`` — same attr, same key
        expression, no lock between the test and the act."""
        test = node.test
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.ops[0], (ast.In, ast.NotIn))):
            return
        attr = base_attr(test.comparators[0])
        if attr is None:
            return
        key = ast.dump(test.left)
        for stmt in node.body + node.orelse:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Subscript) and \
                        base_attr(sub.value) == attr and \
                        ast.dump(sub.slice) == key:
                    facts.cta.append((attr, node.lineno, locked))
                    return

    def walk(node, locked):
        if isinstance(node, ast.With):
            note_reads(node.items[0].context_expr)
            got = locked or any(_lockish(item.context_expr, cls)
                                for item in node.items)
            for child in node.body:
                walk(child, got)
            return
        if isinstance(node, ast.Assign):
            note_reads(node.value)
            src = base_attr(node.value)
            for target in node.targets:
                if _is_self_attr(target) and isinstance(
                        node.value, (ast.Call, ast.Dict, ast.List,
                                     ast.ListComp, ast.DictComp,
                                     ast.Set, ast.Tuple)):
                    # self.x = <fresh object>: later stores into it in
                    # this function configure the new object before
                    # anything else can have grabbed a reference
                    fresh.add(target.attr)
                elif isinstance(target, ast.Name) and src is not None:
                    aliases[target.id] = src
                elif isinstance(target, ast.Subscript):
                    mutation(base_attr(target.value), node, locked,
                             "[...] = store")
                elif isinstance(target, ast.Attribute) and \
                        not _is_self_attr(target):
                    # x.field = v on an alias / chained attr; a DIRECT
                    # self.x = v is a plain (atomic) rebind — exempt
                    mutation(base_attr(target.value), node, locked,
                             ".%s = store" % target.attr)
                elif isinstance(target, (ast.Tuple, ast.List)) and \
                        src is not None:
                    bind_names(target, src)
            note_reads(node)
            return
        if isinstance(node, ast.AugAssign):
            note_reads(node)
            target = node.target
            if _is_self_attr(target):
                mutation(target.attr, node, locked,
                         "augmented assign (read-modify-write)")
            elif isinstance(target, (ast.Subscript, ast.Attribute)):
                mutation(base_attr(target.value), node, locked,
                         "augmented assign (read-modify-write)")
            return
        if isinstance(node, ast.Delete):
            for target in node.targets:
                if isinstance(target, (ast.Subscript, ast.Attribute)) \
                        and not _is_self_attr(target):
                    mutation(base_attr(target.value), node, locked,
                             "del")
            note_reads(node)
            return
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute):
                if _is_self_attr(func):
                    facts.calls.append((func.attr, node.lineno, locked))
                elif func.attr in _MUTATORS:
                    mutation(base_attr(func.value), node, locked,
                             ".%s()" % func.attr)
            note_reads(node)
            for child in ast.iter_child_nodes(node):
                walk(child, locked)
            return
        if isinstance(node, ast.For):
            note_reads(node.iter)
            src = base_attr(node.iter)
            if src is not None:
                bind_names(node.target, src)
            for child in node.body + node.orelse:
                walk(child, locked)
            return
        if isinstance(node, ast.If):
            scan_if(node, locked)
            note_reads(node.test)
            walk(node.test, locked)
            for child in node.body + node.orelse:
                walk(child, locked)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node in skip_defs:
                return
            # a nested def runs later (callback) — locks held NOW are
            # not held THEN
            for child in node.body:
                walk(child, False)
            return
        if isinstance(node, ast.Lambda):
            walk(node.body, False)
            return
        if _is_self_attr(node):
            facts.reads.add(node.attr)
        for child in ast.iter_child_nodes(node):
            walk(child, locked)

    for child in fn.body:
        walk(child, False)
    return facts, aliases


class _ClassScan(object):
    """Concurrency-domain analysis of one class."""

    def __init__(self, cls, handler_roots):
        self.cls = cls
        # thread roots: {entry id: (display name, function node,
        #                           inherited aliases or None)}
        self.roots = {}
        self._nested_roots = set()
        self._discover_roots(handler_roots)
        self.facts = {}
        self._enclosing_aliases = {}
        for name, fn in cls.methods.items():
            facts, aliases = _scan_function(fn, cls, self._nested_roots)
            self.facts[name] = (facts, fn)
            self._enclosing_aliases[name] = aliases
        for entry, (label, fn, encl) in list(self.roots.items()):
            if entry in self.facts:
                continue
            seed = self._enclosing_aliases.get(encl, {})
            facts, _ = _scan_function(fn, cls, self._nested_roots,
                                      aliases=seed)
            self.facts[entry] = (facts, fn)

    def _discover_roots(self, handler_roots):
        cls = self.cls
        for mname, method in cls.methods.items():
            nested = {n.name: n for n in ast.walk(method)
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
                      and n is not method}
            for node in ast.walk(method):
                if not isinstance(node, ast.Call):
                    continue
                callee = _callee_name(node.func)
                targets = []
                if callee == "Thread":
                    targets = [kw.value for kw in node.keywords
                               if kw.arg == "target"] or node.args[:1]
                elif callee == "Timer":
                    targets = [kw.value for kw in node.keywords
                               if kw.arg == "function"] or \
                        node.args[1:2]
                else:
                    targets = [kw.value for kw in node.keywords
                               if kw.arg in _CALLBACK_KWARGS]
                for tgt in targets:
                    if _is_self_attr(tgt) and tgt.attr in cls.methods:
                        self.roots.setdefault(tgt.attr,
                                              (tgt.attr,
                                               cls.methods[tgt.attr],
                                               None))
                    elif isinstance(tgt, ast.Name) and \
                            tgt.id in nested:
                        entry = "%s.<%s>" % (mname, tgt.id)
                        self.roots.setdefault(
                            entry, (entry, nested[tgt.id], mname))
                        self._nested_roots.add(nested[tgt.id])
        for mname in handler_roots:
            if mname in cls.methods:
                self.roots.setdefault(
                    mname, ("%s (via HTTP handler)" % mname,
                            cls.methods[mname], None))
        if cls.is_handler():
            for mname in cls.methods:
                if mname.startswith("do_"):
                    self.roots.setdefault(
                        mname, (mname, cls.methods[mname], None))

    # -- call graph / domains ---------------------------------------------

    def _closure(self, entries):
        seen = set()
        frontier = list(entries)
        while frontier:
            name = frontier.pop()
            if name in seen or name not in self.facts:
                continue
            seen.add(name)
            for callee, _line, _locked in self.facts[name][0].calls:
                if callee not in seen:
                    frontier.append(callee)
        return seen

    def domains(self):
        """``[(label, member function ids)]`` — one per thread root
        plus the external ("main") domain spanning the public API."""
        out = []
        for entry, (label, _fn, _encl) in sorted(self.roots.items()):
            out.append(("thread:%s" % label, self._closure([entry])))
        public = [m for m in self.cls.methods
                  if not m.startswith("_")]
        members = self._closure(public)
        if members:
            out.append(("main", members))
        return out

    def protected(self):
        """Private methods whose every same-class call site holds a
        lock (directly, or via an already-protected caller) — their
        bodies run under the caller's lock, the fixed point of the
        check_once -> _check_locked -> _promote idiom."""
        sites = {}
        for caller, (facts, _fn) in self.facts.items():
            for callee, _line, locked in facts.calls:
                sites.setdefault(callee, []).append((caller, locked))
        prot = set()
        changed = True
        while changed:
            changed = False
            for name in self.facts:
                if name in prot or not name.startswith("_") or \
                        name in self.roots or name not in sites:
                    continue
                if all(locked or caller in prot
                       for caller, locked in sites[name]):
                    prot.add(name)
                    changed = True
        return prot


def _handler_roots(classes):
    """Method names that HTTP handler classes in this module call on
    OTHER objects — server threads enter the owning class there
    (``_Handler.do_GET`` -> ``rt.stats_payload()``)."""
    out = set()
    for cls in classes:
        if not cls.is_handler():
            continue
        for node in ast.walk(cls.node):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and not \
                    _is_self_attr(node.func):
                out.add(node.func.attr)
    return out


def _lint_module(mod, report, rules):
    classes = [_ClassInfo(mod, node) for node in ast.walk(mod.tree)
               if isinstance(node, ast.ClassDef)]
    handler_roots = _handler_roots(classes)
    for cls in classes:
        scan = _ClassScan(cls, handler_roots)
        if not scan.roots:
            continue
        domains = scan.domains()
        if len(domains) < 2:
            # fewer than two concurrency domains: nothing interleaves
            continue
        prot = scan.protected()
        access = {}
        for label, members in domains:
            for member in members:
                for attr in scan.facts[member][0].touched:
                    access.setdefault(attr, set()).add(label)
        fn_domains = {}
        for label, members in domains:
            for member in members:
                fn_domains.setdefault(member, set()).add(label)

        def shared_with(fname, attr):
            """Domains that can interleave with ``fname`` on ``attr``
            (empty = not actually shared).  A function reachable from
            two domains interleaves with itself."""
            mine = fn_domains.get(fname, set())
            if not mine:
                return set()
            everywhere = access.get(attr, set()) | mine
            others = everywhere - mine
            if len(mine) >= 2 and \
                    any(d.startswith("thread:") for d in mine):
                return everywhere - {sorted(mine)[0]}
            if others and \
                    any(d.startswith("thread:") for d in everywhere):
                return others
            return set()

        for fname, (facts, _fn) in scan.facts.items():
            if "repo-shared-mutation" in rules:
                for attr, line, locked, how in facts.mutations:
                    if locked or attr in cls.locks or \
                            attr in cls.safe_attrs or fname in prot:
                        continue
                    others = shared_with(fname, attr)
                    if not others:
                        continue
                    if mod.suppressed(line, "repo-shared-mutation"):
                        continue
                    report.add(
                        "repo-shared-mutation",
                        "%s.%s mutates self.%s (%s) with no lock held "
                        "— the attr is also touched from %s; guard it "
                        "with the class lock (see docs/how_to/"
                        "static_analysis.md level 3)"
                        % (cls.name, fname, attr, how,
                           ", ".join(sorted(others))),
                        file=mod.path, line=line)
            if "repo-check-then-act" in rules:
                for attr, line, locked in facts.cta:
                    if locked or attr in cls.locks or \
                            attr in cls.safe_attrs or fname in prot:
                        continue
                    others = shared_with(fname, attr)
                    if not others:
                        continue
                    if mod.suppressed(line, "repo-check-then-act"):
                        continue
                    report.add(
                        "repo-check-then-act",
                        "%s.%s tests membership in self.%s and then "
                        "indexes it outside any lock — %s can mutate "
                        "the dict between the check and the act; take "
                        "the lock around both (or .get() once)"
                        % (cls.name, fname, attr,
                           ", ".join(sorted(others))),
                        file=mod.path, line=line)


def lint_modules(modules, select=None):
    """Run the race rules over pre-parsed modules (see
    :func:`ast_lint.load_modules`)."""
    rules = set(RULES if select is None else select) & set(RULES)
    report = Report(tool="mxlint.race")
    report.files_scanned = len(modules)
    if not rules:
        return report
    for mod in modules:
        _lint_module(mod, report, rules)
    return report


def lint_paths(paths, select=None, cache=None):
    """Convenience: load ``paths`` and run :func:`lint_modules`."""
    modules, broken = load_modules(paths, cache=cache)
    report = lint_modules(modules, select=select)
    for path, err in broken:
        report.add("parse-error", "cannot parse: %s" % (err,), file=path)
    return report
