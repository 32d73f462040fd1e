#!/usr/bin/env python
"""mxlint — static analyzer for the mxnet_tpu_torch tree (the port's
counterpart of ``tools/mxlint.py``: the same flags, exit codes and JSON
report).

Level 2 (AST) runs always: host calls in captured functions, lock-order
cycles, bare excepts, and env-registry discipline over the given paths
(default: the ``mxnet_tpu_torch`` package, ``chip_smoke.py`` and the
port's tests ``tests/test_torch_*.py``).
Level 3 (whole-repo) also runs always: the shared-mutation race lint
(``repo-shared-mutation`` / ``repo-check-then-act``) and the
wire-contract drift lint (``wire-contract-drift``, driven by the
declared surface registry in ``contract_lint.py``).
Level 1 (graph) is opt-in via ``--graph``: builds the standard MLP
``SPMDTrainer`` on one device (``--context``, default ``cpu``) and lints
one step's dispatched work — carries written in place, host syncs, the
collective audit, dtype drift.  The only mode that imports torch.

Exit codes: 0 = clean, 1 = findings, 2 = internal/usage error.

Reports: human lines on stdout; ``--json PATH`` (or the
``MXTPU_ANALYZE_REPORT`` env var) writes the stable machine-readable
report.  Suppress a finding inline with ``# mxlint: disable=<rule>`` on
(or above) the offending line.

    python mxnet_tpu_torch/analysis/mxlint_main.py          # the tree
    python mxnet_tpu_torch/analysis/mxlint_main.py --changed
    python mxnet_tpu_torch/analysis/mxlint_main.py --graph \\
        --context "gpu(0)" --json r.json
"""
from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import subprocess
import sys
import time
import types

_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_ANALYSIS_DIR)
_REPO = os.path.dirname(_PKG)


def _load_ast_level():
    """Load report.py + the lint passes by file path under a synthetic
    package, WITHOUT importing mxnet_tpu_torch: the AST and whole-repo
    levels are stdlib-only, and this CLI must run (and stay
    side-effect-free) where torch is missing or would cost seconds to
    import."""
    pkg = types.ModuleType("_mxlint_torch_analysis")
    pkg.__path__ = [_ANALYSIS_DIR]
    sys.modules.setdefault("_mxlint_torch_analysis", pkg)

    def load(modname):
        fullname = "_mxlint_torch_analysis." + modname
        if fullname in sys.modules:
            return sys.modules[fullname]
        spec = importlib.util.spec_from_file_location(
            fullname, os.path.join(_ANALYSIS_DIR, modname + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[fullname] = mod
        spec.loader.exec_module(mod)
        return mod

    load("report")
    return load("ast_lint"), load("race_lint"), load("contract_lint")


def _parse_context(text):
    """``cpu`` / ``gpu(0)`` / ``gpu:0`` -> (device type, id)."""
    text = text.strip().replace(" ", "")
    for sep in ("(", ":"):
        if sep in text:
            name, idx = text.split(sep, 1)
            return name, int(idx.rstrip(")") or 0)
    return text, 0


def _graph_lint_mlp(context):
    """Build the standard 2-layer MLP step on one device and lint it (the
    model the tier-1 tests pin) — proving the shipped trainer's step
    writes its carries in place, syncs nothing to the host and runs no
    collective.  The ONLY mode that imports the package (and torch)."""
    if _REPO not in sys.path:
        sys.path.insert(0, _REPO)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.analysis import fixtures

    name, idx = _parse_context(context)
    trainer = fixtures.standard_mlp_trainer(ctx=mx.Context(name, idx))
    try:
        return trainer.analyze(*fixtures.standard_mlp_batch())
    finally:
        trainer.close()


def _default_paths():
    """The lint scope: the package, the chip smoke and the port's
    tests."""
    return [_PKG, os.path.join(_REPO, "chip_smoke.py")] + sorted(
        glob.glob(os.path.join(_REPO, "tests", "test_torch_*.py")))


def _changed_paths(ref):
    """Python files changed vs ``ref`` per git (the pre-commit loop's
    sub-second scope).  Returns None when not in a git checkout (caller
    falls back to the full tree)."""
    try:
        out = subprocess.run(
            ["git", "diff", "--name-only", ref, "--", "*.py"],
            cwd=_REPO, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    paths = []
    for line in out.stdout.splitlines():
        full = os.path.join(_REPO, line.strip())
        if line.strip() and os.path.isfile(full):
            paths.append(full)
    return paths


def _grep(path, needles):
    try:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return False
    return any(n in text for n in needles)


def _mentions_env(paths):
    """Cheap text probe: does any changed file touch the env-registry
    machinery (the only rules that need the package-wide registry)?"""
    return any(_grep(p, ("get_env", "getenv", "environ", "register_env"))
               for p in paths)


def _registry_sources():
    """Package files that can declare env knobs (contain a
    ``register_env`` call)."""
    out = []
    for root, _dirs, files in os.walk(_PKG):
        for name in files:
            if name.endswith(".py"):
                full = os.path.join(root, name)
                if _grep(full, ("register_env",)):
                    out.append(full)
    return out


def _touches_surfaces(contract_lint, paths):
    """Does any changed file participate in a declared wire surface
    (producer, consumer, or the fault namespace, which spans the whole
    tree)?"""
    refs = set()
    for surface in contract_lint.repo_registry():
        if surface.kind == "faults":
            return bool(paths)
        for relpath, _q in tuple(surface.producers) + tuple(
                surface.consumers):
            refs.add(os.path.normpath(os.path.join(_REPO, relpath)))
    return any(os.path.normpath(os.path.abspath(p)) in refs
               for p in paths)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="mxlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("paths", nargs="*",
                        help="files/directories to lint (default: the "
                             "mxnet_tpu_torch package, chip_smoke.py and "
                             "tests/test_torch_*.py)")
    parser.add_argument("--self", dest="lint_self", action="store_true",
                        help="lint the linter (this CLI and the analysis "
                             "package) along with the paths")
    parser.add_argument("--changed", nargs="?", const="HEAD",
                        default=None, metavar="REF",
                        help="lint only .py files in `git diff "
                             "--name-only REF` (default HEAD); falls "
                             "back to the full tree outside a git "
                             "checkout")
    parser.add_argument("--graph", action="store_true",
                        help="also graph-lint the standard MLP step "
                             "(imports torch, runs one step)")
    parser.add_argument("--context", default="cpu",
                        help="device of the --graph step: cpu (default) "
                             "or gpu(0)")
    parser.add_argument("--json", dest="json_path", default=None,
                        help="write the machine-readable report here "
                             "(default: $MXTPU_ANALYZE_REPORT if set)")
    parser.add_argument("--select", "--rules", dest="select",
                        default=None,
                        help="comma-separated rule subset to run")
    parser.add_argument("--list-faults", action="store_true",
                        help="print the fault-point registry (every "
                             "statically resolvable faults.maybe_* "
                             "site under the paths) and exit")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="suppress the human report (exit code and "
                             "--json only)")
    args = parser.parse_args(argv)

    t0 = time.monotonic()
    try:
        ast_lint, race_lint, contract_lint = _load_ast_level()
    except Exception as e:  # noqa: BLE001 — report, don't traceback
        sys.stderr.write("mxlint: cannot load the analysis modules: %s\n"
                         % (e,))
        return 2

    paths = list(args.paths)
    if not paths:
        paths = _default_paths()
    changed_mode = False
    if args.changed is not None and not args.paths:
        changed = _changed_paths(args.changed)
        if changed is not None:
            paths = changed
            changed_mode = True
    if args.list_faults:
        points = ast_lint.collect_fault_points(paths)
        for name in sorted(points):
            sites = ", ".join(
                "%s:%d" % (os.path.relpath(f, _REPO), line)
                for f, line, _ in points[name])
            print("%-22s %s" % (name, sites))
        print("mxlint: %d fault point(s)" % len(points))
        return 0
    if args.lint_self:
        paths.append(_ANALYSIS_DIR)

    all_rules = tuple(ast_lint.RULES) + tuple(race_lint.RULES) + \
        tuple(contract_lint.RULES)
    select = None
    if args.select:
        select = [r.strip() for r in args.select.split(",") if r.strip()]
        unknown = set(select) - set(all_rules)
        if unknown:
            sys.stderr.write("mxlint: unknown rule(s) %s (known: %s)\n"
                             % (sorted(unknown), ", ".join(all_rules)))
            return 2

    # one parse per file, shared by every pass; the env registry is
    # collected STATICALLY from the package (register_env literals), so
    # linting files outside it still knows every declared knob
    cache = {}
    registry = None
    if not changed_mode:
        registry = ast_lint.collect_registered([_PKG], cache=cache)
    elif _mentions_env(paths):
        registry = ast_lint.collect_registered(
            _registry_sources(), cache=cache)

    report = ast_lint.lint_paths(paths, env_registry=registry,
                                 select=select, cache=cache)
    extras = [race_lint.lint_paths(paths, select=select, cache=cache)]
    if not changed_mode or _touches_surfaces(contract_lint, paths):
        extras.append(contract_lint.lint_paths(paths, select=select,
                                               cache=cache))
    for extra in extras:
        extra.files_scanned = 0       # same files, already counted
        report.merge(extra)
    if args.graph:
        try:
            report.merge(_graph_lint_mlp(args.context))
        except Exception as e:  # noqa: BLE001 — device bring-up varies
            sys.stderr.write("mxlint: graph level failed to run: %s\n"
                             % (e,))
            return 2
    elapsed = time.monotonic() - t0

    # read directly: this CLI must not import the package for get_env
    json_path = args.json_path or \
        os.environ.get("MXTPU_ANALYZE_REPORT")  # mxlint: disable=env-direct-read
    if json_path:
        payload = report.to_dict()
        # timing lives OUTSIDE the diffable findings/summary contract
        payload["elapsed_s"] = round(elapsed, 3)
        with open(json_path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
    if not args.quiet:
        print(report.format_text())
        print("mxlint: %.2fs" % elapsed)
    return 1 if report.findings else 0


if __name__ == "__main__":
    sys.exit(main())
