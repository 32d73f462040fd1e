"""Finding/Report containers shared by every analyzer level (port of
``mxnet_tpu/analysis/report.py``; the same JSON for the same findings).

Stdlib-only on purpose: ``analysis/mxlint_main.py`` and the AST level
must stay importable and fast where no torch or CUDA exists (pre-commit
hooks, CI containers).

The JSON report format is a STABLE contract (``REPORT_VERSION``): CI and
bench diff reports across commits, so findings are emitted in a
deterministic order and no timing/host-specific data lives inside the
``findings`` array.
"""
from __future__ import annotations

import json

__all__ = ["Finding", "Report", "REPORT_VERSION"]

#: bump only with a migration note in docs/how_to/static_analysis.md
REPORT_VERSION = 1

_SEVERITIES = ("error", "warning")


class Finding(object):
    """One rule violation.

    ``rule`` is the stable kebab-case identifier (what inline
    suppressions name), ``message`` the human line, ``file``/``line`` the
    anchor when the rule has one (AST rules always do; graph rules point
    at the Python frame that dispatched the op when one is known), and ``data``
    an optional JSON-serializable dict for machine consumers (byte
    counts, op tallies).
    """

    __slots__ = ("rule", "message", "file", "line", "severity", "data")

    def __init__(self, rule, message, file=None, line=None,
                 severity="error", data=None):
        if severity not in _SEVERITIES:
            raise ValueError("severity must be one of %s" % (_SEVERITIES,))
        self.rule = rule
        self.message = message
        self.file = file
        self.line = None if line is None else int(line)
        self.severity = severity
        self.data = data

    def sort_key(self):
        return (self.file or "", self.line or 0, self.rule, self.message)

    def to_dict(self):
        out = {"rule": self.rule, "severity": self.severity,
               "message": self.message}
        if self.file is not None:
            out["file"] = self.file
        if self.line is not None:
            out["line"] = self.line
        if self.data is not None:
            out["data"] = self.data
        return out

    def __repr__(self):
        loc = ""
        if self.file:
            loc = "%s:%s: " % (self.file, self.line if self.line else "?")
        return "%s[%s] %s" % (loc, self.rule, self.message)


class Report(object):
    """An ordered collection of findings plus scan metadata."""

    def __init__(self, tool="mxlint"):
        self.tool = tool
        self.findings = []
        self.files_scanned = 0
        self.stats = {}   # free-form machine data (collective tallies...)

    def add(self, *args, **kwargs):
        """``add(finding)`` or ``add(rule, message, ...)``."""
        if len(args) == 1 and isinstance(args[0], Finding) and not kwargs:
            self.findings.append(args[0])
        else:
            self.findings.append(Finding(*args, **kwargs))
        return self

    def extend(self, findings):
        for f in findings:
            self.add(f)
        return self

    def merge(self, other):
        self.findings.extend(other.findings)
        self.files_scanned += other.files_scanned
        for k, v in other.stats.items():
            self.stats.setdefault(k, v)
        return self

    @property
    def errors(self):
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self):
        return [f for f in self.findings if f.severity == "warning"]

    def by_rule(self):
        out = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))

    @property
    def ok(self):
        return not self.findings

    def to_dict(self):
        return {
            "report_version": REPORT_VERSION,
            "tool": self.tool,
            "files_scanned": self.files_scanned,
            "summary": {"findings": len(self.findings),
                        "errors": len(self.errors),
                        "warnings": len(self.warnings),
                        "by_rule": self.by_rule()},
            "stats": self.stats,
            "findings": [f.to_dict()
                         for f in sorted(self.findings,
                                         key=Finding.sort_key)],
        }

    def to_json(self, indent=2):
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def format_text(self):
        """Human-readable listing, one line per finding."""
        lines = []
        for f in sorted(self.findings, key=Finding.sort_key):
            lines.append(repr(f))
        lines.append("%d file(s) scanned, %d finding(s) (%d error, "
                     "%d warning)" % (self.files_scanned,
                                      len(self.findings),
                                      len(self.errors),
                                      len(self.warnings)))
        return "\n".join(lines)
