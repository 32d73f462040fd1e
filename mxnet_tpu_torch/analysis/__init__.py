"""mxlint — static analysis for the step's dispatched work and the
repo's own concurrency/knob invariants (port of ``mxnet_tpu/analysis``).

Three levels, as in the JAX package:

- :mod:`~mxnet_tpu_torch.analysis.graph_lint` — lint one step's record
  of dispatched work (carries written in place, host syncs, a collective
  audit, dtype drift, kernels launched outside an autograd.Function).
  Runs at the first step inside ``SPMDTrainer`` and at the first forward
  of each serving signature when ``MXTPU_ANALYZE=1`` (warn) or
  ``strict`` (raise), and on demand via ``SPMDTrainer.analyze`` /
  ``PooledModel.analyze`` / :func:`graph_lint.lint_step`.
- :mod:`~mxnet_tpu_torch.analysis.ast_lint` — AST rules over the source
  tree (host calls in captured functions, lock-order cycles, bare
  excepts, env-registry discipline).  ``mxlint_main.py`` is the CLI.
- level 3, cross-module: :mod:`~mxnet_tpu_torch.analysis.race_lint` and
  :mod:`~mxnet_tpu_torch.analysis.contract_lint`.  Same CLI, same
  suppression syntax (``# mxlint: disable=<rule>``).

Every pass module but ``graph_lint``'s recorder is stdlib-only, so the
CLI's AST and whole-repo levels run without torch.
"""
from __future__ import annotations

from ..base import register_env
from .report import Finding, Report, REPORT_VERSION
from . import ast_lint
from . import contract_lint
from . import fixtures
from . import graph_lint
from . import race_lint

__all__ = ["Finding", "Report", "REPORT_VERSION", "ast_lint",
           "contract_lint", "fixtures", "graph_lint", "race_lint",
           "ENV_ANALYZE", "ENV_ANALYZE_REPORT"]

ENV_ANALYZE = register_env(
    "MXTPU_ANALYZE",
    doc="1 runs the graph lint at the first step inside SPMDTrainer and "
        "at each new serving signature and warns on findings; 'strict' "
        "raises MXNetError instead")
ENV_ANALYZE_REPORT = register_env(
    "MXTPU_ANALYZE_REPORT", scope="tools",
    doc="Path for the machine-readable JSON report written by "
        "mxnet_tpu_torch/analysis/mxlint_main.py (same as --json)")
