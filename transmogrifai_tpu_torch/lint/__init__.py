"""opcheck: static workflow analyzer — typed-DAG verification, (the port's copy of
``transmogrifai_tpu/lint/__init__.py``)
leakage/skew detection, and AST-based stage purity lints.

The Scala reference gets feature-engineering type safety from the
compiler; this package restores that guarantee for the Python port
WITHOUT fitting anything: ``lint_workflow`` proves DAG properties
(types, cycles, duplicates, response leakage, retrace hazards) and
parses stage source for purity violations the parallel executor
turns from slow paths into silent-corruption bugs.

Entry points::

    from transmogrifai_tpu_torch.lint import lint_workflow
    report = lint_workflow(workflow)        # LintReport
    report.has_errors, report.format_text(), report.as_dict()

CLI: ``python -m transmogrifai_tpu_torch lint --project proj/`` (exits
non-zero on error-severity findings — the CI gate). Train gate:
``TM_LINT=strict|warn|off`` (default off). Diagnostic catalog:
docs/LINT.md.
"""
from .analyzer import (LINT_MODES, lint_artifact, lint_model,
                       lint_workflow, preflight, resolve_lint_mode)
from .ast_checks import (TRANSFORM_METHODS, analyze_source,
                         analyze_stage_class, analyze_stages)
from .diagnostics import (CATALOG, Diagnostic, LintError, LintReport,
                          ERROR, INFO, WARNING)
from .graph import analyze_graph, check_export_manifest

__all__ = [
    "CATALOG", "Diagnostic", "LintError", "LintReport",
    "ERROR", "WARNING", "INFO", "LINT_MODES",
    "analyze_graph", "analyze_source", "analyze_stage_class",
    "analyze_stages", "check_export_manifest",
    "lint_artifact", "lint_model", "lint_workflow",
    "preflight", "resolve_lint_mode", "TRANSFORM_METHODS",
]
