"""opcheck orchestration: one entry point per lintable artifact kind (the port's copy of
``transmogrifai_tpu/lint/analyzer.py``).

* ``lint_workflow``   — an unfitted Workflow / result-feature DAG
  (graph verification + AST purity over every stage class).
* ``lint_model``      — a fitted WorkflowModel (same graph checks over
  its result-feature DAG, AST over the FITTED stage classes, which can
  differ from the estimators the unfitted DAG holds).
* ``lint_artifact``   — an on-disk artifact: portable export
  (manifest.json), saved workflow dir (workflow.json), or a registry
  root (registry.json; every version is linted).
* ``resolve_lint_mode`` / ``preflight`` — the ``TM_LINT=strict|warn|off``
  train gate used by Workflow.train (findings land in
  ``train_summaries["lintFindings"]`` so serving /statusz and
  model_insights can surface what was waived in warn mode).

Nothing here fits, scores, or compiles an XLA program. Two scoped
exceptions to "never runs stage code": the graph layer calls each
transformer's ``device_fn_signature()`` (a declared-cheap introspection
hook) to probe retrace hazards, and ``lint_artifact`` on a saved
workflow dir constructs a FusedScorer (which invokes ``make_device_fn``
closures without tracing them). The AST layer alone carries the
never-imports/never-executes guarantee — use ``analyze_source`` for
untrusted stage code.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

from .ast_checks import analyze_stage_class, analyze_stages
from .diagnostics import LintError, LintReport
from .graph import analyze_graph, build_index, check_export_manifest

#: accepted TM_LINT values (the train pre-flight gate)
LINT_MODES = ("strict", "warn", "off")


def resolve_lint_mode(explicit: Optional[str] = None) -> str:
    mode = (explicit or os.environ.get("TM_LINT") or "off").lower()
    if mode in ("", "0", "none", "false"):
        mode = "off"
    elif mode in ("1", "true", "on"):
        # bare "enable" spellings mean the non-fatal tier; strict stays
        # an explicit opt-in
        mode = "warn"
    if mode not in LINT_MODES:
        raise ValueError(f"unknown TM_LINT mode {mode!r}; "
                         f"one of {LINT_MODES}")
    return mode


def _result_features(target) -> Sequence:
    """Workflow | Feature | (mixed) sequence -> result feature list.

    Sequences may mix Workflows and Features (several example
    build_workflow() helpers return ``(Workflow, feature)`` tuples)."""
    rf = getattr(target, "result_features", None)
    if rf is not None:
        return list(rf)
    if isinstance(target, (list, tuple)):
        out = []
        for t in target:
            rf = getattr(t, "result_features", None)
            out.extend(rf) if rf is not None else out.append(t)
        return out
    return [target]


def lint_workflow(workflow, extra_features: Sequence = (),
                  ast_checks: bool = True) -> LintReport:
    """Statically verify a workflow DAG without fitting anything.

    ``extra_features`` are features the caller built and EXPECTS to be
    computed — any that cannot reach a result feature is reported as
    dead (TM-LINT-006); the executor would silently never run them.
    """
    features = _result_features(workflow)
    report = LintReport(analyze_graph(features, extra_features))
    if ast_checks:
        idx = build_index(features)
        stages = [f.origin_stage for f in idx.topo
                  if not f.is_raw and f.origin_stage is not None]
        report.extend(analyze_stages(stages))
        # an estimator's declared model_cls is the transformer that will
        # actually run at transform/scoring time — lint it now, before
        # any fit ever instantiates it
        seen = set()
        for st in stages:
            mc = getattr(st, "model_cls", None)
            if isinstance(mc, type) and mc not in seen:
                seen.add(mc)
                report.extend(analyze_stage_class(mc))
    return report


def lint_model(model, ast_checks: bool = True) -> LintReport:
    """Lint a FITTED WorkflowModel: the result-feature DAG plus the
    fitted transformer classes actually used at scoring time."""
    report = LintReport(analyze_graph(model.result_features))
    if ast_checks:
        report.extend(analyze_stages(model.stages))
    return report


def lint_artifact(path: str,
                  result_names: Optional[Sequence[str]] = None,
                  ast_checks: bool = True) -> LintReport:
    """Lint an on-disk serving artifact (the pre-publish gate).

    Auto-detects the layout the serving registry loads: a registry root
    lints every version dir; a version dir lints its portable manifest
    (skew/bucket checks) and, when a saved workflow rides alongside,
    the fitted model too. ``result_names`` cross-checks the manifest
    against a live backend's terminal outputs.
    """
    report = LintReport()
    reg_path = os.path.join(path, "registry.json")
    if os.path.exists(reg_path):
        with open(reg_path) as f:
            doc = json.load(f)
        for name in sorted(doc.get("versions") or {}):
            vdir = os.path.join(path, doc["versions"][name]["path"])
            report.extend(lint_artifact(vdir,
                                        ast_checks=ast_checks).findings)
        return report
    man_path = os.path.join(path, "manifest.json")
    manifest = None
    if os.path.exists(man_path):
        with open(man_path) as f:
            manifest = json.load(f)
    wf_path = os.path.join(path, "workflow.json")
    if os.path.exists(wf_path):
        from ..workflow import WorkflowModel
        model = WorkflowModel.load(path)
        report.extend(lint_model(model, ast_checks=ast_checks).findings)
        if manifest is not None and result_names is None:
            # the saved model is the skew authority for its own export
            from ..workflow import FusedScorer
            result_names = FusedScorer(model).result_names
    if manifest is not None:
        report.extend(check_export_manifest(manifest,
                                            result_names=result_names))
    elif not os.path.exists(wf_path):
        raise ValueError(
            f"{path}: neither a portable export (manifest.json), a saved "
            f"workflow (workflow.json), nor a registry root "
            f"(registry.json)")
    return report


def preflight(workflow, mode: Optional[str] = None) -> Optional[LintReport]:
    """The Workflow.train pre-flight gate. Returns the report (for
    ``train_summaries``) or None when the gate is off. ``strict`` raises
    LintError on error-severity findings; ``warn`` prints them to
    stderr and continues."""
    mode = resolve_lint_mode(mode)
    if mode == "off":
        return None
    report = lint_workflow(workflow)
    if report.has_errors and mode == "strict":
        raise LintError(report, context="workflow pre-flight")
    if report.findings:
        import sys
        print(f"TM_LINT={mode}: " + report.format_text(),
              file=sys.stderr, flush=True)
    return report
