"""Structured lint diagnostics for the opcheck static analyzer (the port's copy of
``transmogrifai_tpu/lint/diagnostics.py``).

Every finding carries a STABLE code (``TM-LINT-NNN``) so CI gates, docs,
and waivers can reference a diagnostic without parsing its message.
Codes are append-only: a retired check keeps its number reserved.

Severity model: ``error`` findings are defects that corrupt results or
artifacts (the ``lint`` CLI exits non-zero on any of them; the
``TM_LINT=strict`` train gate raises); ``warning`` findings are hazards
(perf cliffs, nondeterminism) that don't change correctness of a single
run; ``info`` is advisory.

The catalog lives here — docs/LINT.md is generated prose over the same
codes; keep the two in sync.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITY_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}

#: code -> (slug, default severity, one-line description)
CATALOG: Dict[str, tuple] = {
    # -- layer 1: graph analysis (no stage source needed) ----------------
    "TM-LINT-001": ("type-mismatch", ERROR,
                    "stage input type does not conform to the declared "
                    "in_types/in_type (or the arity is wrong)"),
    "TM-LINT-002": ("cycle", ERROR,
                    "the feature DAG contains a cycle"),
    "TM-LINT-003": ("duplicate-stage-uid", ERROR,
                    "two distinct stages (or two wirings of one stage) "
                    "share a uid — layer merge silently last-wins"),
    "TM-LINT-004": ("duplicate-output-name", ERROR,
                    "two features in the DAG share an output column name "
                    "— the dataset column silently last-wins"),
    "TM-LINT-005": ("response-leakage", ERROR,
                    "the response (or a feature derived from it) feeds a "
                    "predictor path — the model trains on its own label"),
    "TM-LINT-006": ("dead-feature", WARNING,
                    "a declared feature never reaches any result feature "
                    "— it will silently never be computed"),
    "TM-LINT-007": ("export-skew", ERROR,
                    "portable-export manifest columns disagree with the "
                    "DAG terminal outputs (serving/training skew)"),
    "TM-LINT-008": ("bucket-skew", ERROR,
                    "exported scoreBuckets metadata is not a normalized "
                    "bucket set (FusedScorer would reject or re-bucket)"),
    "TM-LINT-009": ("retrace-hazard", WARNING,
                    "device_fn_signature varies across identical configs "
                    "— every train re-traces and the compile cache grows "
                    "without bound"),
    "TM-LINT-010": ("degrade-feeds-model", ERROR,
                    "a failure_policy='degrade' stage's output feeds the "
                    "response/label slot or a model's feature vector "
                    "non-optionally — degrading it would silently change "
                    "model semantics"),
    # -- layer 2: AST analysis (stage source, never executed) ------------
    "TM-LINT-201": ("transform-mutates-self", ERROR,
                    "transform_value mutates the stage instance — a data "
                    "race under the parallel executor / serving threads"),
    "TM-LINT-202": ("missing-cache-marker", ERROR,
                    "transform/_transform_columns caches state on self "
                    "without declaring transform_caches_state — the "
                    "executor's lifetime skip would drop live state"),
    "TM-LINT-203": ("nondeterministic-transform", WARNING,
                    "transform path reads a nondeterministic source "
                    "(np.random/time/uuid) — bitwise parity cannot hold"),
    "TM-LINT-204": ("global-state-transform", WARNING,
                    "transform path declares/writes module-global state "
                    "— hidden coupling across stages and threads"),
}


def register_codes(codes: Dict[str, tuple]) -> None:
    """Append a code block to the catalog (the port's repo-audit suite,
    ``transmogrifai_tpu_torch.analysis``, registers its ``TM-AUDIT-3xx``
    block here so findings ride the same Diagnostic/LintReport
    machinery).
    Same append-only contract as the static catalog: re-registering an
    existing code with a DIFFERENT definition is a programming error."""
    for code, spec in codes.items():
        cur = CATALOG.get(code)
        if cur is not None and cur != spec:
            raise ValueError(f"diagnostic code {code!r} already "
                             f"registered with a different definition")
        CATALOG[code] = spec


class Diagnostic:
    """One structured finding: stable code + location + fix hint."""

    __slots__ = ("code", "slug", "severity", "message", "stage_uid",
                 "feature", "location", "fix_hint")

    def __init__(self, code: str, message: str,
                 severity: Optional[str] = None,
                 stage_uid: Optional[str] = None,
                 feature: Optional[str] = None,
                 location: Optional[str] = None,
                 fix_hint: Optional[str] = None):
        if code not in CATALOG:
            raise ValueError(f"unknown diagnostic code {code!r}")
        slug, default_sev, _ = CATALOG[code]
        self.code = code
        self.slug = slug
        self.severity = severity or default_sev
        self.message = message
        self.stage_uid = stage_uid
        self.feature = feature
        self.location = location
        self.fix_hint = fix_hint

    def as_dict(self) -> Dict[str, Any]:
        d = {"code": self.code, "slug": self.slug,
             "severity": self.severity, "message": self.message}
        for k in ("stage_uid", "feature", "location", "fix_hint"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d

    def format(self) -> str:
        where = self.stage_uid or self.feature or self.location or ""
        where = f" [{where}]" if where else ""
        hint = f"\n    fix: {self.fix_hint}" if self.fix_hint else ""
        return (f"{self.code} {self.severity}{where} {self.slug}: "
                f"{self.message}{hint}")

    def __repr__(self):
        return f"Diagnostic({self.code}, {self.severity}, {self.message!r})"


class LintReport:
    """Ordered collection of findings (errors first, stable within).
    ``tool`` labels the summary line (opcheck for workflow lint,
    opaudit for the repo-source audit suite)."""

    def __init__(self, findings: Optional[List[Diagnostic]] = None,
                 tool: str = "opcheck"):
        self.findings: List[Diagnostic] = list(findings or [])
        self.tool = tool

    def extend(self, findings) -> "LintReport":
        self.findings.extend(findings)
        return self

    def sorted(self) -> List[Diagnostic]:
        return sorted(self.findings,
                      key=lambda d: (_SEVERITY_ORDER.get(d.severity, 3),
                                     d.code))

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.findings if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.findings if d.severity == WARNING]

    @property
    def has_errors(self) -> bool:
        return any(d.severity == ERROR for d in self.findings)

    def codes(self) -> List[str]:
        return [d.code for d in self.findings]

    def as_dict(self) -> Dict[str, Any]:
        return {"findings": [d.as_dict() for d in self.sorted()],
                "errors": len(self.errors),
                "warnings": len(self.warnings)}

    def format_text(self) -> str:
        if not self.findings:
            return f"{self.tool}: no findings"
        lines = [d.format() for d in self.sorted()]
        lines.append(f"{self.tool}: {len(self.errors)} error(s), "
                     f"{len(self.warnings)} warning(s), "
                     f"{len(self.findings)} finding(s)")
        return "\n".join(lines)

    def __len__(self):
        return len(self.findings)

    def __iter__(self):
        return iter(self.findings)


class LintError(ValueError):
    """Raised by the TM_LINT=strict train gate / strict publishers when a
    lint pass reports error-severity findings."""

    def __init__(self, report: LintReport, context: str = "workflow"):
        self.report = report
        codes = ", ".join(sorted({d.code for d in report.errors}))
        super().__init__(
            f"opcheck found {len(report.errors)} error-severity lint "
            f"finding(s) in {context} ({codes}); run the `lint` "
            f"subcommand for details, fix the workflow, or set "
            f"TM_LINT=warn to waive\n{report.format_text()}")
