"""opaudit core: parsed-source cache, suppression ledger, pass runner.

Counterpart of ``transmogrifai_tpu/analysis/core.py``, pointed at the
port's own tree (:data:`DEFAULT_ROOTS`: ``transmogrifai_tpu_torch/``,
the repo-root scripts that drive it and the port's tests); it never
reads the JAX package.

opaudit is the repo-source counterpart of ``lint/`` (opcheck): opcheck
statically verifies USER artifacts (workflow DAGs, stage transforms);
opaudit statically verifies THIS REPO's own source against the
invariants code reviews kept re-catching by hand —
trace-time env reads baked into jit caches, knob-registry drift,
surface-registry drift, lock races, and silently duplicated load-loop
code. Findings ride the same ``Diagnostic``/``LintReport`` machinery
(stable ``TM-AUDIT-3xx`` codes, append-only), and the same
never-executes discipline: analyzed files are ``ast``-parsed from
text, NEVER imported — auditing a file whose import would raise is
pinned to succeed (tests/test_torch_opaudit.py).

Suppression convention::

    some_flagged_line()   # opaudit: disable=<pass>[,<pass>] -- <reason>

The reason string is MANDATORY — a dedicated check (TM-AUDIT-310)
rejects reason-less or unknown-pass suppressions, the same philosophy
as faults.POINTS (a waiver that cannot explain itself proves nothing).
A suppression comment covers findings anchored on its own line or on
the line directly below (comment-above form).

Marker convention (the hot-path pass)::

    # opaudit: hotpath
    def _submit_fast(self, ...):

An ``# opaudit: hotpath`` comment on the line above a ``def`` (or its
first decorator) OPTS that function INTO the hot-path rules
(TM-AUDIT-311..313): per-call env reads, dict-literal allocation in
loops, and lock acquisition inside per-item loops are findings there.
The marker is the inverse of a suppression — it widens scrutiny — and
carries no reason clause.
"""
from __future__ import annotations

import ast
import glob
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..lint.diagnostics import (ERROR, WARNING, Diagnostic, LintReport,
                                register_codes)

#: code -> (slug, severity, description). The slug doubles as the pass
#: name `disable=` takes. Append-only, like the TM-LINT block.
AUDIT_CATALOG: Dict[str, tuple] = {
    "TM-AUDIT-301": ("trace-env", ERROR,
                     "os.environ / env-derived knob read reachable from "
                     "code whose decisions outlive the call (an "
                     "lru_cache/cache body, a torch.compile / "
                     "torch.jit / CUDA-graph target, the kernels' "
                     "build) — the resolved value is frozen and goes "
                     "stale when the env changes"),
    "TM-AUDIT-302": ("knob-registry", ERROR,
                     "raw TM_* env read outside "
                     "resilience.config.parse_env_fields and not "
                     "allowlisted with a reason"),
    "TM-AUDIT-303": ("knob-docs", ERROR,
                     "transmogrifai_tpu_torch/docs/KNOBS.md is stale "
                     "against the harvested "
                     "TM_* knob inventory (run --write-knobs)"),
    "TM-AUDIT-304": ("surface-registry", ERROR,
                     "bench section registry drift across "
                     "bench_gpu.py's _SECTIONS/_SECTION_ORDER/"
                     "_DEVICE_SECTIONS/_summary_line"),
    "TM-AUDIT-305": ("fault-registry", ERROR,
                     "fault-point catalog drift (faults.POINTS vs "
                     "fault_point call sites vs the port's "
                     "docs/RESILIENCE.md)"),
    "TM-AUDIT-306": ("metric-registry", ERROR,
                     "telemetry metric family undocumented in the "
                     "port's docs/OBSERVABILITY.md, or a counter family "
                     "not ending _total"),
    "TM-AUDIT-307": ("lock-discipline", ERROR,
                     "static lock-acquisition nesting cycle, or a "
                     "non-reentrant lock re-acquired while held"),
    "TM-AUDIT-308": ("stats-discipline", ERROR,
                     "SnapshotStats subclass field mutated outside "
                     "_bump/_mutating/_lock (torn-read hazard)"),
    "TM-AUDIT-309": ("clone", WARNING,
                     "near-duplicate function bodies in load-loop code "
                     "(chip_smoke.py, the port's tests) — the copy "
                     "class the shared-loop contract forbids"),
    "TM-AUDIT-310": ("suppression", ERROR,
                     "malformed opaudit suppression: missing '-- "
                     "reason' or unknown pass name"),
    "TM-AUDIT-311": ("hot-path", ERROR,
                     "per-call os.environ/os.getenv read inside a "
                     "'# opaudit: hotpath'-marked function — resolve "
                     "the knob once at module or config scope"),
    "TM-AUDIT-312": ("hot-path", ERROR,
                     "dict literal allocated inside a loop in a "
                     "hotpath-marked function (per-item allocation "
                     "churn; hoist it, or build via comprehension "
                     "outside the loop)"),
    "TM-AUDIT-313": ("hot-path", ERROR,
                     "lock acquisition inside a per-item loop in a "
                     "hotpath-marked function — batch the bookkeeping "
                     "under one hold outside the loop"),
    "TM-AUDIT-320": ("concurrency", ERROR,
                     "field shared across >= 2 thread roots with no "
                     "lock ever held at any read or write — an "
                     "unordered data race"),
    "TM-AUDIT-321": ("concurrency", ERROR,
                     "shared field with an inconsistent guard set: "
                     "writes hold a lock, but some access skips it "
                     "(stale-read / lost-update hazard)"),
    "TM-AUDIT-322": ("concurrency", ERROR,
                     "check-then-act: a guarded field read under one "
                     "lock hold and written under a separate later "
                     "hold of the same lock without re-reading it"),
    "TM-AUDIT-323": ("concurrency", ERROR,
                     "publication: a method returns the live mutable "
                     "container other threads mutate under a lock, "
                     "instead of a copy made inside the hold"),
}
register_codes(AUDIT_CATALOG)

#: pass slugs `disable=` accepts (suppression findings themselves are
#: deliberately NOT suppressible — a waiver of the waiver checker).
PASS_SLUGS = frozenset(
    slug for code, (slug, _sev, _d) in AUDIT_CATALOG.items()
    if code != "TM-AUDIT-310")

_SUPPRESS_RE = re.compile(r"opaudit:\s*disable=(.*)$")
_HOTPATH_RE = re.compile(r"opaudit:\s*hotpath\s*$")


class SourceFile:
    """One analyzed file: text, parsed AST, suppression ledger. Parsed
    exactly once and shared by every pass (the <15 s budget's main
    lever). ``relpath`` is repo-root-relative with forward slashes."""

    def __init__(self, relpath: str, text: str):
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=relpath)
        #: line -> set of pass slugs suppressed there
        self.suppressions: Dict[int, set] = {}
        #: lines carrying a hotpath marker comment (the hot-path pass
        #: reads these to find opted-in functions)
        self.hotpath_markers: set = set()
        #: syntax-level suppression problems: (line, message)
        self.bad_suppressions: List[Tuple[int, str]] = []
        self._scan_suppressions()

    @property
    def module(self) -> str:
        """Dotted module name ('bench' for the repo-root scripts)."""
        mod = self.relpath[:-3] if self.relpath.endswith(".py") \
            else self.relpath
        if mod.endswith("/__init__"):
            mod = mod[: -len("/__init__")]
        return mod.replace("/", ".")

    def _scan_suppressions(self) -> None:
        try:
            toks = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline))
        except (tokenize.TokenError, IndentationError):
            toks = []
        for tok in toks:
            if tok.type != tokenize.COMMENT or "opaudit:" not in tok.string:
                continue
            line = tok.start[0]
            if _HOTPATH_RE.search(tok.string):
                self.hotpath_markers.add(line)
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                self.bad_suppressions.append(
                    (line, "opaudit comment is not of the form "
                           "'opaudit: disable=<pass> -- <reason>' or "
                           "'opaudit: hotpath'"))
                continue
            body = m.group(1)
            # a slug never contains '--', so the FIRST '--' splits the
            # pass list from the mandatory reason
            slug_part, sep, reason = body.partition("--")
            slugs = {s.strip() for s in slug_part.split(",")
                     if s.strip()}
            reason = reason.strip() if sep else ""
            if not slugs:
                self.bad_suppressions.append(
                    (line, "suppression names no pass"))
                continue
            unknown = sorted(slugs - PASS_SLUGS)
            if unknown:
                self.bad_suppressions.append(
                    (line, f"unknown pass name(s) {unknown} (one of "
                           f"{sorted(PASS_SLUGS)})"))
                continue
            if not reason:
                self.bad_suppressions.append(
                    (line, f"suppression of {sorted(slugs)} carries no "
                           f"'-- <reason>' — a waiver that cannot "
                           f"explain itself proves nothing"))
                continue
            self.suppressions.setdefault(line, set()).update(slugs)

    def suppressed(self, line: int, slug: str) -> bool:
        """True when a valid suppression for ``slug`` sits on ``line``
        or on the line directly above (comment-above form)."""
        for ln in (line, line - 1):
            if slug in self.suppressions.get(ln, ()):
                return True
        return False


class AuditContext:
    """Everything a pass may read: the parsed file set plus doc text.
    Docs are loaded lazily (text only — they are never parsed as
    Python)."""

    def __init__(self, repo_root: str, files: Sequence[SourceFile]):
        self.repo_root = repo_root
        self.files = list(files)
        self._by_path = {f.relpath: f for f in self.files}
        self._docs: Dict[str, Optional[str]] = {}

    def file(self, relpath: str) -> Optional[SourceFile]:
        return self._by_path.get(relpath)

    @property
    def package_files(self) -> List[SourceFile]:
        return [f for f in self.files
                if f.relpath.startswith(PACKAGE + "/")]

    @property
    def runtime_files(self) -> List[SourceFile]:
        """The audited runtime surface: the package + the repo-root
        scripts that drive it — NOT tests (tests legitimately poke env
        and duplicate setup; only the clone pass reads them)."""
        return [f for f in self.files
                if not f.relpath.startswith("tests/")]

    @property
    def test_files(self) -> List[SourceFile]:
        return [f for f in self.files if f.relpath.startswith("tests/")]

    def doc_text(self, relpath: str) -> Optional[str]:
        if relpath not in self._docs:
            path = os.path.join(self.repo_root, relpath)
            try:
                with open(path, encoding="utf-8") as fh:
                    self._docs[relpath] = fh.read()
            except OSError:
                self._docs[relpath] = None
        return self._docs[relpath]


#: the audited package
PACKAGE = "transmogrifai_tpu_torch"

#: the audited file set: the port's package, the repo-root scripts that
#: drive it on the card (the smoke, the two probes; the port's bench
#: script once it exists), and the port's tests (clone + suppression
#: hygiene only). A root with a ``*`` is a glob; a missing root is
#: skipped. The JAX package is never read.
DEFAULT_ROOTS = (PACKAGE, "chip_smoke.py", "gbt_parity_probe.py",
                 "fused_pass_probe.py", "profiler_probe.py",
                 "hist_bits_probe.py", "bench_gpu.py",
                 "tests/test_torch_*.py", "tests/torch_*.py")


def _iter_py_files(repo_root: str,
                   roots: Sequence[str] = DEFAULT_ROOTS) -> Iterable[str]:
    for root in roots:
        if "*" in root:
            for path in sorted(glob.glob(os.path.join(repo_root, root))):
                yield os.path.relpath(path, repo_root).replace(os.sep, "/")
            continue
        full = os.path.join(repo_root, root)
        if os.path.isfile(full):
            yield root
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames.sort()
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__",)]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, fn),
                                          repo_root)
                    yield rel.replace(os.sep, "/")


def load_context(repo_root: str,
                 roots: Sequence[str] = DEFAULT_ROOTS) -> AuditContext:
    """ONE filesystem walk + one parse per file, shared by all passes."""
    files: List[SourceFile] = []
    for rel in _iter_py_files(repo_root, roots):
        with open(os.path.join(repo_root, rel), encoding="utf-8") as fh:
            text = fh.read()
        files.append(SourceFile(rel, text))
    return AuditContext(repo_root, files)


def finding(code: str, message: str, relpath: str, line: int,
            fix_hint: Optional[str] = None) -> Diagnostic:
    """Every opaudit finding anchors at file:line so suppression
    comments have somewhere to live."""
    return Diagnostic(code, message, location=f"{relpath}:{line}",
                      fix_hint=fix_hint)


_LOC_RE = re.compile(r"^(.*):(\d+)$")


def _anchor(d: Diagnostic) -> Tuple[str, int]:
    m = _LOC_RE.match(d.location or "")
    return (m.group(1), int(m.group(2))) if m else ("", 0)


def suppression_findings(ctx: AuditContext) -> List[Diagnostic]:
    """The suppression-hygiene pass: malformed/reason-less/unknown-pass
    opaudit comments anywhere in the audited set (tests included)."""
    out: List[Diagnostic] = []
    for sf in ctx.files:
        for line, msg in sf.bad_suppressions:
            out.append(finding(
                "TM-AUDIT-310", msg, sf.relpath, line,
                fix_hint="write '# opaudit: disable=<pass> -- <reason>' "
                         "with a real reason"))
    return out


def split_suppressed(ctx: AuditContext, findings: Iterable[Diagnostic]
                     ) -> Tuple[List[Diagnostic], List[Diagnostic]]:
    """(active, suppressed) — suppressed findings are kept (and shown
    under --json) so a waiver is visible, never silent."""
    active: List[Diagnostic] = []
    suppressed: List[Diagnostic] = []
    for d in findings:
        relpath, line = _anchor(d)
        sf = ctx.file(relpath)
        if sf is not None and d.code != "TM-AUDIT-310" \
                and sf.suppressed(line, d.slug):
            suppressed.append(d)
        else:
            active.append(d)
    return active, suppressed


def sort_findings(findings: List[Diagnostic]) -> List[Diagnostic]:
    """Byte-stable report order: location, then code, then message."""
    return sorted(findings,
                  key=lambda d: (_anchor(d), d.code, d.message))


def run_audit(repo_root: str,
              passes: Optional[Sequence[str]] = None,
              changed_only: Optional[Sequence[str]] = None,
              ctx: Optional[AuditContext] = None) -> Dict[str, object]:
    """Run the suite; returns a deterministic report dict.

    ``passes``: subset of pass slugs (default: all). ``changed_only``:
    repo-relative file list — the passes still see the whole tree (the
    registries are cross-file by nature) but only findings ANCHORED in
    the listed files are reported, the fast pre-commit contract.
    """
    from . import (clones, concurrency, hotpath, knobs, locks, surfaces,
                   trace_env)

    if ctx is None:
        ctx = load_context(repo_root)
    runners = [
        ("trace-env", trace_env.run),
        ("knob-registry", knobs.run_registry),
        ("knob-docs", knobs.run_docs),
        ("surface-registry", surfaces.run_sections),
        ("fault-registry", surfaces.run_faults),
        ("metric-registry", surfaces.run_metrics),
        ("lock-discipline", locks.run_locks),
        ("stats-discipline", locks.run_stats),
        ("concurrency", concurrency.run),
        ("clone", clones.run),
        ("hot-path", hotpath.run),
        ("suppression", suppression_findings),
    ]
    wanted = set(passes) if passes is not None else None
    all_findings: List[Diagnostic] = []
    ran: List[str] = []
    for slug, fn in runners:
        if wanted is not None and slug not in wanted:
            continue
        ran.append(slug)
        all_findings.extend(fn(ctx))
    active, suppressed = split_suppressed(ctx, all_findings)
    if changed_only is not None:
        changed = {c.replace(os.sep, "/") for c in changed_only}
        active = [d for d in active if _anchor(d)[0] in changed]
        suppressed = [d for d in suppressed if _anchor(d)[0] in changed]
    report = LintReport(sort_findings(active), tool="opaudit")
    return {
        "passes": ran,
        "files": len(ctx.files),
        "findings": [d.as_dict() for d in sort_findings(active)],
        "suppressed": [d.as_dict() for d in sort_findings(suppressed)],
        "errors": len(report.errors),
        "warnings": len(report.warnings),
        "report": report,
    }
