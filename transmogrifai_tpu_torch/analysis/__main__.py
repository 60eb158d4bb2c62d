"""``python -m transmogrifai_tpu_torch.analysis`` — the opaudit CLI.

Exit status: 0 when every finding is suppressed (with a reason) or
absent; 1 otherwise. ``--json`` emits the full deterministic report
(two runs over the same tree are byte-identical — pinned by
tests/test_torch_opaudit.py); ``--changed-only f1 f2 ...`` restricts
REPORTED findings to the listed files for pre-commit speed while the
passes still see the whole tree (the registries are cross-file).
``--write-knobs`` / ``--write-docs`` regenerate the port's own
documents under ``transmogrifai_tpu_torch/docs/``: the KNOBS.md table
and the OBSERVABILITY.md metric-registry block the knob-docs /
metric-registry passes verify, and (``--write-docs``) the fault table
of RESILIENCE.md the fault-registry pass reads. ``--profile-requests TRACE``
is the request-plane profile report: rank span segments in a
chrome/jsonl trace by total µs (see analysis/reqprofile.py).
"""
from __future__ import annotations

import argparse
import json
import os

from . import knobs, surfaces
from .core import PASS_SLUGS, load_context, run_audit


def _splice(path: str, begin: str, end: str, block: str,
            heading: str) -> None:
    """Replace the generated block between ``begin`` and ``end`` in the
    document at ``path`` (appending it under ``heading`` when absent;
    creating the document when missing)."""
    try:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
    except OSError:
        text = ""
    if begin in text and end in text:
        text = text.split(begin, 1)[0] + block + text.split(end, 1)[1]
    else:
        text = text.rstrip() + f"\n\n## {heading}\n\n" + block + "\n"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(text)


def _default_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m transmogrifai_tpu_torch.analysis",
        description="opaudit: repo-source invariant auditor")
    ap.add_argument("--root", default=_default_root(),
                    help="repo root (default: the checkout this "
                         "package lives in)")
    ap.add_argument("--json", action="store_true",
                    help="emit the JSON report instead of text")
    ap.add_argument("--passes", default=None,
                    help=f"comma list of passes to run "
                         f"(default: all of {sorted(PASS_SLUGS)})")
    ap.add_argument("--changed-only", nargs="*", default=None,
                    metavar="FILE",
                    help="report only findings anchored in these "
                         "repo-relative files (pre-commit mode)")
    ap.add_argument("--write-knobs", action="store_true",
                    help="regenerate the port's docs/KNOBS.md and exit")
    ap.add_argument("--write-docs", action="store_true",
                    help="regenerate every generated doc block of the "
                         "port's docs (KNOBS.md, the OBSERVABILITY.md "
                         "metric registry, the RESILIENCE.md fault "
                         "table) and exit")
    ap.add_argument("--profile-requests", default=None, metavar="TRACE",
                    help="rank request-plane span segments in a "
                         "chrome/jsonl trace by total µs and exit "
                         "(honors --json)")
    args = ap.parse_args(argv)

    if args.profile_requests is not None:
        from . import reqprofile
        print(reqprofile.run(args.profile_requests,
                             as_json=args.json))
        return 0

    if args.write_knobs or args.write_docs:
        ctx = load_context(args.root)
        wrote = []
        path = os.path.join(args.root, knobs.KNOBS_DOC)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(knobs.render_knobs_doc(ctx))
        wrote.append(knobs.KNOBS_DOC)
        if args.write_docs:
            _splice(os.path.join(args.root, surfaces.OBSERVABILITY_DOC),
                    surfaces._REGISTRY_BEGIN, surfaces._REGISTRY_END,
                    surfaces.render_metric_registry(ctx),
                    "Metric family registry")
            _splice(os.path.join(args.root, surfaces.RESILIENCE_DOC),
                    surfaces._FAULTS_BEGIN, surfaces._FAULTS_END,
                    surfaces.render_fault_registry(ctx),
                    "Fault injection points")
            wrote += [surfaces.OBSERVABILITY_DOC, surfaces.RESILIENCE_DOC]
        print("opaudit: wrote " + ", ".join(wrote))
        return 0

    passes = ([p.strip() for p in args.passes.split(",") if p.strip()]
              if args.passes else None)
    if passes:
        unknown = sorted(set(passes)
                         - PASS_SLUGS - {"suppression"})
        if unknown:
            ap.error(f"unknown pass(es) {unknown}; "
                     f"one of {sorted(PASS_SLUGS | {'suppression'})}")
    report = run_audit(args.root, passes=passes,
                       changed_only=args.changed_only)
    lint_report = report.pop("report")
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(lint_report.format_text())
        if report["suppressed"]:
            print(f"opaudit: {len(report['suppressed'])} finding(s) "
                  f"suppressed with reasons")
    return 1 if report["findings"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
