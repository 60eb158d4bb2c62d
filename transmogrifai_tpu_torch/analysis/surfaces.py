"""opaudit passes ``surface-registry`` (TM-AUDIT-304),
``fault-registry`` (TM-AUDIT-305) and ``metric-registry``
(TM-AUDIT-306): the cross-file registries that drift.

Counterpart of the JAX package's passes, over the port's files and
the port's own documents (``transmogrifai_tpu_torch/docs/``). Every one
of these is a set-equality (or subset) contract between a literal
registry and its use sites, checkable without executing anything:

* bench sections (the port's ``bench_gpu.py``; nothing is reported
  while the script is absent): ``_SECTIONS`` keys == ``_SECTION_ORDER``
  (no dupes), ``_DEVICE_SECTIONS`` ⊆ sections, every section named in
  ``_summary_line``'s body. The port has no capture daemon, so no
  ``PRIORITY`` list is checked.
* fault points: every ``fault_point("name")`` / ``fault_action("name")``
  call site names a catalogued ``faults.POINTS`` member, every member
  is used somewhere, and every member is documented in the port's
  RESILIENCE.md (``--write-docs`` generates its table).
* metric families: every ``tm_*`` family emitted by
  telemetry/metrics.py appears in the port's OBSERVABILITY.md generated
  registry block (``--write-docs`` rebuilds it), and counter families
  end ``_total``. f-string family names are statically expanded when
  they iterate a module-level constant (the ``_ENGINE_COUNTERS``
  pattern); data-driven fields degrade to a ``*`` wildcard, which must
  be documented as such.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..lint.diagnostics import Diagnostic
from .core import AuditContext, SourceFile, finding

BENCH = "bench_gpu.py"
FAULTS = "transmogrifai_tpu_torch/resilience/faults.py"
METRICS = "transmogrifai_tpu_torch/telemetry/metrics.py"
RESILIENCE_DOC = "transmogrifai_tpu_torch/docs/RESILIENCE.md"
OBSERVABILITY_DOC = "transmogrifai_tpu_torch/docs/OBSERVABILITY.md"


def _str_elts(node: ast.AST) -> Optional[List[Tuple[str, int]]]:
    """Constant-string elements of a tuple/list/set literal (or a
    frozenset()/set() call over one); None if the shape is anything
    else."""
    if isinstance(node, ast.Call) and node.args:
        ch = node.func
        name = ch.id if isinstance(ch, ast.Name) else getattr(ch, "attr", "")
        if name in ("frozenset", "set", "tuple", "list"):
            return _str_elts(node.args[0])
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for e in node.elts:
            if not (isinstance(e, ast.Constant)
                    and isinstance(e.value, str)):
                return None
            out.append((e.value, e.lineno))
        return out
    return None


def _module_assign(sf: SourceFile, name: str) -> Optional[ast.AST]:
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return node.value
        if isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name) \
                and node.target.id == name:
            return node.value
    return None


def _assign_line(sf: SourceFile, name: str) -> int:
    node = _module_assign(sf, name)
    return node.lineno if node is not None else 1


# ---------------------------------------------------------------------------
# bench section registry
# ---------------------------------------------------------------------------

def run_sections(ctx: AuditContext) -> List[Diagnostic]:
    bench = ctx.file(BENCH)
    out: List[Diagnostic] = []
    if bench is None:
        return out

    sections_node = _module_assign(bench, "_SECTIONS")
    sections: Dict[str, int] = {}
    if isinstance(sections_node, ast.Dict):
        for k in sections_node.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                sections[k.value] = k.lineno
    order = _str_elts(_module_assign(bench, "_SECTION_ORDER") or
                      ast.Tuple(elts=[])) or []
    device = _str_elts(_module_assign(bench, "_DEVICE_SECTIONS") or
                       ast.Tuple(elts=[])) or []

    hint = ("add the section to every registry surface (_SECTIONS, "
            "_SECTION_ORDER, _summary_line extra block, and "
            "_DEVICE_SECTIONS when it touches the device) or remove it "
            "from all of them")

    order_names = [n for n, _ in order]
    for name, line in sorted(sections.items()):
        if name not in order_names:
            out.append(finding(
                "TM-AUDIT-304",
                f"section {name!r} in _SECTIONS but not _SECTION_ORDER "
                f"— main() would never schedule it",
                BENCH, line, fix_hint=hint))
    seen: Set[str] = set()
    for name, line in order:
        if name not in sections:
            out.append(finding(
                "TM-AUDIT-304",
                f"_SECTION_ORDER entry {name!r} is not a registered "
                f"section", BENCH, line, fix_hint=hint))
        if name in seen:
            out.append(finding(
                "TM-AUDIT-304",
                f"_SECTION_ORDER schedules {name!r} twice",
                BENCH, line, fix_hint=hint))
        seen.add(name)
    for name, line in device:
        if name not in sections:
            out.append(finding(
                "TM-AUDIT-304",
                f"_DEVICE_SECTIONS entry {name!r} is not a registered "
                f"section", BENCH, line, fix_hint=hint))

    # every section must surface in the summary blob (a reader's
    # only window into a section that ran)
    summary_strs: Set[str] = set()
    summary_line = 1
    for node in ast.walk(bench.tree):
        if isinstance(node, ast.FunctionDef) \
                and node.name == "_summary_line":
            summary_line = node.lineno
            for n in ast.walk(node):
                if isinstance(n, ast.Constant) and isinstance(n.value, str):
                    summary_strs.add(n.value)
    for name, line in sorted(sections.items()):
        if name not in summary_strs:
            out.append(finding(
                "TM-AUDIT-304",
                f"section {name!r} never appears in _summary_line — its "
                f"results would be invisible in the bench summary",
                BENCH, summary_line, fix_hint=hint))

    return out


# ---------------------------------------------------------------------------
# fault-point registry
# ---------------------------------------------------------------------------

def fault_sites(ctx: AuditContext
                ) -> Tuple[Dict[str, int], Dict[str, List[Tuple[str, int]]]]:
    """({catalogued point: line in faults.POINTS}, {point named at a
    fault_point / fault_action call: [(file, line)]})."""
    faults = ctx.file(FAULTS)
    points = {n: ln for n, ln in
              (_str_elts(_module_assign(faults, "POINTS")) or [])}
    used: Dict[str, List[Tuple[str, int]]] = {}
    for sf in ctx.runtime_files:
        if sf.relpath == FAULTS:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                fn = node.func
                name = fn.id if isinstance(fn, ast.Name) \
                    else getattr(fn, "attr", "")
                if name in ("fault_point", "fault_action") \
                        and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    used.setdefault(node.args[0].value, []).append(
                        (sf.relpath, node.lineno))
    return points, used


_FAULTS_BEGIN = "<!-- opaudit:fault-registry:begin -->"
_FAULTS_END = "<!-- opaudit:fault-registry:end -->"


def render_fault_registry(ctx: AuditContext) -> str:
    """The fault-point table of the port's RESILIENCE.md: every
    catalogued point and the call sites that arm it."""
    points, used = fault_sites(ctx)
    rows = [f"| `{p}` | " + ", ".join(
        f"`{f}:{ln}`" for f, ln in sorted(used.get(p, ()))) + " |"
        for p in sorted(points)]
    return (_FAULTS_BEGIN + "\n"
            "<!-- GENERATED by python -m transmogrifai_tpu_torch.analysis "
            "--write-docs from resilience/faults.py POINTS and the "
            "fault_point / fault_action call sites; the fault-registry "
            "audit pass (TM-AUDIT-305) reads it. -->\n\n"
            "| point | armed at |\n|---|---|\n"
            + "\n".join(rows) + "\n" + _FAULTS_END)


def run_faults(ctx: AuditContext) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    if ctx.file(FAULTS) is None:
        return out
    points, used = fault_sites(ctx)
    for point, sites in sorted(used.items()):
        if point not in points:
            for relpath, line in sites:
                out.append(finding(
                    "TM-AUDIT-305",
                    f"fault_point({point!r}) is not catalogued in "
                    f"faults.POINTS — the spec parser would reject any "
                    f"drill that targets it",
                    relpath, line,
                    fix_hint="register the point in faults.POINTS and "
                             "document it in docs/RESILIENCE.md"))
    doc = ctx.doc_text(RESILIENCE_DOC) or ""
    for point, line in sorted(points.items()):
        if point not in used:
            out.append(finding(
                "TM-AUDIT-305",
                f"faults.POINTS catalogues {point!r} but no source "
                f"site arms it — a drill against it silently proves "
                f"nothing", FAULTS, line,
                fix_hint="wire a fault_point() call or retire the "
                         "catalog entry"))
        if f"`{point}`" not in doc:
            out.append(finding(
                "TM-AUDIT-305",
                f"fault point {point!r} is not documented in "
                f"{RESILIENCE_DOC} (expected a `{point}` table row)",
                FAULTS, line,
                fix_hint=f"add the injection-point row to "
                         f"{RESILIENCE_DOC}"))
    return out


# ---------------------------------------------------------------------------
# metric-family registry
# ---------------------------------------------------------------------------

def _loop_binding(node: ast.For,
                  consts: Dict[str, list]) -> Dict[str, List[str]]:
    """{loop var -> its value list} when the For iterates a
    module-level tuple-of-tuples constant (or an inline literal)."""
    target, itr = node.target, node.iter
    names: List[str] = []
    if isinstance(target, ast.Name):
        names = [target.id]
    elif isinstance(target, ast.Tuple) and all(
            isinstance(e, ast.Name) for e in target.elts):
        names = [e.id for e in target.elts]
    if not names:
        return {}
    rows = None
    if isinstance(itr, ast.Name) and itr.id in consts:
        rows = consts[itr.id]
    else:
        rows = _literal_rows(itr)
    if rows is None:
        return {}
    out: Dict[str, List[str]] = {}
    for idx, name in enumerate(names):
        vals = []
        for row in rows:
            if isinstance(row, (tuple, list)) and idx < len(row) \
                    and isinstance(row[idx], str):
                vals.append(row[idx])
            else:
                return out
        out[name] = vals
    return out


def _literal_rows(node: ast.AST) -> Optional[list]:
    try:
        val = ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None
    if isinstance(val, (tuple, list)) and all(
            isinstance(r, (tuple, list)) for r in val):
        return list(val)
    return None


def emitted_families(metrics_sf: SourceFile
                     ) -> List[Tuple[str, str, int]]:
    """(family name or ``*``-pattern, mtype, line) for every emission
    site in telemetry/metrics.py."""
    consts: Dict[str, list] = {}
    for node in metrics_sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            rows = _literal_rows(node.value)
            if rows is not None:
                consts[node.targets[0].id] = rows

    fams: List[Tuple[str, str, int]] = []

    def note_call(node: ast.Call, bindings: Dict[str, List[str]]):
        meth = getattr(node.func, "attr", "")
        if meth not in ("counter", "gauge", "family") or not node.args:
            return
        mtype = meth if meth != "family" else (
            node.args[1].value if len(node.args) > 1
            and isinstance(node.args[1], ast.Constant) else "?")
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if arg.value.startswith("tm_"):
                fams.append((arg.value, mtype, node.lineno))
            return
        if isinstance(arg, ast.JoinedStr):
            expansions = [""]
            patterned = [""]
            resolvable = True
            for part in arg.values:
                if isinstance(part, ast.Constant):
                    expansions = [e + part.value for e in expansions]
                    patterned = [p + part.value for p in patterned]
                elif isinstance(part, ast.FormattedValue) \
                        and isinstance(part.value, ast.Name) \
                        and part.value.id in bindings:
                    patterned = [p + "*" for p in patterned]
                    expansions = [e + v for e in expansions
                                  for v in bindings[part.value.id]]
                else:
                    resolvable = False
                    patterned = [p + "*" for p in patterned]
            names = expansions if resolvable else patterned
            for name in names:
                if name.startswith("tm_"):
                    fams.append((name, mtype, node.lineno))

    def walk(node, bindings: Dict[str, List[str]]):
        """Depth-first with the ENCLOSING for-loop bindings in scope —
        an inner loop rebinding a name shadows the outer one, exactly
        like the runtime."""
        if isinstance(node, ast.For):
            inner = dict(bindings)
            bound = _loop_binding(node, consts)
            # a loop we cannot resolve SHADOWS any outer binding of the
            # same names (else the wrong values would expand)
            tgt = node.target
            for e in ([tgt] if isinstance(tgt, ast.Name)
                      else tgt.elts if isinstance(tgt, ast.Tuple)
                      else []):
                if isinstance(e, ast.Name):
                    inner.pop(e.id, None)
            inner.update(bound)
            for child in ast.iter_child_nodes(node):
                walk(child, inner)
            return
        if isinstance(node, ast.Call):
            note_call(node, bindings)
        for child in ast.iter_child_nodes(node):
            walk(child, bindings)

    walk(metrics_sf.tree, {})
    fams.sort()
    return fams


_REGISTRY_BEGIN = "<!-- opaudit:metric-registry:begin -->"
_REGISTRY_END = "<!-- opaudit:metric-registry:end -->"


def render_metric_registry(ctx: AuditContext) -> str:
    metrics = ctx.file(METRICS)
    rows: List[str] = []
    seen: Set[str] = set()
    for name, mtype, _line in emitted_families(metrics):
        if name in seen:
            continue
        seen.add(name)
        rows.append(f"| `{name}` | {mtype} |")
    return (_REGISTRY_BEGIN + "\n"
            "<!-- GENERATED by python -m transmogrifai_tpu_torch.analysis "
            "--write-docs; the metric-registry audit pass "
            "(TM-AUDIT-306) fails when this block drifts from "
            "telemetry/metrics.py. `*` marks a label-driven family "
            "segment. -->\n\n"
            "| family | type |\n|---|---|\n"
            + "\n".join(rows) + "\n" + _REGISTRY_END)


def run_metrics(ctx: AuditContext) -> List[Diagnostic]:
    metrics = ctx.file(METRICS)
    out: List[Diagnostic] = []
    if metrics is None:
        return out
    fams = emitted_families(metrics)
    for name, mtype, line in fams:
        if mtype == "counter" and not name.endswith("_total"):
            out.append(finding(
                "TM-AUDIT-306",
                f"counter family {name} does not end _total — the "
                f"monotonic-counter naming contract /metricsz promises "
                f"scrapers", METRICS, line,
                fix_hint="rename the family (counters end _total) or "
                         "emit it as a gauge"))
    doc = ctx.doc_text(OBSERVABILITY_DOC)
    if doc is None or _REGISTRY_BEGIN not in doc \
            or _REGISTRY_END not in doc:
        out.append(finding(
            "TM-AUDIT-306",
            f"{OBSERVABILITY_DOC} has no generated metric-registry "
            f"block", METRICS, 1,
            fix_hint="run: python -m transmogrifai_tpu_torch.analysis "
                     "--write-docs"))
        return out
    block = doc.split(_REGISTRY_BEGIN, 1)[1].split(_REGISTRY_END, 1)[0]
    want = render_metric_registry(ctx)
    have = _REGISTRY_BEGIN + block + _REGISTRY_END
    if have != want:
        documented = {ln.split("`")[1] for ln in block.splitlines()
                      if ln.startswith("| `")}
        for name, mtype, line in fams:
            if name not in documented:
                out.append(finding(
                    "TM-AUDIT-306",
                    f"metric family {name} ({mtype}) emitted but not "
                    f"documented in {OBSERVABILITY_DOC}'s registry "
                    f"block", METRICS, line,
                    fix_hint="run: python -m transmogrifai_tpu_torch.analysis "
                             "--write-docs"))
        emitted = {name for name, _, _ in fams}
        for name in sorted(documented - emitted):
            out.append(finding(
                "TM-AUDIT-306",
                f"{OBSERVABILITY_DOC} documents {name} but metrics.py "
                f"no longer emits it", METRICS, 1,
                fix_hint="run: python -m transmogrifai_tpu_torch.analysis "
                         "--write-docs"))
        if not out:
            out.append(finding(
                "TM-AUDIT-306",
                f"{OBSERVABILITY_DOC} metric-registry block drifted "
                f"(type or formatting)", METRICS, 1,
                fix_hint="run: python -m transmogrifai_tpu_torch.analysis "
                         "--write-docs"))
    return out
