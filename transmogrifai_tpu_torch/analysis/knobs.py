"""opaudit passes ``knob-registry`` (TM-AUDIT-302) and ``knob-docs``
(TM-AUDIT-303): the TM_* env-knob surface.

The convention (resilience/config.py): every TM_* knob routes through
``parse_env_fields`` — a catalog dict ``{ENV: (field, parser)}`` — so a
typo'd name or unparseable value raises instead of silently running
defaults. Knobs that deliberately bypass the catalogs (single-site
boolean policy helpers, bootstrap reads that run before any catalog
exists) must carry an entry in :data:`DIRECT_READ_ALLOWLIST` with a
reason, or a site suppression comment — never a bare read.

``knob-docs`` keeps the port's ``transmogrifai_tpu_torch/docs/KNOBS.md``
honest: the file's generated
registry table must byte-match what this pass harvests from the tree
(the superset-match the docs contract demands, made exact). Regenerate
with ``python -m transmogrifai_tpu_torch.analysis --write-knobs``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..lint.diagnostics import Diagnostic
from .core import PACKAGE, AuditContext, finding

P = PACKAGE + "/"

#: knobs allowed to bypass parse_env_fields, each with a MANDATORY
#: reason. Additions need review — prefer a catalog entry. Keys are
#: (relpath, knob); a knob read from two files needs two entries.
DIRECT_READ_ALLOWLIST: Dict[Tuple[str, str], str] = {
    # -- bootstrap reads: the kernels' build directory ------------------
    (P + "_compile_cache.py", "TM_COMPILE_CACHE_DIR"):
        "a path knob read where a build lands; a caller's "
        "set_build_dir wins over it and a bad path raises at mkdir",
    (P + "_compile_cache.py", "TM_NO_COMPILE_CACHE"):
        "boolean kill switch for the persistent build directory ('1' "
        "or not), read in the two build-directory helpers",
    (P + "resilience/faults.py", "TM_FAULTS"):
        "the spec string has its own strict parser (parse_spec raises "
        "on any malformed entry) — the convention parse_env_fields "
        "generalized FROM",
    (P + "resilience/checkpoint.py", "TM_TRAIN_CKPT"):
        "a path knob consumed verbatim; resolve_ckpt_dir is the single "
        "chokepoint and explicit args win over it",
    (P + "resilience/checkpoint.py", "TM_CKPT_DIGEST"):
        "tri-state string compared against 'full' only; any other "
        "value means the fast digest",
    (P + "serving/worker.py", "TM_MESH_DEVICES"):
        "echoed verbatim into the worker's flight-recorder identity "
        "event (which device subset this process pinned); the mesh "
        "catalog (parallel/mesh.py) is the parser that consumes it",
    # -- mode/string selectors validated by their own enum check -------
    (P + "executor.py", "TM_WORKFLOW_EXECUTOR"):
        "resolve_executor_mode validates against its own closed mode "
        "set and raises on unknown values",
    (P + "lint/analyzer.py", "TM_LINT"):
        "resolve_lint_mode validates against LINT_MODES and raises on "
        "unknown values",
    (P + "serving/registry.py", "TM_LINT"):
        "read only to distinguish 'explicitly off' from 'defaulted "
        "off' for the publish gate; value validation lives in "
        "resolve_lint_mode",
    (P + "models/tuning.py", "TM_SWEEP_FUSION"):
        "resolve_sweep_mode validates against its closed mode set",
    (P + "workflow.py", "TM_WORKFLOW_PROFILE"):
        "boolean profile toggle read once per train; no value to "
        "mis-parse ('1' or not)",
    (P + "cli.py", "TM_TRACE_DIR"):
        "a path knob consumed verbatim: the serve command's span "
        "export and the run's torch.profiler trace",
    (P + "cli.py", "TM_TRAIN_CKPT"):
        "CLI bridges the --ckpt flag into the env knob and back; the "
        "value is a path consumed verbatim",
    # -- boolean/tri-state policy helpers: one reader function each,
    #    value space {unset,'0','1'} so strict parsing adds nothing ----
    (P + "ops/vectorizers.py", "TM_VECTORIZE"):
        "boolean opt-out read in one helper (default on)",
    (P + "ops/sanity_checker.py", "TM_CHECKER_HOST_RANKS"):
        "tri-state {unset,'0','1'} read in one helper with an explicit "
        "device-conditional default",
    (P + "stages/wrappers.py", "TM_DISALLOW_PICKLE"):
        "boolean security gate read at wrap time; '1' or not",
    (P + "models/kernels.py", "TM_KERNEL_EXACT"):
        "bitwise-anchor boolean read in kernel_exact(); the serving "
        "caches key on it through serve_policy_token()",
    (P + "models/kernels.py", "TM_HIST_BF16"):
        "dtype tri-state via env_dtype, read at each histogram call",
    (P + "models/ft_transformer.py", "TM_FT_BF16"):
        "dtype tri-state via kernels.env_dtype — the shared "
        "mixed-precision policy helper",
    (P + "models/kernels.py", "TM_HIST_ACCUM_BF16"):
        "boolean bf16-accumulation toggle read in one helper: '1' sums "
        "across row blocks in bf16 (unless TM_KERNEL_EXACT=1), anything "
        "else is f32",
    (P + "models/tuning.py", "TM_SWEEP_EXACT"):
        "boolean bitwise-anchor toggle read in one helper",
    (P + "models/tuning.py", "TM_SWEEP_FOLD_SLICE"):
        "boolean default-on toggle read in one helper",
    (P + "models/tuning.py", "TM_TREE_GRID_FOLD"):
        "boolean default-on fold selector read at dispatch; '0' sends a "
        "tree family through the sweep (the per-instance path)",
    (P + "telemetry/recorder.py", "TM_FLIGHT_DIR"):
        "a path knob consumed verbatim, with a tempdir fallback",
    (P + "telemetry/spans.py", "TM_TRACE_SAMPLE"):
        "float sample rate with its own clamped float() parse that "
        "raises on garbage at tracer configure time",
    (P + "telemetry/spans.py", "TM_TRACE_CAPACITY"):
        "int ring bound with its own int() parse at configure time",
}

#: knobs the JAX package reads that the port does not: each with what
#: the port does instead (ROADMAP kept divergences). Rendered into the
#: knob document, so the port's inventory names them too.
IGNORED_KNOBS: Dict[str, str] = {
    "TM_PALLAS": "ignored: the histogram is always the CUDA kernel on "
                 "the card",
    "TM_HIST_DOUBLE_BUFFER": "ignored: sizes TPU VMEM blocks",
    "TM_HIST_MXU_ALIGN": "ignored: pads TPU MXU tiles",
    "TM_HIST_ROWS_PER_STEP": "ignored: unrolls TPU BlockSpec row "
                             "blocks",
    "TM_SERVE_FUSED_PALLAS": "raises (the TM_SERVE_ catalog is strict): "
                             "the port has no Pallas",
    "TM_ENGINE_REQUEST_PLANE": "raises (the TM_ENGINE_ catalog is "
                               "strict): the port has one request plane",
    "TM_ENGINE_QUEUE_IMPL": "raises (the TM_ENGINE_ catalog is strict): "
                            "the port has one queue",
    "TM_MODEL_CROSS_BATCH": "raises (the TM_MODEL_ catalog is strict): "
                            "the port has one request plane",
}

_READ_FUNCS = {"get", "getenv", "setdefault"}


def _chain(node: ast.AST) -> Tuple[str, ...]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _knob_of_read(node: ast.AST) -> Optional[Tuple[str, int]]:
    """(knob, line) when node is a TM_* env READ — direct
    (get/getenv/[...], including ``env``-aliased receivers like
    spans.py's injected environ dict) or through the documented
    knob-reading helper ``env_dtype``."""
    if isinstance(node, ast.Call):
        ch = _chain(node.func)
        is_get = (len(ch) >= 2 and ch[-2] in ("environ", "env")
                  and ch[-1] in _READ_FUNCS) \
            or (ch[-1:] == ("getenv",)) \
            or (ch[-1:] == ("env_dtype",))
        if is_get and node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and node.args[0].value.startswith("TM_"):
            return node.args[0].value, node.lineno
    if isinstance(node, ast.Subscript):
        ch = _chain(node.value)
        if ch[-1:] == ("environ",) and not isinstance(
                getattr(node, "ctx", None), (ast.Store, ast.Del)):
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str) \
                    and sl.value.startswith("TM_"):
                return sl.value, node.lineno
    return None


def harvest(ctx: AuditContext) -> Dict[str, Dict[str, List]]:
    """The knob inventory: knob -> {"reads": [(relpath, line)],
    "catalogs": [(relpath, line)]} over the runtime files. Catalog
    entries are keys of dict literals valued with 2-tuples — the
    ``{ENV: (field, parser)}`` shape parse_env_fields consumes.
    Memoized per context: run_registry and run_docs share one walk."""
    cached = getattr(ctx, "_knob_inventory", None)
    if cached is not None:
        return cached
    inv: Dict[str, Dict[str, List]] = {}

    def slot(knob: str) -> Dict[str, List]:
        return inv.setdefault(knob, {"reads": [], "catalogs": []})

    for sf in ctx.runtime_files:
        for node in ast.walk(sf.tree):
            got = _knob_of_read(node)
            if got is not None:
                knob, line = got
                slot(knob)["reads"].append((sf.relpath, line))
            if isinstance(node, ast.Dict) and node.keys:
                for k, v in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) \
                            and isinstance(k.value, str) \
                            and k.value.startswith("TM_") \
                            and isinstance(v, ast.Tuple) \
                            and len(v.elts) == 2:
                        slot(k.value)["catalogs"].append(
                            (sf.relpath, k.lineno))
    for rec in inv.values():
        rec["reads"].sort()
        rec["catalogs"].sort()
    ctx._knob_inventory = inv
    return inv


def run_registry(ctx: AuditContext) -> List[Diagnostic]:
    inv = harvest(ctx)
    out: List[Diagnostic] = []
    for knob in sorted(inv):
        for relpath, line in inv[knob]["reads"]:
            if relpath == P + "resilience/config.py":
                continue        # parse_env_fields' own environ scan
            if (relpath, knob) in DIRECT_READ_ALLOWLIST \
                    or (relpath, "*") in DIRECT_READ_ALLOWLIST:
                continue
            out.append(finding(
                "TM-AUDIT-302",
                f"raw read of {knob} outside parse_env_fields (and not "
                f"in knobs.DIRECT_READ_ALLOWLIST)",
                relpath, line,
                fix_hint="route through a parse_env_fields catalog, or "
                         "allowlist the site with a reason in "
                         "analysis/knobs.py"))
    return out


# ---------------------------------------------------------------------------
# the port's docs/KNOBS.md generation + drift check
# ---------------------------------------------------------------------------

KNOBS_DOC = PACKAGE + "/docs/KNOBS.md"
_HEADER = """\
# TM_* knob registry

**GENERATED — do not edit by hand.** Rebuild with
`python -m transmogrifai_tpu_torch.analysis --write-knobs`; the
`knob-docs` audit pass (TM-AUDIT-303) fails when this file drifts
from the tree. This is the port's inventory (`transmogrifai_tpu_torch/`
and the scripts that drive it); the JAX package keeps its own in
`docs/KNOBS.md`. Every spellable knob, where it is read, and how the
read is validated; then the JAX package's knobs the port ignores or
refuses.

Route legend: **catalog** — parsed through
`resilience.config.parse_env_fields` (unknown names / bad values
raise); **direct** — allowlisted raw read (reason recorded in
`transmogrifai_tpu_torch/analysis/knobs.py`).

| knob | route | read / catalogued at |
|---|---|---|
"""


def render_knobs_doc(ctx: AuditContext) -> str:
    inv = harvest(ctx)
    rows: List[str] = []
    for knob in sorted(inv):
        rec = inv[knob]
        sites = rec["catalogs"] or rec["reads"]
        route = "catalog" if rec["catalogs"] else "direct"
        # file names only — line numbers would make the byte-match
        # gate churn on every unrelated edit that shifts a line
        files = sorted({p for p, _ln in sites})
        where = "; ".join(f"`{p}`" for p in files[:4])
        if len(files) > 4:
            where += f" (+{len(files) - 4} more)"
        rows.append(f"| `{knob}` | {route} | {where} |")
    ignored = [f"| `{k}` | {why} |"
               for k, why in sorted(IGNORED_KNOBS.items())]
    return (_HEADER + "\n".join(rows) + "\n\n## JAX-package knobs the "
            "port ignores or refuses\n\n| knob | in the port |\n|---|---|\n"
            + "\n".join(ignored) + "\n")


def run_docs(ctx: AuditContext) -> List[Diagnostic]:
    want = render_knobs_doc(ctx)
    have = ctx.doc_text(KNOBS_DOC)
    if have == want:
        return []
    if have is None:
        msg = f"{KNOBS_DOC} is missing"
    else:
        want_knobs = {ln.split("`")[1] for ln in want.splitlines()
                      if ln.startswith("| `")}
        have_knobs = {ln.split("`")[1] for ln in have.splitlines()
                      if ln.startswith("| `")}
        missing = sorted(want_knobs - have_knobs)
        stale = sorted(have_knobs - want_knobs)
        detail = []
        if missing:
            detail.append(f"undocumented: {missing[:6]}")
        if stale:
            detail.append(f"stale: {stale[:6]}")
        msg = (f"{KNOBS_DOC} is stale vs the harvested inventory "
               f"({'; '.join(detail) or 'site/route drift'})")
    # anchored at the generator so a suppression (never expected) would
    # have to sit next to the code that owns the contract
    return [finding("TM-AUDIT-303", msg,
                    P + "analysis/knobs.py", 1,
                    fix_hint="run: python -m transmogrifai_tpu_torch.analysis "
                             "--write-knobs")]
