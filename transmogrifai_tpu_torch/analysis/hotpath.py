"""opaudit hot-path pass (TM-AUDIT-311..313).

The request plane's fast path exists because per-request Python
host work was the serving throughput roof. This pass keeps it that
way: a function marked ``# opaudit: hotpath`` (the comment line above
its ``def`` or first decorator) opts into three machine-checked rules
that each encode a regression class the refactor removed by hand:

* **TM-AUDIT-311 — per-call env reads.** ``os.environ[...]`` /
  ``os.environ.get`` / ``os.getenv`` anywhere in a marked function:
  a knob resolved per request is a dict probe plus string hashing on
  every call (and a trace-env hazard besides). Resolve once at module
  or config scope.
* **TM-AUDIT-312 — dict literals in loops.** An ``ast.Dict`` node
  inside a ``for``/``while`` in a marked function allocates per item.
  Dict COMPREHENSIONS are exempt: they are the idiomatic scatter shape
  (one allocation per request result is the contract, the rule is
  about incidental churn like ``{"k": v}`` bookkeeping records).
* **TM-AUDIT-313 — lock acquisition in per-item loops.** A ``with``
  over a lock-like context (a name/attribute ending in ``lock`` or
  ``cond``, a ``.acquire()`` call, or a ``._mutating()`` call) inside
  a loop re-serializes every item — exactly the one-lock-per-request
  pattern the batched note_* methods replaced. Acquire once outside.

Only functions that OPT IN are audited: the rules are too strict for
cold paths (config parsing legitimately reads environ in a loop), and
an explicit marker documents which functions readers must treat as
throughput-critical. Findings suppress like any other pass
(``# opaudit: disable=hot-path -- <reason>``).
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Tuple

from .core import AuditContext, SourceFile, finding

#: terminal names treated as lock-like in a ``with`` context
_LOCK_SUFFIXES = ("lock", "cond")
_LOCK_CALL_NAMES = ("acquire", "_mutating")


def _terminal_name(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _is_lock_context(expr: ast.AST) -> bool:
    """True for ``self._lock`` / ``cond`` / ``x.acquire()`` /
    ``self._mutating()`` — the shapes the serving stack uses. Exact
    terminal-name matching so ``registry.acquire_if_loaded(...)``
    (a refcount context, not a lock) stays clean."""
    if isinstance(expr, ast.Call):
        return _terminal_name(expr.func) in _LOCK_CALL_NAMES
    name = _terminal_name(expr).lower()
    return name.endswith(_LOCK_SUFFIXES)


def _is_environ_read(node: ast.AST) -> bool:
    """``os.environ`` (any use) or ``os.getenv(...)``."""
    if isinstance(node, ast.Attribute) and node.attr == "environ" \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "os":
        return True
    if isinstance(node, ast.Call) \
            and _terminal_name(node.func) == "getenv":
        return True
    return False


def _marked_functions(sf: SourceFile) -> Iterator[ast.AST]:
    """Functions whose def (or first decorator) sits directly below an
    ``# opaudit: hotpath`` marker line — or on the marker's own line
    (trailing-comment form)."""
    if not sf.hotpath_markers:
        return
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        start = node.lineno
        if node.decorator_list:
            start = min(start,
                        min(d.lineno for d in node.decorator_list))
        if (start - 1) in sf.hotpath_markers \
                or start in sf.hotpath_markers:
            yield node


def _loops_in(fn: ast.AST) -> Iterator[ast.AST]:
    """Loop nodes belonging to ``fn`` itself (nested defs are their
    own opt-in scope — a closure's loop is not this function's)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def _walk_own(root: ast.AST) -> Iterator[ast.AST]:
    """ast.walk that does not descend into nested function scopes."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _audit_function(sf: SourceFile, fn: ast.AST) -> List:
    out = []
    name = getattr(fn, "name", "<fn>")
    for node in _walk_own(fn):
        if _is_environ_read(node):
            out.append(finding(
                "TM-AUDIT-311",
                f"hotpath function {name} reads os.environ per call",
                sf.relpath, node.lineno,
                fix_hint="resolve the knob once at module scope or in "
                         "a parse_env_fields config, and read the "
                         "bound value here"))
    for loop in _loops_in(fn):
        for node in _walk_own(loop):
            if isinstance(node, ast.Dict):
                out.append(finding(
                    "TM-AUDIT-312",
                    f"hotpath function {name} allocates a dict "
                    f"literal inside a loop",
                    sf.relpath, node.lineno,
                    fix_hint="hoist the dict out of the loop or "
                             "restructure as tuples/attributes"))
            elif isinstance(node, ast.With):
                for item in node.items:
                    if _is_lock_context(item.context_expr):
                        out.append(finding(
                            "TM-AUDIT-313",
                            f"hotpath function {name} acquires a lock "
                            f"inside a per-item loop",
                            sf.relpath, node.lineno,
                            fix_hint="batch the loop's bookkeeping "
                                     "under one acquisition outside "
                                     "the loop (the note_group_"
                                     "complete pattern)"))
    return out


def run(ctx: AuditContext) -> List:
    """Audit every hotpath-marked function in the runtime files
    (tests are not audited: they may mark functions only to probe
    this pass)."""
    out: List = []
    for sf in ctx.runtime_files:
        for fn in _marked_functions(sf):
            out.extend(_audit_function(sf, fn))
    return out


def marked_function_names(ctx: AuditContext) -> List[Tuple[str, str]]:
    """(relpath, function name) for every marked function — lets the
    tier-1 seed test pin that the engine's hot path actually carries
    markers (an unmarked fast path would make this pass vacuous)."""
    out: List[Tuple[str, str]] = []
    for sf in ctx.runtime_files:
        for fn in _marked_functions(sf):
            out.append((sf.relpath, getattr(fn, "name", "<fn>")))
    out.sort()
    return out
