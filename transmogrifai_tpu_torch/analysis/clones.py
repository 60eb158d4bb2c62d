"""opaudit pass ``clone`` (TM-AUDIT-309): near-duplicate load-loop code.

A second open-loop Poisson load loop pasted into a new bench section is
the copy this pass exists for — "exactly the drift the shared-loop contract
forbids": the copy starts identical, then one side gets a fix and the
other silently keeps the bug. This pass flags near-duplicate function
BODIES in the scripts and tests where that copy class lives (in the
port: ``chip_smoke.py`` and the port's tests), so the duplication is a
reviewed decision, not an accident.

Mechanics: each function body is normalized to a token stream
(identifiers → ``N``, constants → type codes, attribute/keyword names
kept — the API shape is what makes two load loops "the same loop").
Candidate pairs prefilter on length ratio and token-bag overlap, then
score with ``difflib.SequenceMatcher``; pairs at or above
:data:`SIMILARITY` with at least :data:`MIN_TOKENS` tokens are
findings. Identical tiny helpers (parametrized smoke asserts) stay
under the floor by construction.
"""
from __future__ import annotations

import ast
from difflib import SequenceMatcher
from typing import Dict, List

from ..lint.diagnostics import Diagnostic
from .core import AuditContext, SourceFile, finding

#: similarity threshold (normalized token stream, SequenceMatcher)
SIMILARITY = 0.90
#: ignore functions shorter than this many normalized tokens — below
#: it, similarity is structure every function shares, not a copy
MIN_TOKENS = 150

#: the files the copy class lives in: the smoke and the port's
#: tests (the audited roots hold no other test file)
SCOPE = ("chip_smoke.py", "tests/")


def _tokens(fn: ast.AST) -> List[str]:
    out: List[str] = []
    for node in ast.walk(fn):
        kind = type(node).__name__
        if isinstance(node, ast.Name):
            out.append("N")
        elif isinstance(node, ast.Attribute):
            out.append(f".{node.attr}")
        elif isinstance(node, ast.Constant):
            out.append(type(node.value).__name__)
        elif isinstance(node, ast.keyword):
            out.append(f"{node.arg}=")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append("def")
        elif isinstance(node, ast.operator) \
                or isinstance(node, ast.cmpop) \
                or isinstance(node, ast.unaryop) \
                or isinstance(node, ast.boolop):
            out.append(kind)
        elif isinstance(node, (ast.expr_context, ast.arguments,
                               ast.arg, ast.Load, ast.Store)):
            continue
        else:
            out.append(kind)
    return out


class _Fn:
    __slots__ = ("sf", "name", "line", "tokens", "bag")

    def __init__(self, sf: SourceFile, node: ast.FunctionDef):
        self.sf = sf
        self.name = node.name
        self.line = node.lineno
        self.tokens = _tokens(node)
        bag: Dict[str, int] = {}
        for t in self.tokens:
            bag[t] = bag.get(t, 0) + 1
        self.bag = bag


def _bag_overlap(a: _Fn, b: _Fn) -> float:
    inter = sum(min(n, b.bag.get(t, 0)) for t, n in a.bag.items())
    total = max(len(a.tokens), len(b.tokens))
    return inter / total if total else 0.0


def run(ctx: AuditContext) -> List[Diagnostic]:
    fns: List[_Fn] = []
    for sf in ctx.files:
        if not any(sf.relpath == s or sf.relpath.startswith(s)
                   for s in SCOPE):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.FunctionDef) \
                    and not node.name.startswith("__"):
                fn = _Fn(sf, node)
                if len(fn.tokens) >= MIN_TOKENS:
                    fns.append(fn)
    fns.sort(key=lambda f: (f.sf.relpath, f.line))

    out: List[Diagnostic] = []
    for i, a in enumerate(fns):
        for b in fns[i + 1:]:
            la, lb = len(a.tokens), len(b.tokens)
            if min(la, lb) / max(la, lb) < SIMILARITY:
                continue
            if _bag_overlap(a, b) < SIMILARITY - 0.05:
                continue
            ratio = SequenceMatcher(None, a.tokens, b.tokens,
                                    autojunk=False).ratio()
            if ratio >= SIMILARITY:
                out.append(finding(
                    "TM-AUDIT-309",
                    f"{b.sf.relpath}:{b.line} {b.name} is a "
                    f"{ratio:.0%} token-level duplicate of "
                    f"{a.sf.relpath}:{a.line} {a.name} "
                    f"({lb} vs {la} tokens)",
                    b.sf.relpath, b.line,
                    fix_hint="extract the shared load loop (the "
                             "open-loop-load helper pattern) or "
                             "suppress with the reason the copies "
                             "must stay split"))
    return out
