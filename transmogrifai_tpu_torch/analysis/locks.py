"""opaudit passes ``lock-discipline`` (TM-AUDIT-307) and
``stats-discipline`` (TM-AUDIT-308): the threading invariants of the
serving/continuum control planes.

``lock-discipline`` builds the static lock-acquisition nesting graph
over ``serving/`` (transport/ and worker.py included), ``continuum/``,
``telemetry/`` and ``profiling.py``: a node is ``(class, lock
attribute)``; an edge A→B means some code path acquires B while
holding A — either a literally nested ``with self._b:`` block or a
``self.method()`` call made under the hold whose callee (transitively,
through same-class calls) acquires B. A cycle is a static deadlock
hazard (a supervisor-versus-topology race, for one). Re-acquiring a
lock already held is flagged when the class builds it as a plain
``threading.Lock`` (only RLocks — and Conditions, RLock-backed by
default — may nest).

Lock discovery is KIND-based, not just name-based: any attribute a
method assigns ``threading.Lock()`` / ``RLock()`` / ``Condition()``
is a lock whatever it is called (``self._life``, ``self._cond``), a
``Condition(self._x)`` canonicalizes to the lock it wraps, and a
local alias (``cond = self._cond`` then ``with cond:``) resolves to
the underlying attribute — the transport/worker idiom.

``stats-discipline`` pins the SnapshotStats contract (profiling.py):
subclasses mutate counters only via ``_bump(...)`` or inside ``with
self._mutating():`` / ``with self._lock:`` — a bare ``self.x += 1``
is a torn-read hazard the ``snapshot_seq`` convention exists to
prevent. ``__init__`` and ``reset`` (re)initialize freely.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..lint.diagnostics import Diagnostic
from .core import AuditContext, SourceFile, finding

#: modules whose threaded control planes the lock graph covers
LOCK_SCOPE_PREFIXES = (
    "transmogrifai_tpu_torch/serving/", "transmogrifai_tpu_torch/continuum/",
    "transmogrifai_tpu_torch/telemetry/", "transmogrifai_tpu_torch/profiling.py",
    # the rank threads (spmd.run_ranks), the mesh and the processes
    "transmogrifai_tpu_torch/parallel/",
)


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _lock_token(item: ast.withitem) -> Optional[str]:
    """The lock attribute a ``with`` item acquires on self:
    ``with self._x_lock:`` -> '_x_lock'; ``with self._mutating():`` ->
    '_lock' (the helper holds self._lock)."""
    ce = item.context_expr
    if isinstance(ce, ast.Call):
        attr = _self_attr(ce.func)
        if attr == "_mutating":
            return "_lock"
        if attr and "lock" in attr.lower():    # self._lock_for(...) style
            return attr
        return None
    attr = _self_attr(ce)
    if attr and "lock" in attr.lower():
        return attr
    return None


class _ClassInfo:
    __slots__ = ("name", "sf", "node", "lock_kinds", "lock_alias",
                 "methods", "bases")

    def __init__(self, name, sf, node):
        self.name = name
        self.sf = sf
        self.node = node
        #: lock attr -> 'Lock' | 'RLock' | 'Condition' | '?' (declared
        #: by ANY method's ``self.x = threading.<ctor>()``)
        self.lock_kinds: Dict[str, str] = {}
        #: ``self._cond = Condition(self._lock)`` -> {'_cond': '_lock'}
        self.lock_alias: Dict[str, str] = {}
        #: method name -> (direct acquisitions under no hold,
        #:                 [(held, acquired, line)],
        #:                 [(held or None, callee, line)])
        self.methods: Dict[str, tuple] = {}
        self.bases: List[str] = []

    def canon(self, attr: str) -> str:
        """The lock an attribute ultimately holds: a Condition built
        over an explicit lock IS that lock for nesting purposes."""
        seen: Set[str] = set()
        while attr in self.lock_alias and attr not in seen:
            seen.add(attr)
            attr = self.lock_alias[attr]
        return attr

    def kind_of(self, attr: str) -> str:
        return self.lock_kinds.get(self.canon(attr), "?")


def _scan_class(sf: SourceFile, node: ast.ClassDef) -> _ClassInfo:
    ci = _ClassInfo(node.name, sf, node)
    for b in node.bases:
        if isinstance(b, ast.Name):
            ci.bases.append(b.id)
        elif isinstance(b, ast.Attribute):
            ci.bases.append(b.attr)
    # pass 1 — lock declarations, WHEREVER they happen (__init__ builds
    # most, but start() publishing a fresh Condition counts too): the
    # kind catalog must exist before any method walk so that `_life`
    # and `_cond` style names resolve as locks
    for item in node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for n in ast.walk(item):
            if isinstance(n, ast.Assign) and isinstance(
                    n.value, ast.Call):
                fn = n.value.func
                kind = fn.id if isinstance(fn, ast.Name) \
                    else getattr(fn, "attr", "")
                if kind in ("Lock", "RLock", "Condition"):
                    for t in n.targets:
                        attr = _self_attr(t)
                        if attr:
                            ci.lock_kinds[attr] = kind
                            if kind == "Condition" and n.value.args:
                                over = _self_attr(n.value.args[0])
                                if over:
                                    ci.lock_alias[attr] = over
    if "SnapshotStats" in ci.bases:
        ci.lock_kinds.setdefault("_lock", "Lock")   # inherited
    # pass 2 — per-method acquisition/call walk with alias tracking
    for item in node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        acquires: List[Tuple[Optional[str], str, int]] = []
        calls: List[Tuple[Optional[str], str, int]] = []
        aliases: Dict[str, str] = {}

        def tok(item_: ast.withitem) -> Optional[str]:
            attr = _lock_token(item_)
            if attr is None:
                ce = item_.context_expr
                a = None
                if isinstance(ce, ast.Name):
                    a = aliases.get(ce.id)
                else:
                    a = _self_attr(ce)
                if a is not None and a in ci.lock_kinds:
                    attr = a
            return ci.canon(attr) if attr is not None else None

        def walk(n, held: Tuple[str, ...]):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return              # nested defs: separate analysis unit
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                src = _self_attr(n.value)
                if src is not None and src in ci.lock_kinds:
                    aliases[n.targets[0].id] = src
            if isinstance(n, ast.With):
                tokens = [t for t in (tok(i) for i in n.items) if t]
                for t in tokens:
                    acquires.append((held[-1] if held else None, t,
                                     n.lineno))
                inner = held + tuple(tokens)
                for i in n.items:
                    walk(i.context_expr, held)
                for stmt in n.body:
                    walk(stmt, inner)
                return
            if isinstance(n, ast.Call):
                attr = _self_attr(n.func)
                if attr and attr not in ("_mutating",):
                    calls.append((held[-1] if held else None, attr,
                                  n.lineno))
            for child in ast.iter_child_nodes(n):
                walk(child, held)

        for stmt in item.body:
            walk(stmt, ())
        ci.methods[item.name] = (acquires, calls)
    return ci


def _method_acquisitions(ci: _ClassInfo, method: str,
                         seen: Set[str]) -> Set[Tuple[str, int]]:
    """Locks a method acquires (directly or via same-class calls made
    OUTSIDE any hold — calls under a hold contribute edges instead)."""
    if method in seen or method not in ci.methods:
        return set()
    seen.add(method)
    acquires, calls = ci.methods[method]
    out = {(tok, line) for _held, tok, line in acquires}
    for held, callee, line in calls:
        sub = _method_acquisitions(ci, callee, seen)
        out |= {(tok, line) for tok, _ln in sub}
    return out


def run_locks(ctx: AuditContext) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    classes: List[_ClassInfo] = []
    for sf in ctx.runtime_files:
        if not any(sf.relpath.startswith(p) or sf.relpath == p
                   for p in LOCK_SCOPE_PREFIXES):
            continue
        for node in sf.tree.body:
            if isinstance(node, ast.ClassDef):
                classes.append(_scan_class(sf, node))

    # edges: (class, held) -> (class, acquired), with a witness site
    edges: Dict[Tuple[str, str], Dict[Tuple[str, str],
                                      Tuple[str, int]]] = {}
    for ci in classes:
        qual = f"{ci.sf.module}.{ci.name}"
        for mname, (acquires, calls) in sorted(ci.methods.items()):
            for held, tok, line in acquires:
                if held is None:
                    continue
                if held == tok:
                    kind = ci.lock_kinds.get(tok, "?")
                    if kind == "Lock":
                        out.append(finding(
                            "TM-AUDIT-307",
                            f"{qual}.{mname} re-acquires self.{tok} "
                            f"while already holding it, and __init__ "
                            f"builds it as a non-reentrant "
                            f"threading.Lock — guaranteed self-"
                            f"deadlock on this path",
                            ci.sf.relpath, line,
                            fix_hint="hoist the inner block out of the "
                                     "hold, or make the lock an RLock"))
                    continue
                edges.setdefault((qual, held), {}).setdefault(
                    (qual, tok), (ci.sf.relpath, line))
            for held, callee, line in calls:
                if held is None:
                    continue
                for tok, _ln in sorted(
                        _method_acquisitions(ci, callee, set())):
                    if tok == held:
                        kind = ci.lock_kinds.get(tok, "?")
                        if kind == "Lock":
                            out.append(finding(
                                "TM-AUDIT-307",
                                f"{qual}.{mname} calls self.{callee}() "
                                f"while holding self.{held}, and "
                                f"{callee} (re)acquires the same non-"
                                f"reentrant lock — self-deadlock",
                                ci.sf.relpath, line,
                                fix_hint="use the _locked variant "
                                         "pattern or an RLock"))
                        continue
                    edges.setdefault((qual, held), {}).setdefault(
                        (qual, tok), (ci.sf.relpath, line))

    # cycle detection (deterministic DFS)
    color: Dict[Tuple[str, str], int] = {}
    stack: List[Tuple[str, str]] = []

    def dfs(node) -> Optional[List]:
        color[node] = 1
        stack.append(node)
        for nxt in sorted(edges.get(node, {})):
            if color.get(nxt, 0) == 1:
                return stack[stack.index(nxt):] + [nxt]
            if color.get(nxt, 0) == 0:
                cyc = dfs(nxt)
                if cyc:
                    return cyc
        stack.pop()
        color[node] = 2
        return None

    reported: Set[tuple] = set()
    for node in sorted(edges):
        if color.get(node, 0) == 0:
            cyc = dfs(node)
            if cyc:
                key = tuple(sorted(set(cyc)))
                if key not in reported:
                    reported.add(key)
                    relpath, line = edges[cyc[0]][cyc[1]]
                    pretty = " -> ".join(
                        f"{c.split('.')[-1]}.{l}" for c, l in cyc)
                    out.append(finding(
                        "TM-AUDIT-307",
                        f"lock-order cycle: {pretty} — two threads "
                        f"entering from different ends deadlock",
                        relpath, line,
                        fix_hint="impose one global acquisition order "
                                 "(document it on the class) and "
                                 "release before crossing"))
    return out


# ---------------------------------------------------------------------------
# SnapshotStats mutation discipline
# ---------------------------------------------------------------------------

#: methods that may (re)initialize fields with bare assignments
_INIT_METHODS = {"__init__", "reset"}


def run_stats(ctx: AuditContext) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for sf in ctx.runtime_files:
        for node in sf.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            bases = {b.id if isinstance(b, ast.Name)
                     else getattr(b, "attr", "") for b in node.bases}
            if "SnapshotStats" not in bases:
                continue
            for item in node.body:
                if not isinstance(item, ast.FunctionDef) \
                        or item.name in _INIT_METHODS:
                    continue

                def walk(n, guarded: bool):
                    if isinstance(n, (ast.FunctionDef, ast.Lambda)):
                        return
                    if isinstance(n, ast.With):
                        toks = [t for t in
                                (_lock_token(i) for i in n.items) if t]
                        g = guarded or bool(toks)
                        for stmt in n.body:
                            walk(stmt, g)
                        return
                    if isinstance(n, (ast.Assign, ast.AugAssign)) \
                            and not guarded:
                        targets = n.targets if isinstance(n, ast.Assign) \
                            else [n.target]
                        for t in targets:
                            base = t
                            while isinstance(base, ast.Subscript):
                                base = base.value
                            attr = _self_attr(base)
                            if attr and not attr.startswith("__"):
                                out.append(finding(
                                    "TM-AUDIT-308",
                                    f"{node.name}.{item.name} mutates "
                                    f"self.{attr} outside _bump/"
                                    f"_mutating/_lock — snapshot_seq "
                                    f"cannot see the write and a "
                                    f"scraper can tear it",
                                    sf.relpath, n.lineno,
                                    fix_hint="wrap the write in `with "
                                             "self._mutating():` or "
                                             "express it via _bump()"))
                    for child in ast.iter_child_nodes(n):
                        walk(child, guarded)

                for stmt in item.body:
                    walk(stmt, False)
    return out
