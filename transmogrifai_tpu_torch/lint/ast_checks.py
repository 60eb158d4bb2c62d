"""opcheck layer 2: AST-based stage purity lints (no execution) (the port's copy of
``transmogrifai_tpu/lint/ast_checks.py``).

Stage source is parsed with the stdlib ``ast`` module — the stage under
test is never imported, instantiated, or executed, so a deliberately
corrupting transform can be linted safely from its source text
(``analyze_source``). For stages already living in a wired workflow,
``analyze_stage_class`` walks the class MRO and parses each transform
method's defining source instead.

Transform-path methods (``transform``, ``transform_value``,
``_transform_columns``) must be pure with respect to the stage instance
and the process: the parallel executor (executor.py) dispatches them
from pool threads, the serving engine from request threads, and the
bitwise-parity guarantees assume re-running one is free. Three escape
hatches are linted:

  * TM-LINT-201 — ``transform_value`` mutates ``self``. The row path is
    shared by scoring_row_fn and the serving engine; a mutation there
    is a data race, full stop.
  * TM-LINT-202 — ``transform``/``_transform_columns`` caches state on
    ``self`` WITHOUT declaring ``transform_caches_state = True``. The
    executor's lifetime pruning skips transforms with no downstream
    consumer; an undeclared cache silently never populates
    (VectorsCombiner's manifest is the declared, legal form).
  * TM-LINT-203 — nondeterministic reads (``np.random``, ``time``,
    ``uuid`` ...) in any transform path.
  * TM-LINT-204 — ``global`` declarations / ``globals()`` writes in a
    transform path.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .diagnostics import Diagnostic

#: methods forming the transform path (the executor/serving hot path)
TRANSFORM_METHODS = ("transform", "_transform_columns", "transform_value")

#: the runtime marker the executor consults before lifetime-skipping a
#: transform — imported from the executor so the lint and the skip
#: decision can never disagree on the attribute name
from ..executor import TRANSFORM_STATE_ATTR as MARKER  # noqa: E402

#: attribute-chain prefixes whose READ in a transform path breaks the
#: bitwise-parity / replay guarantees
_NONDET_CHAINS = (
    ("np", "random"), ("numpy", "random"), ("jax", "random"),
    ("random",),
    ("time", "time"), ("time", "perf_counter"), ("time", "monotonic"),
    ("time", "time_ns"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("uuid", "uuid1"), ("uuid", "uuid4"),
    ("os", "urandom"), ("secrets",),
)

#: method names that mutate their receiver in place
_MUTATOR_METHODS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "add", "discard", "update", "setdefault", "sort", "reverse",
}

_FIX = {
    "201": "make transform_value pure; move learned state into fitted "
           "params at fit time",
    "202": f"declare `{MARKER} = True` on the class (the executor will "
           f"then never lifetime-skip its transform), or stop caching "
           f"on self",
    "203": "inject randomness/clocks at fit time (seeded, persisted in "
           "params) so transform replays bitwise-identically",
    "204": "pass state through fitted params or the Dataset, not module "
           "globals",
}


def _attr_chain(node: ast.AST) -> Tuple[str, ...]:
    """`np.random.default_rng` -> ('np', 'random', 'default_rng')."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _self_attr(node: ast.AST) -> Optional[str]:
    """The attribute name when `node` is (a subscript of) `self.<attr>`."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _TransformVisitor(ast.NodeVisitor):
    """Collect purity violations inside ONE transform-path function."""

    def __init__(self):
        self.self_mutations: List[Tuple[int, str, str]] = []  # line, attr, how
        self.nondet: List[Tuple[int, str]] = []               # line, chain
        self.global_state: List[Tuple[int, str]] = []         # line, what

    # -- self mutation ---------------------------------------------------
    def _note_target(self, target: ast.AST, how: str) -> None:
        attr = _self_attr(target)
        if attr is not None:
            self.self_mutations.append((target.lineno, attr, how))
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._note_target(elt, how)

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            self._note_target(t, "assigns")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._note_target(node.target, "updates")
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self._note_target(node.target, "assigns")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete):
        for t in node.targets:
            self._note_target(t, "deletes")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        fn = node.func
        # self.<attr>.append(...) and friends
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATOR_METHODS:
            attr = _self_attr(fn.value)
            if attr is not None:
                self.self_mutations.append(
                    (node.lineno, attr, f"calls .{fn.attr}() on"))
        # object.__setattr__(self, ...) / setattr(self, ...)
        chain = _attr_chain(fn)
        if chain[-1:] == ("__setattr__",) or chain == ("setattr",):
            if node.args and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id == "self":
                self.self_mutations.append(
                    (node.lineno, "<setattr>", "setattr() on"))
        if chain == ("globals",):
            self.global_state.append((node.lineno, "globals()"))
        self.generic_visit(node)

    # -- nondeterminism ---------------------------------------------------
    def visit_Attribute(self, node: ast.Attribute):
        chain = _attr_chain(node)
        for pref in _NONDET_CHAINS:
            if chain[:len(pref)] == pref or \
                    (len(pref) == 2 and pref[0] == "datetime"
                     and len(chain) >= 2 and chain[-1] == pref[1]
                     and "datetime" in chain):
                self.nondet.append((node.lineno, ".".join(chain)))
                return          # whole chain handled; nothing nested
        self.generic_visit(node)

    # -- global state ------------------------------------------------------
    def visit_Global(self, node: ast.Global):
        self.global_state.append(
            (node.lineno, "global " + ", ".join(node.names)))

    def visit_Nonlocal(self, node: ast.Nonlocal):
        self.global_state.append(
            (node.lineno, "nonlocal " + ", ".join(node.names)))


def _analyze_method(cls_name: str, fn: ast.FunctionDef, has_marker: bool,
                    where: str) -> List[Diagnostic]:
    v = _TransformVisitor()
    for stmt in fn.body:
        v.visit(stmt)
    out: List[Diagnostic] = []
    loc = f"{where}:{cls_name}.{fn.name}"
    for line, attr, how in v.self_mutations:
        if fn.name == "transform_value":
            out.append(Diagnostic(
                "TM-LINT-201",
                f"{cls_name}.transform_value {how} self.{attr} (line "
                f"{line}) — the row path runs concurrently under the "
                f"serving engine and scoring_row_fn",
                location=loc, fix_hint=_FIX["201"]))
        elif not has_marker:
            out.append(Diagnostic(
                "TM-LINT-202",
                f"{cls_name}.{fn.name} {how} self.{attr} (line {line}) "
                f"but the class does not declare `{MARKER} = True` — "
                f"the parallel executor may skip this transform and "
                f"silently drop the cached state",
                location=loc, fix_hint=_FIX["202"]))
    for line, chain in v.nondet:
        out.append(Diagnostic(
            "TM-LINT-203",
            f"{cls_name}.{fn.name} reads {chain} (line {line}) — "
            f"transform output would differ across replays",
            location=loc, fix_hint=_FIX["203"]))
    for line, what in v.global_state:
        out.append(Diagnostic(
            "TM-LINT-204",
            f"{cls_name}.{fn.name} touches module-global state "
            f"({what}, line {line})",
            location=loc, fix_hint=_FIX["204"]))
    return out


def _class_declares_marker(cls_node: ast.ClassDef) -> bool:
    for stmt in cls_node.body:
        targets = ()
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = (stmt.target,)
        for t in targets:
            if isinstance(t, ast.Name) and t.id == MARKER:
                val = stmt.value
                return bool(isinstance(val, ast.Constant) and val.value)
    return False


def analyze_source(source: str, where: str = "<source>",
                   class_names: Optional[Sequence[str]] = None
                   ) -> List[Diagnostic]:
    """Lint every stage-shaped class in a source TEXT (never executed).

    A class participates when it defines at least one transform-path
    method. The ``transform_caches_state`` marker is resolved from the
    class body only (source mode cannot see inherited markers — pass the
    live class to ``analyze_stage_class`` for MRO-accurate results).
    """
    tree = ast.parse(textwrap.dedent(source))
    out: List[Diagnostic] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        if class_names is not None and node.name not in class_names:
            continue
        marker = _class_declares_marker(node)
        for item in node.body:
            if isinstance(item, ast.FunctionDef) and \
                    item.name in TRANSFORM_METHODS:
                out.extend(_analyze_method(node.name, item, marker, where))
    return out


def analyze_stage_class(cls: type) -> List[Diagnostic]:
    """Lint one live stage class: each transform-path method is parsed
    at its DEFINING class in the MRO (so inherited impure transforms are
    caught once, at their source), with the marker resolved through
    normal attribute lookup."""
    out: List[Diagnostic] = []
    has_marker = bool(getattr(cls, MARKER, False))
    seen: Set[Tuple[type, str]] = set()
    for name in TRANSFORM_METHODS:
        definer = None
        for klass in cls.__mro__:
            if name in klass.__dict__:
                definer = klass
                break
        if definer is None or (definer, name) in seen:
            continue
        seen.add((definer, name))
        fn = definer.__dict__[name]
        try:
            src = textwrap.dedent(inspect.getsource(fn))
        except (OSError, TypeError):
            continue            # REPL/exec-defined: no source to parse
        try:
            tree = ast.parse(src)
        except SyntaxError:
            continue
        where = f"{definer.__module__}.{definer.__qualname__}"
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and node.name == name:
                out.extend(_analyze_method(
                    definer.__name__, node, has_marker, where))
    return out


def analyze_stages(stages: Iterable) -> List[Diagnostic]:
    """Lint the distinct classes behind a collection of stage objects."""
    out: List[Diagnostic] = []
    seen: Set[type] = set()
    for st in stages:
        cls = type(st)
        if cls in seen:
            continue
        seen.add(cls)
        out.extend(analyze_stage_class(cls))
    return out
