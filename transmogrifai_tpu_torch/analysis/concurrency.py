"""opaudit pass ``concurrency`` (TM-AUDIT-320..323): static race
detection over the serving stack's threaded control planes.

Where ``lock-discipline`` (locks.py) checks how locks NEST, this pass
checks what locks GUARD — a RacerD/ERASER-style lockset analysis run
entirely on the parsed AST (never importing the analyzed modules):

1. **Thread-root discovery.** For every class in the concurrency scope
   (serving/, serving/transport/, continuum/, telemetry/,
   profiling.py) enumerate its thread entry points: the implicit
   ``main`` root (every public method — caller threads), plus one root
   per method the class hands to another thread — ``threading.Thread(
   target=self._loop)``, ``pool.submit(self._dispatch, ...)``,
   ``fut.add_done_callback(self._on_done)`` — and one root per nested
   ``def``/``lambda`` (callbacks execute later, on whichever thread
   fires them, and do NOT inherit the locks their creator held).
   Per-method thread-reachability is the closure of same-class
   ``self.method()`` calls from each root.

2. **Shared-field inventory + GuardedBy inference.** A ``self._*``
   field reachable from >= 2 distinct roots is SHARED. For every read
   and write the pass infers the lockset held: lexical ``with
   self._lock:`` / ``with self._cond:`` holds (``threading.Condition``
   built over an explicit lock canonicalizes to that lock; local
   aliases like ``cond = self._cond`` resolve), the SnapshotStats
   helpers (``with self._mutating():`` and ``self._bump(...)`` hold
   ``self._lock``), and entry-held locks — a private method called
   ONLY under ``with self._life:`` inherits ``{_life}`` at entry (the
   intersection over all call sites, computed to fixpoint). A shared
   field with an empty guard set everywhere is TM-AUDIT-320; a field
   with a dominant guard but outlier accesses that skip it is
   TM-AUDIT-321, anchored at each outlier.

3. **Atomicity smells.** TM-AUDIT-322: within one function, a guarded
   field read under one ``with L:`` hold and then written under a
   LATER, separate hold of the same lock without re-reading it inside
   that hold — the classic check-then-act window. TM-AUDIT-323: a
   ``return self._x`` of a guarded mutable container (dict/list/set/
   deque built in ``__init__``) without copying inside the hold — the
   caller iterates the live object while other threads mutate it.

Precision levers (what keeps the findings triageable):

* fields written only in ``__init__`` are exempt (published-immutable);
* lock/condition objects themselves, ``threading.Event`` (atomic by
  contract), ``queue.Queue`` family, ``itertools.count`` (one C-level
  step under the GIL), and ``threading.Thread`` handles are exempt;
* accesses in methods no root reaches are ignored;
* classes that never hand a method to another thread have only the
  ``main`` root, hence no shared fields — single-threaded helpers and
  SnapshotStats subclasses (owned by the stats-discipline pass) stay
  silent here.

Deliberate lock-free designs (advisory occupancy reads, copy-on-write
tuple snapshots, Event-sequenced flags) are EXPECTED to trip 320/321 —
that is the point: each one carries an ``# opaudit:
disable=concurrency -- <why this race is benign>`` so the invariant is
written next to the code relying on it (docs/ANALYSIS.md).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..lint.diagnostics import Diagnostic
from .core import AuditContext, SourceFile, finding
from .locks import LOCK_SCOPE_PREFIXES, _self_attr

#: same audited surface as the lock-discipline pass — the threaded
#: control planes (serving/ includes transport/ and worker.py).
CONCURRENCY_SCOPE_PREFIXES = LOCK_SCOPE_PREFIXES

#: constructors that make a field a lock (participates in locksets,
#: exempt from the shared-field checks itself)
_LOCK_CTORS = ("Lock", "RLock", "Condition")

#: constructors whose objects are safe to share without a guard:
#: Event/Semaphore are atomic by contract, the queue.Queue family
#: locks internally, itertools.count steps atomically under the GIL,
#: and Thread handles are lifecycle-only.
_ATOMIC_CTORS = ("Event", "Semaphore", "BoundedSemaphore", "Barrier",
                 "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
                 "count", "Thread")

#: constructors/literals that make a field a MUTABLE CONTAINER for the
#: publication check (TM-AUDIT-323)
_MUTABLE_CTORS = ("dict", "list", "set", "deque", "defaultdict",
                  "OrderedDict", "Counter")

#: method names that mutate their receiver — ``self._x.append(...)``
#: is a WRITE to the contents of field ``_x``
_MUTATOR_METHODS = frozenset({
    "append", "appendleft", "add", "clear", "discard", "extend",
    "insert", "pop", "popitem", "popleft", "remove", "reverse",
    "rotate", "setdefault", "sort", "update",
})

#: free functions that mutate their FIRST argument in place
_MUTATOR_FUNCS = frozenset({"heappush", "heappop", "heapify",
                            "heappushpop", "heapreplace"})

#: call sinks whose function arguments run LATER on another thread —
#: a lambda handed to one of these is a thread root; a lambda handed
#: to sort()/min()/filter() runs inline under the caller's holds
_CALLBACK_SINKS = frozenset({"add_done_callback", "submit", "Thread",
                             "Timer", "signal", "call_soon",
                             "call_soon_threadsafe", "call_later",
                             "start_new_thread", "apply_async"})


def _ctor_kind(value: ast.AST) -> Optional[str]:
    """The constructor name of ``self.x = threading.Lock()`` /
    ``deque()`` / ``{}`` / ``[]`` — or None for anything else."""
    if isinstance(value, ast.Dict):
        return "dict"
    if isinstance(value, ast.List):
        return "list"
    if isinstance(value, ast.Set):
        return "set"
    if isinstance(value, ast.Call):
        fn = value.func
        if isinstance(fn, ast.Name):
            return fn.id
        if isinstance(fn, ast.Attribute):
            return fn.attr
    return None


class _Access:
    """One read or write of ``self.<field>``: where, and under what."""

    __slots__ = ("field", "write", "holds", "line")

    def __init__(self, field: str, write: bool,
                 holds: Tuple[Tuple[str, Tuple[int, int]], ...],
                 line: int):
        self.field = field
        self.write = write
        #: innermost-last ((lock, hold-site-id), ...) — the id keys
        #: the check-then-act pairing, the lock names the lockset
        self.holds = holds
        self.line = line

    @property
    def lockset(self) -> frozenset:
        return frozenset(lock for lock, _hid in self.holds)

    def hold_id(self, lock: str):
        for l, hid in reversed(self.holds):
            if l == lock:
                return hid
        return None


class _Unit:
    """One analysis unit: a method, a nested def, or a lambda.
    Nested defs and lambdas are thread ROOTS of their own — callbacks
    run later, on whoever fires them, holding none of their creator's
    locks."""

    __slots__ = ("name", "line", "accesses", "calls", "returns",
                 "is_root", "entry")

    def __init__(self, name: str, line: int, is_root: bool):
        self.name = name
        self.line = line
        self.accesses: List[_Access] = []
        #: (callee method name, holds-at-site, line)
        self.calls: List[Tuple[str, tuple, int]] = []
        #: bare ``return self._x`` sites: (field, line)
        self.returns: List[Tuple[str, int]] = []
        self.is_root = is_root
        #: entry-held lockset (fixpoint over call sites); None =
        #: never reached
        self.entry: Optional[frozenset] = frozenset() if is_root else None


class _ClassModel:
    """Everything the checks need about one class: lock fields (with
    Condition-over-lock canonicalization), exempt fields, mutable
    container fields, the unit table, and the thread roots."""

    def __init__(self, sf: SourceFile, node: ast.ClassDef):
        self.sf = sf
        self.node = node
        self.qual = f"{sf.module}.{node.name}"
        self.lock_canon: Dict[str, str] = {}
        self.atomic_fields: Set[str] = set()
        self.mutable_fields: Set[str] = set()
        self.methods: Dict[str, ast.FunctionDef] = {}
        self.property_names: Set[str] = set()
        self.units: Dict[str, _Unit] = {}
        #: root label -> entry unit name
        self.roots: Dict[str, str] = {}
        bases = {b.id if isinstance(b, ast.Name) else getattr(b, "attr", "")
                 for b in node.bases}
        if "SnapshotStats" in bases:
            # the inherited stats lock: _mutating()/_bump() hold it
            self.lock_canon.setdefault("_lock", "_lock")

    def canon(self, lock: str) -> str:
        seen = set()
        while lock in self.lock_canon and \
                self.lock_canon[lock] != lock and lock not in seen:
            seen.add(lock)
            lock = self.lock_canon[lock]
        return lock


def _is_public(name: str) -> bool:
    """Entry method of the implicit ``main`` root (caller threads)."""
    if name == "__init__":
        return False
    if name.startswith("__") and name.endswith("__"):
        return True
    return not name.startswith("_")


def _classify_fields(model: _ClassModel) -> None:
    """First sweep: every ``self.x = <ctor>(...)`` anywhere in the
    class body classifies the field — lock (with Condition-over-lock
    aliasing), atomic-by-contract, or mutable container — and
    ``__init__`` writes feed the published-immutable exemption."""
    for item in model.node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        model.methods[item.name] = item
        for dec in item.decorator_list:
            name = dec.id if isinstance(dec, ast.Name) \
                else getattr(dec, "attr", "")
            if name in ("property", "cached_property", "setter"):
                model.property_names.add(item.name)
        for n in ast.walk(item):
            if not isinstance(n, ast.Assign):
                continue
            kind = _ctor_kind(n.value)
            if kind is None:
                continue
            for t in n.targets:
                attr = _self_attr(t)
                if not attr:
                    continue
                if kind in _LOCK_CTORS:
                    target = attr
                    if kind == "Condition" and isinstance(n.value, ast.Call) \
                            and n.value.args:
                        over = _self_attr(n.value.args[0])
                        if over:
                            target = over     # Condition(self._lock)
                    model.lock_canon[attr] = target
                elif kind in _ATOMIC_CTORS:
                    model.atomic_fields.add(attr)
                elif kind in _MUTABLE_CTORS:
                    model.mutable_fields.add(attr)


def _walk_unit(model: _ClassModel, unit: _Unit, body) -> None:
    """Collect accesses/calls/returns for one unit, tracking the
    lexical lock holds (with local alias resolution) and spinning off
    nested defs/lambdas as fresh root units."""
    aliases: Dict[str, str] = {}

    def lock_of(item: ast.withitem) -> Optional[str]:
        ce = item.context_expr
        attr = None
        if isinstance(ce, ast.Call):
            a = _self_attr(ce.func)
            if a == "_mutating":
                return model.canon("_lock")
            attr = a
        else:
            attr = _self_attr(ce)
            if attr is None and isinstance(ce, ast.Name):
                attr = aliases.get(ce.id)
        if attr is None:
            return None
        if attr in model.lock_canon or "lock" in attr.lower() \
                or "cond" in attr.lower():
            return model.canon(attr)
        return None

    def spawn(node, label: str) -> None:
        sub = _Unit(f"{unit.name}.{label}", node.lineno, is_root=True)
        model.units[sub.name] = sub
        model.roots[f"cb:{sub.name}"] = sub.name
        body_ = node.body if isinstance(node.body, list) else [node.body]
        _walk_unit(model, sub, body_)

    def record(field: str, write: bool, holds, line: int) -> None:
        unit.accesses.append(_Access(field, write, holds, line))

    def write_target(t, holds) -> None:
        """A write through an assignment target: ``self._x = v``,
        ``self._x[k] = v``, ``self._x.y = v``, tuple unpacking."""
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                write_target(el, holds)
            return
        base = t
        while isinstance(base, ast.Subscript):
            base = base.value
        attr = _self_attr(base)
        if attr is not None:
            record(attr, True, holds, t.lineno)
            return
        # self._x.y = v / self._x[k].y = v — mutation THROUGH field _x
        if isinstance(base, ast.Attribute):
            inner = base.value
            while isinstance(inner, ast.Subscript):
                inner = inner.value
            attr = _self_attr(inner)
            if attr is not None:
                record(attr, True, holds, t.lineno)

    def walk_expr(n, holds) -> None:
        """Reads, mutator calls, same-class calls, callback refs."""
        if isinstance(n, ast.Lambda):
            # a bare lambda (sort key, filter predicate, dict default)
            # runs inline on this thread under these holds; only a
            # lambda handed to a _CALLBACK_SINKS call becomes a root
            walk_expr(n.body, holds)
            return
        if isinstance(n, ast.Call):
            fn = n.func
            sink_name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            is_sink = sink_name in _CALLBACK_SINKS
            attr = _self_attr(fn)
            if attr is not None:
                if attr in model.methods:
                    unit.calls.append((attr, holds, n.lineno))
                elif attr == "_bump":
                    # SnapshotStats helper: writes the named counters
                    # under self._lock
                    held = holds + ((model.canon("_lock"),
                                     (n.lineno, n.col_offset)),)
                    for kw in n.keywords:
                        if kw.arg:
                            record(kw.arg, True, held, n.lineno)
                elif attr != "_mutating":
                    record(attr, False, holds, n.lineno)
            elif isinstance(fn, ast.Attribute):
                recv = _self_attr(fn.value)
                if recv is not None:
                    # self._x.append(...) — container mutation or read
                    record(recv, fn.attr in _MUTATOR_METHODS,
                           holds, n.lineno)
                else:
                    walk_expr(fn.value, holds)
                if fn.attr in _MUTATOR_FUNCS and n.args:
                    first = _self_attr(n.args[0])
                    if first is not None:
                        record(first, True, holds, n.lineno)
            elif isinstance(fn, ast.Name):
                if fn.id in _MUTATOR_FUNCS and n.args:
                    first = _self_attr(n.args[0])
                    if first is not None:
                        record(first, True, holds, n.lineno)
            for a in n.args:
                if isinstance(a, ast.Lambda) and is_sink:
                    spawn(a, f"<lambda>L{a.lineno}")
                else:
                    walk_expr(a, holds)
            for kw in n.keywords:
                if isinstance(kw.value, ast.Lambda) \
                        and (is_sink or kw.arg == "target"):
                    spawn(kw.value, f"<lambda>L{kw.value.lineno}")
                else:
                    walk_expr(kw.value, holds)
            return
        if isinstance(n, ast.Attribute):
            attr = _self_attr(n)
            if attr is not None:
                if attr in model.methods:
                    # a bound method used as a VALUE — Thread target,
                    # pool.submit arg, done-callback: a thread root
                    # (property reads are plain reads, not callbacks)
                    if attr not in model.property_names:
                        model.roots.setdefault(f"cb:{attr}", attr)
                    else:
                        record(attr, False, holds, n.lineno)
                else:
                    record(attr, False, holds, n.lineno)
                return
            walk_expr(n.value, holds)
            return
        for child in ast.iter_child_nodes(n):
            walk_expr(child, holds)

    def walk_stmt(n, holds) -> None:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            spawn(n, n.name)
            return
        if isinstance(n, ast.ClassDef):
            return      # nested class: different ``self`` entirely
        if isinstance(n, ast.With):
            inner = holds
            for item in n.items:
                walk_expr(item.context_expr, holds)
                tok = lock_of(item)
                if tok:
                    inner = inner + ((tok, (n.lineno, n.col_offset)),)
            for stmt in n.body:
                walk_stmt(stmt, inner)
            return
        if isinstance(n, ast.Assign):
            walk_expr(n.value, holds)
            # local lock alias: ``cond = self._cond`` (records the
            # read above; the alias makes later ``with cond:`` resolve)
            if len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
                src = _self_attr(n.value)
                if src is not None and (src in model.lock_canon
                                        or "lock" in src.lower()
                                        or "cond" in src.lower()):
                    aliases[n.targets[0].id] = src
            for t in n.targets:
                write_target(t, holds)
            return
        if isinstance(n, ast.AugAssign):
            walk_expr(n.value, holds)
            attr = _self_attr(n.target)
            if attr is not None:
                record(attr, False, holds, n.lineno)   # read...
                record(attr, True, holds, n.lineno)    # ...then write
            else:
                write_target(n.target, holds)
            return
        if isinstance(n, ast.Return):
            if n.value is not None:
                attr = _self_attr(n.value)
                if attr is not None:
                    unit.returns.append((attr, n.lineno))
                walk_expr(n.value, holds)
            return
        if isinstance(n, ast.Expr):
            walk_expr(n.value, holds)
            return
        # compound statements: walk tests/iters as expressions,
        # bodies as statements
        for field_name, value in ast.iter_fields(n):
            if field_name in ("body", "orelse", "finalbody", "handlers"):
                items = value if isinstance(value, list) else [value]
                for sub in items:
                    if isinstance(sub, ast.excepthandler):
                        for s in sub.body:
                            walk_stmt(s, holds)
                    elif isinstance(sub, ast.stmt):
                        walk_stmt(sub, holds)
                    elif isinstance(sub, ast.AST):
                        walk_expr(sub, holds)
            elif isinstance(value, ast.AST):
                if isinstance(value, ast.stmt):
                    walk_stmt(value, holds)
                else:
                    walk_expr(value, holds)
            elif isinstance(value, list):
                for sub in value:
                    if isinstance(sub, ast.stmt):
                        walk_stmt(sub, holds)
                    elif isinstance(sub, ast.AST):
                        walk_expr(sub, holds)

    for stmt in body:
        walk_stmt(stmt, ())


def _build_model(sf: SourceFile, node: ast.ClassDef) -> _ClassModel:
    model = _ClassModel(sf, node)
    _classify_fields(model)
    for name, item in model.methods.items():
        if name == "__init__":
            continue    # pre-publication: no other thread exists yet
        unit = _Unit(name, item.lineno, is_root=_is_public(name))
        model.units[name] = unit
        _walk_unit(model, unit, item.body)
    if any(_is_public(m) for m in model.methods if m != "__init__"):
        # one merged root for every caller-thread entry point
        model.roots["main"] = "__main__"
    return model


def _solve(model: _ClassModel) -> Dict[str, Set[str]]:
    """Entry-lockset fixpoint + per-unit root attribution. Returns
    unit name -> set of root labels reaching it."""
    # seed roots: cb:* units (their entry is already frozenset());
    # 'main' fans into every public method
    reached: Dict[str, Set[str]] = {u: set() for u in model.units}
    for label, entry in model.roots.items():
        if label == "main":
            for name, unit in model.units.items():
                if "." not in name and _is_public(name):
                    reached[name].add("main")
                    unit.entry = frozenset()
        elif entry in model.units:
            reached[entry].add(label)
            model.units[entry].entry = frozenset()
    changed = True
    while changed:
        changed = False
        for name, unit in model.units.items():
            if unit.entry is None:
                continue
            for callee, holds, _line in unit.calls:
                target = model.units.get(callee)
                if target is None:
                    continue
                at_site = unit.entry | frozenset(l for l, _ in holds)
                new_entry = at_site if target.entry is None \
                    else target.entry & at_site
                if new_entry != target.entry:
                    target.entry = new_entry
                    changed = True
                if not reached[name] <= reached[callee]:
                    reached[callee] |= reached[name]
                    changed = True
    return reached


def _field_table(model: _ClassModel, reached: Dict[str, Set[str]]):
    """field -> (roots, [(access, effective lockset)]) over reachable
    units, skipping exempt fields."""
    exempt = set(model.lock_canon) | model.atomic_fields \
        | set(model.methods)
    table: Dict[str, Tuple[Set[str], List[Tuple[_Access, frozenset]]]] = {}
    for name, unit in model.units.items():
        roots = reached.get(name, set())
        if not roots or unit.entry is None:
            continue
        for acc in unit.accesses:
            if acc.field in exempt or not acc.field.startswith("_"):
                continue
            entry = table.setdefault(acc.field, (set(), []))
            entry[0].update(roots)
            entry[1].append((acc, acc.lockset | unit.entry))
    return table


def _infer_guard(accesses) -> Optional[frozenset]:
    """The field's GuardedBy candidate: the lock(s) held at every
    lock-holding WRITE (writes define the guard — a read-only lock
    means nothing); falls back to read locksets for fields whose
    writes are all bare. None when no access holds anything."""
    write_sets = [ls for a, ls in accesses if a.write and ls]
    if write_sets:
        return frozenset.intersection(*write_sets)
    read_sets = [ls for a, ls in accesses if ls]
    if read_sets:
        return frozenset.intersection(*read_sets)
    return None


def _guard_findings(model: _ClassModel, table) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for field in sorted(table):
        roots, accesses = table[field]
        if len(roots) < 2:
            continue
        writes = [(a, ls) for a, ls in accesses if a.write]
        if not writes:
            continue    # written only in __init__: published-immutable
        root_note = ", ".join(sorted(roots))
        guard = _infer_guard(accesses)
        if guard is None:
            anchor = min(a.line for a, _ls in writes)
            out.append(finding(
                "TM-AUDIT-320",
                f"{model.qual}: shared field self.{field} is read and "
                f"written from multiple thread roots ({root_note}) "
                f"with no lock ever held",
                model.sf.relpath, anchor,
                fix_hint="guard every access with one lock, or "
                         "document the lock-free design with "
                         "'# opaudit: disable=concurrency -- <why>'"))
            continue
        if not guard:
            anchor = min(a.line for a, _ls in writes)
            locks = sorted({l for _a, ls in accesses for l in ls})
            out.append(finding(
                "TM-AUDIT-321",
                f"{model.qual}: shared field self.{field} (roots: "
                f"{root_note}) is written under disjoint guard sets "
                f"({', '.join('self.' + l for l in locks)}) — no "
                f"single lock orders its accesses",
                model.sf.relpath, anchor,
                fix_hint="pick ONE lock to guard the field and hold "
                         "it at every read and write"))
            continue
        guard_note = "/".join("self." + l for l in sorted(guard))
        for a, ls in sorted(accesses, key=lambda p: p[0].line):
            if ls & guard:
                continue
            kind = "written" if a.write else "read"
            out.append(finding(
                "TM-AUDIT-321",
                f"{model.qual}: shared field self.{field} {kind} "
                f"without {guard_note} held (writes are guarded by "
                f"it; roots: {root_note})",
                model.sf.relpath, a.line,
                fix_hint=f"take {guard_note} around this access, or "
                         f"suppress with a written reason if the "
                         f"race is deliberate"))
    return out


def _atomicity_findings(model: _ClassModel, table) -> List[Diagnostic]:
    """TM-AUDIT-322 check-then-act: read under one hold of L, write
    under a LATER separate hold of L in the same function, with no
    re-read inside the writing hold."""
    out: List[Diagnostic] = []
    guarded = {}
    for field, (roots, accesses) in table.items():
        if len(roots) < 2:
            continue
        g = _infer_guard(accesses)
        if g:
            guarded[field] = g
    for name in sorted(model.units):
        unit = model.units[name]
        if unit.entry is None:
            continue
        by_field: Dict[str, List[_Access]] = {}
        for acc in unit.accesses:
            if acc.field in guarded:
                by_field.setdefault(acc.field, []).append(acc)
        for field, accs in sorted(by_field.items()):
            for lock in sorted(guarded[field]):
                reads = [(a.hold_id(lock), a.line) for a in accs
                         if not a.write and a.hold_id(lock)]
                for w in accs:
                    if not w.write:
                        continue
                    w_hid = w.hold_id(lock)
                    if w_hid is None:
                        continue
                    reread = any(hid == w_hid and line <= w.line
                                 for hid, line in reads)
                    stale = [line for hid, line in reads
                             if hid != w_hid and line < w.line]
                    if stale and not reread:
                        out.append(finding(
                            "TM-AUDIT-322",
                            f"{model.qual}.{name}: self.{field} read "
                            f"under one self.{lock} hold (line "
                            f"{min(stale)}) then written under a "
                            f"separate hold at line {w.line} without "
                            f"re-reading it — another thread can "
                            f"mutate it between the two holds "
                            f"(check-then-act)",
                            model.sf.relpath, w.line,
                            fix_hint="merge the check and the act "
                                     "into ONE hold, or re-validate "
                                     "the field inside the writing "
                                     "hold"))
                        break   # one finding per write site
    return out


def _publication_findings(model: _ClassModel, table) -> List[Diagnostic]:
    """TM-AUDIT-323: ``return self._x`` of a guarded mutable container
    hands the caller the live object — it iterates after the hold is
    released while other threads mutate it."""
    out: List[Diagnostic] = []
    guarded_mutable = set()
    for field, (roots, accesses) in table.items():
        if field not in model.mutable_fields or len(roots) < 2:
            continue
        if _infer_guard(accesses):
            guarded_mutable.add(field)
    if not guarded_mutable:
        return out
    for name in sorted(model.units):
        unit = model.units[name]
        if unit.entry is None:
            continue
        for field, line in unit.returns:
            if field in guarded_mutable:
                out.append(finding(
                    "TM-AUDIT-323",
                    f"{model.qual}.{name} returns the live mutable "
                    f"container self.{field} that other threads "
                    f"mutate under a lock — the caller iterates it "
                    f"outside any hold",
                    model.sf.relpath, line,
                    fix_hint=f"return a copy made INSIDE the hold "
                             f"(list/dict(self.{field}))"))
    return out


def class_model(sf: SourceFile, node: ast.ClassDef) -> _ClassModel:
    """Build + solve one class (exposed for tests/tooling)."""
    model = _build_model(sf, node)
    model.reached = _solve(model)   # type: ignore[attr-defined]
    return model


def run(ctx: AuditContext) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for sf in ctx.runtime_files:
        if not any(sf.relpath.startswith(p) or sf.relpath == p
                   for p in CONCURRENCY_SCOPE_PREFIXES):
            continue
        for node in sf.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            model = _build_model(sf, node)
            if len(model.roots) < 2:
                continue    # single-rooted: no cross-thread sharing
            reached = _solve(model)
            table = _field_table(model, reached)
            out.extend(_guard_findings(model, table))
            out.extend(_atomicity_findings(model, table))
            out.extend(_publication_findings(model, table))
    return out
