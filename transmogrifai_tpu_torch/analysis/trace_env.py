"""opaudit pass ``trace-env`` (TM-AUDIT-301): env reads frozen past
the call.

Counterpart of the JAX package's pass, which finds ``os.environ`` reads
reachable from ``jit``/``pallas_call``/``shard_map``-traced code: the
resolved value is burned into the traced program and a later env
change silently serves the stale policy. The port traces no program,
but the same hazard exists wherever a Python body's decisions outlive
the call that made them. The fix this pass points at is the same:
resolve the knob OUTSIDE and pass the value in (or key the cache on
it).

Mechanics (pure ``ast``, nothing imported):

* *Frozen roots*: functions decorated with ``functools.lru_cache`` /
  ``functools.cache`` (their body runs once per argument tuple);
  functions decorated with or passed to ``torch.compile``,
  ``torch.jit.script`` / ``torch.jit.trace`` and
  ``torch.cuda.make_graphed_callables`` (compiled or captured once),
  including ``lru_cache(...)(f)`` and lambdas passed to those wrappers;
  the body of a ``with torch.cuda.graph(...):`` block (captured once,
  replayed); and :data:`ROOT_FUNCS`, the kernels' build
  (``_cuda_build.load_library``: a library built and loaded once serves
  the process).
* *Call graph*: name-based, deliberately conservative. Resolved edges:
  local nested defs, module-level defs, ``from x import y`` /
  ``import x as m; m.f()`` within the audited package, ``self.m()``
  within a class, and ``obj.m()`` when exactly ONE audited class
  defines a method ``m`` (unique-name heuristic; a name defined twice
  is skipped rather than guessed).
* *Env sources*: ``os.environ`` / ``os.getenv`` reads, plus reads of
  module-level globals whose initializer contains an env read (the
  "module-level knob" form).

Everything reached from a frozen root runs inside the frozen decision,
so one reachability sweep over the call graph is the hazard surface.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..lint.diagnostics import Diagnostic
from .core import AuditContext, SourceFile, finding

#: attribute chains (suffixes) of the wrappers whose function argument
#: or decorated target runs once and is then reused: compiled, scripted,
#: traced or captured
TRACE_WRAPPERS = (("torch", "compile"), ("jit", "script"), ("jit", "trace"),
                  ("make_graphed_callables",))
#: decorators whose target's body runs once per argument tuple
CACHE_DECORATORS = (("lru_cache",), ("functools", "cache"),
                    ("functools", "lru_cache"), ("cache",))
#: context managers whose body is captured once and replayed
CAPTURE_CONTEXTS = (("cuda", "graph"),)
#: the kernels' build: (module, function) -> why its decisions outlive
#: the call
ROOT_FUNCS = {
    ("transmogrifai_tpu_torch._cuda_build", "load_library"):
        "the kernels' build (a library loaded once serves the process)",
}


def _ends_with(ch: Tuple[str, ...], suffixes) -> bool:
    return any(len(ch) >= len(s) and ch[-len(s):] == s for s in suffixes)


def _is_wrapper(ch: Tuple[str, ...]) -> bool:
    return _ends_with(ch, TRACE_WRAPPERS) or _ends_with(ch,
                                                        CACHE_DECORATORS)


def _chain(node: ast.AST) -> Tuple[str, ...]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _is_env_read(node: ast.AST) -> bool:
    """os.environ.get(..) / os.getenv(..) / os.environ[..] /
    environ.get — attribute-chain based, alias-tolerant."""
    if isinstance(node, ast.Call):
        ch = _chain(node.func)
        if ch[-1:] == ("getenv",) and (len(ch) == 1 or ch[-2] == "os"):
            return True
        if len(ch) >= 2 and ch[-2] == "environ" and ch[-1] in (
                "get", "setdefault", "items", "keys"):
            return True
    if isinstance(node, ast.Subscript):
        ch = _chain(node.value)
        if ch[-1:] == ("environ",):
            return True
    return False


class _FuncInfo:
    __slots__ = ("key", "sf", "node", "cls", "local_names",
                 "calls", "env_reads", "global_loads", "traced_by")

    def __init__(self, key, sf, node, cls):
        self.key = key                      # (module, qualname)
        self.sf = sf
        self.node = node
        self.cls = cls                      # enclosing class name or None
        self.local_names: Dict[str, tuple] = {}   # nested def name -> key
        self.calls: List[Tuple[str, ...]] = []    # raw call chains
        self.env_reads: List[int] = []            # line numbers
        self.global_loads: Set[str] = set()       # module-global Name loads
        self.traced_by: Optional[Tuple[str, int]] = None  # (how, line)


class _Graph:
    """Per-repo index: functions, imports, env-derived module globals."""

    def __init__(self):
        self.funcs: Dict[tuple, _FuncInfo] = {}
        #: module -> {local alias -> imported module name}
        self.mod_imports: Dict[str, Dict[str, str]] = {}
        #: module -> {name -> (source module, source name)}
        self.from_imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        #: module -> {global name assigned from an env-reading expr
        #:            -> line of the assignment}
        self.env_globals: Dict[str, Dict[str, int]] = {}
        #: method name -> list of keys (for the unique-name heuristic)
        self.methods: Dict[str, List[tuple]] = {}
        #: module-level function name -> key, per module
        self.mod_funcs: Dict[str, Dict[str, tuple]] = {}


def _resolve_relative(module: str, level: int, target: str,
                      is_package: bool = False) -> str:
    if level == 0:
        return target
    parts = module.split(".")
    # level 1 names the CONTAINING package: for a plain module that
    # strips its own last component, but a package __init__'s module
    # name IS its package, so it strips one component fewer
    strip = level - 1 if is_package else level
    base = parts[: len(parts) - strip] if len(parts) >= strip else []
    return ".".join(base + ([target] if target else [])).strip(".")


def _index_file(g: _Graph, sf: SourceFile) -> None:
    mod = sf.module
    g.mod_imports.setdefault(mod, {})
    g.from_imports.setdefault(mod, {})
    g.env_globals.setdefault(mod, {})
    g.mod_funcs.setdefault(mod, {})

    # imports register wherever they appear — this codebase leans on
    # function-local imports to break cycles and defer jax loading
    is_pkg = sf.relpath.endswith("/__init__.py")
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                g.mod_imports[mod][alias.asname or
                                   alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom):
            src = _resolve_relative(mod, node.level, node.module or "",
                                    is_package=is_pkg)
            for alias in node.names:
                g.from_imports[mod][alias.asname or alias.name] = (
                    src, alias.name)

    for node in sf.tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            value = node.value
            if value is None:
                continue
            has_env = any(_is_env_read(n) for n in ast.walk(value))
            if has_env:
                for t in targets:
                    if isinstance(t, ast.Name):
                        g.env_globals[mod][t.id] = t.lineno

    def walk_funcs(body, qual_prefix, cls):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{qual_prefix}{node.name}"
                key = (mod, qual)
                fi = _FuncInfo(key, sf, node, cls)
                g.funcs[key] = fi
                if cls is None and "." not in qual:
                    g.mod_funcs[mod][node.name] = key
                if cls is not None and qual.count(".") == 1:
                    g.methods.setdefault(node.name, []).append(key)
                _scan_function(g, fi)
                walk_funcs(node.body, qual + ".", None)
            elif isinstance(node, ast.ClassDef):
                walk_funcs(node.body, f"{qual_prefix}{node.name}.",
                           node.name)

    walk_funcs(sf.tree.body, "", None)


def _decorator_traces(dec: ast.AST) -> bool:
    """@functools.lru_cache / @lru_cache(maxsize=...) / @functools.cache
    / @torch.compile / @torch.compile(...) / @torch.jit.script /
    @partial(torch.compile, ...)"""
    ch = _chain(dec)
    if ch and _is_wrapper(ch):
        return True
    if isinstance(dec, ast.Call):
        ch = _chain(dec.func)
        if ch and _is_wrapper(ch):
            return True
        if ch[-1:] == ("partial",) and dec.args:
            inner = _chain(dec.args[0])
            if inner and _is_wrapper(inner):
                return True
    return False


def _scan_function(g: _Graph, fi: _FuncInfo) -> None:
    node = fi.node
    for dec in node.decorator_list:
        if _decorator_traces(dec):
            fi.traced_by = (f"@{ast.unparse(dec)}"[:60], node.lineno)
    mod, qual = fi.key
    for name_node in node.body:
        if isinstance(name_node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fi.local_names[name_node.name] = (mod,
                                              f"{qual}.{name_node.name}")

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, n):      # nested defs scanned on
            return                           # their own _FuncInfo

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Lambda(self, n):
            # a lambda's body runs when the enclosing (traced) code
            # invokes it — analyze it as part of this function
            self.generic_visit(n)

        def visit_Call(self, n):
            if _is_env_read(n):
                fi.env_reads.append(n.lineno)
            else:
                ch = _chain(n.func)
                if ch:
                    fi.calls.append(ch)
            for a in n.args:
                self.visit(a)
            for kw in n.keywords:
                self.visit(kw.value)
            self.visit(n.func)

        def visit_Subscript(self, n):
            if _is_env_read(n):
                fi.env_reads.append(n.lineno)
            self.generic_visit(n)

        def visit_Name(self, n):
            if isinstance(n.ctx, ast.Load):
                fi.global_loads.add(n.id)

    v = V()
    for stmt in node.body:
        v.visit(stmt)


def _wrapper_roots(g: _Graph, sf: SourceFile) -> List[tuple]:
    """Functions passed BY NAME to torch.compile() / torch.jit.script()
    / torch.jit.trace() / make_graphed_callables() / lru_cache(...)()
    anywhere in the file, plus lambdas (lambdas scanned inline: their
    body's env reads are reported directly), plus the body of every
    ``with torch.cuda.graph(...):`` block (indexed as a function of its
    own, a root)."""
    mod = sf.module
    roots: List[tuple] = []
    lambda_reads: List[int] = []
    node_key = {id(fi.node): k for k, fi in g.funcs.items()
                if fi.sf is sf}

    # map: enclosing function stack for local-name resolution
    def enclosing_local(name: str, stack: List[tuple]) -> Optional[tuple]:
        for key in reversed(stack):
            fi = g.funcs.get(key)
            if fi and name in fi.local_names:
                return fi.local_names[name]
        return g.mod_funcs.get(mod, {}).get(name)

    def walk(node, stack):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            key = node_key.get(id(node))
            stack = stack + [key] if key else stack
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(it.context_expr, ast.Call)
                and _ends_with(_chain(it.context_expr.func),
                               CAPTURE_CONTEXTS)
                for it in node.items):
            encl = g.funcs.get(stack[-1]) if stack else None
            key = (mod, f"{encl.key[1] if encl else '<module>'}"
                        f".<graph@{node.lineno}>")
            body = ast.FunctionDef(
                name=key[1], args=ast.arguments(
                    posonlyargs=[], args=[], kwonlyargs=[],
                    kw_defaults=[], defaults=[]),
                body=node.body, decorator_list=[], lineno=node.lineno)
            fi = _FuncInfo(key, sf, body, encl.cls if encl else None)
            if encl is not None:
                fi.local_names.update(encl.local_names)
            g.funcs[key] = fi
            _scan_function(g, fi)
            roots.append((key, node.lineno, "with torch.cuda.graph"))
        if isinstance(node, ast.Call):
            ch = _chain(node.func)
            wrapped = None
            if isinstance(node.func, ast.Call) and _ends_with(
                    _chain(node.func.func), CACHE_DECORATORS) \
                    and node.args:
                wrapped = node.args[0]          # lru_cache(...)(f)
                ch = _chain(node.func.func)
            elif ch and _is_wrapper(ch) and node.args:
                wrapped = node.args[0]
            elif ch and _is_wrapper(ch):
                kw = {k.arg: k.value for k in node.keywords}
                wrapped = kw.get("model") or kw.get("func") \
                    or kw.get("fn") or kw.get("f")
            if wrapped is not None:
                if isinstance(wrapped, ast.Name):
                    key = enclosing_local(wrapped.id, stack)
                    if key and key in g.funcs:
                        roots.append((key, node.lineno,
                                      f"{'.'.join(ch)}({wrapped.id})"))
                elif isinstance(wrapped, ast.Lambda):
                    for n in ast.walk(wrapped.body):
                        if _is_env_read(n):
                            lambda_reads.append(n.lineno)
        for child in ast.iter_child_nodes(node):
            walk(child, stack)

    walk(sf.tree, [])
    return [(key, line, how) for key, line, how in roots], lambda_reads


#: cap on the rare-method fan-out: a name defined in more classes than
#: this is too generic to resolve without type information
_METHOD_FANOUT = 4


def _lookup(g: _Graph, module: str, name: str,
            depth: int = 0) -> Optional[tuple]:
    """(module, name) -> a def key, chasing package-__init__
    re-exports (``from .impl import f``) up to 3 hops."""
    key = (module, name)
    if key in g.funcs:
        return key
    if depth >= 3:
        return None
    imp = g.from_imports.get(module, {}).get(name)
    if imp is not None:
        return _lookup(g, imp[0], imp[1], depth + 1)
    return None


def _resolve_call(g: _Graph, fi: _FuncInfo,
                  ch: Tuple[str, ...]) -> List[tuple]:
    mod, qual = fi.key
    if len(ch) == 1:
        name = ch[0]
        if name in fi.local_names:
            return [fi.local_names[name]]
        if name in g.mod_funcs.get(mod, {}):
            return [g.mod_funcs[mod][name]]
        imp = g.from_imports.get(mod, {}).get(name)
        if imp:
            key = _lookup(g, imp[0], imp[1])
            return [key] if key is not None else []
        return []
    if ch[0] == "self" and len(ch) == 2 and fi.cls is not None:
        # the defining class's method plus every same-name override in
        # the package (subclass dispatch: _TreeFamily._fit_binned resolves
        # to the family overrides that actually run)
        keys = [k for k in g.methods.get(ch[1], ())
                if k[1].endswith(f".{ch[1]}")]
        own = (mod, f"{fi.cls}.{ch[1]}")
        if own in g.funcs and own not in keys:
            keys.append(own)
        return sorted(keys) if len(keys) <= _METHOD_FANOUT + 1 \
            else ([own] if own in g.funcs else [])
    if len(ch) == 2:
        # imported module attr: import x.y as m; m.f()
        target_mod = g.mod_imports.get(mod, {}).get(ch[0])
        if target_mod:
            key = _lookup(g, target_mod, ch[1])
            return [key] if key is not None else []
        # `from . import kernels` form lands in from_imports
        imp = g.from_imports.get(mod, {}).get(ch[0])
        if imp:
            key = _lookup(g, f"{imp[0]}.{imp[1]}" if imp[0] else imp[1],
                          ch[1])
            return [key] if key is not None else []
    # rare-method heuristic: obj.m() resolves when few enough audited
    # classes define m (family-object dispatch, e.g. fit_eval_grid)
    cands = g.methods.get(ch[-1], [])
    if 1 <= len(cands) <= _METHOD_FANOUT:
        return sorted(cands)
    return []


def run(ctx: AuditContext) -> List[Diagnostic]:
    g = _Graph()
    files = ctx.runtime_files
    for sf in files:
        _index_file(g, sf)

    roots: List[tuple] = []       # (func key, how, line)
    out: List[Diagnostic] = []
    for sf in files:
        wroots, lambda_reads = _wrapper_roots(g, sf)
        for key, line, how in wroots:
            roots.append((key, how, line))
        for line in sorted(set(lambda_reads)):
            out.append(finding(
                "TM-AUDIT-301",
                f"lambda passed to a compiling or caching wrapper reads "
                f"os.environ once, for every later call",
                sf.relpath, line,
                fix_hint="resolve the knob outside the traced lambda "
                         "and close over the VALUE"))
    for key, fi in list(g.funcs.items()):
        if fi.traced_by is not None:
            roots.append((key, fi.traced_by[0], fi.traced_by[1]))
        elif key in ROOT_FUNCS:
            roots.append((key, ROOT_FUNCS[key], fi.node.lineno))

    # BFS: reached[key] = (root key, chain of keys from root)
    reached: Dict[tuple, Tuple[tuple, Tuple[tuple, ...]]] = {}
    frontier = []
    for key, how, line in sorted(set(roots)):
        if key not in reached:
            reached[key] = (key, (key,))
            frontier.append(key)
    while frontier:
        key = frontier.pop()
        fi = g.funcs.get(key)
        if fi is None:
            continue
        root, chain = reached[key]
        for ch in fi.calls:
            for callee in _resolve_call(g, fi, ch):
                if callee not in reached:
                    reached[callee] = (root, chain + (callee,))
                    frontier.append(callee)

    seen_sites: Set[Tuple[str, int]] = set()
    for key in sorted(reached):
        fi = g.funcs.get(key)
        if fi is None:
            continue
        root, chain = reached[key]
        chain_s = " -> ".join(f"{m.split('.')[-1]}.{q}" for m, q in chain)
        for line in sorted(set(fi.env_reads)):
            site = (fi.sf.relpath, line)
            if site in seen_sites:
                continue
            seen_sites.add(site)
            out.append(finding(
                "TM-AUDIT-301",
                f"env read frozen past the call inside {key[1]} "
                f"(reached from root {root[1]} via {chain_s})",
                fi.sf.relpath, line,
                fix_hint="thread the resolved value in as an argument "
                         "(and key any cache on it)"))
        mod = key[0]
        for name in sorted(fi.global_loads
                           & set(g.env_globals.get(mod, ()))):
            site = (fi.sf.relpath, fi.node.lineno)
            decl_line = g.env_globals[mod][name]
            if (fi.sf.relpath, decl_line, name) in seen_sites:
                continue
            seen_sites.add((fi.sf.relpath, decl_line, name))
            out.append(finding(
                "TM-AUDIT-301",
                f"{key[1]} (reachable from a frozen root via {chain_s}) "
                f"reads "
                f"module global {name!r}, initialized from os.environ "
                f"at line {decl_line}",
                fi.sf.relpath, decl_line,
                fix_hint="pass the value as an argument instead of a "
                         "module-level knob"))
    return out
