"""Pass 4 — whole-package concurrency analysis (NNS6xx).

Counterpart of the JAX package's ``analyze/concurrency.py``; on the port
the card wait that blocks is ``synchronize`` (an event's or the device's).

Pure-AST, whole-program: every file of the package is parsed once, every
``threading.Lock/RLock/Condition`` construction becomes a *lock site*,
and a conservative inter-procedural walk of ``with <lock>:`` bodies
(following ``self.method()`` / ``self.attr.method()`` / module-function
calls within the package) builds the **lock-acquisition graph**: an edge
``A -> B`` means some code path can take ``B`` while holding ``A``.
Locks are keyed at *class granularity* (``Controller._lock``), the same
abstraction kernel lockdep uses — two instances of one class share a
key, so the graph describes lock *order*, not individual objects.

- **NNS601** a cycle in the acquisition graph: two code paths take the
  same pair of locks in opposite orders — a potential deadlock.  Both
  acquisition paths are printed.  Self-edges (re-acquiring the same
  class-keyed lock) are not reported: for ``RLock`` they are legal, and
  for distinct instances of one class they are order-unobservable here.
- **NNS602** hold-and-block: a call that can block indefinitely —
  socket ``recv/recvfrom/accept/sendall``, ``Event.wait``/``join``,
  ``select``, ``synchronize``, registry ``snapshot()`` — made (or
  reachable through package calls) while a lock is held.  Waiting on
  the *same* condition the ``with`` holds is exempt (``Condition.wait``
  releases it).
- **NNS603** unguarded shared state: an attribute assigned both from a
  ``Thread(target=self._x)`` entry point and from a public method, with
  at least one of the writes outside any lock.
- **NNS604** leaf-lock discipline: a lock whose construction line
  carries ``# nns-lock: leaf`` promises to never be held across another
  acquisition (that promise is what makes it safe to take from *any*
  context, e.g. the control audit lock on the scrape path).
  Acquiring any other lock — directly or through a call — while a
  declared leaf is held breaks the promise.

Suppressions use the shared grammar (``# nns-lint: disable=NNS602 --
reason``, see :mod:`.codelint`).  The analysis also exports the graph
itself (:class:`LockGraph`: nodes/edges/sites, ``--json`` /``--dot``)
so tools can render what the runtime witness (``utils/lockdep.py``)
later confirms or refutes.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .codelint import _Suppressions, _lockish, _unparse
from .diagnostics import Diagnostic, sort_diagnostics

#: attribute calls that can block indefinitely while a lock is held
_BLOCK_ATTRS = {"recv", "recvfrom", "accept", "sendall", "join",
                "select", "synchronize"}
#: ``.wait``/``.wait_for`` block too, modulo the Condition exemption
_WAIT_ATTRS = {"wait", "wait_for"}
#: receiver names that mark ``snapshot()`` as the registry scrape
_REGISTRYISH = re.compile(r"registry", re.IGNORECASE)
#: ``<mod>.join`` receivers that are path math, not thread joins
_PATH_MODULES = {"os.path", "posixpath", "ntpath", "pathlib"}
#: ``# nns-lock: leaf`` on a lock construction line declares a leaf lock
_LEAF_RE = re.compile(r"#\s*nns-lock:\s*leaf\b")
_LOCK_CTORS = {"Lock", "RLock", "Condition"}
#: call-following depth cap: beyond this the summary is treated as empty
_MAX_DEPTH = 8

_SYNC_CTORS = {"Lock", "RLock", "Condition", "Event", "Semaphore",
               "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue",
               "LifoQueue", "PriorityQueue", "deque", "local"}


class LockSite:
    """One lock *key* (class-or-module granularity) plus where it is
    constructed.  ``leaf`` means the construction line declared
    ``# nns-lock: leaf``."""

    __slots__ = ("key", "kind", "display", "line", "leaf")

    def __init__(self, key: str, kind: str, display: str, line: int,
                 leaf: bool = False):
        self.key = key
        self.kind = kind
        self.display = display
        self.line = line
        self.leaf = leaf


class LockGraph:
    """The exported acquisition graph: ``nodes`` keyed like
    ``Controller._lock`` / ``pkg/mod.py:_HUB_LOCK``, ``edges`` with the
    example acquisition path that created them."""

    def __init__(self):
        self.nodes: Dict[str, LockSite] = {}
        self.edges: Dict[Tuple[str, str], dict] = {}

    def node(self, site: LockSite) -> LockSite:
        return self.nodes.setdefault(site.key, site)

    def edge(self, src: str, dst: str, path: List[str]) -> None:
        e = self.edges.get((src, dst))
        if e is None:
            self.edges[(src, dst)] = {"src": src, "dst": dst,
                                      "path": list(path), "count": 1}
        else:
            e["count"] += 1

    def as_graph_dict(self) -> dict:
        return {
            "nodes": [
                {"key": s.key, "kind": s.kind, "leaf": s.leaf,
                 "site": f"{s.display}:L{s.line}"}
                for s in sorted(self.nodes.values(),
                                key=lambda s: s.key)],
            "edges": [
                {"src": e["src"], "dst": e["dst"], "count": e["count"],
                 "path": e["path"]}
                for e in sorted(self.edges.values(),
                                key=lambda e: (e["src"], e["dst"]))],
        }

    def to_dot(self) -> str:
        lines = ['digraph "lock-order" {', "  rankdir=LR;",
                 "  node [shape=box, fontsize=10];"]
        for s in sorted(self.nodes.values(), key=lambda s: s.key):
            shape = ', style=bold, color="darkgreen"' if s.leaf else ""
            lines.append(
                f'  "{s.key}" [label="{s.key}\\n{s.kind} '
                f'{s.display}:L{s.line}"{shape}];')
        for e in sorted(self.edges.values(),
                        key=lambda e: (e["src"], e["dst"])):
            lines.append(f'  "{e["src"]}" -> "{e["dst"]}" '
                         f'[label="{e["count"]}", fontsize=8];')
        lines.append("}")
        return "\n".join(lines)

    def cycles(self) -> List[List[str]]:
        """Simple cycles of length >= 2, deduplicated by node set."""
        adj: Dict[str, List[str]] = {}
        for (a, b) in self.edges:
            if a != b:
                adj.setdefault(a, []).append(b)
        seen: Set[frozenset] = set()
        out: List[List[str]] = []
        for (a, b) in sorted(self.edges):
            if a == b:
                continue
            path = self._find_path(adj, b, a)
            if path is None:
                continue
            cyc = [a] + path  # path = [b, ..., a]: closes at a
            key = frozenset(cyc)
            if key in seen:
                continue
            seen.add(key)
            out.append(cyc)
        return out

    def _find_path(self, adj, start: str, goal: str
                   ) -> Optional[List[str]]:
        stack = [(start, [start])]
        visited = {start}
        while stack:
            node, path = stack.pop()
            if node == goal:
                return path
            for nxt in adj.get(node, ()):
                if nxt not in visited:
                    visited.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None


# -- per-file model ----------------------------------------------------------


class _Fn:
    __slots__ = ("node", "display", "cls", "qual")

    def __init__(self, node, display, cls):
        self.node = node
        self.display = display
        self.cls = cls  # class name or None for module functions
        self.qual = (f"{cls}.{node.name}" if cls else node.name)


class _Cls:
    __slots__ = ("name", "display", "bases", "methods", "attr_types",
                 "lock_attrs", "thread_targets")

    def __init__(self, name, display, bases):
        self.name = name
        self.display = display
        self.bases = bases
        self.methods: Dict[str, _Fn] = {}
        self.attr_types: Dict[str, str] = {}
        self.lock_attrs: Dict[str, LockSite] = {}
        self.thread_targets: Set[str] = set()


def _ann_name(ann) -> Optional[str]:
    """Extract a class name from an annotation AST (unwraps Optional[X],
    "X" string forms)."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split("[")[-1].rstrip("]").split(".")[-1] or None
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Attribute):
        return ann.attr
    if isinstance(ann, ast.Subscript):  # Optional[X] / List[X]
        return _ann_name(ann.slice)
    return None


def _lock_ctor_kind(value: ast.expr) -> Optional[str]:
    """``threading.Lock()`` / ``Lock()`` → "Lock" (etc.), else None."""
    if not isinstance(value, ast.Call):
        return None
    f = value.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    return name if name in _LOCK_CTORS else None


def _sync_ctor(value: ast.expr) -> bool:
    if not isinstance(value, ast.Call):
        return False
    f = value.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    return name in _SYNC_CTORS


class _File:
    __slots__ = ("display", "source", "lines", "tree", "suppress",
                 "classes", "funcs", "module_locks", "import_mods",
                 "import_origin")

    def __init__(self, display: str, source: str):
        self.display = display
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=display)
        self.suppress = _Suppressions(source)
        self.classes: List[_Cls] = []
        self.funcs: Dict[str, _Fn] = {}
        self.module_locks: Dict[str, LockSite] = {}
        #: local alias -> module basename ("watch") for in-package
        #: ``from ..obs import watch as _watch`` style imports
        self.import_mods: Dict[str, str] = {}
        #: local alias -> (source module basename, original name) for
        #: ``from .transport import _HUB_LOCK`` style imports
        self.import_origin: Dict[str, Tuple[str, str]] = {}
        self._collect()

    def _leaf_at(self, line: int) -> bool:
        idx = line - 1
        return (0 <= idx < len(self.lines)
                and bool(_LEAF_RE.search(self.lines[idx])))

    def _collect(self) -> None:
        # imports anywhere (this codebase defers many imports into
        # function bodies to break import cycles)
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._collect_import(node)
        for node in self.tree.body:
            if isinstance(node, ast.Assign):
                kind = _lock_ctor_kind(node.value)
                if kind:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.module_locks[t.id] = LockSite(
                                f"{self.display}:{t.id}", kind,
                                self.display, node.lineno,
                                self._leaf_at(node.lineno))
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                self.funcs[node.name] = _Fn(node, self.display, None)
            elif isinstance(node, ast.ClassDef):
                self._collect_class(node)

    def _collect_import(self, node) -> None:
        if isinstance(node, ast.ImportFrom):
            modbase = (node.module or "").split(".")[-1]
            for a in node.names:
                self.import_mods[a.asname or a.name] = a.name
                if modbase:
                    self.import_origin[a.asname or a.name] = \
                        (modbase, a.name)
        else:
            for a in node.names:
                self.import_mods[a.asname or a.name] = \
                    a.name.split(".")[-1]

    def _collect_class(self, node: ast.ClassDef) -> None:
        bases = []
        for b in node.bases:
            if isinstance(b, ast.Name):
                bases.append(b.id)
            elif isinstance(b, ast.Attribute):
                bases.append(b.attr)
        cls = _Cls(node.name, self.display, bases)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cls.methods[item.name] = _Fn(item, self.display,
                                             node.name)
                self._collect_self_assigns(cls, item)
            elif isinstance(item, ast.AnnAssign) \
                    and isinstance(item.target, ast.Name):
                t = _ann_name(item.annotation)
                if t:
                    cls.attr_types.setdefault(item.target.id, t)
            elif isinstance(item, ast.Assign):
                # class-level lock: _REG_LOCK = threading.Lock()
                kind = _lock_ctor_kind(item.value)
                if kind:
                    for t in item.targets:
                        if isinstance(t, ast.Name):
                            cls.lock_attrs[t.id] = LockSite(
                                f"{node.name}.{t.id}", kind,
                                self.display, item.lineno,
                                self._leaf_at(item.lineno))
        # Thread(target=self.m) entry points, anywhere in the class
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                fname = n.func.attr if isinstance(n.func, ast.Attribute) \
                    else (n.func.id if isinstance(n.func, ast.Name)
                          else "")
                if fname != "Thread":
                    continue
                for kw in n.keywords:
                    if kw.arg == "target" \
                            and isinstance(kw.value, ast.Attribute) \
                            and isinstance(kw.value.value, ast.Name) \
                            and kw.value.value.id == "self":
                        cls.thread_targets.add(kw.value.attr)
        self.classes.append(cls)

    def _collect_self_assigns(self, cls: _Cls, fn_node) -> None:
        """Lock attrs + attr type hints from ``self.x = ...`` bodies and
        annotated __init__ params assigned straight onto self."""
        ann = {}
        if fn_node.name == "__init__":
            args = fn_node.args
            for a in args.args + args.kwonlyargs:
                t = _ann_name(a.annotation)
                if t:
                    ann[a.arg] = t
        for n in ast.walk(fn_node):
            if not isinstance(n, ast.Assign):
                continue
            for t in n.targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                kind = _lock_ctor_kind(n.value)
                if kind:
                    cls.lock_attrs[t.attr] = LockSite(
                        f"{cls.name}.{t.attr}", kind, self.display,
                        n.lineno, self._leaf_at(n.lineno))
                    continue
                if isinstance(n.value, ast.Call) \
                        and isinstance(n.value.func, ast.Name):
                    cls.attr_types.setdefault(t.attr, n.value.func.id)
                elif isinstance(n.value, ast.Name) \
                        and n.value.id in ann:
                    cls.attr_types.setdefault(t.attr, ann[n.value.id])


# -- whole-package analysis --------------------------------------------------


class _Held:
    __slots__ = ("key", "text", "where", "leaf")

    def __init__(self, key, text, where, leaf):
        self.key = key
        self.text = text    # source text of the with-expr (exemptions)
        self.where = where  # "display:Lline (qual)"
        self.leaf = leaf


class _Package:
    def __init__(self, files: Dict[str, _File]):
        self.files = files
        self.graph = LockGraph()
        self.diags: List[Diagnostic] = []
        self.classes: Dict[str, _Cls] = {}
        self.mods: Dict[str, _File] = {}  # module basename -> file
        for f in files.values():
            base = os.path.basename(f.display)[:-3]
            self.mods.setdefault(base, f)
            for c in f.classes:
                self.classes.setdefault(c.name, c)
        self._summaries: Dict[int, Optional[dict]] = {}
        self._emitted: Set[tuple] = set()

    # -- emit ---------------------------------------------------------------

    def _emit(self, code: str, display: str, line: int, message: str,
              hint: Optional[str] = None) -> None:
        key = (code, display, line, message)
        if key in self._emitted:
            return
        self._emitted.add(key)
        f = self.files.get(display)
        if f is not None and f.suppress.active(code, line):
            return
        self.diags.append(Diagnostic.make(
            code, message, element=display, pad=f"L{line}", hint=hint))

    # -- resolution ---------------------------------------------------------

    def _mro(self, cls_name: str) -> List[_Cls]:
        out, todo, seen = [], [cls_name], set()
        while todo:
            name = todo.pop(0)
            if name in seen:
                continue
            seen.add(name)
            c = self.classes.get(name)
            if c is None:
                continue
            out.append(c)
            todo += c.bases
        return out

    def _find_method(self, cls_name: str, meth: str) -> Optional[_Fn]:
        for c in self._mro(cls_name):
            if meth in c.methods:
                return c.methods[meth]
        return None

    def _lock_attr_site(self, cls_name: str, attr: str
                        ) -> Optional[LockSite]:
        for c in self._mro(cls_name):
            if attr in c.lock_attrs:
                return c.lock_attrs[attr]
        return None

    def _attr_type(self, cls_name: str, attr: str) -> Optional[str]:
        for c in self._mro(cls_name):
            t = c.attr_types.get(attr)
            if t and t in self.classes:
                return t
        # name-match fallback: self.watch -> class Watch,
        # self.registry -> class MetricsRegistry
        stripped = attr.lstrip("_").lower()
        if len(stripped) >= 4:
            for name in self.classes:
                low = name.lower()
                if low == stripped or low.endswith(stripped):
                    return name
        return None

    def _infer_type(self, expr: ast.expr, fn: _Fn) -> Optional[str]:
        if isinstance(expr, ast.Name):
            if expr.id in ("self", "cls"):
                return fn.cls
            if expr.id in self.classes:
                return expr.id
            # parameter annotations
            args = fn.node.args
            for a in args.args + args.kwonlyargs:
                if a.arg == expr.id:
                    t = _ann_name(a.annotation)
                    if t and t in self.classes:
                        return t
            return None
        if isinstance(expr, ast.Attribute):
            base_t = self._infer_type(expr.value, fn)
            if base_t:
                return self._attr_type(base_t, expr.attr)
        return None

    def _resolve_lock(self, expr: ast.expr, fn: _Fn
                      ) -> Optional[LockSite]:
        """Map a with-item context expression to a LockSite key, or
        None when the expression is not lock-like."""
        if isinstance(expr, ast.Call):
            expr = expr.func
        if isinstance(expr, ast.Name):
            f = self.files[fn.display]
            if expr.id in f.module_locks:
                return f.module_locks[expr.id]
            # a module lock imported from a sibling module by name
            origin = f.import_origin.get(expr.id)
            if origin is not None and origin[0] in self.mods \
                    and origin[1] in self.mods[origin[0]].module_locks:
                return self.mods[origin[0]].module_locks[origin[1]]
            if not _lockish(expr.id):
                return None
            return self._implicit(f"{fn.display}:{expr.id}",
                                  fn.display, expr.lineno)
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            # module-attribute lock: _transport._HUB_LOCK
            if isinstance(expr.value, ast.Name):
                f = self.files[fn.display]
                mod = f.import_mods.get(expr.value.id)
                if mod in self.mods \
                        and attr in self.mods[mod].module_locks:
                    return self.mods[mod].module_locks[attr]
            rtype = self._infer_type(expr.value, fn)
            if rtype:
                site = self._lock_attr_site(rtype, attr)
                if site is not None:
                    return site
                if _lockish(attr):
                    return self._implicit(f"{rtype}.{attr}", fn.display,
                                          expr.lineno)
                return None
            if not _lockish(attr):
                return None
            # unique-attr heuristic: exactly one class in the package
            # declares a lock with this attr name (e.g. _alock)
            owners = [c for c in self.classes.values()
                      if attr in c.lock_attrs]
            if len(owners) == 1:
                return owners[0].lock_attrs[attr]
            return self._implicit(
                f"{fn.display}:{_unparse(expr)}", fn.display,
                expr.lineno)
        text = _unparse(expr)
        if text and _lockish(text):
            return self._implicit(f"{fn.display}:{text}", fn.display,
                                  expr.lineno)
        return None

    def _implicit(self, key: str, display: str, line: int) -> LockSite:
        site = self.graph.nodes.get(key)
        if site is None:
            site = LockSite(key, "?", display, line)
        return site

    def _resolve_call(self, call: ast.Call, fn: _Fn) -> Optional[_Fn]:
        f = call.func
        if isinstance(f, ast.Name):
            file = self.files[fn.display]
            if f.id in file.funcs:
                return file.funcs[f.id]
            origin = file.import_origin.get(f.id)
            if origin is not None and origin[0] in self.mods:
                return self.mods[origin[0]].funcs.get(origin[1])
            return None
        if not isinstance(f, ast.Attribute):
            return None
        if isinstance(f.value, ast.Name):
            # module alias call: _watch.maybe_start_from_env()
            file = self.files[fn.display]
            mod = file.import_mods.get(f.value.id)
            if mod in self.mods and f.attr in self.mods[mod].funcs:
                return self.mods[mod].funcs[f.attr]
        rtype = self._infer_type(f.value, fn)
        if rtype:
            return self._find_method(rtype, f.attr)
        return None

    # -- summaries (transitive lock/block behaviour per function) -----------

    def summary(self, fn: _Fn, depth: int = 0) -> dict:
        """``{"acquired": {key: [path lines]},
        "blocking": [(desc, path lines)]}`` — everything ``fn`` can do
        lock-wise, following package calls."""
        fid = id(fn.node)
        cached = self._summaries.get(fid)
        if cached is not None:
            return cached
        if fid in self._summaries or depth > _MAX_DEPTH:
            return {"acquired": {}, "blocking": []}  # recursion guard
        self._summaries[fid] = None  # in progress
        summ = {"acquired": {}, "blocking": []}
        self._walk(fn, fn.node.body, [], summ, depth, emit=False)
        self._summaries[fid] = summ
        return summ

    # -- the walk ------------------------------------------------------------

    def _where(self, fn: _Fn, line: int) -> str:
        return f"{fn.display}:L{line} ({fn.qual})"

    def _walk(self, fn: _Fn, body: Sequence[ast.stmt],
              held: List[_Held], summ: Optional[dict], depth: int,
              emit: bool = True) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested defs run later; locks not held then
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                acquired = list(held)
                for item in stmt.items:
                    site = self._resolve_lock(item.context_expr, fn)
                    if site is None:
                        continue
                    self._on_acquire(fn, item.context_expr.lineno, site,
                                     acquired, summ, emit)
                    acquired = acquired + [_Held(
                        site.key, _unparse(item.context_expr),
                        self._where(fn, item.context_expr.lineno),
                        site.leaf)]
                self._walk(fn, stmt.body, acquired, summ, depth, emit)
                continue
            for expr in _stmt_exprs(stmt):
                for node in ast.walk(expr):
                    if isinstance(node, ast.Call):
                        self._on_call(fn, node, held, summ, depth, emit)
            for key in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, key, None)
                if sub:
                    self._walk(fn, sub, held, summ, depth, emit)
            for h in getattr(stmt, "handlers", None) or []:
                self._walk(fn, h.body, held, summ, depth, emit)

    def _on_acquire(self, fn: _Fn, line: int, site: LockSite,
                    held: List[_Held], summ: Optional[dict],
                    emit: bool) -> None:
        self.graph.node(site)
        where = self._where(fn, line)
        if summ is not None:
            summ["acquired"].setdefault(
                site.key, [f"acquires {site.key} at {where}"])
        for h in held:
            if h.key == site.key:
                continue
            if emit:
                self.graph.edge(h.key, site.key, [
                    f"holds {h.key} since {h.where}",
                    f"acquires {site.key} at {where}"])
            if h.leaf and emit:
                self._emit(
                    "NNS604", fn.display, line,
                    f"{fn.qual} acquires {site.key} while holding the "
                    f"declared leaf lock {h.key} (held since "
                    f"{h.where}) — leaf locks promise to never nest",
                    hint="release the leaf lock first, or drop the "
                         "'# nns-lock: leaf' declaration if nesting "
                         "is intended")

    def _on_call(self, fn: _Fn, call: ast.Call, held: List[_Held],
                 summ: Optional[dict], depth: int, emit: bool) -> None:
        line = call.lineno
        desc = self._blocking_desc(call, held)
        if desc is not None:
            if summ is not None:
                summ["blocking"].append(
                    (desc, [f"blocks in {desc} at "
                            f"{self._where(fn, line)}"]))
            if held and emit:
                self._emit_hold_and_block(fn, line, desc, held, [])
        callee = self._resolve_call(call, fn)
        if callee is None or callee.node is fn.node:
            return
        sub = self.summary(callee, depth + 1)
        hop = f"calls {callee.qual}() at {self._where(fn, line)}"
        if summ is not None:
            for key, path in sub["acquired"].items():
                summ["acquired"].setdefault(key, [hop] + path)
            for bdesc, bpath in sub["blocking"]:
                summ["blocking"].append((bdesc, [hop] + bpath))
        if not held:
            return
        for key, path in sub["acquired"].items():
            for h in held:
                if h.key == key:
                    continue
                if emit:
                    self.graph.edge(h.key, key, [
                        f"holds {h.key} since {h.where}", hop] + path)
                if h.leaf and emit:
                    self._emit(
                        "NNS604", fn.display, line,
                        f"{fn.qual} calls {callee.qual}() — which "
                        f"acquires {key} — while holding the declared "
                        f"leaf lock {h.key} (held since {h.where})",
                        hint="\n".join([hop] + path))
        if emit:
            for bdesc, bpath in sub["blocking"]:
                self._emit_hold_and_block(fn, line, bdesc, held,
                                          [hop] + bpath)

    def _emit_hold_and_block(self, fn: _Fn, line: int, desc: str,
                             held: List[_Held],
                             via: List[str]) -> None:
        locks = "/".join(h.key for h in held)
        hint = "move the blocking call outside the lock (snapshot " \
               "state under the lock, act on it after release)"
        if via:
            hint = "\n".join(via) + "\n" + hint
        self._emit(
            "NNS602", fn.display, line,
            f"{fn.qual} makes the blocking call {desc} while holding "
            f"{locks} (hold-and-block)", hint=hint)

    def _blocking_desc(self, call: ast.Call, held: List[_Held]
                       ) -> Optional[str]:
        f = call.func
        if not isinstance(f, ast.Attribute):
            return None
        if isinstance(f.value, ast.Constant):
            return None  # "sep".join(...) string op
        recv = _unparse(f.value)
        if f.attr in _WAIT_ATTRS:
            if any(h.text == recv for h in held):
                return None  # Condition.wait releases the held lock
            return f"{recv}.{f.attr}()"
        if f.attr == "join" and recv in _PATH_MODULES:
            return None  # os.path.join: string op, not thread join
        if f.attr in _BLOCK_ATTRS:
            return f"{recv}.{f.attr}()"
        if f.attr == "snapshot" and _REGISTRYISH.search(recv):
            return f"{recv}.snapshot() (full registry scrape)"
        return None

    # -- passes --------------------------------------------------------------

    def run(self) -> None:
        for f in self.files.values():
            for fn in f.funcs.values():
                self._walk(fn, fn.node.body, [], None, 0)
            for c in f.classes:
                for fn in c.methods.values():
                    self._walk(fn, fn.node.body, [], None, 0)
        self._report_cycles()
        for f in self.files.values():
            for c in f.classes:
                self._check_shared_state(c)

    def _report_cycles(self) -> None:
        for cyc in self.graph.cycles():
            arrows = " -> ".join(cyc)
            hint_lines: List[str] = []
            for a, b in zip(cyc, cyc[1:]):
                e = self.graph.edges.get((a, b))
                if e is None:
                    continue
                hint_lines.append(f"{a} -> {b}:")
                hint_lines += [f"  {step}" for step in e["path"]]
            first = self.graph.edges.get((cyc[0], cyc[1]))
            display, line = "", 0
            if first is not None:
                m = re.search(r"at ([^\s]+):L(\d+)", first["path"][-1])
                if m:
                    display, line = m.group(1), int(m.group(2))
            self._emit(
                "NNS601", display or cyc[0], line,
                f"lock-order cycle {arrows}: two paths take these "
                f"locks in opposite orders — a potential deadlock",
                hint="\n".join(hint_lines))

    def _check_shared_state(self, cls: _Cls) -> None:
        if not cls.thread_targets:
            return
        writes: Dict[str, List[Tuple[str, int, bool, bool]]] = {}

        def record(fn: _Fn, body, held: bool):
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                now_held = held or (
                    isinstance(stmt, (ast.With, ast.AsyncWith))
                    and any(self._resolve_lock(i.context_expr, fn)
                            for i in stmt.items))
                targets = []
                if isinstance(stmt, ast.Assign):
                    targets = stmt.targets
                elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                    targets = [stmt.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        if isinstance(stmt, ast.Assign) \
                                and _sync_ctor(stmt.value):
                            continue  # (re)binding a sync primitive
                        writes.setdefault(t.attr, []).append(
                            (fn.node.name, stmt.lineno, now_held,
                             fn.node.name in cls.thread_targets))
                for key in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, key, None)
                    if sub:
                        record(fn, sub, now_held)
                for h in getattr(stmt, "handlers", None) or []:
                    record(fn, h.body, now_held)

        for name, fn in cls.methods.items():
            if name == "__init__":
                continue
            record(fn, fn.node.body, False)
        for attr, sites in writes.items():
            from_thread = [s for s in sites if s[3]]
            from_public = [s for s in sites
                           if not s[3] and not s[0].startswith("_")]
            if not from_thread or not from_public:
                continue
            unguarded = [s for s in from_thread + from_public
                         if not s[2]]
            if not unguarded:
                continue
            meth, line = unguarded[0][0], unguarded[0][1]
            others = sorted({f"{s[0]} (L{s[1]})"
                             for s in from_thread + from_public
                             if (s[0], s[1]) != (meth, line)})
            self._emit(
                "NNS603", cls.display, line,
                f"{cls.name}.{attr} is written by the thread entry "
                f"point(s) {sorted(set(s[0] for s in from_thread))} "
                f"and the public method(s) "
                f"{sorted(set(s[0] for s in from_public))} with no "
                f"guarding lock at {meth} (L{line})",
                hint="guard every cross-thread write with one lock, "
                     "or confine the field to a single thread; "
                     "other write sites: " + ", ".join(others))


# -- public API --------------------------------------------------------------


def _stmt_exprs(stmt: ast.stmt) -> List[ast.expr]:
    out: List[ast.expr] = []
    for field, value in ast.iter_fields(stmt):
        if field in ("body", "orelse", "finalbody", "handlers"):
            continue
        if isinstance(value, ast.expr):
            out.append(value)
        elif isinstance(value, list):
            out += [v for v in value if isinstance(v, ast.expr)]
    return out


def analyze_sources(sources: Dict[str, str]
                    ) -> Tuple[List[Diagnostic], LockGraph]:
    """Run the NNS6xx pass over ``{display_path: source}``.  Files that
    do not parse yield an NNS403-style parse diagnostic and are skipped
    (same convention as :func:`.codelint.lint_package`)."""
    files: Dict[str, _File] = {}
    diags: List[Diagnostic] = []
    for display, source in sorted(sources.items()):
        try:
            files[display] = _File(display, source)
        except SyntaxError as e:
            diags.append(Diagnostic.make(
                "NNS403", f"{display}: does not parse: {e}",
                element=display, pad=f"L{e.lineno or 0}"))
    pkg = _Package(files)
    pkg.run()
    return sort_diagnostics(diags + pkg.diags), pkg.graph


def lint_concurrency_source(source: str, path: str = "<string>"
                            ) -> List[Diagnostic]:
    """Single-source convenience (tests, snippets)."""
    return analyze_sources({path: source})[0]


def analyze_package_concurrency(pkg_root: str
                                ) -> Tuple[List[Diagnostic], LockGraph]:
    """The ``--concurrency`` entry point: NNS6xx over every module of a
    package checkout, lock graph included."""
    pkg_root = os.path.abspath(pkg_root)
    base = os.path.dirname(pkg_root)
    sources: Dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "build", "native")]
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            display = os.path.relpath(path, base).replace(os.sep, "/")
            with open(path, encoding="utf-8") as f:
                sources[display] = f.read()
    return analyze_sources(sources)
