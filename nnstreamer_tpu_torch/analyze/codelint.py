"""Pass 3 — concurrency lint (NNS3xx) + codebase lint (NNS4xx).

Counterpart of the JAX package's ``analyze/codelint.py``; the device hot
paths are the port's ``ops/kernels.py`` and ``runtime/fusion.py``.

Pure-AST analysis, no imports of the linted code:

- **NNS301** blocking call inside a bus-watch handler.  Watch handlers
  run synchronously inside ``Bus.post`` on whatever thread posted (often
  a streaming thread) — a handler that sleeps/joins/waits stalls the
  stream.
- **NNS302** bus post while holding a lock.  ``post`` runs handlers
  re-entrantly; a handler that takes the same lock deadlocks.
- **NNS303** blocking call while holding a lock (sleep/join/queue
  get-put/Event.wait/imports/file IO under ``with <lock>``).  Waiting on
  the *same* condition object the ``with`` holds is exempt —
  ``Condition.wait`` releases the lock.
- **NNS401** a ``@register_element`` class that never declares pads:
  neither it nor any base in the package calls
  ``add_sink_pad``/``add_src_pad`` or overrides ``request_pad`` — such an
  element can never be linked.
- **NNS402** host ``numpy`` array ops in device hot-path code (the fused
  kernels/fusion modules and any ``jit``-decorated function).  Trace-time
  shape/dtype math (``np.prod(x.shape)``) is exempt; array math must be
  torch ops on the card tensor, or it forces a device→host drain and a
  sync per buffer.
- **NNS403** bare ``except:`` — swallows ``KeyboardInterrupt`` and hides
  real failures from the bus.

Suppressions: ``# nns-lint: disable=NNS303 -- <reason>`` on the flagged
line, or ``# nns-lint: disable-file=NNS303 -- <reason>`` anywhere for the
whole file.  Always give the reason.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set

from .diagnostics import Diagnostic

_SUPPRESS_RE = re.compile(
    r"#\s*nns-lint:\s*disable(?P<scope>-file)?\s*=\s*"
    r"(?P<codes>NNS\d{3}(?:\s*,\s*NNS\d{3})*)")

#: attribute calls that block the calling thread
_BLOCKING_ATTRS = {"join", "wait", "wait_for", "acquire", "accept",
                   "recv", "recvfrom", "select", "import_module"}
#: bare-name calls that block
_BLOCKING_NAMES = {"sleep", "input", "open"}
#: bus-post entry points (NNS302)
_POST_ATTRS = {"post", "post_message", "post_error"}
#: numpy array ops that belong to torch ops in hot paths (NNS402)
_NP_ARRAY_OPS = {
    "sum", "mean", "exp", "log", "sqrt", "matmul", "dot", "concatenate",
    "stack", "transpose", "reshape", "einsum", "maximum", "minimum",
    "argmax", "argmin", "where", "tanh", "clip", "abs", "add", "multiply",
    "subtract", "divide", "power", "cumsum", "sort", "take", "pad",
}
#: modules whose every function is a device hot path
_HOT_MODULES = (os.path.join("ops", "kernels.py"),
                os.path.join("runtime", "fusion.py"))


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - very old ast nodes
        return ""


class _Suppressions:
    """``disable=`` applies to its own line; when written on a pure
    comment line it applies to the next code line instead (so a long
    reason can precede the suppressed statement)."""

    def __init__(self, source: str):
        self.by_line: Dict[int, Set[str]] = {}
        self.file_wide: Set[str] = set()
        lines = source.splitlines()
        for ln, line in enumerate(lines, 1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            codes = {c.strip() for c in m.group("codes").split(",")}
            if m.group("scope"):
                self.file_wide |= codes
                continue
            target = ln
            if line.lstrip().startswith("#"):  # standalone comment line
                for nxt in range(ln, len(lines)):
                    stripped = lines[nxt].strip()
                    if stripped and not stripped.startswith("#"):
                        target = nxt + 1
                        break
            self.by_line.setdefault(target, set()).update(codes)

    def active(self, code: str, line: int) -> bool:
        return code in self.file_wide or code in self.by_line.get(line,
                                                                  ())


def _lockish(text: str) -> bool:
    low = text.lower()
    return ("lock" in low or low.endswith("_cv") or "cond" in low
            or "mutex" in low)


def _with_texts(stmt) -> List[str]:
    """Source text of each with-item's context expression (sans call
    parens, so ``with self._lock:`` and ``with lock():`` both yield the
    lock name)."""
    out = []
    for item in stmt.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call):
            expr = expr.func
        out.append(_unparse(expr))
    return out


def _own_exprs(stmt: ast.stmt) -> List[ast.expr]:
    """Expressions attached directly to ``stmt`` (its test/targets/value),
    excluding nested statement bodies, which the caller recurses into."""
    out: List[ast.expr] = []
    for field, value in ast.iter_fields(stmt):
        if field in ("body", "orelse", "finalbody", "handlers"):
            continue
        if isinstance(value, ast.expr):
            out.append(value)
        elif isinstance(value, list):
            out += [v for v in value if isinstance(v, ast.expr)]
    return out


def _blocking_desc(call: ast.Call, held: Sequence[str]) -> Optional[str]:
    """Describe why ``call`` blocks, or None.  ``held`` is the with-expr
    text of currently held locks (for the Condition.wait exemption)."""
    f = call.func
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Constant):
            return None  # "sep".join(...), b"".join(...): string ops
        recv = _unparse(f.value)
        if f.attr == "sleep":
            return f"{recv}.sleep()"
        if f.attr in ("wait", "wait_for"):
            if recv in held:
                return None  # Condition.wait releases the lock it holds
            return f"{recv}.{f.attr}()"
        if f.attr in _BLOCKING_ATTRS:
            return f"{recv}.{f.attr}()"
        if f.attr in ("get", "put") and _queueish(recv, call):
            return f"{recv}.{f.attr}() (blocking queue op)"
        return None
    if isinstance(f, ast.Name):
        if f.id in _BLOCKING_NAMES:
            return f"{f.id}()"
        if f.id == "__import__":
            return "__import__()"
    return None


def _queueish(recv: str, call: ast.Call) -> bool:
    tail = recv.rsplit(".", 1)[-1].lower()
    if re.fullmatch(r"_?d?q(ueue)?\d*", tail) or "queue" in tail:
        return True
    # an explicit timeout/block kwarg marks a blocking queue-style call
    return any(kw.arg in ("timeout", "block") for kw in call.keywords)


class _FileLint:
    """All per-file checks for one source file."""

    def __init__(self, source: str, path: str, display_path: str):
        self.source = source
        self.path = path
        self.display = display_path
        self.tree = ast.parse(source, filename=path)
        self.suppress = _Suppressions(source)
        self.diags: List[Diagnostic] = []

    def _emit(self, code: str, line: int, message: str,
              hint: Optional[str] = None) -> None:
        if self.suppress.active(code, line):
            return
        self.diags.append(Diagnostic.make(
            code, message, element=self.display, pad=f"L{line}",
            hint=hint))

    # -- NNS3xx --------------------------------------------------------------

    def concurrency(self) -> "_FileLint":
        handlers = self._watch_handler_names()
        for fn in self._functions(self.tree):
            if fn.name in handlers:
                self._lint_handler(fn)
            self._walk_locked(fn, fn.body, [])
        return self

    def _watch_handler_names(self) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "add_watch":
                for arg in node.args:
                    if isinstance(arg, ast.Attribute):
                        names.add(arg.attr)
                    elif isinstance(arg, ast.Name):
                        names.add(arg.id)
        return names

    def _functions(self, root: ast.AST) -> List[ast.FunctionDef]:
        return [n for n in ast.walk(root)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

    def _lint_handler(self, fn: ast.FunctionDef) -> None:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                desc = _blocking_desc(node, held=[])
                if desc:
                    self._emit(
                        "NNS301", node.lineno,
                        f"{fn.name} is a bus-watch handler but makes the "
                        f"blocking call {desc}; handlers run synchronously "
                        f"in the posting (streaming) thread",
                        hint="hand work off to a queue/thread; handlers "
                             "must only inspect the message and return")

    def _walk_locked(self, fn: ast.FunctionDef, body: Sequence[ast.stmt],
                     held: List[str]) -> None:
        """Recursive statement walk tracking the set of held locks."""
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested def runs later; locks not held then
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                if held:
                    # the with-items themselves run under the outer lock
                    # (e.g. `with lock: with open(p) as f:`)
                    for item in stmt.items:
                        for node in ast.walk(item.context_expr):
                            if isinstance(node, ast.Call):
                                self._check_locked_call(fn, node, held)
                locks = [t for t in _with_texts(stmt) if _lockish(t)]
                self._walk_locked(fn, stmt.body, held + locks)
                continue
            if held:
                for expr in _own_exprs(stmt):
                    for node in ast.walk(expr):
                        if isinstance(node, ast.Call):
                            self._check_locked_call(fn, node, held)
            for key in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, key, None)
                if sub:
                    self._walk_locked(fn, sub, held)
            for h in getattr(stmt, "handlers", None) or []:
                self._walk_locked(fn, h.body, held)

    def _check_locked_call(self, fn: ast.FunctionDef, node: ast.Call,
                           held: Sequence[str]) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _POST_ATTRS:
            self._emit(
                "NNS302", node.lineno,
                f"{fn.name} posts to the bus while holding "
                f"{'/'.join(held)}; Bus.post runs watch handlers "
                f"synchronously — a handler taking the same lock "
                f"deadlocks",
                hint="collect the message under the lock, post after "
                     "releasing it")
            return
        desc = _blocking_desc(node, held)
        if desc:
            self._emit(
                "NNS303", node.lineno,
                f"{fn.name} makes the blocking call {desc} while holding "
                f"{'/'.join(held)}",
                hint="move the blocking call outside the lock, or use a "
                     "timeout-free non-blocking variant")

    # -- NNS4xx --------------------------------------------------------------

    def code(self) -> "_FileLint":
        self._bare_excepts()
        self._hot_numpy()
        return self

    def _bare_excepts(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                self._emit(
                    "NNS403", node.lineno,
                    "bare 'except:' swallows KeyboardInterrupt/SystemExit "
                    "and hides failures from the bus",
                    hint="catch Exception (with a reason comment) or the "
                         "specific errors expected")

    def _hot_numpy(self) -> None:
        module_hot = any(self.display.replace("/", os.sep).endswith(m)
                         for m in _HOT_MODULES)
        for fn in self._functions(self.tree):
            if not (module_hot or _jit_decorated(fn)):
                continue
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id in ("np", "numpy")
                        and node.func.attr in _NP_ARRAY_OPS):
                    continue
                if _trace_time_args(node):
                    continue  # shape/dtype math is fine at trace time
                self._emit(
                    "NNS402", node.lineno,
                    f"host numpy op np.{node.func.attr}(...) in device "
                    f"hot path '{fn.name}' — forces a device→host drain "
                    f"and blocks the card's asynchronous launches",
                    hint="use torch ops on the card tensor so the op "
                         "stays on the device")


def _jit_decorated(fn: ast.FunctionDef) -> bool:
    return any("jit" in _unparse(d) for d in fn.decorator_list)


def _trace_time_args(call: ast.Call) -> bool:
    """True when every argument derives from shapes/dims/constants —
    trace-time scalar math, not array math."""
    args = list(call.args) + [kw.value for kw in call.keywords]
    return all(_trace_time_expr(a) for a in args)


def _trace_time_expr(arg: ast.expr) -> bool:
    for node in ast.walk(arg):
        if isinstance(node, ast.Attribute) \
                and node.attr in ("shape", "ndim", "dtype"):
            return True
        if isinstance(node, ast.Name) \
                and re.search(r"shape|dim|size|rank", node.id.lower()):
            return True
    # no names at all -> pure constants
    return not any(isinstance(n, ast.Name) for n in ast.walk(arg))


# -- NNS401: package-wide pad-declaration check ------------------------------


class _ClassInfo:
    __slots__ = ("name", "bases", "declares_pads", "registered", "lineno",
                 "display")

    def __init__(self, name, bases, declares_pads, registered, lineno,
                 display):
        self.name = name
        self.bases = bases
        self.declares_pads = declares_pads
        self.registered = registered
        self.lineno = lineno
        self.display = display


def _collect_classes(tree: ast.AST, display: str) -> List[_ClassInfo]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        bases = []
        for b in node.bases:
            if isinstance(b, ast.Name):
                bases.append(b.id)
            elif isinstance(b, ast.Attribute):
                bases.append(b.attr)
        registered = any("register_element" in _unparse(d)
                         for d in node.decorator_list)
        declares = any(isinstance(n, ast.FunctionDef)
                       and n.name == "request_pad"
                       for n in node.body)
        for n in ast.walk(node):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in ("add_sink_pad", "add_src_pad"):
                declares = True
        out.append(_ClassInfo(node.name, bases, declares, registered,
                              node.lineno, display))
    return out


def _check_pad_declarations(classes: List[_ClassInfo],
                            suppressions: Dict[str, _Suppressions]
                            ) -> List[Diagnostic]:
    by_name = {c.name: c for c in classes}

    def declares(name: str, seen: Set[str]) -> bool:
        c = by_name.get(name)
        if c is None or name in seen:
            return False
        if c.declares_pads:
            return True
        seen.add(name)
        return any(declares(b, seen) for b in c.bases)

    diags: List[Diagnostic] = []
    for c in classes:
        if not c.registered:
            continue
        if declares(c.name, set()):
            continue
        sup = suppressions.get(c.display)
        if sup is not None and sup.active("NNS401", c.lineno):
            continue
        diags.append(Diagnostic.make(
            "NNS401",
            f"element class {c.name} is registered but neither it nor "
            f"any base declares pads (no add_sink_pad/add_src_pad call, "
            f"no request_pad override) — it can never be linked",
            element=c.display, pad=f"L{c.lineno}",
            hint="create pads in __init__ or subclass Source/Sink/"
                 "TransformElement"))
    return diags


# -- public API --------------------------------------------------------------


def lint_source(source: str, path: str = "<string>",
                concurrency: bool = True, code: bool = True
                ) -> List[Diagnostic]:
    """Lint one source text (used by tests and single-file runs).  The
    NNS401 package-wide check runs with just this file's classes."""
    fl = _FileLint(source, path, path)
    if concurrency:
        fl.concurrency()
    if code:
        fl.code()
        fl.diags += _check_pad_declarations(
            _collect_classes(fl.tree, path), {path: fl.suppress})
    return fl.diags


def lint_package(pkg_root: str) -> List[Diagnostic]:
    """Run the self-lint over an ``nnstreamer_tpu_torch`` checkout:
    NNS3xx over ``runtime/``, NNS4xx over every module, NNS401 resolved
    package-wide."""
    pkg_root = os.path.abspath(pkg_root)
    base = os.path.dirname(pkg_root)
    diags: List[Diagnostic] = []
    classes: List[_ClassInfo] = []
    suppressions: Dict[str, _Suppressions] = {}
    runtime_dir = os.path.join(pkg_root, "runtime")
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "build", "native")]
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            display = os.path.relpath(path, base).replace(os.sep, "/")
            with open(path, encoding="utf-8") as f:
                source = f.read()
            try:
                fl = _FileLint(source, path, display)
            except SyntaxError as e:
                diags.append(Diagnostic.make(
                    "NNS403", f"{display}: does not parse: {e}",
                    element=display, pad=f"L{e.lineno or 0}"))
                continue
            if os.path.abspath(dirpath) == runtime_dir:
                fl.concurrency()
            fl.code()
            diags += fl.diags
            classes += _collect_classes(fl.tree, display)
            suppressions[display] = fl.suppress
    diags += _check_pad_declarations(classes, suppressions)
    return diags
