"""Runtime lock-order witness ("lockdep", after the kernel facility).

Counterpart of the JAX package's ``utils/lockdep.py``: the same labels,
witness JSON and diff tool.  This module *measures* the
lock-acquisition graph.  With
``NNS_TPU_TORCH_LOCKDEP=1`` the :func:`enable` hook wraps the
``threading.Lock``/``threading.RLock`` constructors so every lock whose
construction site lives in this package (or its tests) becomes a
recording proxy:

- every successful acquisition is a node hit, labelled by its
  **construction site** (``file.py:Class.__init__._lock`` — qualname
  plus the assignment target, not a line number, so the witness stays
  stable across unrelated edits yet distinguishes sibling locks);
- acquiring ``B`` while holding ``A`` records the order edge
  ``A -> B`` with the acquiring thread;
- an edge that closes a cycle in the order graph (some other thread
  ever took the locks in the opposite order) is recorded as a
  **violation the moment it happens** — no actual deadlock needed;
- :func:`check_dispatch`, called from the serving-pool window flush,
  records a **held-across-dispatch** violation when the dispatching
  thread holds any witnessed lock (a device invoke under a lock stalls
  every peer for a whole window).

``NNS_TPU_TORCH_LOCKDEP_OUT=<path>`` dumps the witness JSON at interpreter
exit (or call :func:`dump` yourself).  :func:`diff_main`
(``python -m nnstreamer_tpu_torch.utils.lockdep``) diffs a witness
against a baseline and fails on any cycle or violation.

Zero-cost when disarmed: nothing is patched until :func:`enable` runs,
and locks constructed outside the package are returned unwrapped.  The
package is matched as its own directory, with the trailing separator:
the JAX package's directory name is a prefix of this one's, and its
locks stay unwrapped.  Both packages' witnesses patch the same
``threading`` constructors, so one process arms one of them;
:func:`disable` restores the constructors.
"""

from __future__ import annotations

import atexit
import json
import linecache
import os
import re
import sys
import threading
import _thread
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["enable", "enabled", "disable", "check_dispatch", "dump",
           "reset",
           "maybe_enable_from_env", "witness_dict", "find_cycles"]

ENABLED = False
#: ``NNS_TPU_TORCH_LOCKDEP_SCOPE=all`` wraps every construction site (test
#: fixtures, scripts); the default "pkg" wraps only package/tests sites
_SCOPE_ALL = False

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

#: stdlib frames skipped when labelling under scope=all (the lock's
#: *owner* is whoever constructed the Queue/Event, not queue.py)
_STDLIB_SKIP = ("threading.py", "queue.py")

#: assignment target on the construction line — distinguishes two locks
#: built in the same function (``self._lock`` vs ``self._stats_lock``)
#: without baking brittle line numbers into the label
_ASSIGN_RE = re.compile(
    r"^\s*(?:self\.)?([A-Za-z_]\w*)\s*(?::[^=]+)?=[^=]")

#: ``# nns-lock: dispatch-ok`` on the construction line declares the
#: lock is the dispatch SERIALIZATION itself (e.g. the batcher's
#: flush-serial lock) — holding it across the device invoke is the
#: design, so :func:`check_dispatch` exempts it
_DISPATCH_OK_RE = re.compile(r"#\s*nns-lock:[^#]*\bdispatch-ok\b")

#: guards the witness tables; a raw lock so it is never itself wrapped
_WLOCK = _thread.allocate_lock()
_NODES: Dict[str, int] = {}
_EDGES: Dict[Tuple[str, str], dict] = {}
_VIOLATIONS: List[dict] = []
_TLS = threading.local()

#: directories whose frames count as "ours" when labelling a lock site
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the package's directory with its trailing separator: a bare prefix
#: test would also match a sibling directory whose name extends it
_PKG_DIR = _PKG_ROOT + os.sep
_BASE = os.path.dirname(_PKG_ROOT)
_SELF_FILE = os.path.abspath(__file__)


def _held() -> list:
    h = getattr(_TLS, "held", None)
    if h is None:
        h = _TLS.held = []
    return h


def _thread_name(tid: int) -> str:
    """The thread's name WITHOUT threading.current_thread(): on a
    foreign thread that call constructs a _DummyThread whose Event
    takes a (wrapped) lock — re-entering the witness forever."""
    t = threading._active.get(tid)
    return t.name if t is not None else f"t{tid}"


def _site_label() -> Optional[Tuple[str, bool]]:
    """(label, dispatch-ok) from the first stack frame inside the
    package or its test suite; None for foreign constructions (left
    unwrapped)."""
    f = sys._getframe(2)
    while f is not None:
        fname = f.f_code.co_filename
        if fname == _SELF_FILE:
            # construction triggered from witness internals (e.g. a
            # _DummyThread materialized mid-record): never wrap
            return None
        ours = fname.startswith(_PKG_DIR) \
            or os.sep + "tests" + os.sep in fname \
            or os.path.basename(fname).startswith("test_")
        if not ours and _SCOPE_ALL:
            ours = os.path.basename(fname) not in _STDLIB_SKIP
        if ours:
            if fname.startswith(_BASE):
                rel = os.path.relpath(fname, _BASE).replace(os.sep, "/")
            else:
                rel = os.path.basename(fname)
            qual = getattr(f.f_code, "co_qualname", None)
            if qual is None:
                qual = f.f_code.co_name
                slf = f.f_locals.get("self")
                if slf is not None:
                    qual = f"{type(slf).__name__}.{qual}"
            line = linecache.getline(fname, f.f_lineno)
            m = _ASSIGN_RE.match(line)
            which = m.group(1) if m else f"L{f.f_lineno}"
            return (f"{rel}:{qual}.{which}",
                    _DISPATCH_OK_RE.search(line) is not None)
        f = f.f_back
    return None


def _record_acquire(proxy, label: str) -> None:
    if getattr(_TLS, "busy", False):  # re-entered mid-record: bail
        return
    _TLS.busy = True
    try:
        _record_acquire_inner(proxy, label)
    finally:
        _TLS.busy = False


def _record_acquire_inner(proxy, label: str) -> None:
    held = _held()
    if any(e[0] is proxy for e in held):
        held.append((proxy, label, True))  # reentrant: no new edges
        return
    tid = threading.get_ident()
    tname = _thread_name(tid)
    with _WLOCK:
        _NODES[label] = _NODES.get(label, 0) + 1
        for _p, hlabel, _re in held:
            if hlabel == label:
                continue
            key = (hlabel, label)
            e = _EDGES.get(key)
            if e is None:
                _EDGES[key] = {"count": 1, "threads": {tname},
                               "tids": {tid}}
                cyc = _closes_cycle(hlabel, label)
                if cyc is not None:
                    _VIOLATIONS.append({
                        "kind": "cycle",
                        "edge": [hlabel, label],
                        "path": cyc,
                        "thread": tname, "tid": tid})
            else:
                e["count"] += 1
                e["threads"].add(tname)
                e["tids"].add(tid)
    held.append((proxy, label, False))


def _closes_cycle(src: str, dst: str) -> Optional[List[str]]:
    """Path dst ->* src in the edge graph (callers hold _WLOCK) — if it
    exists, the new src->dst edge closed a cycle."""
    adj: Dict[str, List[str]] = {}
    for (a, b) in _EDGES:
        if a != b:
            adj.setdefault(a, []).append(b)
    stack: List[Tuple[str, List[str]]] = [(dst, [dst])]
    visited: Set[str] = {dst}
    while stack:
        node, path = stack.pop()
        if node == src:
            return [src, dst] + path[1:]
        for nxt in adj.get(node, ()):
            if nxt not in visited:
                visited.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _record_release(proxy) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is proxy:
            del held[i]
            return


class _LockProxy:
    """Wraps a real ``threading.Lock`` and reports to the witness."""

    _KIND = "Lock"
    __slots__ = ("_lk", "_label", "_dok", "__weakref__")

    def __init__(self, real, label: str, dispatch_ok: bool = False):
        self._lk = real
        self._label = label
        self._dok = dispatch_ok

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            _record_acquire(self, self._label)
        return ok

    acquire_lock = acquire  # old-style alias some callers use

    def release(self):
        _record_release(self)
        self._lk.release()

    release_lock = release

    def locked(self):
        return self._lk.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<lockdep {self._KIND} {self._label} of {self._lk!r}>"


class _RLockProxy(_LockProxy):
    """RLock flavour: also speaks the private Condition protocol
    (``_is_owned``/``_release_save``/``_acquire_restore``) so wrapped
    RLocks keep working as Condition backing locks — a Condition.wait
    fully releases the lock, so the held-stack entries drop with it."""

    _KIND = "RLock"
    __slots__ = ()

    def _is_owned(self):
        return self._lk._is_owned()

    def _release_save(self):
        held = _held()
        n = 0
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                del held[i]
                n += 1
        return (self._lk._release_save(), n)

    def _acquire_restore(self, saved):
        state, n = saved
        self._lk._acquire_restore(state)
        held = _held()
        for i in range(n):
            # re-entry after a wait: the original acquisition already
            # recorded the order edges, so restore silently
            held.append((self, self._label, i > 0))

    def __exit__(self, *exc):
        self.release()
        return False


def _wrap_lock():
    real = _REAL_LOCK()
    if getattr(_TLS, "busy", False):
        return real
    site = _site_label()
    if site is None:
        return real
    return _LockProxy(real, site[0], site[1])


def _wrap_rlock():
    real = _REAL_RLOCK()
    if getattr(_TLS, "busy", False):
        return real
    site = _site_label()
    if site is None:
        return real
    return _RLockProxy(real, site[0], site[1])


# -- public API --------------------------------------------------------------


def enable() -> bool:
    """Patch the lock constructors.  Idempotent; affects only locks
    constructed *after* the call whose construction site is inside the
    package or its tests.  (``threading.Condition()`` picks the patched
    RLock up automatically — it resolves ``RLock`` from the module at
    call time.)"""
    global ENABLED, _SCOPE_ALL
    if os.environ.get("NNS_TPU_TORCH_LOCKDEP_SCOPE", "") == "all":
        _SCOPE_ALL = True
    if ENABLED:
        return False
    ENABLED = True
    threading.Lock = _wrap_lock
    threading.RLock = _wrap_rlock
    return True


def enabled() -> bool:
    return ENABLED


def disable() -> bool:
    """Restore the lock constructors :func:`enable` patched (locks built
    meanwhile stay proxies).  Returns whether anything was restored."""
    global ENABLED
    if not ENABLED:
        return False
    ENABLED = False
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    return True


def check_dispatch(what: str) -> bool:
    """Call at a device-dispatch fence: records a held-across-dispatch
    violation (and returns True) when the calling thread holds any
    witnessed lock."""
    if not ENABLED:
        return False
    held = [label for p, label, re in _held()
            if not re and not getattr(p, "_dok", False)]
    if not held:
        return False
    tid = threading.get_ident()
    with _WLOCK:
        _VIOLATIONS.append({
            "kind": "held-across-dispatch",
            "what": what,
            "held": held,
            "thread": _thread_name(tid),
            "tid": tid})
    return True


def find_cycles(edges) -> List[List[str]]:
    """All distinct cycles (by node set) in ``[(src, dst), ...]``."""
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        if a != b:
            adj.setdefault(a, []).append(b)
    seen: Set[frozenset] = set()
    out: List[List[str]] = []
    for a, b in sorted(set((a, b) for a, b in edges if a != b)):
        stack: List[Tuple[str, List[str]]] = [(b, [b])]
        visited = {b}
        found = None
        while stack:
            node, path = stack.pop()
            if node == a:
                found = path
                break
            for nxt in adj.get(node, ()):
                if nxt not in visited:
                    visited.add(nxt)
                    stack.append((nxt, path + [nxt]))
        if found is None:
            continue
        cyc = [a] + found  # found = [b, ..., a], so cyc closes at a
        key = frozenset(cyc)
        if key not in seen:
            seen.add(key)
            out.append(cyc)
    return out


def witness_dict() -> dict:
    """The witness as a JSON-ready dict (sorted, deterministic)."""
    with _WLOCK:
        nodes = [{"label": k, "count": v}
                 for k, v in sorted(_NODES.items())]
        edges = [{"src": a, "dst": b, "count": e["count"],
                  "threads": sorted(e["threads"]),
                  "tids": sorted(e["tids"])}
                 for (a, b), e in sorted(_EDGES.items())]
        violations = list(_VIOLATIONS)
        cycles = find_cycles(list(_EDGES))
    return {"version": 1, "nodes": nodes, "edges": edges,
            "violations": violations, "cycles": cycles}


def dump(path: str) -> dict:
    doc = witness_dict()
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return doc


def reset() -> None:
    """Clear the witness tables (tests)."""
    with _WLOCK:
        _NODES.clear()
        _EDGES.clear()
        del _VIOLATIONS[:]


def maybe_enable_from_env() -> bool:
    """``NNS_TPU_TORCH_LOCKDEP=1`` arms the witness; ``NNS_TPU_TORCH_LOCKDEP_OUT``
    additionally dumps the witness JSON at interpreter exit."""
    if os.environ.get("NNS_TPU_TORCH_LOCKDEP", "") not in ("1", "true", "on"):
        return False
    armed = enable()
    out = os.environ.get("NNS_TPU_TORCH_LOCKDEP_OUT", "")
    if armed and out:
        atexit.register(dump, out)
    return armed


# -- baseline diff ------------------------------------------------------------


def _fmt_cycle(path: List[str]) -> str:
    return " -> ".join(path)


def diff_main(argv: Optional[List[str]] = None) -> int:
    """Diff a lockdep witness against the committed baseline.

    Exit 0 when the witness is non-empty, free of violations, and its
    cycles are all listed in the baseline's ``allowed_cycles``; exit 1
    on any cycle / violation / empty witness; exit 2 on usage errors.
    Edges absent from the baseline are reported informationally — the
    order graph may legitimately grow, only *cycles* are bugs.
    """
    import argparse

    p = argparse.ArgumentParser(
        prog="nns-torch-lockdep-diff",
        description="diff a lockdep witness JSON against a baseline "
                    "(default: tests/lockdep_torch_baseline.json)")
    p.add_argument("witness", help="witness JSON produced via "
                   "NNS_TPU_TORCH_LOCKDEP_OUT or lockdep.dump()")
    p.add_argument("--baseline",
                   default=os.path.join(_BASE, "tests",
                                        "lockdep_torch_baseline.json"),
                   help="baseline JSON (default: tests/lockdep_torch_"
                        "baseline.json next to the package)")
    p.add_argument("--update", action="store_true",
                   help="rewrite the baseline from this witness instead "
                        "of diffing (refuses while violations exist)")
    args = p.parse_args(argv)

    try:
        with open(args.witness, "r", encoding="utf-8") as f:
            wit = json.load(f)
    except (OSError, ValueError) as exc:
        print(f"nns-lockdep-diff: cannot read witness: {exc}",
              file=sys.stderr)
        return 2

    nodes = wit.get("nodes") or []
    edges = wit.get("edges") or []
    cycles = wit.get("cycles") or []
    violations = wit.get("violations") or []

    if not nodes:
        print("nns-lockdep-diff: FAIL: witness is empty (no lock "
              "acquisitions recorded) — was NNS_TPU_TORCH_LOCKDEP=1 set "
              "before the package imported?", file=sys.stderr)
        return 1

    if args.update:
        if violations or cycles:
            print("nns-lockdep-diff: refusing --update: witness has "
                  f"{len(violations)} violation(s) / {len(cycles)} "
                  "cycle(s); fix them first", file=sys.stderr)
            return 1
        base = {
            "version": 1,
            "edges": sorted([e["src"], e["dst"]] for e in edges),
            "allowed_cycles": [],
        }
        tmp = args.baseline + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(base, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, args.baseline)
        print(f"nns-lockdep-diff: baseline updated: {args.baseline} "
              f"({len(nodes)} nodes, {len(edges)} edges)")
        return 0

    try:
        with open(args.baseline, "r", encoding="utf-8") as f:
            base = json.load(f)
    except (OSError, ValueError) as exc:
        print(f"nns-lockdep-diff: cannot read baseline: {exc} "
              "(generate one with --update)", file=sys.stderr)
        return 2

    rc = 0
    allowed = {frozenset(c) for c in base.get("allowed_cycles", [])}
    for cyc in cycles:
        if frozenset(cyc) in allowed:
            continue
        rc = 1
        print(f"LOCK-ORDER CYCLE: {_fmt_cycle(cyc)}")
        # print the witnessed acquisition edges that make up the cycle
        ring = set(zip(cyc, cyc[1:]))
        for e in edges:
            if (e["src"], e["dst"]) in ring:
                print(f"  edge {e['src']} -> {e['dst']} "
                      f"(count={e['count']}, "
                      f"threads={','.join(e['threads'])})")
    for v in violations:
        if v.get("kind") == "cycle" and frozenset(v["path"]) in allowed:
            continue
        rc = 1
        if v.get("kind") == "cycle":
            print(f"VIOLATION cycle (thread {v['thread']}): "
                  f"{_fmt_cycle(v['path'])}")
        elif v.get("kind") == "held-across-dispatch":
            print(f"VIOLATION held-across-dispatch at {v['what']} "
                  f"(thread {v['thread']}): holding "
                  f"{', '.join(v['held'])}")
        else:
            print(f"VIOLATION {v}")

    known = {tuple(e) for e in base.get("edges", [])}
    new_edges = [e for e in edges
                 if (e["src"], e["dst"]) not in known]
    if new_edges:
        print(f"note: {len(new_edges)} order edge(s) not in baseline "
              "(informational; rerun with --update to absorb):")
        for e in new_edges:
            print(f"  {e['src']} -> {e['dst']}")

    if rc:
        print(f"nns-lockdep-diff: FAIL ({len(nodes)} nodes, "
              f"{len(edges)} edges)", file=sys.stderr)
    else:
        print(f"nns-lockdep-diff: OK ({len(nodes)} nodes, "
              f"{len(edges)} edges, {len(new_edges)} new)")
    return rc


if __name__ == "__main__":
    sys.exit(diff_main())
