"""Replay a JAX-package test module through the port.

``replay("test_prof.py", globals())`` reads ``tests/test_prof.py``, maps
it onto ``nnstreamer_tpu_torch`` (:data:`COMMON`: the package name, the
environment prefix, the ``torch-cuda`` framework for ``jax-xla``, CPU
pipelines), applies the caller's own ``(old, new)`` pairs, rewrites its
asserts as pytest does and executes it in the caller's namespace, so
pytest collects the JAX module's tests, fixtures and helpers as the
port's.  Each pair must match: a pair that no longer matches the JAX
source raises instead of silently testing something else.
"""

import ast
import os
import re
from typing import Iterable, Optional, Tuple

from _pytest.assertion.rewrite import rewrite_asserts

TESTS = os.path.dirname(os.path.abspath(__file__))

#: regex substitutions every replayed module takes
COMMON: Tuple[Tuple[str, str], ...] = (
    (r"\bnnstreamer_tpu\.filters\.jax_xla import register_model, "
     r"unregister_model",
     "nnstreamer_tpu_torch.filters import register_model, "
     "unregister_model"),
    (r"\bnnstreamer_tpu\b", "nnstreamer_tpu_torch"),
    (r"NNS_TPU_(?!TORCH_)", "NNS_TPU_TORCH_"),
    (r"\bjax-xla\b", "torch-cuda"),
    (r"\bPipeline\(name=", 'Pipeline(device="cpu", name='),
    (r"\bPipeline\(\)", 'Pipeline(device="cpu")'),
)


def port_text(src: str, subs: Iterable[Tuple[str, str]] = (),
              what: str = "source") -> str:
    """The port's version of JAX-package test code ``src``: the caller's
    literal ``subs`` first (each must occur in ``src``), then
    :data:`COMMON`."""
    for old, new in subs:
        if old not in src:
            raise ValueError(f"{what}: replay pair no longer matches: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    for pat, rep in COMMON:
        src = re.sub(pat, rep, src)
    return src


def port_source(name: str, subs: Iterable[Tuple[str, str]] = ()) -> str:
    """The port's version of ``tests/<name>`` (:func:`port_text`)."""
    with open(os.path.join(TESTS, name), encoding="utf-8") as f:
        return port_text(f.read(), subs, what=name)


def replay(name: str, namespace: dict,
           subs: Iterable[Tuple[str, str]] = (),
           only: Optional[Iterable[str]] = None,
           leave_out: Iterable[str] = ()) -> None:
    """Execute the port's version of ``tests/<name>`` in ``namespace``
    (the replaying test module's globals).  ``only``: the test functions
    and classes to keep (every other ``test_*``/``Test*`` is left out;
    imports, helpers and fixtures stay).  ``leave_out``: test functions
    and classes to drop, each of which must exist."""
    src = port_source(name, subs)
    path = os.path.join(TESTS, name)
    tree = ast.parse(src, filename=path)
    names = {n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    drop = set(leave_out)
    if drop - names:
        raise ValueError(f"{name}: no test named {sorted(drop - names)}")
    if only is not None:
        keep = set(only)
        missing = keep - names
        if missing:
            raise ValueError(f"{name}: no test named {sorted(missing)}")
        drop |= {n for n in names
                 if n not in keep and n.lower().startswith("test")}
    tree.body = [n for n in tree.body
                 if not isinstance(n, (ast.FunctionDef, ast.ClassDef))
                 or n.name not in drop]
    rewrite_asserts(tree, src.encode(), path)
    exec(compile(tree, f"{path} (port)", "exec"), namespace)


def port_function(fn, overrides: Optional[dict] = None,
                  subs: Iterable[Tuple[str, str]] = ()):
    """The port's version of the JAX-package test function ``fn`` (a
    golden case, a helper): its source through :func:`port_text`,
    compiled in a copy of its module's globals updated with
    ``overrides`` (the port's ``parse_launch``, ``Buffer``, ...)."""
    import inspect
    import textwrap

    src = port_text(textwrap.dedent(inspect.getsource(fn)), subs,
                    what=fn.__qualname__)
    namespace = dict(fn.__globals__)
    namespace.update(overrides or {})
    path = inspect.getsourcefile(fn)
    exec(compile(src, f"{path} (port)", "exec"), namespace)
    return namespace[fn.__name__]
