"""Pipeline-description corpus discovery for the analyzer CLI.

Counterpart of the JAX package's ``analyze/pipelines.py``.  Two sources:

- ``parse_launch("...")`` string literals in ``chip_smoke.py`` (the
  port's own pipelines on the card), or in any ``.py`` file or directory
  of them, extracted by AST.  An f-string placeholder that stands for a
  property value (``max-buffers={n}``) becomes a neutral ``0`` — the
  analyzer checks structure and caps grammar, not runtime values; a
  literal with a placeholder anywhere else (a whole token, part of a
  name) cannot be known statically and is skipped;
- the documentation example pipelines in
  ``nnstreamer_tpu_torch.tools.gen_element_docs.EXAMPLES`` (the strings
  the generated element docs embed).

The JAX package's ``examples/`` are not a corpus of the port: their
``framework=jax-xla`` is not a port framework.  Descriptions are analyzed
as written; nothing here rewrites their text.

Doc examples are *fragments* (some start with ``... !`` or reference
models that only exist at runtime), so they analyze in fragment mode:
structurally-incomplete findings downgrade to info.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class CorpusEntry:
    label: str      # e.g. "examples/classify_stream.py:33"
    description: str
    fragment: bool


def _literal_string(node: ast.expr) -> Optional[str]:
    """Resolve a string literal / f-string / literal concatenation to
    text; a placeholder right after ``=`` becomes ``0``, any other
    placeholder makes the literal unresolvable (None)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            elif isinstance(v, ast.FormattedValue) and parts \
                    and parts[-1].endswith("="):
                parts.append("0")
            else:
                return None
        return "".join(parts)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _literal_string(node.left)
        right = _literal_string(node.right)
        if left is not None and right is not None:
            return left + right
    return None


def extract_parse_launch_strings(path: str) -> List[CorpusEntry]:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    out: List[CorpusEntry] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = func.id if isinstance(func, ast.Name) else (
            func.attr if isinstance(func, ast.Attribute) else "")
        if name != "parse_launch" or not node.args:
            continue
        desc = _literal_string(node.args[0])
        if desc:
            out.append(CorpusEntry(
                label=f"{path}:{node.lineno}", description=desc,
                fragment=False))
    return out


def example_pipelines(source: str) -> List[CorpusEntry]:
    """The ``parse_launch`` literals of one ``.py`` file, or of every
    ``.py`` file directly in a directory; nothing for a missing path."""
    out: List[CorpusEntry] = []
    if os.path.isfile(source):
        out += extract_parse_launch_strings(source)
    elif os.path.isdir(source):
        for fname in sorted(os.listdir(source)):
            if fname.endswith(".py"):
                out += extract_parse_launch_strings(
                    os.path.join(source, fname))
    return out


def doc_pipelines() -> List[CorpusEntry]:
    from ..tools.gen_element_docs import EXAMPLES

    out: List[CorpusEntry] = []
    for name in sorted(EXAMPLES):
        desc = EXAMPLES[name]
        if desc.startswith("... !"):
            desc = desc[len("... !"):].strip()
        out.append(CorpusEntry(label=f"doc:{name}", description=desc,
                               fragment=True))
    return out


def default_corpus(source: str) -> List[CorpusEntry]:
    """``source``'s literals (``chip_smoke.py`` for the CLI) plus the
    element-doc examples."""
    return example_pipelines(source) + doc_pipelines()
