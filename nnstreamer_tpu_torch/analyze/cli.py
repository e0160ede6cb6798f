"""CLI for the static analyzer: ``python -m nnstreamer_tpu_torch.analyze``
(``nns-torch-lint``), the counterpart of the JAX package's ``nns-lint``.

Modes (combinable; at least one target is required):

- positional ``PIPELINE`` strings and/or ``--file PATH`` — analyze
  descriptions (graph verifier + caps dry-run), built on the ``meta``
  device: nothing runs and no CUDA context opens;
- ``--examples [PATH]`` — analyze every ``parse_launch`` description
  extracted from ``chip_smoke.py`` (or the ``.py`` file or directory
  PATH) plus the port's element-doc example pipelines;
- ``--self [PKG_DIR]`` — concurrency lint (NNS3xx) over ``runtime/`` and
  codebase lint (NNS4xx) over the whole package;
- ``--concurrency [PKG_DIR]`` — whole-package lock-order/deadlock
  analysis (NNS6xx) with the lock graph in ``--json``/``--dot``.

Output: human text (default) or ``--json`` (stable: targets and
diagnostics sorted, fixed key set).  Exit status: 0 clean, 1 findings at
error severity (or warning severity with ``--strict``), 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import List, Optional, Tuple

from .diagnostics import Diagnostic, Severity, counts, sort_diagnostics

JSON_VERSION = 1


def _repo_root() -> str:
    # nnstreamer_tpu_torch/analyze/cli.py -> repo checkout root
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _pkg_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nnstreamer_tpu_torch.analyze",
        description="Static pipeline verifier + codebase lint "
                    "(gst-validate analog). Diagnostic catalog: "
                    "Documentation/analyze.md")
    p.add_argument("pipelines", nargs="*", metavar="PIPELINE",
                   help="gst-launch-style description(s) to analyze")
    p.add_argument("--file", action="append", default=[],
                   metavar="PATH", help="read a description from a file")
    p.add_argument("--examples", nargs="?", const="__default__",
                   metavar="PATH",
                   help="analyze the parse_launch descriptions of "
                        "chip_smoke.py (or of the .py file or directory "
                        "PATH) and the element-doc examples")
    p.add_argument("--self", dest="self_lint", nargs="?",
                   const="__default__", metavar="PKG_DIR",
                   help="run the NNS3xx/NNS4xx source passes over the "
                        "package")
    p.add_argument("--concurrency", nargs="?", const="__default__",
                   metavar="PKG_DIR",
                   help="run the whole-package concurrency analysis "
                        "(NNS6xx): lock inventory, inter-procedural "
                        "lock-order graph, deadlock cycles, "
                        "hold-and-block, leaf-lock discipline.  "
                        "--json includes the lock graph; --dot dumps "
                        "it alongside pipeline graphs")
    p.add_argument("--watch-rules", dest="watch_rules", nargs="?",
                   const="__env__", metavar="FILE",
                   help="validate an obs/watch.py alert-rules file "
                        "(NNS510: malformed grammar, metric families "
                        "the registry never exports); bare "
                        "--watch-rules reads $NNS_TPU_TORCH_WATCH_RULES")
    p.add_argument("--ctl-playbooks", dest="ctl_playbooks", nargs="?",
                   const="__env__", metavar="FILE",
                   help="validate an obs/control.py playbook file "
                        "(NNS511: malformed grammar, unknown rule/"
                        "actuator, targets no analyzed pipeline "
                        "creates); bare --ctl-playbooks reads "
                        "$NNS_TPU_TORCH_CTL_PLAYBOOKS")
    p.add_argument("--dot", nargs="?", const="-", metavar="DIR",
                   help="emit Pipeline.to_dot() for every parsed "
                        "description — the static graph dump (parity: "
                        "GST_DEBUG_DUMP_DOT_DIR on a never-started "
                        "pipeline).  Bare --dot prints to stdout; "
                        "--dot DIR writes one .dot file per target")
    p.add_argument("--fragment", action="store_true",
                   help="treat descriptions as pipeline fragments "
                        "(incomplete graphs downgrade to info)")
    p.add_argument("--json", dest="as_json", action="store_true",
                   help="machine-readable output")
    p.add_argument("--strict", action="store_true",
                   help="exit nonzero on warnings too")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="hide info-severity diagnostics")
    return p


def _gather(args) -> List[Tuple[str, List[Diagnostic], Optional[object]]]:
    """``(label, diagnostics, pipeline-or-None)`` per target — the
    pipeline rides along (never started) so ``--dot`` can dump it."""
    from . import analyze_description, lint_package
    from .pipelines import default_corpus

    targets: List[Tuple[str, List[Diagnostic], Optional[object]]] = []
    for desc in args.pipelines:
        diags, pipe = analyze_description(desc, fragment=args.fragment)
        targets.append((desc, diags, pipe))
    for path in args.file:
        try:
            with open(path, encoding="utf-8") as f:
                desc = f.read().strip()
        except OSError as e:
            targets.append((path, [Diagnostic.make(
                "NNS100", f"cannot read description file: {e}")], None))
            continue
        diags, pipe = analyze_description(desc, fragment=args.fragment)
        targets.append((path, diags, pipe))
    if args.examples is not None:
        src = args.examples
        if src == "__default__":
            src = os.path.join(_repo_root(), "chip_smoke.py")
        for entry in default_corpus(src):
            diags, pipe = analyze_description(entry.description,
                                              fragment=entry.fragment)
            targets.append((entry.label, diags, pipe))
    if args.self_lint is not None:
        pkg = args.self_lint
        if pkg == "__default__":
            pkg = _pkg_root()
        targets.append(
            (f"self:{os.path.basename(os.path.abspath(pkg))}",
             sort_diagnostics(lint_package(pkg)), None))
    if args.concurrency is not None:
        from .concurrency import analyze_package_concurrency

        pkg = args.concurrency
        if pkg == "__default__":
            pkg = _pkg_root()
        diags, graph = analyze_package_concurrency(pkg)
        # the LockGraph rides in the pipeline slot: it has to_dot()
        # (--dot) and as_graph_dict() (--json) of its own
        targets.append(
            (f"concurrency:{os.path.basename(os.path.abspath(pkg))}",
             diags, graph))
    if args.watch_rules is not None:
        from .watchrules import check_watch_rules

        path = None if args.watch_rules == "__env__" else args.watch_rules
        label = path or os.environ.get("NNS_TPU_TORCH_WATCH_RULES", "") \
            or "$NNS_TPU_TORCH_WATCH_RULES"
        targets.append((f"watch-rules:{label}",
                        sort_diagnostics(check_watch_rules(path)), None))
    if args.ctl_playbooks is not None:
        from .ctlplaybooks import check_playbooks

        path = None if args.ctl_playbooks == "__env__" \
            else args.ctl_playbooks
        label = path or os.environ.get("NNS_TPU_TORCH_CTL_PLAYBOOKS", "") \
            or "$NNS_TPU_TORCH_CTL_PLAYBOOKS"
        # bind rule names against the SAME invocation's rules file when
        # one was given (the deployment's actual rule set), and check
        # concrete targets against the pipelines analyzed above
        rule_names = None
        if args.watch_rules is not None \
                and args.watch_rules != "__env__":
            try:
                from ..obs import watch as _watch

                rule_names = [r.name
                              for r in _watch.load_rules(
                                  args.watch_rules)]
            except Exception:  # noqa: BLE001 - the rules file's own
                # problems are already NNS510 findings above
                rule_names = None
        pipes = [p for _label, _diags, p in targets
                 if p is not None and hasattr(p, "elements")]
        targets.append((f"ctl-playbooks:{label}",
                        sort_diagnostics(check_playbooks(
                            path, rule_names=rule_names,
                            pipelines=pipes)), None))
    _canary_rules_target(args, targets)
    _prof_env_target(targets)
    return targets


def _prof_env_target(targets) -> None:
    """NNS518 pure-env faces: the target only appears when a profiler
    env var is actually set, so default nns-lint output stays
    byte-stable (same pattern as the canary-rules target).  The
    deep-episode-vs-``for`` face binds in check_watch_rules instead —
    it needs the rules file."""
    if not (os.environ.get("NNS_TPU_TORCH_PROF", "").strip()
            or os.environ.get("NNS_TPU_TORCH_PROF_DEEP_DIR", "").strip()):
        return
    from .watchrules import prof_env_problems

    targets.append(("prof-env",
                    sort_diagnostics(prof_env_problems()), None))


def _canary_rules_target(args, targets) -> None:
    """NNS513 rules face: when any analyzed pipeline declares a
    ``canary=`` split, bind it against the active watch rule set (the
    same-invocation ``--watch-rules`` file, else $NNS_TPU_TORCH_WATCH_RULES,
    else the default pack) — a canary nothing judges never promotes or
    rolls back.  The target only appears when a canary was analyzed,
    so non-lifecycle corpora keep their output byte-stable."""
    pipes = [p for _label, _diags, p in targets
             if p is not None and hasattr(p, "elements")]
    has_canary = any(
        getattr(e, "FACTORY", "") == "tensor_filter"
        and str(getattr(e, "canary", "") or "").strip()
        and bool(getattr(e, "share_model", False))
        for p in pipes for e in p.elements.values())
    if not has_canary:
        return
    from ..obs import watch as _watch
    from .graph import canary_watch_checks

    label = "(default pack)"
    try:
        if args.watch_rules is not None \
                and args.watch_rules != "__env__":
            rules = _watch.load_rules(args.watch_rules)
            label = args.watch_rules
        else:
            rules = _watch.rules_from_env()
            label = os.environ.get("NNS_TPU_TORCH_WATCH_RULES", "") \
                or label
    except Exception:  # noqa: BLE001 - a broken rules file is already
        # an NNS510 finding; the canary face can't bind against it
        return
    targets.append((f"canary-rules:{label}",
                    sort_diagnostics(canary_watch_checks(pipes, rules)),
                    None))


def _dot_name(label: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", label).strip("_")[:80] \
        or "pipeline"


def _emit_dot(targets, dest: str, out) -> None:
    """``--dot``: the static graph dump for every target that parsed.
    The pipeline was assembled but never started — caps on the edges are
    whatever the dry-run left fixed, '?' otherwise (parity with a
    GST_DEBUG_DUMP_DOT_DIR dump taken at NULL)."""
    used: dict = {}
    for label, _diags, pipe in targets:
        if pipe is None:
            continue
        dot = pipe.to_dot()
        if dest == "-":
            print(f"// dot: {label}", file=out)
            print(dot, file=out)
        else:
            os.makedirs(dest, exist_ok=True)
            stem = _dot_name(label)
            # two labels may sanitize/truncate to one stem: suffix a
            # counter so no target's graph is silently clobbered
            n = used.get(stem, 0)
            used[stem] = n + 1
            if n:
                stem = f"{stem}.{n}"
            path = os.path.join(dest, stem + ".dot")
            with open(path, "w", encoding="utf-8") as f:
                f.write(dot + "\n")
            print(f"wrote {path}", file=out)


def _print_text(targets, quiet: bool, out) -> None:
    for label, diags, _pipe in targets:
        shown = [d for d in diags
                 if not (quiet and d.severity == Severity.INFO)]
        head = label if len(label) <= 72 else label[:69] + "..."
        print(f"=== {head}", file=out)
        if not shown:
            print("    clean", file=out)
        for d in shown:
            print("    " + str(d).replace("\n", "\n    "), file=out)
    total = counts([d for _, diags, _ in targets for d in diags])
    print(f"{total[Severity.ERROR]} error(s), "
          f"{total[Severity.WARNING]} warning(s), "
          f"{total[Severity.INFO]} info", file=out)


def _print_json(targets, out) -> None:
    doc = {
        "version": JSON_VERSION,
        "targets": [],
        "summary": counts([d for _, diags, _ in targets for d in diags]),
    }
    for label, diags, obj in targets:
        entry = {"target": label,
                 "diagnostics": [d.to_dict() for d in diags]}
        # the --concurrency target carries its LockGraph: nodes/edges/
        # sites ride in the document for tools/ consumers
        if hasattr(obj, "as_graph_dict"):
            entry["lock_graph"] = obj.as_graph_dict()
        doc["targets"].append(entry)
    json.dump(doc, out, indent=2, sort_keys=True)
    out.write("\n")


def main(argv=None, out=None) -> int:
    out = out or sys.stdout
    args = build_parser().parse_args(argv)
    if not (args.pipelines or args.file or args.examples is not None
            or args.self_lint is not None
            or args.concurrency is not None
            or args.watch_rules is not None
            or args.ctl_playbooks is not None):
        build_parser().print_usage(sys.stderr)
        print("error: nothing to analyze (give a PIPELINE, --file, "
              "--examples, --self, --concurrency, --watch-rules or "
              "--ctl-playbooks)",
              file=sys.stderr)
        return 2
    targets = _gather(args)
    if args.dot is not None:
        # dot text / "wrote" lines go to stderr under --json so the
        # JSON document on stdout stays machine-parseable
        _emit_dot(targets, args.dot, sys.stderr if args.as_json else out)
    if args.as_json:
        _print_json(targets, out)
    else:
        _print_text(targets, args.quiet, out)
    all_diags = [d for _, diags, _ in targets for d in diags]
    c = counts(all_diags)
    if c[Severity.ERROR] or (args.strict and c[Severity.WARNING]):
        return 1
    return 0
