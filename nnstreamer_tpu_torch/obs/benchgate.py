"""Continuous-bench history + regression gate (``nns-bench-diff``).

Counterpart of the JAX package's ``obs/benchgate.py``: the same history
record, digest and baseline-spec format.  Result files accumulate, but
nothing tracks them ACROSS runs: a change that halves a speedup ships
unless a human re-reads the numbers.  This module closes that loop:

- :func:`append_history` — a bench run appends one normalized JSONL
  record to a history file (:data:`HISTORY_PATH` by default, the port's
  own: the JAX package's ``BENCH_history.jsonl`` is never written):
  scenario,
  the result's top-level scalar fields, the git sha it ran at, and a
  digest of the metrics-registry snapshot (so two runs whose exported
  metric STATE differs are distinguishable even when the headline
  scalars agree).
- :func:`diff` / :func:`main` — compare the latest history record of a
  scenario against a committed **baseline spec**: a JSON file naming
  per-metric expected values, tolerances and directions.  The verdict
  is ``pass`` / ``regression`` / ``missing-baseline`` (exit codes
  0/1/2), printed as text or ``--json`` — the CI regression gate.

Baseline spec format (per-metric tolerance lives WITH the baseline,
not in CI flags)::

    {
      "scenario": "batching",
      "metrics": {
        "value":              {"baseline": 4.5, "tolerance": 0.5,
                               "direction": "higher"},
        "dispatch_reduction": {"baseline": 8.0, "tolerance": 0.5}
      }
    }

``direction`` is ``higher`` (default: regression when the current
value falls below ``baseline*(1-tolerance)``), ``lower`` (regression
when it rises above ``baseline*(1+tolerance)``), or ``exact``
(regression when it leaves ``baseline ± tolerance*|baseline|`` in
EITHER direction — for analytically-known figures).  A plain bench result
file (no ``metrics`` mapping) also works as a baseline: the ``value``
field is compared at the default tolerance.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

HISTORY_PATH = "BENCH_torch_history.jsonl"
DEFAULT_TOLERANCE = 0.10

VERDICT_PASS = "pass"
VERDICT_REGRESSION = "regression"
VERDICT_MISSING = "missing-baseline"

_EXIT = {VERDICT_PASS: 0, VERDICT_REGRESSION: 1, VERDICT_MISSING: 2}


# -- history ------------------------------------------------------------------


def git_sha(cwd: Optional[str] = None) -> str:
    """HEAD sha of the repo the bench ran in, "" when not a checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd or os.getcwd(),
            capture_output=True, text=True, timeout=10)
        return out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def registry_digest(snapshot: Optional[dict] = None) -> str:
    """Stable sha256 of the metrics-registry snapshot with the volatile
    fields (scrape time, host tag) dropped — two runs that exported the
    same metric state digest identically across hosts."""
    if snapshot is None:
        from .metrics import REGISTRY

        snapshot = REGISTRY.snapshot()
    stable = {k: v for k, v in snapshot.items()
              if k not in ("time", "host")}
    blob = json.dumps(stable, sort_keys=True, default=str).encode()
    return "sha256:" + hashlib.sha256(blob).hexdigest()


def extract_scalars(result: dict) -> Dict[str, Any]:
    """The comparable surface of one bench result: its top-level
    numeric and boolean fields (nested blocks — per-leg curves, metric
    snapshots — stay in the BENCH_*.json, not the history line)."""
    out: Dict[str, Any] = {}
    for k, v in result.items():
        if isinstance(v, bool) or isinstance(v, (int, float)):
            out[k] = v
    return out


def append_history(scenario: str, result: dict,
                   path: str = HISTORY_PATH,
                   snapshot: Optional[dict] = None) -> dict:
    """Append one normalized record of a bench run to the JSONL
    history; returns the record."""
    rec = {
        "scenario": str(scenario),
        "time": time.time(),
        "git_sha": git_sha(),
        "unit": result.get("unit"),
        "scalars": extract_scalars(result),
        "registry_digest": registry_digest(snapshot),
    }
    with open(path, "a") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")
    return rec


def read_history(path: str) -> List[dict]:
    """Every parseable record, file order (unparseable lines are
    skipped — a truncated append from a killed run must not wedge the
    gate forever)."""
    if not os.path.isfile(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def latest_record(path: str, scenario: str) -> Optional[dict]:
    recs = [r for r in read_history(path)
            if r.get("scenario") == scenario]
    return recs[-1] if recs else None


def select_record(records: List[dict], selector: str) -> Optional[dict]:
    """Pick one record of a scenario's history by ``selector``: an
    integer index (0-based file order; negative counts from the end,
    ``-1`` = latest) or a git-sha prefix (latest match wins).  An
    all-digit selector is tried as an index first; out of range, it
    falls back to sha-prefix matching (sha prefixes like ``2740`` are
    common and histories are short, so a real index collision is rare
    and the ambiguity is resolved toward "something" over exit 2).
    None when nothing matches."""
    sel = str(selector).strip()
    neg = sel[1:] if sel.startswith("-") else sel
    if neg.isdigit():
        idx = int(sel)
        if -len(records) <= idx < len(records):
            return records[idx]
    for rec in reversed(records):
        if str(rec.get("git_sha", "")).startswith(sel):
            return rec
    return None


def record_as_baseline(record: dict,
                       tolerance: float = DEFAULT_TOLERANCE) -> dict:
    """Turn one history record into a baseline document, so ANY two
    history records can be diffed (``--against``): every scalar becomes
    a metric at the default tolerance, direction ``higher`` (for
    lower-is-better metrics, gate with a spec file instead)."""
    return {
        "scenario": record.get("scenario"),
        "git_sha": record.get("git_sha"),
        "metrics": {
            name: {"baseline": value, "tolerance": tolerance,
                   "direction": "higher"}
            for name, value in sorted(
                record.get("scalars", {}).items())
            if isinstance(value, (bool, int, float))
        },
    }


# -- the diff -----------------------------------------------------------------


def _baseline_metrics(baseline: dict,
                      default_tolerance: float) -> Dict[str, dict]:
    """Normalize a baseline document into {metric: {baseline,
    tolerance, direction}}.  Spec files carry a ``metrics`` mapping; a
    raw bench result contributes its ``value`` field."""
    metrics = baseline.get("metrics")
    if isinstance(metrics, dict) and metrics and all(
            isinstance(v, dict) for v in metrics.values()):
        out = {}
        for name, spec in metrics.items():
            out[name] = {
                "baseline": spec.get("baseline"),
                "tolerance": float(spec.get("tolerance",
                                            default_tolerance)),
                "direction": str(spec.get("direction", "higher")),
            }
        return out
    if isinstance(baseline.get("value"), (int, float)):
        return {"value": {"baseline": baseline["value"],
                          "tolerance": default_tolerance,
                          "direction": "higher"}}
    return {}


def diff(record: Optional[dict], baseline: Optional[dict],
         default_tolerance: float = DEFAULT_TOLERANCE) -> dict:
    """Compare one history record against one baseline document.
    Returns the verdict dict (``verdict``, per-metric ``checks``)."""
    if baseline is None:
        return {"verdict": VERDICT_MISSING, "checks": [],
                "reason": "no baseline document"}
    specs = _baseline_metrics(baseline, default_tolerance)
    if not specs:
        return {"verdict": VERDICT_MISSING, "checks": [],
                "reason": "baseline document names no metrics"}
    if record is None:
        return {"verdict": VERDICT_MISSING, "checks": [],
                "reason": "no history record for the scenario"}
    scalars = record.get("scalars", {})
    checks = []
    regressed = False
    for name in sorted(specs):
        spec = specs[name]
        base = spec["baseline"]
        tol = spec["tolerance"]
        direction = spec["direction"]
        cur = scalars.get(name)
        if isinstance(cur, bool):
            cur = float(cur)
        if isinstance(base, bool):
            base = float(base)
        check = {"metric": name, "baseline": base, "current": cur,
                 "tolerance": tol, "direction": direction}
        if cur is None or base is None:
            check["ok"] = False
            check["reason"] = "metric missing from " + (
                "record" if cur is None else "baseline")
            regressed = True
        else:
            if base != 0:
                check["delta_frac"] = round((cur - base) / abs(base), 4)
            if direction == "lower":
                ok = cur <= base + tol * abs(base)
            elif direction == "exact":
                # analytically-known figures (crossings-per-frame on
                # the seed pipeline): a move in EITHER direction is a
                # regression — more crossings is the exact class the
                # ledger exists to catch
                ok = abs(cur - base) <= tol * abs(base)
            else:
                ok = cur >= base - tol * abs(base)
            check["ok"] = bool(ok)
            regressed = regressed or not ok
        checks.append(check)
    return {
        "verdict": VERDICT_REGRESSION if regressed else VERDICT_PASS,
        "scenario": record.get("scenario"),
        "git_sha": record.get("git_sha"),
        "checks": checks,
    }


def _render_text(verdict: dict) -> str:
    lines = []
    for c in verdict.get("checks", []):
        mark = "ok  " if c.get("ok") else "FAIL"
        delta = c.get("delta_frac")
        lines.append(
            f"  {mark} {c['metric']}: current={c.get('current')} "
            f"baseline={c.get('baseline')} tol={c['tolerance']:g} "
            f"({c['direction']})"
            + (f" delta={delta:+.1%}" if delta is not None else "")
            + (f" [{c['reason']}]" if c.get("reason") else ""))
    head = f"verdict: {verdict['verdict']}"
    if verdict.get("reason"):
        head += f" ({verdict['reason']})"
    if verdict.get("scenario"):
        head += f" — scenario {verdict['scenario']}"
    return "\n".join([head] + lines)


# -- CLI ----------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nns-torch-bench-diff",
        description="Compare the latest history record of "
                    "a scenario against a committed baseline; exit 0 "
                    "pass / 1 regression / 2 missing baseline")
    p.add_argument("--history", default=HISTORY_PATH,
                   help=f"history JSONL path (default {HISTORY_PATH})")
    p.add_argument("--scenario", required=True,
                   help="scenario name recorded in the history")
    p.add_argument("--baseline", default=None,
                   help="baseline JSON: a spec file with a 'metrics' "
                        "mapping (per-metric tolerance/direction) or a "
                        "raw BENCH_*.json (its 'value' is compared); "
                        "exactly one of --baseline/--against")
    p.add_argument("--against", default=None, metavar="RECORD",
                   help="compare against another HISTORY RECORD of the "
                        "scenario instead of a baseline file: an index "
                        "(0-based; negative from the end, -2 = "
                        "second-latest) or a git-sha prefix — every "
                        "scalar is compared at the default tolerance, "
                        "direction 'higher'")
    p.add_argument("--record", default=None, metavar="RECORD",
                   help="which history record is 'current' (same "
                        "selector grammar as --against; default: the "
                        "scenario's latest)")
    p.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                   help="default relative tolerance for metrics that "
                        "don't carry their own (default 0.10)")
    p.add_argument("--json", dest="as_json", action="store_true",
                   help="print the verdict as JSON instead of text")
    return p


def main(argv=None, out=None) -> int:
    out = out or sys.stdout
    parser = build_parser()
    args = parser.parse_args(argv)
    if (args.baseline is None) == (args.against is None):
        parser.error("exactly one of --baseline / --against required")
    records = [r for r in read_history(args.history)
               if r.get("scenario") == args.scenario]
    baseline = None
    if args.against is not None:
        against = select_record(records, args.against)
        if against is not None:
            baseline = record_as_baseline(against, args.tolerance)
    elif os.path.isfile(args.baseline):
        try:
            with open(args.baseline) as f:
                baseline = json.load(f)
        except ValueError:
            baseline = None
    if args.record is not None:
        record = select_record(records, args.record)
    else:
        record = records[-1] if records else None
    verdict = diff(record, baseline, default_tolerance=args.tolerance)
    if args.as_json:
        print(json.dumps(verdict, indent=1), file=out)
    else:
        print(_render_text(verdict), file=out)
    return _EXIT[verdict["verdict"]]


if __name__ == "__main__":
    sys.exit(main())
