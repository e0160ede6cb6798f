"""NNS511 — static validation of ``obs/control.py`` playbook files.

Counterpart of the JAX package's ``analyze/ctlplaybooks.py``, over the port's
modules.

A controller playbook that names a watch rule nobody evaluates, an
actuator nothing exports, or a pool/link target the deployment never
creates fails exactly like a broken alert rule: *silently*, by never
acting.  This pass loads a TOML/JSON playbook file (the same loader the
controller uses — one grammar, one error surface) WITHOUT starting
anything and reports:

- malformed grammar (unknown keys/kinds/actions, bad durations,
  duplicate names, unreadable/unparseable files) — the exact
  :class:`~nnstreamer_tpu_torch.obs.control.PlaybookError` the controller
  would raise at startup;
- playbooks that can never act: an actuator name missing from the
  :data:`~nnstreamer_tpu_torch.runtime.actuators.KNOWN_ACTUATORS` catalog, a
  rule name absent from the active rule set (the ``--watch-rules``
  file when one is given in the same invocation, else
  ``$NNS_TPU_TORCH_WATCH_RULES``, else the built-in pack), or a concrete
  (non-glob) pool/link target that no element in the analyzed
  pipeline(s) creates — pool targets need a ``share-model=true``
  ``tensor_filter`` whose ``framework:model-tail`` label matches, link
  targets an edge element whose name matches.

Invoked by ``nns-lint --ctl-playbooks FILE`` (bare ``--ctl-playbooks``
reads ``$NNS_TPU_TORCH_CTL_PLAYBOOKS``, the same env var the runtime loads
from).  The target cross-check only runs when the same invocation also
analyzed pipelines — with nothing analyzed, a missing target is
unknowable, not wrong.
"""

from __future__ import annotations

import fnmatch
import os
from typing import List, Optional, Tuple

from .diagnostics import Diagnostic

_HINT = ("playbook grammar + the actuator catalog: "
         "Documentation/observability.md ('Closed-loop control & "
         "MTTR'); known actuators: "
         "nnstreamer_tpu_torch.runtime.actuators.KNOWN_ACTUATORS")

#: element factories whose retry policy registers a steerable link
#: breaker (chaos/retrypolicy.py) — the link-target existence check
_LINK_FACTORIES = ("tensor_query_client", "edgesrc", "mqttsrc",
                   "mqttsink")


def _pipeline_targets(pipelines) -> Tuple[List[str], List[str]]:
    """(pool labels, link names) the analyzed pipelines would create:
    pool labels as ``framework:model-tail`` for share-model filters,
    link names as the owning element's name (= the RetryPolicy /
    LinkMetrics ``link`` label)."""
    pools: List[str] = []
    links: List[str] = []
    for pipe in pipelines or []:
        for e in getattr(pipe, "elements", {}).values():
            if getattr(e, "share_model", False):
                fw = str(getattr(e, "framework", "") or "auto")
                model = getattr(e, "model", "")
                tail = os.path.basename(str(model))
                pools.append(f"{fw}:{tail}")
            if getattr(e, "FACTORY", "") in _LINK_FACTORIES:
                links.append(e.name)
    return pools, links


def check_playbooks(path: Optional[str],
                    rule_names: Optional[List[str]] = None,
                    pipelines=None) -> List[Diagnostic]:
    """Diagnostics for one playbook file.  ``path=None`` means "use
    ``$NNS_TPU_TORCH_CTL_PLAYBOOKS``" — unset is itself a finding.
    ``rule_names`` is the active rule set to bind against (None →
    the env rules file when set, else the built-in watch pack);
    ``pipelines`` the parsed-but-never-started pipelines of the same
    invocation, for the target existence check."""
    from ..obs import control as _control
    from ..obs import watch as _watch

    if path is None:
        path = os.environ.get("NNS_TPU_TORCH_CTL_PLAYBOOKS", "").strip()
        if not path:
            return [Diagnostic.make(
                "NNS511",
                "--ctl-playbooks given without a file and "
                "NNS_TPU_TORCH_CTL_PLAYBOOKS is unset — no playbooks to "
                "validate", hint=_HINT)]
    label = os.path.basename(path)
    try:
        playbooks = _control.load_playbooks(path)
    except _control.PlaybookError as e:
        return [Diagnostic.make(
            "NNS511", f"{label}: malformed playbook file: {e}",
            element=path, hint=_HINT)]
    except OSError as e:
        return [Diagnostic.make(
            "NNS511", f"{label}: cannot read playbook file: {e}",
            element=path, hint=_HINT)]
    if rule_names is None:
        try:
            rule_names = [r.name for r in _watch.rules_from_env()]
        except (_watch.RuleError, OSError):
            rule_names = [r.name for r in _watch.default_rules()]
    rule_names = list(rule_names) + ["endpoint-down"]
    pools, links = _pipeline_targets(pipelines)
    diags: List[Diagnostic] = []
    for pb in playbooks:
        for problem in _control.lint_playbook(pb, rule_names):
            diags.append(Diagnostic.make(
                "NNS511", f"{label}: playbook {pb.name!r}: {problem}",
                element=path, pad=pb.name, hint=_HINT))
        # target existence: only for concrete targets, and only when
        # this invocation analyzed pipelines to check against
        if pipelines and pb.target and pb.target != "*":
            have = pools if pb.kind == "pool" else links
            if not any(fnmatch.fnmatch(t, pb.target) for t in have):
                what = "share-model pool" if pb.kind == "pool" \
                    else "edge link"
                diags.append(Diagnostic.make(
                    "NNS511",
                    f"{label}: playbook {pb.name!r}: target "
                    f"{pb.target!r} matches no {what} any analyzed "
                    f"pipeline creates (have: {sorted(set(have))})",
                    element=path, pad=pb.name, hint=_HINT))
    return diags
