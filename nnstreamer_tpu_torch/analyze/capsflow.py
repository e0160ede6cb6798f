"""Pass 2 — caps dry-run (NNS2xx, NNS108).

Counterpart of the JAX package's ``analyze/capsflow.py``, over the port's
modules.

Propagates caps sources-outward through the whole assembled graph using
the *real* negotiation machinery (``SourceElement.negotiate`` →
``Element.set_caps``/``negotiate_src_pads`` and every element override),
exactly as ``Pipeline.start()`` would in its PAUSED-equivalent pass — but
as a pure function: no fusion rewrite, no element ``start()``, no
threads, and every pad's caps/spec state is restored afterwards.

Failures are *collected*, not raised, and classified via the structured
context on :class:`NegotiationError` (reason / pads / caps on each side),
so a finding names the exact link and — for empty intersections — the
exact caps field that killed the negotiation (rank-flexible ``dimensions``
compare and ``framerate`` 0/1 wildcards included, parity:
``gst_tensor_caps_can_intersect``).
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional, Tuple

from ..core.caps import Caps, _intersect_value
from ..runtime.element import Element, NegotiationError, SourceElement
from ..runtime.pipeline import Pipeline
from .diagnostics import Diagnostic


def caps_dry_run(pipe: Pipeline, fragment: bool = False) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    pads = [p for e in pipe.elements.values()
            for p in e.sinkpads + e.srcpads]
    saved = [(p, p.caps, p.spec) for p in pads]
    try:
        sources = [e for e in pipe.elements.values()
                   if isinstance(e, SourceElement)]
        for s in sources:
            if not s.srcpads or all(sp.peer is None for sp in s.srcpads):
                continue  # graph pass already reports the dangling pad
            try:
                s.negotiate()
            except NegotiationError as e:
                diags.append(_classify(e, s))
            except OSError as e:
                # source schema lives in a runtime file (datareposrc
                # json descriptor, sensor sysfs dir, ...) not present now
                diags.append(Diagnostic.make(
                    "NNS203", f"{s.name}: source schema depends on a "
                    f"file unavailable at analysis time: {e}",
                    element=s.name,
                    hint="the dry-run cannot follow this branch; the "
                         "file is read when the pipeline starts"))
            except (ValueError, TypeError, KeyError) as e:
                # an element override raised raw — still a negotiation
                # failure, just without structured context
                diags.append(Diagnostic.make(
                    "NNS204", f"{s.name}: negotiation failed: {e}",
                    element=s.name))
        if not diags and not fragment:
            # only when nothing else explains it: a pad negotiation never
            # reached with zero findings means a source-less island
            # (fragments have unreached pads by definition)
            diags += _unreached_pads(pipe)
        diags += _fan_in_rates(pipe)
    finally:
        for p, caps, spec in saved:
            p.caps, p.spec = caps, spec
    return diags


# -- classification ----------------------------------------------------------


def _link_name(e: NegotiationError, fallback: Element) -> Tuple[str, str]:
    """(element, pad) naming the failing spot."""
    if e.src_pad is not None and e.sink_pad is not None:
        return (e.src_pad.element.name,
                f"{e.src_pad.name} -> "
                f"{e.sink_pad.element.name}.{e.sink_pad.name}")
    for pad in (e.sink_pad, e.src_pad):
        if pad is not None:
            return pad.element.name, pad.name
    return fallback.name, ""


def _classify(e: NegotiationError, source: Element) -> Diagnostic:
    el, pad = _link_name(e, source)
    if e.reason == "no-spec":
        return Diagnostic.make(
            "NNS203", f"{e}", element=el, pad=pad or None,
            hint="the source's output schema is set programmatically "
                 "(spec=/caps=) before start; the dry-run cannot follow "
                 "this branch")
    if e.reason == "open":
        return Diagnostic.make(
            "NNS205", f"{e}", element=el, pad=pad or None,
            hint="the model/sub-plugin is resolved at runtime "
                 "(register_model, model files); caps cannot be verified "
                 "statically for this element")
    if e.reason == "empty":
        field = _explain_empty(e.upstream, e.downstream)
        msg = str(e)
        if field:
            msg += f" — first incompatible field: {field}"
        return Diagnostic.make(
            "NNS201", msg, element=el, pad=pad or None,
            hint="fix the named field on one side of the link (insert a "
                 "tensor_transform / tensor_converter, or relax the "
                 "capsfilter)")
    if e.reason == "unfixable":
        field = _unfixed_field(e.upstream)
        msg = str(e)
        if field:
            msg += f" — non-fixable field: {field}"
        return Diagnostic.make(
            "NNS202", msg, element=el, pad=pad or None,
            hint="constrain the field to a concrete value (capsfilter) so "
                 "fixation can pick one")
    return Diagnostic.make(
        "NNS204", f"{e}", element=el, pad=pad or None,
        hint="the element's negotiation hook rejected the incoming caps; "
             "see the message for the element's reason")


def _explain_empty(up: Optional[Caps], down: Optional[Caps]
                   ) -> Optional[str]:
    """Name the first field whose values cannot intersect (or the media
    type, when no struct pair shares a mimetype)."""
    if up is None or down is None or up.is_empty() or down.is_empty():
        return None
    mime_pair = False
    for a in up.structs:
        for b in down.structs:
            if a.mime != b.mime and "*" not in (a.mime, b.mime):
                continue
            mime_pair = True
            ad, bd = a.as_dict(), b.as_dict()
            for k in sorted(set(ad) & set(bd)):
                ok, _ = _intersect_value(k, ad[k], bd[k])
                if not ok:
                    return (f"{k} ({_fmt_value(ad[k])} vs "
                            f"{_fmt_value(bd[k])})")
    if not mime_pair:
        a = up.structs[0].mime
        b = down.structs[0].mime
        return f"media type ({a} vs {b})"
    return None


def _fmt_value(v) -> str:
    if isinstance(v, frozenset):
        return "{" + ",".join(sorted(str(x) for x in v)) + "}"
    return str(v)


def _unfixed_field(caps: Optional[Caps]) -> Optional[str]:
    from ..core.caps import _is_fixed_value

    if caps is None or caps.is_empty():
        return None
    s = caps.structs[0]
    if s.mime == "*":
        return "media type (wildcard)"
    for k, v in s.fields:
        if not _is_fixed_value(k, v):
            return f"{k} ({_fmt_value(v)})"
    return None


# -- post-propagation checks -------------------------------------------------


def _unreached_pads(pipe: Pipeline) -> List[Diagnostic]:
    """Linked pads negotiation never reached with no other caps finding —
    usually an island of linked elements with no source feeding it."""
    diags: List[Diagnostic] = []
    for e in pipe.elements.values():
        for p in e.sinkpads + e.srcpads:
            if p.peer is not None and p.caps is None:
                diags.append(Diagnostic.make(
                    "NNS206",
                    f"negotiation did not reach {e.name}.{p.name}",
                    element=e.name, pad=p.name,
                    hint="caused by an upstream finding, or an upstream "
                         "branch whose caps are only known at runtime"))
    return diags


def _fan_in_rates(pipe: Pipeline) -> List[Diagnostic]:
    """NNS108: fan-in elements (mux/merge/aggregator/crop — anything with
    several linked sink pads) whose negotiated input framerates disagree.
    ``0/1`` is the reference's "any rate" wildcard and matches anything."""
    diags: List[Diagnostic] = []
    for e in pipe.elements.values():
        linked = [p for p in e.sinkpads if p.peer is not None]
        if len(linked) < 2:
            continue
        rates = {}
        for p in linked:
            rate = None
            if p.spec is not None:
                rate = p.spec.rate
            elif p.caps is not None and not p.caps.is_empty():
                rate = p.caps.structs[0].get("framerate")
            if rate in (None, ""):
                continue
            rate = Fraction(rate)
            if rate != 0:
                rates[p.name] = rate
        if len(set(rates.values())) > 1:
            detail = ", ".join(f"{k}={v}" for k, v in sorted(rates.items()))
            diags.append(Diagnostic.make(
                "NNS108",
                f"{e.name}: fan-in inputs disagree on framerate "
                f"({detail}) — sync policies will stall or drop",
                element=e.name,
                hint="rate-match the branches (tensor_rate) or use "
                     "sync_mode=nosync/refresh deliberately"))
    return diags
