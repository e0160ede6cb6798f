"""Pass 1 — graph verifier (NNS1xx), and the NNS5xx topology checks.

Counterpart of the JAX package's ``analyze/graph.py``, reading the
port's seams: the ``torch-cuda`` filter, ``runtime/fusion.py``, the kernel
cache of ``ops/build.py``.

Checks the *structure* of an assembled (not started) Pipeline: dangling
pads, zero-sink/zero-source graphs, cycles, and elements no source can
ever feed.  Runs no threads and negotiates nothing — parity with what
``gst-validate`` can prove from a launch line alone.

``fragment=True`` analyzes a pipeline snippet (doc examples starting with
``... !``): structural findings that a fragment legitimately lacks
(source/sink/unlinked edge pads) downgrade to info.
"""

from __future__ import annotations

from typing import Dict, List, Set

from ..runtime.element import Element, SourceElement
from ..runtime.pipeline import Pipeline
from .diagnostics import Diagnostic, Severity


def _downgrade(fragment: bool):
    return Severity.INFO if fragment else None


def verify_graph(pipe: Pipeline, fragment: bool = False) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    elements = list(pipe.elements.values())
    if not elements:
        diags.append(Diagnostic.make(
            "NNS107", "pipeline is empty", element=pipe.name))
        return diags

    sources = [e for e in elements if isinstance(e, SourceElement)]
    sinks = [e for e in elements if e.sinkpads and not e.srcpads]
    if not sources:
        diags.append(Diagnostic.make(
            "NNS107", "pipeline has no source element — nothing will ever "
            "produce data", element=pipe.name,
            hint="add a source (appsrc, device_src, filesrc, ...) or link "
                 "this fragment downstream of one",
            severity=_downgrade(fragment)))
    if not sinks:
        diags.append(Diagnostic.make(
            "NNS106", "pipeline has no sink element — EOS tracking and "
            "wait_eos() will never complete", element=pipe.name,
            hint="terminate every branch in a sink (tensor_sink, appsink, "
                 "filesink, ...)", severity=_downgrade(fragment)))

    for e in elements:
        for p in e.sinkpads:
            if p.peer is None:
                diags.append(Diagnostic.make(
                    "NNS101", f"sink pad {e.name}.{p.name} is not linked — "
                    f"Pipeline.start() will refuse this graph",
                    element=e.name, pad=p.name,
                    hint="link an upstream element into this pad or remove "
                         "the element", severity=_downgrade(fragment)))
        for p in e.srcpads:
            if p.peer is None:
                diags.append(Diagnostic.make(
                    "NNS102", f"src pad {e.name}.{p.name} is not linked — "
                    f"buffers pushed there are silently dropped",
                    element=e.name, pad=p.name,
                    hint="link the pad downstream or drop it (request pads "
                         "only exist because something asked for them)",
                    severity=_downgrade(fragment)))

    diags += _find_cycles(elements)
    diags += _find_unreachable(elements, sources, fragment)
    diags += _batching_checks(elements, fragment)
    diags += _serving_checks(elements)
    diags += _lifecycle_checks(elements)
    diags += _obs_checks(elements)
    diags += _dataflow_checks(elements)
    diags += _fusion_checks(elements)
    return diags


def _adjacency(elements: List[Element]) -> Dict[str, List[str]]:
    adj: Dict[str, List[str]] = {e.name: [] for e in elements}
    for e in elements:
        for sp in e.srcpads:
            if sp.peer is not None:
                adj[e.name].append(sp.peer.element.name)
    return adj


def _find_cycles(elements: List[Element]) -> List[Diagnostic]:
    """Iterative DFS three-color cycle detection; reports each cycle once
    with the element path."""
    adj = _adjacency(elements)
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in adj}
    diags: List[Diagnostic] = []
    reported: Set[frozenset] = set()
    for root in adj:
        if color[root] != WHITE:
            continue
        stack = [(root, iter(adj[root]))]
        color[root] = GREY
        path = [root]
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if color[nxt] == GREY:
                    cyc = path[path.index(nxt):] + [nxt]
                    key = frozenset(cyc)
                    if key not in reported:
                        reported.add(key)
                        diags.append(Diagnostic.make(
                            "NNS104",
                            "cycle in the pipeline graph: "
                            + " -> ".join(cyc),
                            element=nxt,
                            hint="pipelines are DAGs; feed state back "
                                 "through tensor_reposink/tensor_reposrc "
                                 "slots instead of pad links"))
                elif color[nxt] == WHITE:
                    color[nxt] = GREY
                    stack.append((nxt, iter(adj[nxt])))
                    path.append(nxt)
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                stack.pop()
                path.pop()
    return diags


def _find_unreachable(elements: List[Element],
                      sources: List[Element],
                      fragment: bool) -> List[Diagnostic]:
    """BFS downstream from every source; anything never visited can never
    see a buffer."""
    if fragment or not sources:
        # fragments have no sources by construction; a fully source-less
        # graph is already NNS107 — flagging every element adds noise
        return []
    adj = _adjacency(elements)
    seen: Set[str] = set()
    frontier = [s.name for s in sources]
    seen.update(frontier)
    while frontier:
        nxt: List[str] = []
        for n in frontier:
            for m in adj[n]:
                if m not in seen:
                    seen.add(m)
                    nxt.append(m)
        frontier = nxt
    diags: List[Diagnostic] = []
    for e in elements:
        if e.name not in seen:
            diags.append(Diagnostic.make(
                "NNS105", f"element {e.name} is unreachable: no source "
                f"element feeds it", element=e.name,
                hint="link it downstream of a source or remove it"))
    return diags


def _int_prop(e: Element, name: str, default: int = 0) -> int:
    try:
        return int(getattr(e, name, default) or default)
    except (TypeError, ValueError):
        return default


def _has_upstream_queue(e: Element) -> bool:
    """Whether any ``queue`` sits in the upstream closure of ``e``."""
    seen = {e.name}
    frontier: List[Element] = [e]
    while frontier:
        cur = frontier.pop()
        for p in cur.sinkpads:
            if p.peer is None:
                continue
            up = p.peer.element
            if up.name in seen:
                continue
            seen.add(up.name)
            if getattr(up, "FACTORY", "") == "queue":
                return True
            frontier.append(up)
    return False


def _batching_checks(elements: List[Element],
                     fragment: bool) -> List[Diagnostic]:
    """NNS5xx: micro-batching topology (runtime/batching.py).  A
    ``tensor_filter batch>1`` only coalesces when a ``queue`` decouples
    it from its producer (the thread boundary lets buffers pile into the
    window; chained directly, each producer push waits out the deadline
    instead), and ``latency=1`` forces every dispatch synchronous, so
    windows never hold more than the one frame in flight.  NNS505 is the
    dual: ``latency=1`` *behind* a queue reports a number the queue's
    buffering makes misleading."""
    diags: List[Diagnostic] = []
    for e in elements:
        if getattr(e, "FACTORY", "") != "tensor_filter":
            continue
        batch = _int_prop(e, "batch", 1)
        latency = _int_prop(e, "latency", 0)
        if batch <= 1 and latency != 1:
            continue
        has_queue = _has_upstream_queue(e)
        if batch > 1 and latency == 1:
            diags.append(Diagnostic.make(
                "NNS502",
                f"{e.name}: batch={batch} with latency=1 — synchronous "
                f"per-invoke measurement blocks the stream on every "
                f"dispatch, so the coalescing window never holds more "
                f"than the frame being measured",
                element=e.name,
                hint="drop latency=1 (use the sampled stats) or batch=1 "
                     "for latency-calibration runs"))
        if batch > 1 and not has_queue:
            diags.append(Diagnostic.make(
                "NNS501",
                f"{e.name}: batch={batch} but no queue upstream — "
                f"without a thread boundary the producer hands one "
                f"buffer at a time, so every window closes on the "
                f"batch-timeout-ms deadline with one frame: all added "
                f"latency, no coalescing",
                element=e.name,
                hint="insert `queue !` in front of the filter (or drop "
                     "batch=)", severity=_downgrade(fragment)))
        if latency == 1 and has_queue:
            diags.append(Diagnostic.make(
                "NNS505",
                f"{e.name}: latency=1 measures only the synchronous "
                f"invoke, but an upstream queue parks buffers ahead of "
                f"this filter — a frame's end-to-end latency is invoke "
                f"time PLUS queue residency, which the reported number "
                f"cannot see",
                element=e.name,
                hint="for true per-frame latency attach the obs latency "
                     "tracer (Documentation/observability.md) — it "
                     "breaks the end-to-end time down per element, "
                     "queue residency included"))
    return diags


# NNS506/NNS507 (tensor_query_client's link bounds and clock sync) wait
# for the port's edge layer (ROADMAP item 5); NNS509/NNS512 (mesh
# divisibility, pool placement conflicts) for mesh placement (item 6).
# The port's tensor_filter has no mesh=/devices= property and no
# tensor_query_client yet, so a description using them does not parse
# (NNS100).  The catalog keeps their codes.


def _obs_checks(elements: List[Element]) -> List[Diagnostic]:
    """NNS508: observability props on a pipeline running with the
    global obs kill switch set (``NNS_TPU_TORCH_OBS_DISABLE``).  Under the
    switch no blocking stat sample is ever taken and no tracer can
    attach, so ``stat-sample-interval-ms``, ``latency=1``,
    ``latency-report`` and query-client ``trace`` propagation all
    silently no-op — the user asked for numbers nobody will produce."""
    from ..obs import hooks as obs_hooks

    if not obs_hooks.obs_disabled():
        return []
    diags: List[Diagnostic] = []
    for e in elements:
        props: List[str] = []
        if getattr(e, "stat_sample_interval_ms", None) is not None:
            props.append("stat-sample-interval-ms")
        if _int_prop(e, "latency", 0) == 1:
            props.append("latency=1")
        if bool(getattr(e, "latency_report", False)):
            props.append("latency-report")
        if getattr(e, "FACTORY", "") == "tensor_query_client" \
                and bool(getattr(e, "trace", False)):
            props.append("trace")
        if not props:
            continue
        diags.append(Diagnostic.make(
            "NNS508",
            f"{e.name}: {', '.join(props)} set, but observability is "
            f"globally disabled (NNS_TPU_TORCH_OBS_DISABLE) — no latency "
            f"sample will ever be taken and no trace context will "
            f"propagate; the prop(s) silently no-op",
            element=e.name,
            hint="unset NNS_TPU_TORCH_OBS_DISABLE to get the numbers these "
                 "props ask for, or drop the props "
                 "(Documentation/observability.md)"))
    return diags


#: the version-labelled metric families the model lifecycle exports —
#: a canary= declaration whose active watch rules bind NONE of these
#: has no judge: promotion/rollback would never trigger (NNS513)
MODEL_SERIES = frozenset({
    "nns_model_version_invokes_total",
    "nns_model_version_frames_total",
    "nns_model_version_errors_total",
    "nns_model_version_latency_us",
    "nns_model_version_state",
    "nns_model_canary_streams",
    "nns_model_canary_latency_us",
    "nns_model_baseline_latency_us",
    "nns_model_canary_errors_total",
    "nns_model_canary_frames_total",
})


def _supports_reload(e: Element) -> bool:
    """Whether this filter's framework can actually hot-reload: it
    implements ``prepare_swap`` (the lifecycle's double-buffered
    path) or overrides the RELOAD_MODEL event handler."""
    fw = str(getattr(e, "framework", "") or "auto")
    model = getattr(e, "model", None)
    try:
        from ..filters.api import FilterSubplugin
        from ..filters.registry import detect_framework, find_filter

        if fw in ("", "auto"):
            fw = detect_framework(model)
        cls = find_filter(fw)
    except (ValueError, KeyError):
        return True  # unknown framework: the open itself will complain
    # the port's base class declares prepare_swap (raising): a framework
    # supports reload when it overrides either hook
    return cls.prepare_swap is not FilterSubplugin.prepare_swap \
        or cls.handle_event is not FilterSubplugin.handle_event


def _lifecycle_checks(elements: List[Element]) -> List[Diagnostic]:
    """NNS513 (element faces): canary grammar / canary without
    share-model, is-updatable on a framework without reload support,
    and a misconfigured persistent compile-cache directory.  The
    canary-without-watch-rule face needs the active rule set and runs
    in the CLI (``canary_watch_checks``).  Also the element face of
    NNS517: ``tenant=`` on a filter that never dispatches through a
    shared pool."""
    import os

    diags: List[Diagnostic] = []
    filters = [e for e in elements
               if getattr(e, "FACTORY", "") == "tensor_filter"]
    for e in filters:
        canary = str(getattr(e, "canary", "") or "").strip()
        if canary:
            from ..runtime.lifecycle import LifecycleError, parse_canary

            try:
                parse_canary(canary)
            except LifecycleError as err:
                diags.append(Diagnostic.make(
                    "NNS513", f"{e.name}: {err}", element=e.name,
                    hint="canary grammar: '<version>:1/N' or '1/N' "
                         "(Documentation/lifecycle.md)"))
            else:
                if not bool(getattr(e, "share_model", False)):
                    diags.append(Diagnostic.make(
                        "NNS513",
                        f"{e.name}: canary={canary!r} without "
                        f"share-model=true — canarying routes 1-in-N "
                        f"STREAMS of a shared pool; a private filter "
                        f"has exactly one stream and nothing to split",
                        element=e.name,
                        hint="set share-model=true (the canary split "
                             "is pool-level) or drop canary="))
        tenant = str(getattr(e, "tenant", "") or "").strip()
        if tenant and not bool(getattr(e, "share_model", False)):
            diags.append(Diagnostic.make(
                "NNS517",
                f"{e.name}: tenant={tenant!r} without share-model="
                f"true — tenant attribution splits the SHARED pool's "
                f"device-seconds across the streams parked in each "
                f"window; a private filter never dispatches through "
                f"a pool, so nothing is ever billed to the tenant",
                element=e.name,
                hint="set share-model=true (attribution is pool-"
                     "level) or drop tenant= "
                     "(Documentation/observability.md)"))
        if bool(getattr(e, "is_updatable", False)) \
                and not _supports_reload(e):
            fw = str(getattr(e, "framework", "") or "auto")
            diags.append(Diagnostic.make(
                "NNS513",
                f"{e.name}: is-updatable=true, but framework {fw!r} "
                f"implements neither prepare_swap nor a RELOAD_MODEL "
                f"handler — a reload event will raise instead of "
                f"swapping",
                element=e.name,
                hint="drop is-updatable, or use a framework with "
                     "reload support (torch-cuda)"))
    cache_dir = os.environ.get("NNS_TPU_TORCH_COMPILE_CACHE_DIR", "").strip()
    if filters and cache_dir and (
            not os.path.isdir(cache_dir)
            or not os.access(cache_dir, os.W_OK)):
        diags.append(Diagnostic.make(
            "NNS513",
            f"NNS_TPU_TORCH_COMPILE_CACHE_DIR={cache_dir!r} is not a "
            f"writable directory — the kernel cache of ops/build.py "
            f"cannot keep its built libraries, so every fresh process "
            f"runs nvcc for every kernel again",
            element=filters[0].name,
            hint="create the directory (writable) or unset "
                 "NNS_TPU_TORCH_COMPILE_CACHE_DIR "
                 "(Documentation/lifecycle.md)"))
    return diags


def canary_watch_checks(pipelines, rules) -> List[Diagnostic]:
    """NNS513 (rules face): a ``canary=`` declaration whose ACTIVE
    watch rule set binds none of the version-labelled series — the
    canary would route traffic forever with no judge to promote or
    roll it back.  ``rules`` is the same-invocation rule set
    (--watch-rules file, else $NNS_TPU_TORCH_WATCH_RULES, else the default
    pack — which binds none of them)."""
    canary_els = []
    for pipe in pipelines:
        for e in pipe.elements.values():
            if getattr(e, "FACTORY", "") == "tensor_filter" \
                    and str(getattr(e, "canary", "") or "").strip() \
                    and bool(getattr(e, "share_model", False)):
                canary_els.append(e)
    if not canary_els:
        return []
    bound = any(r.metric in MODEL_SERIES
                or getattr(r, "per", "") in MODEL_SERIES
                for r in rules)
    if bound:
        return []
    return [Diagnostic.make(
        "NNS513",
        f"{e.name}: canary={str(getattr(e, 'canary', '')).strip()!r} "
        f"declared, but no active watch rule binds any "
        f"version-labelled series (nns_model_canary_latency_us, "
        f"nns_model_canary_errors_total, ...) — nothing will ever "
        f"judge the canary, so promotion/rollback never triggers",
        element=e.name,
        hint="add a comparator rule pair (canary latency vs baseline "
             "via per=, canary error rate) and promote/rollback "
             "playbooks (Documentation/lifecycle.md)")
        for e in canary_els]


#: frameworks whose sub-plugin instances carry host-side per-stream
#: state (user callables / script objects): sharing ONE instance across
#: pipelines via the serving pool is unsafe unless the user code is
#: explicitly reentrant
_STATEFUL_FRAMEWORKS = frozenset({"custom", "custom-easy", "python3"})

#: residency-transparent elements: they forward whatever residency
#: their input has (queue/tee pass references; mux/merge/demux/split
#: fan in/out on device whenever the inputs are device-resident) — the
#: NNS514 sandwich walk looks THROUGH them
_RESIDENCY_TRANSPARENT = frozenset({
    "queue", "tee", "identity", "join", "tensor_mux", "tensor_merge",
    "tensor_demux", "tensor_split"})

#: elements that compute on host, full stop: their chain reads every
#: input tensor on host and emits host arrays — between two device
#: stages they are a residency FENCE (one d2h + one h2d per frame)
_HOST_ONLY_FACTORIES = frozenset({
    "tensor_converter", "tensor_sparse_enc", "tensor_sparse_dec"})


def _residency_class(e: Element) -> str:
    """'device' | 'host' | 'transparent' | 'opaque' for the NNS514
    walk.  Conservative: anything unrecognized is opaque (stops the
    walk without counting as either side), so new elements can never
    produce a false sandwich."""
    f = getattr(e, "FACTORY", "")
    if f in _RESIDENCY_TRANSPARENT:
        return "transparent"
    if f in _HOST_ONLY_FACTORIES:
        return "host"
    if f == "device_src":
        return "device"
    if f == "tensor_transform":
        # torch ops on the pipeline's device; acceleration=false declares
        # host intent (the reference's ORC flag) — stay conservative
        # and treat it as opaque rather than a device side of a fence
        if not bool(getattr(e, "acceleration", True)):
            return "opaque"
        return "device"
    if f == "tensor_filter":
        fw = str(getattr(e, "framework", "") or "auto")
        if fw in _STATEFUL_FRAMEWORKS:
            return "host"
        if _resolves_torch_cuda(fw, getattr(e, "model", None)):
            return "device"
        return "opaque"
    if f == "tensor_decoder":
        dev_render = str(getattr(e, "option7", "")
                         or "").strip().lower() == "device"
        return "device" if dev_render else "host"
    return "opaque"


def _dataflow_checks(elements: List[Element]) -> List[Diagnostic]:
    """NNS514: a host-only element sandwiched between two device-
    resident stages.  The upstream stage's output must drain d2h for
    the host element to read it, and the downstream stage re-uploads
    h2d — a residency fence paying one full host round-trip pair per
    frame, in a chain that would otherwise stay on the card end to end
    (Documentation/dataflow.md).  The walk looks through residency-
    transparent plumbing (queue/tee/mux/...)."""
    cls = {e.name: _residency_class(e) for e in elements}
    down = _adjacency(elements)
    up: Dict[str, List[str]] = {e.name: [] for e in elements}
    for name, outs in down.items():
        for o in outs:
            up[o].append(name)

    def reaches_device(start: str, adj: Dict[str, List[str]]) -> bool:
        seen, stack = set(), list(adj[start])
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            c = cls.get(n, "opaque")
            if c == "device":
                return True
            if c == "transparent":
                stack.extend(adj[n])
        return False

    diags: List[Diagnostic] = []
    for e in elements:
        if cls[e.name] != "host":
            continue
        if not (reaches_device(e.name, up)
                and reaches_device(e.name, down)):
            continue
        what = getattr(e, "FACTORY", type(e).__name__)
        diags.append(Diagnostic.make(
            "NNS514",
            f"{e.name}: host-only element ({what}) between two "
            f"device-resident stages — a residency fence: every frame "
            f"pays a d2h drain to feed it and an h2d upload to leave "
            f"it, in a chain that would otherwise stay on the card end to "
            f"end",
            element=e.name,
            hint="move the host stage before the first (or after the "
                 "last) device stage, replace it with a device-capable "
                 "equivalent (tensor_transform, tensor_decoder "
                 "option7=device, a torch-cuda filter), or accept the "
                 "round-trip knowingly (Documentation/dataflow.md)"))
    return diags


#: plumbing the fusion pass CANNOT look through (runtime/fusion.py
#: requires direct pad adjacency): a queue or tee between segment
#: stages blocks the single-dispatch collapse even though dataflow
#: still works
_FUSION_PLUMBING = frozenset({"queue", "tee"})

#: bounding_boxes schemes with a device render program
#: (decoders/boundingbox.py device_post_program) — the set for which
#: ``option7=device`` makes the decoder a fusable device endpoint
_DEVICE_RENDER_SCHEMES = frozenset({
    "mobilenet-ssd-postprocess", "mobilenetssd-pp"})


def _fusion_checks(elements: List[Element]) -> List[Diagnostic]:
    """NNS515: a linear transform→filter→decoder segment that WOULD
    collapse into one program per window (runtime/fusion.py) but
    is prevented by a breakable configuration — interposed queue/tee,
    ``share-model=true`` or ``invoke-dynamic`` on the filter, or a
    device-capable decoder scheme left on the host render path.  Warn
    only when every leg of the segment is present and the cause is
    actually breakable: an upstream queue feeding a ``batch>1`` filter
    is load-bearing (NNS501 *requires* it), and a decoder mode without
    a device render program could never fuse, so neither fires."""
    byname = {e.name: e for e in elements}
    down = _adjacency(elements)
    up: Dict[str, List[str]] = {e.name: [] for e in elements}
    for name, outs in down.items():
        for o in outs:
            up[o].append(name)

    def probe(start: str, adj: Dict[str, List[str]], factory: str):
        """First element of ``factory`` reachable from ``start``
        looking only THROUGH fusion-blocking plumbing (queue/tee).
        Returns ``(element | None, crossed_plumbing)``."""
        seen: Set[str] = set()
        stack = [(n, False) for n in adj[start]]
        while stack:
            n, crossed = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            e = byname.get(n)
            f = getattr(e, "FACTORY", "")
            if f in _FUSION_PLUMBING:
                stack.extend((m, True) for m in adj[n])
                continue
            if f == factory:
                return e, crossed
        return None, False

    diags: List[Diagnostic] = []
    for flt in elements:
        if getattr(flt, "FACTORY", "") != "tensor_filter":
            continue
        fw = str(getattr(flt, "framework", "") or "auto")
        if not _resolves_torch_cuda(fw, getattr(flt, "model", None)):
            continue
        tr, crossed_up = probe(flt.name, up, "tensor_transform")
        dec, crossed_down = probe(flt.name, down, "tensor_decoder")
        if tr is None or dec is None:
            continue  # not a transform→filter→decoder segment
        cause = hint = None
        batched = int(getattr(flt, "batch", 1) or 1) > 1
        dec_mode = str(getattr(dec, "mode", "") or "")
        dec_scheme = str(getattr(dec, "option1", "") or "").strip().lower()
        dec_device = str(getattr(dec, "option7", "")
                         or "").strip().lower() == "device"
        if bool(getattr(flt, "invoke_dynamic", False)):
            cause = f"invoke-dynamic=true on {flt.name} recompiles " \
                    f"per buffer, so no whole-segment program exists"
            hint = "drop invoke-dynamic (use flexible caps only where " \
                   "shapes truly vary per buffer)"
        elif bool(getattr(flt, "share_model", False)):
            cause = f"share-model=true on {flt.name}: the pooled " \
                    f"instance serves many pipelines, so this " \
                    f"pipeline's transform/decoder stages cannot be " \
                    f"baked into it"
            hint = "give the filter its own instance (share-model=" \
                   "false) or accept per-stage dispatches on the " \
                   "shared path"
        elif (crossed_up and not batched) or crossed_down:
            where = "between the transform and the filter" \
                if crossed_up and not batched \
                else "between the filter and the decoder"
            cause = f"a queue/tee sits {where}: fusion requires " \
                    f"direct pad adjacency"
            hint = "link the segment stages directly (move the " \
                   "queue before the transform / the tee after the " \
                   "decoder)"
        elif dec_mode == "bounding_boxes" and not dec_device \
                and dec_scheme in _DEVICE_RENDER_SCHEMES:
            cause = f"{dec.name} renders on host " \
                    f"(scheme {dec_scheme} has a device render " \
                    f"program, but option7=device is not set)"
            hint = f"set option7=device on {dec.name} so the overlay " \
                   f"fuses into the filter's program"
        if cause is None:
            continue
        diags.append(Diagnostic.make(
            "NNS515",
            f"{tr.name}→{flt.name}→{dec.name}: segment cannot fuse "
            f"into one program per window — {cause}",
            element=flt.name, hint=hint))
    return diags


# NNS516 (pipeline-split stage subsets, the offload branch's residency,
# the heavy stage's share-model) waits for the pipeline split (ROADMAP
# item 6): it needs devices= stage subsets.  Its inventory face must read
# only a CUDA runtime that is already initialised
# (``torch.cuda.is_initialized()``): lint never opens a context itself.


def _resolves_torch_cuda(framework: str, model) -> bool:
    """Whether this filter will open the torch-cuda sub-plugin (explicit
    framework, or auto-detection by model extension)."""
    if framework == "torch-cuda":
        return True
    if framework not in ("", "auto"):
        return False
    try:
        from ..filters.registry import detect_framework

        return detect_framework(model) == "torch-cuda"
    except (ValueError, KeyError):
        return False


def _serving_checks(elements: List[Element]) -> List[Diagnostic]:
    """NNS503/NNS504: shared-model serving topology (runtime/serving.py).
    Two torch-cuda filters opening the same model without ``share-model``
    hold two weight copies and two programs on the card — and their
    batch windows coalesce independently; ``share-model=true`` on a
    host-side stateful framework shares one user object across
    pipelines, which is only safe for reentrant code."""
    diags: List[Diagnostic] = []
    by_model: Dict[tuple, List[Element]] = {}
    for e in elements:
        if getattr(e, "FACTORY", "") != "tensor_filter":
            continue
        fw = str(getattr(e, "framework", "") or "auto")
        share = bool(getattr(e, "share_model", False))
        if share and fw in _STATEFUL_FRAMEWORKS:
            diags.append(Diagnostic.make(
                "NNS504",
                f"{e.name}: share-model=true with framework={fw} — the "
                f"pooled instance is ONE host-side user object invoked "
                f"from every sharing pipeline's flush context; unless "
                f"the user code is reentrant and stateless this "
                f"corrupts state across streams",
                element=e.name,
                hint="drop share-model (each filter keeps its own "
                     "instance) or port the model to torch-cuda, whose "
                     "pooled instances share immutable weights"))
        model = getattr(e, "model", None)
        if share or not isinstance(model, str) or not model:
            continue
        if not _resolves_torch_cuda(fw, model):
            continue
        # mirror serving.pool_key: filters differing in ANY of these
        # would land in separate pool entries, so recommending
        # share-model to them would not actually share anything
        key = (model, str(getattr(e, "accelerator", "") or ""),
               str(getattr(e, "custom", "") or ""),
               str(getattr(e, "input", "") or ""),
               str(getattr(e, "inputtype", "") or ""),
               str(getattr(e, "output", "") or ""),
               str(getattr(e, "outputtype", "") or ""),
               str(getattr(e, "shared_tensor_filter_key", "") or ""))
        by_model.setdefault(key, []).append(e)
    for key, els in by_model.items():
        if len(els) < 2:
            continue
        model = key[0]
        names = ", ".join(el.name for el in els)
        diags.append(Diagnostic.make(
            "NNS503",
            f"{len(els)} torch-cuda filters ({names}) open model "
            f"{model!r} without share-model — each holds its own "
            f"weight copy and program on the card, and their "
            f"batch windows dispatch independently",
            element=els[0].name,
            hint="set share-model=true on all of them to share ONE "
                 "pooled instance and one cross-pipeline batch window "
                 "(Documentation/serving.md)"))
    return diags
