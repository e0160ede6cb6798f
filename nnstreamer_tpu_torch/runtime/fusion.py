"""Transform↔filter↔decoder fusion pass (counterpart of the JAX package's
``runtime/fusion.py``).

Before negotiation, every maximal run of ``tensor_transform`` elements
feeding a ``torch-cuda`` ``tensor_filter`` is folded into the filter's
per-frame program: the transforms become passthrough nodes and the filter
runs ``model ∘ t_k ∘ … ∘ t_1`` itself (the prologue); a
``tensor_decoder mode=bounding_boxes option7=device`` right after it
becomes the program's epilogue.  One element then does the device work of
the whole segment per window, and nothing crosses to the host between the
stages.  (The reference's Orc multi-op fusion idea,
nnstreamer:gst/nnstreamer/elements/gsttensor_transform.c:473-483.)

Fusion is skipped for a candidate filter when any of these hold (the
pipeline still runs, just unfused): framework isn't torch-cuda,
input/output-combination or invoke-dynamic in play, the filter shares its
model with other pipelines (share-model), a transform mid-run feeds more
than one consumer, or a transform has no static mode.  A micro-batched
filter (``batch>1``) keeps its fused prologue: it runs on the stacked
window, frame by frame in effect (``_OpChain.fn_for(lead=1)``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .element import NegotiationError

_log = logging.getLogger("nnstreamer_tpu_torch")


@dataclass(frozen=True)
class FusedSegment:
    """One fused linear segment, run by its filter as one program:
    ``transforms → filter [→ decoder]``.  Built by :func:`fuse_pipeline`
    after both passes ran.  ``chain_digest`` is the ordered identity of
    every non-model stage in the filter's program; the element names give
    callers a stable label for the segment.
    """

    filter: str
    transforms: Tuple[str, ...] = ()
    decoder: Optional[str] = None
    chain_digest: str = ""

    @property
    def stages(self) -> int:
        """Pipeline stages collapsed into the one dispatch."""
        return len(self.transforms) + 1 + (1 if self.decoder else 0)


def _is_torch_cuda(flt) -> bool:
    fw = (flt.framework or "auto")
    if fw == "torch-cuda":
        return True
    if fw != "auto":
        return False
    from ..filters.registry import detect_framework

    try:
        return detect_framework(flt.model) == "torch-cuda"
    except ValueError:
        return False


def fuse_transform_filter(pipeline, enable: bool = True) -> int:
    """Mark fusable transform runs as passthrough and hand their op
    chains to the downstream filter.  Returns the number of filters that
    received a fused prologue.  Always resets previous marks first (an
    element reused in a different topology or a fuse=False pipeline must
    not stay passthrough), then marks only when ``enable``."""
    from ..elements.filter import TensorFilter
    from ..elements.transform import TensorTransform

    for el in pipeline.elements.values():
        if isinstance(el, TensorTransform):
            el._fused = False
            el._fusion_filter = None
        elif isinstance(el, TensorFilter):
            # mutate IN PLACE: an already-opened torch-cuda subplugin
            # holds this very list by reference (set_fused_pre) —
            # rebinding would leave a stale prologue in its program
            el._fused_pre.clear()
    if not enable:
        return 0

    fused = 0
    for el in list(pipeline.elements.values()):
        if not isinstance(el, TensorFilter):
            continue
        if el.invoke_dynamic or el.input_combination \
                or el.output_combination:
            continue
        if el.share_model:
            # a pooled instance serves MANY pipelines: baking one
            # pipeline's transform chain into it would corrupt every
            # other sharer's stream
            continue
        if not _is_torch_cuda(el):
            continue
        if not el.sinkpads or el.sinkpads[0].peer is None:
            continue
        run: List = []  # (transform, opchain), filter→source order
        up = el.sinkpads[0].peer.element
        while isinstance(up, TensorTransform):
            if up._fused or not up.mode:
                break
            if len(up.srcpads) != 1 or len(up.sinkpads) != 1 \
                    or up.sinkpads[0].peer is None:
                break
            try:
                chain = up._opchain()
            except (NegotiationError, ValueError, NotImplementedError):
                break  # negotiation reports it
            run.append((up, chain))
            up = up.sinkpads[0].peer.element
        if not run:
            continue
        run.reverse()  # source→filter order
        el._fused_pre[:] = [c for _, c in run]
        for t, _ in run:
            t._fused = True
            # handle to unfuse at negotiation if the stream turns out
            # flexible (per-buffer schemas can't pre-compile a prologue)
            t._fusion_filter = el
        fused += 1
        _log.info("fused %s into %s (one program)",
                  "+".join(t.name for t, _ in run), el.name)
    return fused


def fuse_filter_decoder(pipeline, enable: bool = True) -> int:
    """Fuse a device-rendering decoder's program INTO its upstream
    torch-cuda filter: ``tensor_filter ! tensor_decoder
    mode=bounding_boxes option7=device`` becomes one program for
    transform+model+NMS+overlay; the decoder turns into a consumer of the
    ready canvas.  Same reset-first contract as
    :func:`fuse_transform_filter`."""
    from ..elements.decoder import TensorDecoder
    from ..elements.filter import TensorFilter

    for el in pipeline.elements.values():
        if isinstance(el, TensorFilter):
            el._fused_post.clear()
            el._fused_post_decoder = None
        elif isinstance(el, TensorDecoder):
            dec = getattr(el, "_dec", None)
            if dec is not None and hasattr(dec, "fused_upstream"):
                dec.fused_upstream = False
    if not enable:
        return 0

    fused = 0
    for el in list(pipeline.elements.values()):
        if not isinstance(el, TensorDecoder):
            continue
        if not el.sinkpads or el.sinkpads[0].peer is None:
            continue
        up = el.sinkpads[0].peer.element
        if not isinstance(up, TensorFilter):
            continue
        if up.invoke_dynamic or up.output_combination or up._fused_post \
                or up.share_model:
            continue
        if len(up.srcpads) != 1 or \
                up.srcpads[0].peer is not el.sinkpads[0]:
            continue  # filter output must feed ONLY this decoder
        if not _is_torch_cuda(up):
            continue
        try:
            dec = el._decoder()
        except (NegotiationError, KeyError):
            continue  # negotiation reports it
        make_post = getattr(dec, "device_post_program", None)
        post = make_post() if make_post is not None else None
        if post is None:
            continue
        up._fused_post[:] = [post]
        up._fused_post_decoder = dec
        dec.fused_upstream = True
        fused += 1
        _log.info("fused %s's device overlay into %s (one program for "
                  "model+postprocess+overlay)", el.name, up.name)
    return fused


def fuse_pipeline(pipeline, enable: bool = True) -> List[FusedSegment]:
    """Run both fusion passes, then describe every fused linear segment
    as a :class:`FusedSegment`.  Called by ``Pipeline.start()`` before
    negotiation; the result is stored on ``pipeline.fused_segments`` so
    callers can assert what actually collapsed.

    The digest is ordered and covers every fused stage: each prologue op
    chain contributes ``_OpChain.digest()`` and a fused decoder epilogue
    the ``chain_digest`` stamped on the post fn.  A fused
    stage WITHOUT a digest poisons the segment's digest (set to ``""``).
    """
    from ..elements.filter import TensorFilter

    fuse_transform_filter(pipeline, enable=enable)
    fuse_filter_decoder(pipeline, enable=enable)
    segments: List[FusedSegment] = []
    if not enable:
        pipeline.fused_segments = segments
        return segments
    for el in pipeline.elements.values():
        if not isinstance(el, TensorFilter):
            continue
        if not el._fused_pre and not el._fused_post:
            continue
        transforms = tuple(
            t.name for t in pipeline.elements.values()
            if getattr(t, "_fusion_filter", None) is el)
        decoder = None
        if el._fused_post_decoder is not None:
            for d in pipeline.elements.values():
                if getattr(d, "_dec", None) is el._fused_post_decoder:
                    decoder = d.name
                    break
        parts: List[str] = []
        ok = True
        for c in el._fused_pre:
            dig = getattr(c, "digest", None)
            if dig is None:
                ok = False
                break
            parts.append("pre:" + c.digest())
        for p in el._fused_post:
            dig = getattr(p, "chain_digest", None)
            if dig is None:
                ok = False
                break
            parts.append("post:" + dig)
        segments.append(FusedSegment(
            filter=el.name, transforms=transforms, decoder=decoder,
            chain_digest=";".join(parts) if ok else ""))
    pipeline.fused_segments = segments
    return segments
