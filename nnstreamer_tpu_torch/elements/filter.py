"""``tensor_filter`` — the NN invoke element.

Counterpart of the JAX package's ``elements/filter.py`` for its
single-instance path (parity: the reference's tensor_filter.c hot path and
tensor_filter_common.c open_fw): open the framework, negotiate (including
the SET_INPUT_INFO reshape and the fused prologue/epilogue from
runtime/fusion.py), and invoke once per buffer.  Inputs are handed to the
sub-plugin as tensors on its device; PyTorch launches the work
asynchronously, so the streaming thread runs ahead of the card.

Not in this slice (later work): micro-batching, shared serving pools,
chaos injection, model lifecycle / hot reload, observability hooks.
"""

from __future__ import annotations

from typing import Any, List, Optional

from ..core import Buffer, Caps, Tensor, TensorFormat, TensorsSpec
from ..filters.api import FilterError, FilterProps, FilterSubplugin
from ..filters.registry import detect_framework, find_filter
from ..runtime.element import Element, NegotiationError, Pad, StreamError
from ..runtime.registry import register_element


def _parse_combination(s: str) -> Optional[List[int]]:
    if not s:
        return None
    return [int(x) for x in str(s).split(",") if str(x).strip() != ""]


@register_element("tensor_filter")
class TensorFilter(Element):
    FACTORY = "tensor_filter"

    def __init__(self, name=None, framework: str = "auto", model: Any = None,
                 accelerator: str = "", custom: str = "",
                 input_combination: str = "", output_combination: str = "",
                 inputtype: str = "", input: str = "", outputtype: str = "",
                 output: str = "", **props):
        self.framework = framework
        self.model = model
        self.accelerator = accelerator
        self.custom = custom
        self.input_combination = input_combination
        self.output_combination = output_combination
        self.inputtype, self.input = inputtype, input
        self.outputtype, self.output = outputtype, output
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()
        self.subplugin: Optional[FilterSubplugin] = None
        self.in_spec: Optional[TensorsSpec] = None
        self.out_spec: Optional[TensorsSpec] = None
        self._in_combi = None
        self._out_combi = None
        self._fused_pre: list = []  # op chains inlined by runtime/fusion.py
        self._fused_post: list = []  # epilogue fns (decoder overlay fusion)
        self._fused_post_decoder = None  # Decoder obj to notify on unfuse

    # -- open ----------------------------------------------------------------

    def _user_spec(self, dims: str, types: str) -> Optional[TensorsSpec]:
        if not dims or not types:
            return None
        return TensorsSpec.parse(dims, types)

    def open_fw(self) -> None:
        """Resolve framework + configure the sub-plugin (parity:
        gst_tensor_filter_common_open_fw)."""
        if self.subplugin is not None:
            return
        fw_name = self.framework or "auto"
        if fw_name == "auto":
            fw_name = detect_framework(self.model)
        cls = find_filter(fw_name)
        fprops = FilterProps(
            framework=fw_name, model=self.model,
            accelerator=self.accelerator, custom=self.custom,
            input_spec=self._user_spec(self.input, self.inputtype),
            output_spec=self._user_spec(self.output, self.outputtype),
            device=self.device)
        sp = cls()
        sp.configure(fprops)
        if self._fused_pre and hasattr(sp, "set_fused_pre"):
            sp.set_fused_pre(self._fused_pre)
        if self._fused_post and hasattr(sp, "set_fused_post"):
            sp.set_fused_post(self._fused_post)
        self.subplugin = sp
        self.in_spec, self.out_spec = sp.get_model_info()
        self._in_combi = _parse_combination(self.input_combination)
        # output-combination tokens: iN (input passthrough) / oN (model out)
        self._out_combi = [t.strip() for t in str(
            self.output_combination).split(",") if t.strip()] or None

    def stop(self) -> None:
        if self.subplugin is not None:
            self.subplugin.close()
            self.subplugin = None

    # -- negotiation ---------------------------------------------------------

    def pad_template_caps(self, pad: Pad) -> Caps:
        if pad.direction.value == "sink":
            try:
                self.open_fw()
            except (FilterError, KeyError, ValueError) as e:
                raise NegotiationError(f"{self.name}: open failed: {e}",
                                       reason="open", sink_pad=pad) from e
            if self._in_combi is not None:
                # model sees a subset; pad accepts anything containing it
                return Caps.any_tensors()
            # Preferred: exact model input caps. Fallback: any tensors —
            # caps_negotiated then tries the SET_INPUT_INFO reshape path.
            exact = Caps.from_spec(self.in_spec)
            return Caps(structs=exact.structs + Caps.any_tensors().structs)
        return Caps.any_tensors()

    def caps_negotiated(self, pad: Pad) -> None:
        self.open_fw()
        spec = pad.spec
        if spec is None or self._in_combi is not None:
            return
        if not spec.is_static():
            # flexible input: per-buffer schemas can't carry a fixed
            # overlay epilogue — withdraw the decoder fusion so the
            # decoder renders for itself (mirror of transform _unfuse)
            if self._fused_post:
                self._fused_post.clear()
                if self._fused_post_decoder is not None:
                    self._fused_post_decoder.fused_upstream = False
            return
        prog = getattr(self.subplugin, "_program", None)
        stale = prog is not None and \
            (prog.with_pre != bool(self._fused_pre)
             or prog.with_post != bool(self._fused_post))
        if self._fused_pre or self._fused_post or stale:
            # fused prologue: the program must be specialized to the RAW
            # upstream schema even when it happens to be compatible with
            # the model's declared input
            try:
                self.in_spec, self.out_spec = \
                    self.subplugin.set_input_info(spec)
            except FilterError as e:
                raise NegotiationError(
                    f"{self.name}: fused prologue rejects input "
                    f"{spec}: {e}") from e
            return
        if not spec.is_compatible(self.in_spec):
            try:
                self.in_spec, self.out_spec = \
                    self.subplugin.set_input_info(spec)
            except FilterError as e:
                raise NegotiationError(
                    f"{self.name}: input {spec} incompatible with model "
                    f"{self.in_spec}: {e}") from e

    def propose_src_caps(self, pad: Pad) -> Caps:
        self.open_fw()
        rate = self.sinkpad.spec.rate if self.sinkpad.spec is not None \
            else 0
        out = self.out_spec.with_rate(rate)
        if self._out_combi is not None and self.sinkpad.spec is not None:
            out = self._combined_out_spec(self.sinkpad.spec).with_rate(rate)
        return Caps.from_spec(out)

    def _combined_out_spec(self, in_spec: TensorsSpec) -> TensorsSpec:
        """output-combination 'iN,...,oM,...' merges input passthroughs and
        model outputs (parity: tensor_filter.c:848-880)."""
        tensors = []
        for tok in str(self.output_combination).split(","):
            tok = tok.strip()
            if tok.startswith("i"):
                tensors.append(in_spec.tensors[int(tok[1:])])
            elif tok.startswith("o"):
                tensors.append(self.out_spec.tensors[int(tok[1:])])
        return TensorsSpec(tensors=tuple(tensors))

    # -- hot path ------------------------------------------------------------

    def chain(self, pad: Pad, buf: Buffer) -> None:
        sp = self.subplugin
        if sp is None:
            raise StreamError(f"{self.name}: no sub-plugin opened")
        tensors = buf.tensors
        if self._in_combi is not None:
            tensors = [tensors[i] for i in self._in_combi]
        outputs = sp.invoke([t.torch(sp.device) for t in tensors])
        out_tensors = [Tensor(o) for o in outputs]
        if self._out_combi is not None:
            out_tensors = self._combine_outputs(buf, out_tensors)
        self.push(Buffer(tensors=out_tensors, pts=buf.pts,
                         duration=buf.duration, offset=buf.offset,
                         meta=dict(buf.meta), format=TensorFormat.STATIC))

    def _combine_outputs(self, in_buf: Buffer, outputs: List[Tensor]
                         ) -> List[Tensor]:
        combined = []
        for tok in str(self.output_combination).split(","):
            tok = tok.strip()
            if tok.startswith("i"):
                combined.append(in_buf.tensors[int(tok[1:])])
            elif tok.startswith("o"):
                combined.append(outputs[int(tok[1:])])
        return combined
