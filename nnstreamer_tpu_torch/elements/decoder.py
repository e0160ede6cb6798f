"""``tensor_decoder`` element: dispatch to decoder sub-plugins by mode.

Near-copy of the JAX package's ``elements/decoder.py`` (parity target:
the reference's gsttensor_decoder.c): ``mode=`` selects the sub-plugin,
option1..option9 configure it.

The host-read policy: a decoder that reads its input on the host, and
does not reduce this buffer on the device first, gets every device tensor
of the buffer in ONE device→host copy (``drain_once``) before it decodes,
instead of one synchronising copy per tensor.  A device-rendering or
pre-reducing decoder gets no copy from here.
"""

from __future__ import annotations

from typing import Optional

from ..core import Buffer, Caps
from ..decoders import Decoder, drain_once, find_decoder
from ..runtime.element import NegotiationError, Pad, TransformElement
from ..runtime.registry import register_element


@register_element("tensor_decoder")
class TensorDecoder(TransformElement):
    FACTORY = "tensor_decoder"

    def __init__(self, name=None, mode: str = "", **props):
        self.mode = mode
        self.option1 = self.option2 = self.option3 = ""
        self.option4 = self.option5 = self.option6 = ""
        self.option7 = self.option8 = self.option9 = ""
        super().__init__(name, **props)
        self._dec: Optional[Decoder] = None

    def _decoder(self) -> Decoder:
        if self._dec is None:
            if not self.mode:
                raise NegotiationError(f"{self.name}: mode not set")
            self._dec = find_decoder(self.mode)()
            for i in range(9):
                v = getattr(self, f"option{i + 1}")
                if v:
                    self._dec.set_option(i, str(v))
        return self._dec

    def propose_src_caps(self, pad: Pad) -> Caps:
        in_spec = self.sinkpad.spec
        if in_spec is None:
            raise NegotiationError(
                f"{self.name}: decoder needs tensor input caps")
        try:
            return self._decoder().out_caps(in_spec)
        except (ValueError, KeyError) as e:
            raise NegotiationError(f"{self.name}: {e}") from e

    def pad_template_caps(self, pad: Pad) -> Caps:
        return Caps.any_tensors() if pad.direction.value == "sink" else \
            Caps.any()

    def transform(self, buf: Buffer) -> Buffer:
        dec = self._decoder()
        if dec.wants_host_input() and not dec.prereduce_active(buf):
            drain_once(buf.tensors)
        return dec.decode(buf, self.sinkpad.spec)
