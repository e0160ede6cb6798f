"""``flexbuf`` decoder: tensors → FlexBuffers wire payloads.

Counterpart of the JAX package's ``decoders/flexbuf.py`` (parity target:
the reference's tensordec-flexbuf.cc, mime ``other/flexbuf``): serializes
the tensor frame into one FlexBuffers map (``num_tensors``/``rate_n``/
``rate_d``/``format``/``tensor_#``) so the receiving side — the
``flexbuf`` converter sub-plugin or the reference's
tensor_converter_flexbuf.cc — reconstructs it without out-of-band caps.
Codec shared with the converter via ``converters/codecs.py``.
"""

from __future__ import annotations

from ..converters.codecs import flexbuf_encode
from . import register_decoder
from .wirefmt import _WireDecoder


@register_decoder
class FlexBuf(_WireDecoder):
    MODE = "flexbuf"
    MIME = "other/flexbuf"
    ENCODE = staticmethod(flexbuf_encode)
