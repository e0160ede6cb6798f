"""``image_labeling`` decoder: classification scores → label text.

Counterpart of the JAX package's ``decoders/imagelabel.py`` (parity: the
reference's tensordec-imagelabel.c): the argmax over the whole flattened
score tensor (one label per buffer, whatever the batch), the label looked
up in the file given as option1 (one label per line; an index past its
end gives ``str(index)``).  The output is the label's UTF-8 bytes under
``text/x-raw, format=utf8``; the buffer meta gets ``label``,
``label_index`` and ``score``.

For a tensor on the device the argmax runs there: the index (as f32) and
the max are packed into one (2,) tensor, and only that crosses to the host,
in one copy.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import Buffer, Caps, CapsStruct, Tensor, TensorSpec, TensorsSpec
from ..obs import transfer as _xfer
from . import Decoder, register_decoder
from .boxutil import load_labels


def argmax_pair(x: torch.Tensor) -> torch.Tensor:
    """(index as f32, max as f32) of the flattened ``x``, as one (2,)
    tensor on ``x``'s device; the first index among equal maxima."""
    flat = x.reshape(-1)
    idx = torch.argmax(flat).reshape(1)
    # gather, not flat[idx]: indexing with a 0-d tensor reads the index on
    # the host, a device→host copy of its own
    return torch.cat([idx.to(torch.float32),
                      flat.gather(0, idx).to(torch.float32)])


@register_decoder
class ImageLabeling(Decoder):
    MODE = "image_labeling"

    def __init__(self):
        super().__init__()
        self.labels: List[str] = []

    def options_updated(self) -> None:
        path = self.options[0]
        if path:
            self.labels = load_labels(path)

    def out_caps(self, in_spec: TensorsSpec) -> Caps:
        return Caps.new(CapsStruct.make(
            "text/x-raw", format="utf8", framerate=in_spec.rate))

    def prereduce_active(self, buf: Buffer) -> bool:
        return buf.tensors[0].is_device

    def decode(self, buf: Buffer, in_spec: Optional[TensorsSpec]) -> Buffer:
        t = buf.tensors[0]
        if t.is_device:
            # the one device→host copy
            pair = _xfer.to_host(argmax_pair(t.torch()))
            idx, score = int(pair[0]), float(pair[1])
        else:
            flat = t.np().reshape(-1)
            idx = int(np.argmax(flat))
            score = float(flat[idx])
        label = self.labels[idx] if idx < len(self.labels) else str(idx)
        payload = label.encode("utf-8")
        out = Tensor(np.frombuffer(payload, dtype=np.uint8),
                     TensorSpec.from_shape((len(payload),), np.uint8))
        b = Buffer(tensors=[out], pts=buf.pts, duration=buf.duration,
                   meta=dict(buf.meta))
        b.meta.update({"label": label, "label_index": idx, "score": score})
        return b
