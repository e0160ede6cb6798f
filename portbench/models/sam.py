"""SAM's image encoder through the program: ``models/sam.py`` (bf16
compute on float32 weights, ``flash_attention`` with the decomposed
relative-position bias), its (B, 256, 64, 64) embedding at the sink.  The
weights go in as the published state dict, through the program's
``sam_from_state_dict``."""

from __future__ import annotations

import numpy as np

# imported here, so a program without the encoder fails before set-up
import nnstreamer_tpu_torch.models.sam  # noqa: F401

#: the program's hand-written kernels this pipeline runs
KERNELS = ("scale_bias_cast", "flash_attention")

PIPELINE = (
    "tensor_transform name=norm mode=arithmetic option={norm} backend=cuda ! "
    "tensor_filter name=net framework=torch-cuda model={model} ! "
    "appsink name=out max-buffers=4")


def register(name: str, tree, cfg, batch: int) -> None:
    import torch

    from nnstreamer_tpu_torch.filters import register_model
    from nnstreamer_tpu_torch.models import sam_apply, sam_from_state_dict

    size = int(cfg["image_size"])
    dtype = getattr(torch, cfg["compute_dtype"])
    register_model(name, lambda m, x: sam_apply(m, x, dtype),
                   params=sam_from_state_dict(tree),
                   in_shapes=[(batch, size, size, 3)], in_dtypes=np.float32)


def pipeline(cfg, model: str, norm: str) -> str:
    return PIPELINE.format(norm=norm, model=model)


def outputs(buf):
    return {"embed": buf.tensors[0].torch().clone()}
