"""The ViT classifier through the program: ``models/vit.py`` (bf16
compute on float32 weights, ``flash_attention``), its logits at the
sink."""

from __future__ import annotations

import numpy as np

#: the program's hand-written kernels this pipeline runs
KERNELS = ("scale_bias_cast", "flash_attention")

PIPELINE = (
    "tensor_transform name=norm mode=arithmetic option={norm} backend=cuda ! "
    "tensor_filter name=net framework=torch-cuda model={model} ! "
    "appsink name=out max-buffers=4")


def register(name: str, tree, cfg, batch: int) -> None:
    import torch

    from nnstreamer_tpu_torch.filters import register_model
    from nnstreamer_tpu_torch.models import vit_apply
    from nnstreamer_tpu_torch.models.convert import vit_from_jax

    size = int(cfg["image_size"])
    dtype = getattr(torch, cfg["compute_dtype"])
    register_model(name, lambda m, x: vit_apply(m, x, dtype),
                   params=vit_from_jax(tree, int(cfg["num_heads"])),
                   in_shapes=[(batch, size, size, 3)], in_dtypes=np.float32)


def pipeline(cfg, model: str, norm: str) -> str:
    return PIPELINE.format(norm=norm, model=model)


def outputs(buf):
    return {"logits": buf.tensors[0].torch()}
