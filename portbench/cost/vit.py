"""ViT: the matrix products' and attention's operations, the attention
kernel's and the prologue's bytes."""

from __future__ import annotations

from typing import Dict, Tuple


def _sizes(cfg):
    p, s = int(cfg["patch"]), int(cfg["image_size"])
    return (int(cfg["hidden_size"]), int(cfg["mlp_dim"]), (s // p) ** 2, p,
            int(cfg["num_layers"]), int(cfg["num_classes"]))


def attention_flops_per_frame(cfg) -> float:
    """One layer's ``q·kᵀ`` and ``p·v`` over every head: 4·S²·D."""
    d, _, n, _, _, _ = _sizes(cfg)
    return float(4 * n * n * d)


def flops_per_frame(cfg) -> float:
    d, m, n, p, layers, nc = _sizes(cfg)
    embed = 2 * n * d * p * p * 3
    dense = 2 * n * (d * 3 * d + d * d + 2 * d * m)
    return float(embed + layers * (dense + attention_flops_per_frame(cfg))
                 + 2 * d * nc)


def kernel_costs(cfg, batch: int) -> Dict[str, Tuple[float, float]]:
    """One launch: attention over a window's frames for one layer (q, k,
    v read and o written once, bfloat16); the prologue over the window."""
    d, _, n, _, _, _ = _sizes(cfg)
    s = int(cfg["image_size"])
    return {"attention": (batch * attention_flops_per_frame(cfg),
                          float(4 * batch * n * d * 2)),
            "prologue": (0.0, float(batch * s * s * 3 * (1 + 4)))}
