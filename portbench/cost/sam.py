"""SAM's image encoder: the products' and attention's operations (the
windowed blocks' on their padded tokens), and the bytes of each attention
launch: q, k, v and o in bfloat16, the relative-position tables in
float32."""

from __future__ import annotations

from typing import Dict, Tuple


def _sizes(cfg):
    p, s = int(cfg["patch"]), int(cfg["image_size"])
    g, w = s // p, int(cfg["window_size"])
    n_win = (-(-g // w)) ** 2
    return (int(cfg["hidden_size"]), int(cfg["mlp_dim"]), g, p, w, n_win,
            int(cfg["num_layers"]), len(cfg["global_attn_indexes"]),
            int(cfg["out_chans"]))


def attention_launches(cfg) -> Dict[str, int]:
    """``flash_attention`` launches a forward: one a block."""
    *_, layers, n_global, _ = _sizes(cfg)
    return {"window": layers - n_global, "global": n_global}


def _attention(cfg, kind: str):
    """(sequences a frame, tokens a sequence, key grid side) of one
    attention launch."""
    d, _, g, _, w, n_win, *_ = _sizes(cfg)
    return (n_win, w * w, w) if kind == "window" else (1, g * g, g)


def flops_per_frame(cfg) -> float:
    d, m, g, p, w, n_win, layers, n_global, oc = _sizes(cfg)
    n = g * g
    embed = 2 * n * d * p * p * 3
    neck = 2 * n * d * oc + 2 * n * oc * oc * 9
    total = embed + neck
    for kind, count in attention_launches(cfg).items():
        seqs, s, k = _attention(cfg, kind)
        tokens = seqs * s
        dense = 2 * tokens * (3 * d * d + d * d) + 2 * n * 2 * d * m
        attn = seqs * 4 * s * s * d
        relpos = 2 * 2 * tokens * d * k
        total += count * (dense + attn + relpos)
    return float(total)


def kernel_costs(cfg, batch: int) -> Dict[str, Tuple[float, float]]:
    """One launch over a window's frames: ``attention_window`` and
    ``attention_global`` (4·S²·D a head; q, k, v and o read or written
    once in bf16, rel_h and rel_w once in f32); the prologue."""
    d, s = int(cfg["hidden_size"]), int(cfg["image_size"])
    out = {"prologue": (0.0, float(batch * s * s * 3 * (1 + 4)))}
    for kind in ("window", "global"):
        seqs, n, k = _attention(cfg, kind)
        rows = batch * seqs * n
        out[f"attention_{kind}"] = (float(batch * seqs * 4 * n * n * d),
                                    float(4 * rows * d * 2
                                          + rows * int(cfg["num_heads"])
                                          * 2 * k * 4))
    return out


def attention_bound_s(cfg, batch: int, peaks, kind: str) -> float:
    """The least time a window's ``kind`` launches could take: for each,
    the larger of its operations over the bf16 peak and its bytes over the
    memory bandwidth."""
    flops, nbytes = kernel_costs(cfg, batch)[f"attention_{kind}"]
    return attention_launches(cfg)[kind] * max(
        flops / peaks["bf16_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
