"""Plain reference of the ViT classifier with a global-average-pool head:
its weights from the seed, the float32 forward, and the judge that holds
the program's logits against it.

Plain ``torch`` in float32 with TF32 off (the control: every matrix
product's and the patch convolution's operands rounded to float8 e4m3).
Attention is the textbook ``softmax(q·kᵀ/√d)·v`` on materialized scores;
layer norm takes the population variance with eps from the
configuration; GELU is the tanh form.  Nothing here imports the program
under test.

Weights are a tree in the layout the program's weights files use
(``embed.{w,b}`` with ``w`` HWIO, ``pos``, ``blocks[i].{ln1,qkv,proj,ln2,
mlp1,mlp2}``, ``ln_f``, ``head``; dense ``w`` as (in, out)).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .common import generator, no_tf32, normalize, operand_cast

Tree = Dict[str, Any]


def _dense_shapes(cfg):
    d, m = int(cfg["hidden_size"]), int(cfg["mlp_dim"])
    return {"qkv": (d, 3 * d), "proj": (d, d), "mlp1": (d, m),
            "mlp2": (m, d)}


def make_tree(cfg, seed: int, device) -> Tree:
    """The classifier's weights from ``seed``, made on ``device`` in two
    draws (matrices, then vectors), in the configuration's weights dtype:
    matrices normal with std ``gain/√fan_in``, layer-norm gains near 1,
    biases and offsets small (see ``weights`` in the configuration)."""
    w_cfg = cfg["weights"]
    dtype = getattr(torch, w_cfg["dtype"])
    d, p, L = int(cfg["hidden_size"]), int(cfg["patch"]), int(cfg["num_layers"])
    n_patch = (int(cfg["image_size"]) // p) ** 2
    nc = int(cfg["num_classes"])
    shapes = _dense_shapes(cfg)
    mats = [("embed", (p, p, 3, d), p * p * 3), ("pos", (n_patch, d), None)]
    for i in range(L):
        mats += [((i, k), s, s[0]) for k, s in shapes.items()]
    mats.append(("head", (d, nc), d))
    sizes = [math.prod(s) for _, s, _ in mats]
    g = generator(seed, "weights", device)
    flat = torch.randn(sum(sizes), generator=g, device=device).clamp_(-2, 2)
    # in the order taken below: embed bias; per block the four biases,
    # then ln1 and ln2 (gain, offset); ln_f; the head's bias
    vec_sizes = [d] + [3 * d, d, int(cfg["mlp_dim"]), d, d, d, d, d] * L \
        + [d, d, nc]
    vec = torch.rand(sum(vec_sizes), generator=g, device=device) * 2 - 1
    gain = float(w_cfg["gain"])
    out, off = [], 0
    for (_, s, fan_in), n in zip(mats, sizes):
        std = float(w_cfg["pos_std"]) if fan_in is None \
            else gain / math.sqrt(fan_in)
        out.append((flat[off:off + n].view(s) * std).to(dtype))
        off += n
    vecs = list(torch.split(vec, vec_sizes))
    bias, ln = float(w_cfg["bias"]), float(w_cfg["ln"])

    def take(kind: str):
        v = vecs.pop(0)
        return ((1 + ln * v) if kind == "g" else bias * v).to(dtype)

    tree: Tree = {"embed": {"w": out[0], "b": take("b")}, "pos": out[1],
                  "blocks": []}
    for i in range(L):
        blk = {k: {"w": out[2 + 4 * i + j]}
               for j, k in enumerate(shapes)}
        for k in shapes:
            blk[k]["b"] = take("b")
        blk["ln1"] = {"g": take("g"), "b": take("b")}
        blk["ln2"] = {"g": take("g"), "b": take("b")}
        tree["blocks"].append(blk)
    tree["ln_f"] = {"g": take("g"), "b": take("b")}
    tree["head"] = {"w": out[-1], "b": take("b")}
    return tree


def _ln(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["g"].float() + p["b"].float()


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                     * (x + 0.044715 * x ** 3)))


def logits(tree: Tree, x: torch.Tensor, cfg,
           precision: str = "float32") -> torch.Tensor:
    """Normalized NHWC float32 frames → (N, num_classes) logits."""
    cast = operand_cast(precision)
    eps = float(cfg["ln_eps"])
    heads = int(cfg["num_heads"])
    p = int(cfg["patch"])

    def dense(h, q):
        return cast(h) @ cast(q["w"].float()) + q["b"].float()

    w = tree["embed"]["w"].float().permute(3, 2, 0, 1)       # HWIO → OIHW
    h = F.conv2d(cast(x.permute(0, 3, 1, 2)), cast(w), stride=p)
    n, d = h.shape[0], h.shape[1]
    h = h.flatten(2).transpose(1, 2) + tree["embed"]["b"].float() \
        + tree["pos"].float()
    dh = d // heads
    for blk in tree["blocks"]:
        qkv = dense(_ln(h, blk["ln1"], eps), blk["qkv"])
        q, k, v = (t.reshape(n, -1, heads, dh).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        att = torch.softmax((cast(q) @ cast(k).transpose(-1, -2))
                            / math.sqrt(dh), dim=-1)
        o = (cast(att) @ cast(v)).transpose(1, 2).reshape(n, -1, d)
        h = h + dense(o, blk["proj"])
        h = h + dense(_gelu(dense(_ln(h, blk["ln2"], eps), blk["mlp1"])),
                      blk["mlp2"])
    pooled = _ln(h, tree["ln_f"], eps).mean(1)
    return dense(pooled, tree["head"])


def judge(tree: Tree, cfg, samples, frames_of, device,
          precision: str = "float32", chunk: int = 32) -> Dict[str, float]:
    """Hold the program's logits against the reference.

    ``samples``: dicts with ``logits`` (B, num_classes) and the ``slot``
    of the input window, whose uint8 frames ``frames_of(slot)`` gives.
    Returns ``logit_gap``: over the frames, the largest distance between
    a served logit and the reference's, as a share of the root mean
    square of that frame's reference logits."""
    no_tf32()
    norm = cfg["normalize"]
    gap = 0.0
    frames = 0
    with torch.inference_mode():
        for smp in samples:
            u8 = frames_of(smp["slot"])
            got = smp["logits"]
            for lo in range(0, u8.shape[0], chunk):
                hi = min(lo + chunk, u8.shape[0])
                x = normalize(u8[lo:hi].to(device), norm["sub"], norm["div"])
                ref = logits(tree, x, cfg, precision)
                rms = ref.pow(2).mean(-1).sqrt()
                err = (got[lo:hi].to(device).float() - ref).abs().amax(-1)
                gap = max(gap, float((err / rms).max()))
                frames += hi - lo
    return {"logit_gap": gap, "frames": float(frames)}


def control_outputs(tree: Tree, cfg, frames_u8: torch.Tensor, device,
                    chunk: int = 32) -> Dict[str, torch.Tensor]:
    """The reference computed with fp8 operands, in the program's place:
    one window's logits."""
    norm = cfg["normalize"]
    out = []
    with torch.inference_mode():
        for lo in range(0, frames_u8.shape[0], chunk):
            x = normalize(frames_u8[lo:lo + chunk].to(device), norm["sub"],
                          norm["div"])
            out.append(logits(tree, x, cfg, "fp8"))
    return {"logits": torch.cat(out)}
