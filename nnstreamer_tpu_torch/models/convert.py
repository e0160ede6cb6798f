"""JAX-layout parameter trees → the port's modules.

No JAX counterpart: this is the bridge that lets the port and the JAX
package run on the same weights.

- :func:`ssd_mobilenet_v2_init` draws the SSD-MobileNetV2 parameter tree
  with numpy exactly as the JAX package's ``ssd_mobilenet_v2_init`` does
  (``jax.random.PRNGKey(s)`` seeds numpy with ``s``), so one seed gives the
  same tree bit for bit, in the JAX layout.
- :func:`params_from_jax` turns such a tree (numpy arrays, from either
  package) into a ``state_dict`` of :class:`~.ssd.SSDMobileNetV2`: conv
  weights go from HWIO to OIHW, depthwise weights from (kh,kw,1,C) to
  (C,1,kh,kw); batch-norm vectors keep their names.
- :func:`vit_params_from_jax` turns a JAX ViT tree into a ``state_dict``
  of :class:`~.vit.ViT`: the patch-embed weight goes from HWIO to OIHW;
  dense ``w`` (din, dout), layer-norm ``g``/``b``, ``pos`` and biases keep
  their layout.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from .mobilenet import Params, _conv_init, _rng_of, mobilenet_v2_init
from .ssd import _ANCHORS_PER_CELL, _EXTRA_CHANNELS, SSDMobileNetV2
from .vit import ViT


def ssd_mobilenet_v2_init(seed: int, num_classes: int = 91) -> Params:
    """SSD-MobileNetV2 parameter tree (JAX layout, numpy arrays)."""
    rng = _rng_of(seed)
    params: Params = {"backbone": mobilenet_v2_init(rng, num_classes=1)}
    # drawn (the RNG stream must advance as in the JAX package), unused
    del params["backbone"]["head"], params["backbone"]["last"]
    extras, cin = [], 320
    for c in _EXTRA_CHANNELS:
        extras.append(_conv_init(rng, 3, 3, cin, c))
        cin = c
    params["extras"] = extras
    params["heads"] = [
        {"loc": _conv_init(rng, 3, 3, c, _ANCHORS_PER_CELL * 4),
         "cls": _conv_init(rng, 3, 3, c, _ANCHORS_PER_CELL * num_classes)}
        for c in (96, 320, *_EXTRA_CHANNELS)]
    params["num_classes"] = num_classes
    return params


def _conv_state(prefix: str, p: Params, out: Dict[str, torch.Tensor]) -> None:
    w = np.asarray(p["w"], dtype=np.float32)        # (kh, kw, cin/g, cout)
    out[prefix + "weight"] = torch.from_numpy(
        np.ascontiguousarray(w.transpose(3, 2, 0, 1)))  # OIHW
    for k in ("scale", "bias", "mean", "var"):
        out[prefix + k] = torch.from_numpy(
            np.array(p[k], dtype=np.float32))


def params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """``state_dict`` of :class:`SSDMobileNetV2` from a JAX-layout SSD
    parameter tree."""
    sd: Dict[str, torch.Tensor] = {}
    bb = tree["backbone"]
    _conv_state("backbone.stem.", bb["stem"], sd)
    for i, blk in enumerate(bb["blocks"]):
        for part in ("expand", "dw", "project"):
            if part in blk:
                _conv_state(f"backbone.blocks.{i}.{part}.", blk[part], sd)
    for i, p in enumerate(tree["extras"]):
        _conv_state(f"extras.{i}.", p, sd)
    for i, head in enumerate(tree["heads"]):
        _conv_state(f"heads.{i}.loc.", head["loc"], sd)
        _conv_state(f"heads.{i}.cls.", head["cls"], sd)
    return sd


def ssd_from_jax(tree: Any) -> SSDMobileNetV2:
    """An :class:`SSDMobileNetV2` (on the CPU, eval mode) holding the
    weights of a JAX-layout tree."""
    model = SSDMobileNetV2(num_classes=int(tree["num_classes"]))
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model.eval()


def _f32(a) -> torch.Tensor:
    """A contiguous f32 tensor holding a copy of ``a``."""
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def vit_params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """``state_dict`` of :class:`ViT` from a JAX-layout ViT tree (numpy
    leaves: ``embed.w`` (p,p,3,D) HWIO and ``embed.b``, ``pos`` (N,D),
    ``blocks[i].{ln1,qkv,proj,ln2,mlp1,mlp2}``, ``head``, ``ln_f``)."""
    sd: Dict[str, torch.Tensor] = {
        "embed_w": _f32(np.transpose(tree["embed"]["w"], (3, 2, 0, 1))),
        "embed_b": _f32(tree["embed"]["b"]),
        "pos": _f32(tree["pos"]),
    }
    for prefix, p in (("head.", tree["head"]), ("ln_f.", tree["ln_f"])):
        for k, v in p.items():
            sd[prefix + k] = _f32(v)
    for i, blk in enumerate(tree["blocks"]):
        for part, p in blk.items():
            for k, v in p.items():
                sd[f"blocks.{i}.{part}.{k}"] = _f32(v)
    return sd


def vit_from_jax(tree: Any, heads: int) -> ViT:
    """A :class:`ViT` (on the CPU, eval mode) holding the weights of a
    JAX-layout tree; ``heads`` is what the JAX code passes per call."""
    patch, _, _, dim = np.shape(tree["embed"]["w"])
    side = math.isqrt(np.shape(tree["pos"])[0])   # patches per image side
    blocks = tree["blocks"]
    model = ViT(image_size=side * patch, patch=patch, dim=dim,
                depth=len(blocks), heads=heads,
                mlp_dim=np.shape(blocks[0]["mlp1"]["w"])[1] if blocks else 1,
                num_classes=np.shape(tree["head"]["w"])[1])
    model.load_state_dict(vit_params_from_jax(tree), strict=True)
    return model.eval()
