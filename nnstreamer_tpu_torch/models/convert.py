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
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .mobilenet import Params, _conv_init, _rng_of, mobilenet_v2_init
from .ssd import _ANCHORS_PER_CELL, _EXTRA_CHANNELS, SSDMobileNetV2


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
