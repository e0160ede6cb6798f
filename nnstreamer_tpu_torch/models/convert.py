"""JAX-layout parameter trees → the port's modules.

No JAX counterpart: this is the bridge that lets the port and the JAX
package run on the same weights.

- :func:`ssd_mobilenet_v2_init` draws the SSD-MobileNetV2 parameter tree
  with numpy exactly as the JAX package's ``ssd_mobilenet_v2_init`` does
  (``jax.random.PRNGKey(s)`` seeds numpy with ``s``), so one seed gives the
  same tree bit for bit, in the JAX layout.
- ``*_params_from_jax`` turn a tree (numpy arrays or tensors, from either
  package, or from a weights file) into a module's ``state_dict``: conv
  weights go from HWIO to OIHW, depthwise weights from (kh,kw,1,C) to
  (C,1,kh,kw); batch-norm vectors, dense ``w`` (din, dout) and biases keep
  their layout.  A bf16 leaf stays bf16 (``params_io.weights_to_bf16``,
  or a ``BF16`` safetensors leaf); every other leaf becomes f32.
- ``*_from_jax`` build the module on the meta device and take the
  state_dict's tensors as its own (``load_state_dict(assign=True)``), so a
  bf16 weight stays bf16 and nothing is copied twice; the module's shape
  (width, classes, depth) is read off the tree.
- ``*_tree_apply`` are the ``apply`` of a weights file
  (``models/params_io.py``; ``tensor_filter model=file://…``): they run
  the tree the file holds, building its module once per tree.  What the
  tree does not hold comes from the file's ``apply_kwargs``.
- ``mobilenet_v1_to_jax``/``mobilenet_v2_to_jax`` carry a module's
  weights back to a JAX-layout numpy tree (OIHW to HWIO), bit for bit:
  ``to_jax(from_jax(tree))`` equals ``tree``.  :func:`tree_module_of`
  maps a tree apply to the function that makes its module and the
  module's own apply — a tree apply caches its module per tree and
  detaches the leaves, so a trainer trains the module and carries the
  weights back (:data:`MODULE_TO_JAX`).
"""

from __future__ import annotations

import functools
import math
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.buffer import from_numpy, to_numpy
from .mobilenet import (
    _V1_BLOCKS,
    _V2_BLOCKS,
    MobileNetV1,
    MobileNetV2,
    Params,
    _conv_init,
    _rng_of,
    mobilenet_v1_apply,
    mobilenet_v2_apply,
    mobilenet_v2_init,
)
from .ssd import (
    _ANCHORS_PER_CELL,
    _EXTRA_CHANNELS,
    SSDMobileNetV2,
    feature_sizes_for,
    ssd_anchors,
    ssd_detect_apply,
)
from .vit import ViT
from .yolo import YOLO, yolo_detect_apply, yolo_raw_apply


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


# -- leaves --------------------------------------------------------------------


def _leaf(a) -> torch.Tensor:
    """A weights leaf as a contiguous tensor on its own device: bf16
    stays bf16, anything else becomes f32.  A numpy leaf is copied."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        return (t if t.dtype == torch.bfloat16 else t.float()).contiguous()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return from_numpy(a.copy())
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _shape(a) -> Tuple[int, ...]:
    return tuple(a.shape)


def _conv_state(prefix: str, p: Params, out: Dict[str, torch.Tensor]) -> None:
    w = _leaf(p["w"])                                   # (kh, kw, cin/g, cout)
    out[prefix + "weight"] = w.permute(3, 2, 0, 1).contiguous()   # OIHW
    for k in ("scale", "bias", "mean", "var"):
        out[prefix + k] = _leaf(p[k])


def _dense_state(prefix: str, p: Params, out: Dict[str, torch.Tensor]) -> None:
    out[prefix + "w"] = _leaf(p["w"])
    out[prefix + "b"] = _leaf(p["b"])


def _host_leaf(t: torch.Tensor) -> np.ndarray:
    """A module leaf as an owned numpy array (bf16 by bit pattern)."""
    return to_numpy(t.detach().contiguous()).copy()


def _conv_tree(m: nn.Module) -> Params:
    """A ConvBN's leaves in the JAX layout: OIHW → HWIO, the batch-norm
    vectors as they are."""
    out: Params = {"w": _host_leaf(m.weight.detach().permute(2, 3, 1, 0))}
    for k in ("scale", "bias", "mean", "var"):
        out[k] = _host_leaf(getattr(m, k))
    return out


def _dense_tree(m: nn.Module) -> Params:
    return {"w": _host_leaf(m.w), "b": _host_leaf(m.b)}


def _assign(make: Callable[[], nn.Module],
            sd: Dict[str, torch.Tensor]) -> nn.Module:
    """``make()``'s module, built on the meta device, holding ``sd``'s
    tensors as they are (dtype and device kept), in eval mode."""
    with torch.device("meta"):
        model = make()
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval()


def _width_of(pairs) -> float:
    """The width multiplier a MobileNet tree was drawn at, from
    ``(base channels, channels, floor)`` triples of the rule ``max(floor,
    int(base·width))``: the middle of the interval every triple allows."""
    lo, hi = 0.0, math.inf
    for base, n, floor in pairs:
        if n > floor:
            lo = max(lo, n / base)
        hi = min(hi, (n + 1) / base)
    if not lo < hi:
        raise ValueError(f"no width multiplier gives channels {pairs}")
    return (lo + hi) / 2 if lo > 0 else hi / 2


# -- SSD -----------------------------------------------------------------------


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
    """An :class:`SSDMobileNetV2` (eval mode) holding the weights of a
    JAX-layout tree."""
    # a safetensors file holds the scalar as a 1-element array
    n = tree["num_classes"]
    n = int(n.reshape(-1)[0]) if hasattr(n, "reshape") else int(n)
    return _assign(lambda: SSDMobileNetV2(num_classes=n),
                   params_from_jax(tree))


# -- MobileNet classifiers -----------------------------------------------------


def mobilenet_v1_params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """``state_dict`` of :class:`MobileNetV1` from a JAX-layout tree
    (``stem``, ``blocks[i].{dw,pw}``, ``head``)."""
    sd: Dict[str, torch.Tensor] = {}
    _conv_state("stem.", tree["stem"], sd)
    for i, blk in enumerate(tree["blocks"]):
        _conv_state(f"blocks.{i}.dw.", blk["dw"], sd)
        _conv_state(f"blocks.{i}.pw.", blk["pw"], sd)
    _dense_state("head.", tree["head"], sd)
    return sd


def mobilenet_v1_from_jax(tree: Any) -> MobileNetV1:
    """A :class:`MobileNetV1` (eval mode) holding a JAX-layout tree's
    weights; its width and classes are read off the tree."""
    pairs = [(32, _shape(tree["stem"]["w"])[3], 8)] + [
        (c, _shape(b["pw"]["w"])[3], 8)
        for (_s, c), b in zip(_V1_BLOCKS, tree["blocks"])]
    width = _width_of(pairs)
    classes = _shape(tree["head"]["w"])[1]
    return _assign(lambda: MobileNetV1(classes, width),
                   mobilenet_v1_params_from_jax(tree))


def mobilenet_v1_to_jax(model: MobileNetV1) -> Params:
    """The JAX-layout numpy tree of a :class:`MobileNetV1`'s weights: the
    inverse of :func:`mobilenet_v1_from_jax`."""
    return {"stem": _conv_tree(model.stem),
            "blocks": [{"dw": _conv_tree(b.dw), "pw": _conv_tree(b.pw)}
                       for b in model.blocks],
            "head": _dense_tree(model.head)}


def mobilenet_v2_params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """``state_dict`` of :class:`MobileNetV2` from a JAX-layout tree
    (``stem``, ``blocks[i].{expand,dw,project}``, ``last``, ``head``)."""
    sd: Dict[str, torch.Tensor] = {}
    _conv_state("stem.", tree["stem"], sd)
    for i, blk in enumerate(tree["blocks"]):
        for part in ("expand", "dw", "project"):
            if part in blk:
                _conv_state(f"blocks.{i}.{part}.", blk[part], sd)
    _conv_state("last.", tree["last"], sd)
    _dense_state("head.", tree["head"], sd)
    return sd


def mobilenet_v2_from_jax(tree: Any) -> MobileNetV2:
    """A :class:`MobileNetV2` classifier (eval mode) holding a JAX-layout
    tree's weights; its width and classes are read off the tree."""
    couts = [c for _t, c, n, _s in _V2_BLOCKS for _ in range(n)]
    pairs = [(32, _shape(tree["stem"]["w"])[3], 8)] + [
        (c, _shape(b["project"]["w"])[3], 8)
        for c, b in zip(couts, tree["blocks"])] + [
        (1280, _shape(tree["last"]["w"])[3], 1280)]
    width = _width_of(pairs)
    classes = _shape(tree["head"]["w"])[1]
    return _assign(lambda: MobileNetV2(classes, width),
                   mobilenet_v2_params_from_jax(tree))


def mobilenet_v2_to_jax(model: MobileNetV2) -> Params:
    """The JAX-layout numpy tree of a :class:`MobileNetV2` classifier's
    weights: the inverse of :func:`mobilenet_v2_from_jax`."""
    blocks = []
    for b in model.blocks:
        p: Params = {}
        if b.expand is not None:
            p["expand"] = _conv_tree(b.expand)
        p["dw"] = _conv_tree(b.dw)
        p["project"] = _conv_tree(b.project)
        blocks.append(p)
    return {"stem": _conv_tree(model.stem), "blocks": blocks,
            "last": _conv_tree(model.last), "head": _dense_tree(model.head)}


# -- YOLO ----------------------------------------------------------------------


def yolo_params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """``state_dict`` of :class:`~.yolo.YOLO` from a JAX-layout tree
    (``stem``, ``early``, ``b0..b2`` with their ``refines`` lists,
    ``head0..head2``)."""
    sd: Dict[str, torch.Tensor] = {}
    _conv_state("stem.", tree["stem"], sd)
    for blk in ("early", "b0", "b1", "b2"):
        for part in ("down", "dw", "pw"):
            _conv_state(f"{blk}.{part}.", tree[blk][part], sd)
        for j, r in enumerate(tree[blk].get("refines", [])):
            _conv_state(f"{blk}.refines.{j}.dw.", r["dw"], sd)
            _conv_state(f"{blk}.refines.{j}.pw.", r["pw"], sd)
    for i in range(3):
        _conv_state(f"head{i}.", tree[f"head{i}"], sd)
    return sd


def yolo_from_jax(tree: Any) -> YOLO:
    """A :class:`~.yolo.YOLO` (eval mode) holding a JAX-layout tree's
    weights; width, depth and classes are read off the tree."""
    width = _shape(tree["stem"]["w"])[3]
    depth = 1 + len(tree["b0"].get("refines", []))
    classes = _shape(tree["head0"]["w"])[3] - 4
    return _assign(lambda: YOLO(classes, width, depth),
                   yolo_params_from_jax(tree))


# -- ViT -----------------------------------------------------------------------


def vit_params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """``state_dict`` of :class:`ViT` from a JAX-layout ViT tree (numpy
    leaves: ``embed.w`` (p,p,3,D) HWIO and ``embed.b``, ``pos`` (N,D),
    ``blocks[i].{ln1,qkv,proj,ln2,mlp1,mlp2}``, ``head``, ``ln_f``)."""
    sd: Dict[str, torch.Tensor] = {
        "embed_w": _leaf(tree["embed"]["w"]).permute(3, 2, 0, 1)
        .contiguous(),
        "embed_b": _leaf(tree["embed"]["b"]),
        "pos": _leaf(tree["pos"]),
    }
    for prefix, p in (("head.", tree["head"]), ("ln_f.", tree["ln_f"])):
        for k, v in p.items():
            sd[prefix + k] = _leaf(v)
    for i, blk in enumerate(tree["blocks"]):
        for part, p in blk.items():
            for k, v in p.items():
                sd[f"blocks.{i}.{part}.{k}"] = _leaf(v)
    return sd


def vit_from_jax(tree: Any, heads: int) -> ViT:
    """A :class:`ViT` (eval mode) holding the weights of a JAX-layout
    tree; ``heads`` is what the JAX code passes per call."""
    patch, _, _, dim = _shape(tree["embed"]["w"])
    side = math.isqrt(_shape(tree["pos"])[0])   # patches per image side
    blocks = tree["blocks"]
    return _assign(
        lambda: ViT(image_size=side * patch, patch=patch, dim=dim,
                    depth=len(blocks), heads=heads,
                    mlp_dim=_shape(blocks[0]["mlp1"]["w"])[1]
                    if blocks else 1,
                    num_classes=_shape(tree["head"]["w"])[1]),
        vit_params_from_jax(tree))


# -- weights files: one module per tree ----------------------------------------

#: trees a module is kept for, most recent last
_TREE_MODULES_MAX = 8
_tree_modules: "OrderedDict[tuple, Tuple[Any, nn.Module]]" = OrderedDict()
_tree_modules_lock = threading.Lock()


def _module_of_tree(tree: Any, build: Callable[..., nn.Module],
                    *args) -> nn.Module:
    """``build(tree, *args)``, kept per (tree, family, args) so a model
    file's tree builds its module once; the entry holds the tree, so its
    ``id`` is not reused while cached."""
    key = (id(tree), build.__name__, args)
    with _tree_modules_lock:
        hit = _tree_modules.get(key)
        if hit is not None:
            _tree_modules.move_to_end(key)
            return hit[1]
    model = build(tree, *args)
    with _tree_modules_lock:
        _tree_modules[key] = (tree, model)
        while len(_tree_modules) > _TREE_MODULES_MAX:
            _tree_modules.popitem(last=False)
    return model


def _dtype(dtype: Any):
    """A torch dtype from a dtype or its name (``apply_kwargs`` are JSON);
    None keeps the family's default."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


@functools.lru_cache(maxsize=16)
def _anchors_on(size: int, device: str) -> torch.Tensor:
    return torch.from_numpy(ssd_anchors(size, feature_sizes_for(size))).to(
        device)


def mobilenet_v1_tree_apply(tree: Params, x: torch.Tensor,
                            dtype: Any = None,
                            train: bool = False) -> torch.Tensor:
    """``apply`` of a MobileNetV1 weights file: f32 logits.  The tree's
    module is cached and its leaves detached, so no gradient reaches the
    tree: train through :func:`tree_module_of`."""
    return mobilenet_v1_apply(_module_of_tree(tree, mobilenet_v1_from_jax),
                              x, _dtype(dtype), train)


def mobilenet_v2_tree_apply(tree: Params, x: torch.Tensor,
                            dtype: Any = None,
                            train: bool = False) -> torch.Tensor:
    """``apply`` of a MobileNetV2 classifier weights file: f32 logits
    (no gradient reaches the tree, as :func:`mobilenet_v1_tree_apply`)."""
    return mobilenet_v2_apply(_module_of_tree(tree, mobilenet_v2_from_jax),
                              x, _dtype(dtype), train)


def _module_apply(family_apply: Callable, model: nn.Module, x: torch.Tensor,
                  dtype: Any = None, train: bool = False) -> torch.Tensor:
    return family_apply(model, x, _dtype(dtype), train)


#: tree apply → (the function that makes its module, the module's apply)
TREE_MODULES: Dict[Callable, Tuple[Callable, Callable]] = {
    mobilenet_v1_tree_apply: (mobilenet_v1_from_jax, mobilenet_v1_apply),
    mobilenet_v2_tree_apply: (mobilenet_v2_from_jax, mobilenet_v2_apply),
}

#: module type → its inverse: the JAX-layout tree of a module's weights
MODULE_TO_JAX: Dict[type, Callable] = {
    MobileNetV1: mobilenet_v1_to_jax,
    MobileNetV2: mobilenet_v2_to_jax,
}


def tree_module_of(apply: Callable) -> Optional[Tuple[Callable, Callable]]:
    """``(build, module_apply)`` for a tree apply of :data:`TREE_MODULES`
    (through ``functools.partial``, whose keywords the module apply
    keeps), or None: ``build(tree)`` gives the module and
    ``module_apply(module, x, train=...)`` runs it; :data:`MODULE_TO_JAX`
    gives the tree back."""
    kwargs: Dict[str, Any] = {}
    fn = apply
    while isinstance(fn, functools.partial):
        if fn.args:
            return None
        kwargs = {**fn.keywords, **kwargs}
        fn = fn.func
    entry = TREE_MODULES.get(fn)
    if entry is None:
        return None
    build, family_apply = entry
    return build, functools.partial(_module_apply, family_apply, **kwargs)


def ssd_tree_apply(tree: Params, x: torch.Tensor, end_to_end: bool = True,
                   max_out: int = 100, dtype: Any = None):
    """``apply`` of an SSD-MobileNetV2 weights file: ``(boxes, scores,
    classes)`` with decode + NMS (anchors for ``x``'s size), or the raw
    ``(loc, cls)`` with ``end_to_end=False``, as ``register_ssd``."""
    model = _module_of_tree(tree, ssd_from_jax)
    dtype = torch.bfloat16 if dtype is None else _dtype(dtype)
    if not end_to_end:
        return model(x, dtype)
    return ssd_detect_apply(model, x, _anchors_on(int(x.shape[1]),
                                                  str(x.device)),
                            max_out=max_out, dtype=dtype)


def yolo_tree_apply(tree: Params, x: torch.Tensor, raw: bool = False,
                    max_out: int = 100, dtype: Any = None):
    """``apply`` of a YOLO weights file: the postprocess contract, or the
    v8 wire layout with ``raw=True``, as ``register_yolo``."""
    model = _module_of_tree(tree, yolo_from_jax)
    if raw:
        return yolo_raw_apply(model, x, _dtype(dtype))
    return yolo_detect_apply(model, x, max_out=max_out, dtype=_dtype(dtype))
