"""Model zoo for the ``torch-cuda`` filter: the SSD-MobileNetV2 detector
of the detection path, with its MobileNetV2 backbone; the ViT classifier
of the classification path; and the converters from JAX-layout parameter
trees."""

from .convert import (
    params_from_jax,
    ssd_from_jax,
    ssd_mobilenet_v2_init,
    vit_from_jax,
    vit_params_from_jax,
)
from .mobilenet import MobileNetV2Backbone, mobilenet_v2_init
from .ssd import (
    SSDMobileNetV2,
    batched_nms,
    decode_boxes,
    feature_sizes_for,
    ssd_anchors,
    ssd_detect_apply,
)
from .vit import ViT, register_vit, vit_apply, vit_init, vit_tree

__all__ = [
    "params_from_jax", "ssd_from_jax", "ssd_mobilenet_v2_init",
    "MobileNetV2Backbone", "mobilenet_v2_init",
    "SSDMobileNetV2", "batched_nms", "decode_boxes", "feature_sizes_for",
    "ssd_anchors", "ssd_detect_apply",
    "vit_from_jax", "vit_params_from_jax",
    "ViT", "register_vit", "vit_apply", "vit_init", "vit_tree",
]
