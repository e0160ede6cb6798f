"""Model zoo for the ``torch-cuda`` filter: the SSD-MobileNetV2 detector
of the main path, with its MobileNetV2 backbone and the converter from
JAX-layout parameter trees."""

from .convert import params_from_jax, ssd_from_jax, ssd_mobilenet_v2_init
from .mobilenet import MobileNetV2Backbone, mobilenet_v2_init
from .ssd import (
    SSDMobileNetV2,
    batched_nms,
    decode_boxes,
    feature_sizes_for,
    ssd_anchors,
    ssd_detect_apply,
)

__all__ = [
    "params_from_jax", "ssd_from_jax", "ssd_mobilenet_v2_init",
    "MobileNetV2Backbone", "mobilenet_v2_init",
    "SSDMobileNetV2", "batched_nms", "decode_boxes", "feature_sizes_for",
    "ssd_anchors", "ssd_detect_apply",
]
