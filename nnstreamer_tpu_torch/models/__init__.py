"""Model zoo for the ``torch-cuda`` filter: the SSD-MobileNetV2 detector
with its MobileNetV2 backbone, the MobileNetV1 and MobileNetV2
classifiers, the YOLO detector (raw v8 layout or decode + NMS in the
model), the ViT classifier; ``trace_classifier``, a MobileNet as a
TorchScript module for the ``pytorch`` filter; the converters from
JAX-layout parameter trees and each family's ``*_tree_apply`` for
weights files; and ``params_io``, the weights files both packages
read."""

from .convert import (
    mobilenet_v1_from_jax,
    mobilenet_v1_tree_apply,
    mobilenet_v2_from_jax,
    mobilenet_v2_tree_apply,
    params_from_jax,
    ssd_from_jax,
    ssd_mobilenet_v2_init,
    ssd_tree_apply,
    vit_from_jax,
    vit_params_from_jax,
    yolo_from_jax,
    yolo_tree_apply,
)
from .mobilenet import (
    MobileNetV1,
    MobileNetV2,
    MobileNetV2Backbone,
    mobilenet_v1_apply,
    mobilenet_v1_init,
    mobilenet_v2_apply,
    mobilenet_v2_init,
    register_mobilenet,
    trace_classifier,
)
from .params_io import weights_to_bf16
from .ssd import (
    SSDMobileNetV2,
    batched_nms,
    decode_boxes,
    feature_sizes_for,
    register_ssd,
    ssd_anchors,
    ssd_detect_apply,
)
from .vit import (
    ViT,
    register_vit,
    vit_apply,
    vit_init,
    vit_tree,
    vit_tree_apply,
)
from .yolo import (
    YOLO,
    register_yolo,
    yolo_detect_apply,
    yolo_init,
    yolo_raw_apply,
)

__all__ = [
    "mobilenet_v1_from_jax", "mobilenet_v1_tree_apply",
    "mobilenet_v2_from_jax", "mobilenet_v2_tree_apply",
    "params_from_jax", "ssd_from_jax", "ssd_mobilenet_v2_init",
    "ssd_tree_apply", "vit_from_jax", "vit_params_from_jax",
    "yolo_from_jax", "yolo_tree_apply",
    "MobileNetV1", "MobileNetV2", "MobileNetV2Backbone",
    "mobilenet_v1_apply", "mobilenet_v1_init", "mobilenet_v2_apply",
    "mobilenet_v2_init", "register_mobilenet", "trace_classifier",
    "weights_to_bf16",
    "SSDMobileNetV2", "batched_nms", "decode_boxes", "feature_sizes_for",
    "register_ssd", "ssd_anchors", "ssd_detect_apply",
    "ViT", "register_vit", "vit_apply", "vit_init", "vit_tree",
    "vit_tree_apply",
    "YOLO", "register_yolo", "yolo_detect_apply", "yolo_init",
    "yolo_raw_apply",
]
