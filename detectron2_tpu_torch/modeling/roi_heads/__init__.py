from detectron2_tpu_torch.modeling.roi_heads.box_head import FastRCNNConvFCHead
from detectron2_tpu_torch.modeling.roi_heads.fast_rcnn import (
    FastRCNNOutputLayers,
    fast_rcnn_inference_padded,
)
from detectron2_tpu_torch.modeling.roi_heads.keypoint_head import (
    ROI_KEYPOINT_HEAD_REGISTRY,
    KRCNNConvDeconvUpsampleHead,
    build_keypoint_head,
    keypoint_rcnn_inference,
)
from detectron2_tpu_torch.modeling.roi_heads.mask_head import MaskRCNNConvUpsampleHead, mask_rcnn_inference
from detectron2_tpu_torch.modeling.roi_heads.roi_heads import (
    ROI_HEADS_REGISTRY,
    Res5ROIHeads,
    StandardROIHeads,
    build_roi_heads,
)
from detectron2_tpu_torch.modeling.roi_heads.cascade_rcnn import CascadeROIHeads  # registers itself

__all__ = [
    "FastRCNNConvFCHead",
    "FastRCNNOutputLayers",
    "fast_rcnn_inference_padded",
    "ROI_KEYPOINT_HEAD_REGISTRY",
    "KRCNNConvDeconvUpsampleHead",
    "build_keypoint_head",
    "keypoint_rcnn_inference",
    "MaskRCNNConvUpsampleHead",
    "mask_rcnn_inference",
    "ROI_HEADS_REGISTRY",
    "CascadeROIHeads",
    "Res5ROIHeads",
    "StandardROIHeads",
    "build_roi_heads",
]
