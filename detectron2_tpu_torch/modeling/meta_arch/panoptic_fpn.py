"""Panoptic FPN (counterpart of ``detectron2_tpu/modeling/meta_arch/
panoptic_fpn.py``): ``GeneralizedRCNN`` with the semantic segmentation head
on the same FPN features, and the greedy fusion of instance and semantic
predictions on the host.

Training returns the sem-seg loss, the ROI heads' losses times
``instance_loss_weight`` and the RPN's losses. Inference returns the
detections dict of :class:`GeneralizedRCNN` plus ``"sem_seg"`` ``[B, H, W,
C]`` float32 logits in the padded frame, as the JAX model does.
:func:`add_panoptic_outputs` makes d2's ``panoptic_seg`` from those outputs
for the evaluators (the JAX package has no such step: ROADMAP C).
"""

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from detectron2_tpu_torch.modeling.meta_arch.rcnn import GeneralizedRCNN
from detectron2_tpu_torch.modeling.meta_arch.semantic_seg import build_sem_seg_head
from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess, sem_seg_postprocess

__all__ = ["PanopticFPN", "add_panoptic_outputs", "combine_semantic_and_instance_outputs"]


class PanopticFPN(GeneralizedRCNN):
    def __init__(
        self,
        *,
        sem_seg_head: nn.Module,
        instance_loss_weight: float = 1.0,
        combine_overlap_thresh: float = 0.5,
        combine_stuff_area_thresh: int = 4096,
        combine_instances_score_thresh: float = 0.5,
        combine_enabled: bool = True,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.sem_seg_head = sem_seg_head
        self.instance_loss_weight = instance_loss_weight
        self.combine_overlap_thresh = combine_overlap_thresh
        self.combine_stuff_area_thresh = combine_stuff_area_thresh
        self.combine_instances_score_thresh = combine_instances_score_thresh
        self.combine_enabled = combine_enabled

    @classmethod
    def from_config(cls, cfg) -> "PanopticFPN":
        """The model of a yacs ``cfg``, on the CPU in eval mode (as the JAX
        ``PanopticFPN.from_config``, which ``configs/common/models/
        panoptic_fpn.py`` calls)."""
        from detectron2_tpu_torch.modeling.backbone import build_backbone
        from detectron2_tpu_torch.modeling.proposal_generator import build_rpn
        from detectron2_tpu_torch.modeling.roi_heads import build_roi_heads

        backbone = build_backbone(cfg)
        shapes = backbone.output_shape()
        combine = cfg.MODEL.PANOPTIC_FPN.COMBINE
        return cls(
            backbone=backbone,
            proposal_generator=build_rpn(cfg, shapes),
            roi_heads=build_roi_heads(cfg, shapes),
            sem_seg_head=build_sem_seg_head(cfg, shapes),
            instance_loss_weight=cfg.MODEL.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT,
            combine_overlap_thresh=combine.OVERLAP_THRESH,
            combine_stuff_area_thresh=combine.STUFF_AREA_LIMIT,
            combine_instances_score_thresh=combine.INSTANCES_CONFIDENCE_THRESH,
            combine_enabled=combine.ENABLED,
            pixel_mean=cfg.MODEL.PIXEL_MEAN,
            pixel_std=cfg.MODEL.PIXEL_STD,
            input_format=cfg.INPUT.FORMAT,
            compute_dtype=cfg.TPU.COMPUTE_DTYPE,
            mask_paste_in_graph=cfg.TPU.PASTE_MASKS_IN_GRAPH,
        ).eval()

    def train_target_sizes(self) -> Dict:
        """The R-CNN heads' targets and the per-pixel labels."""
        sizes = super().train_target_sizes()
        return {**sizes, "with_sem_seg": True, "sem_seg_ignore_value": self.sem_seg_head.ignore_value}

    def forward(self, batch: Dict, train: bool = False, generator: Optional[torch.Generator] = None):
        if not train:
            return self._inference(batch)
        image = torch.as_tensor(batch["image"], device=self.device)
        image_sizes = torch.as_tensor(batch["image_sizes"], device=self.device)
        targets = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items() if k.startswith("gt_")}
        features = self.backbone(self.preprocess_image(image), train=True, generator=generator)
        _, losses = self.sem_seg_head(features, targets.pop("gt_sem_seg"), train=True)
        detector_losses, proposal_losses = self._losses(batch, features, image_sizes, targets, generator)
        losses.update({k: v * self.instance_loss_weight for k, v in detector_losses.items()})
        losses.update(proposal_losses)
        return losses

    @torch.inference_mode()
    def _inference(self, batch: Dict) -> Dict[str, torch.Tensor]:
        image = torch.as_tensor(batch["image"], device=self.device)
        image_sizes = torch.as_tensor(batch["image_sizes"], device=self.device)
        images = self.preprocess_image(image)
        features = self.backbone(images)
        sem_seg, _ = self.sem_seg_head(features)
        detections = self._detect(batch, images, image_sizes, features)
        detections["sem_seg"] = sem_seg
        return detections


def combine_semantic_and_instance_outputs(
    instances,
    semantic_results: np.ndarray,
    overlap_threshold: float,
    stuff_area_thresh: float,
    instances_score_thresh: float,
):
    """Greedy panoptic fusion on the host, the JAX statement as it is
    (``detectron2_tpu/modeling/meta_arch/panoptic_fpn.py:81-155``): paste
    instances in score order (``np.argsort(-scores)``, so ties break as
    there), skipping heavy overlap, then fill stuff regions above the area
    threshold.

    Args:
        instances: Instances with pred_masks (full-resolution bool
            ``BitMasks``), scores and pred_classes, on any device.
        semantic_results: ``[H, W]`` semantic argmax labels.

    Returns:
        (panoptic_seg ``[H, W]`` int32 segment ids, segments_info list[dict])
    """
    semantic_results = np.asarray(semantic_results)
    scores = instances.scores.cpu().numpy()
    classes = instances.pred_classes.cpu().numpy()
    masks = instances.pred_masks.tensor.cpu().numpy().astype(bool)
    panoptic_seg = np.zeros(semantic_results.shape, dtype=np.int32)

    sorted_inds = np.argsort(-scores)
    current_segment_id = 0
    segments_info = []

    for inst_id in sorted_inds:
        score = float(scores[inst_id])
        if score < instances_score_thresh:
            break
        mask = masks[inst_id]
        mask_area = mask.sum()
        if mask_area == 0:
            continue
        intersect = mask & (panoptic_seg > 0)
        intersect_area = intersect.sum()
        if intersect_area * 1.0 / mask_area > overlap_threshold:
            continue
        if intersect_area > 0:
            mask = mask & (panoptic_seg == 0)

        current_segment_id += 1
        panoptic_seg[mask] = current_segment_id
        segments_info.append(
            {
                "id": current_segment_id,
                "isthing": True,
                "score": score,
                "category_id": int(classes[inst_id]),
                "instance_id": int(inst_id),
            }
        )

    # add semantic results to remaining empty areas
    for semantic_label in np.unique(semantic_results):
        if semantic_label == 0:  # 0 is a special "thing" label
            continue
        mask = (semantic_results == semantic_label) & (panoptic_seg == 0)
        mask_area = mask.sum()
        if mask_area < stuff_area_thresh:
            continue
        current_segment_id += 1
        panoptic_seg[mask] = current_segment_id
        segments_info.append(
            {"id": current_segment_id, "isthing": False, "category_id": int(semantic_label), "area": int(mask_area)}
        )

    return panoptic_seg, segments_info


def add_panoptic_outputs(model: nn.Module, batch: Dict, outputs: Dict) -> Dict:
    """d2's ``outputs["panoptic_seg"]``, one ``(panoptic_seg [h, w],
    segments_info)`` per image at its original size (``metadata``'s height
    and width, else its size in the batch), for a :class:`PanopticFPN` with
    ``combine_enabled``; other models' outputs come back unchanged. On the
    outputs' device the masks are pasted (``detector_postprocess``) and the
    semantic logits resized and reduced to labels; the fusion runs on the
    host with the model's thresholds. ``DefaultTrainer.test`` and
    ``lazyconfig_train_net``'s test both run it after each forward."""
    if not (isinstance(model, PanopticFPN) and model.combine_enabled):
        return outputs
    image_sizes = torch.as_tensor(batch["image_sizes"]).tolist()
    panoptic: List = []
    for i, (meta, hw) in enumerate(zip(batch["metadata"], image_sizes)):
        h, w = meta.get("height", hw[0]), meta.get("width", hw[1])
        instances = detector_postprocess({k: v[i] for k, v in outputs.items()}, h, w, *hw)
        labels = sem_seg_postprocess(outputs["sem_seg"][i], hw, h, w).argmax(dim=-1)
        panoptic.append(
            combine_semantic_and_instance_outputs(
                instances,
                labels.cpu().numpy(),
                model.combine_overlap_thresh,
                model.combine_stuff_area_thresh,
                model.combine_instances_score_thresh,
            )
        )
    return {**outputs, "panoptic_seg": panoptic}
