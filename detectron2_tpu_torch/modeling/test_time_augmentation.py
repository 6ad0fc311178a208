"""Test-time augmentation (counterpart of
``detectron2_tpu/modeling/test_time_augmentation.py:25-200``).

Each augmented copy of an image (every shortest-edge size, each also
flipped) runs through the model as a batch of one on the model's device.
The detections are mapped back to the original frame through the inverse
transforms (on the host, in float64, as the JAX package does), merged by
per-class NMS with the reference's one-hot protocol, and the mask head runs
again on the merged boxes in every augmented frame
(``forward_with_given_boxes``); the flipped masks are flipped back, all are
averaged and pasted at the original size on the device in float32, as
``detector_postprocess`` pastes (the JAX package pastes on the host in
float64; ROADMAP C "Known differences").
"""

import copy
from typing import Dict, List, Optional

import numpy as np
import torch

from detectron2_tpu_torch.data import PaddedBatchCollator
from detectron2_tpu_torch.data import transforms as T
from detectron2_tpu_torch.ops.nms import batched_nms_padded
from detectron2_tpu_torch.ops.paste_masks import paste_masks_in_image
from detectron2_tpu_torch.structures import BitMasks, Boxes, Instances

__all__ = ["DatasetMapperTTA", "GeneralizedRCNNWithTTA"]


class DatasetMapperTTA:
    """One dataset dict (``image`` ``[H, W, C]``, a numpy array or a tensor,
    and the original ``height``, ``width``) -> its augmented copies, each
    with its ``transforms`` from the original frame."""

    def __init__(self, min_sizes: List[int], max_size: int, flip: bool):
        self.min_sizes = list(min_sizes)
        self.max_size = max_size
        self.flip = flip

    @classmethod
    def from_config(cls, cfg) -> "DatasetMapperTTA":
        return cls(min_sizes=cfg.TEST.AUG.MIN_SIZES, max_size=cfg.TEST.AUG.MAX_SIZE, flip=cfg.TEST.AUG.FLIP)

    def __call__(self, dataset_dict: dict) -> List[dict]:
        image = dataset_dict["image"]
        orig_shape = (dataset_dict["height"], dataset_dict["width"])
        if tuple(image.shape[:2]) != orig_shape:
            pre_tfm = T.ResizeTransform(orig_shape[0], orig_shape[1], image.shape[0], image.shape[1])
        else:
            pre_tfm = T.NoOpTransform()
        aug_candidates = []
        for min_size in self.min_sizes:
            resize = T.ResizeShortestEdge(min_size, self.max_size)
            aug_candidates.append([resize])
            if self.flip:
                aug_candidates.append([resize, T.RandomFlip(prob=1.0)])
        rest = {k: v for k, v in dataset_dict.items() if k != "image"}
        ret = []
        for aug in aug_candidates:
            aug_input = T.AugInput(image)
            tfms = aug_input.apply_augmentations(aug)
            dic = copy.deepcopy(rest)
            dic["transforms"] = pre_tfm + tfms
            dic["image"] = aug_input.image
            ret.append(dic)
        return ret


def _is_flipped(tfm: T.TransformList) -> bool:
    return any(isinstance(t, T.HFlipTransform) for t in tfm.transforms)


class GeneralizedRCNNWithTTA:
    """Test-time augmentation around the port's GeneralizedRCNN, on the
    model's device. Call it with a list of dicts of ``image`` (``[H, W, C]``
    in the model's input format) and the original ``height``, ``width``;
    returns ``[{"instances": Instances}]`` in the original frame."""

    def __init__(self, cfg, model, tta_mapper: Optional[DatasetMapperTTA] = None):
        self.cfg = cfg.clone()
        if cfg.MODEL.KEYPOINT_ON:
            raise NotImplementedError("TTA for keypoints is not supported (d2 neither)")
        self.model = model.eval()
        self.tta_mapper = tta_mapper or DatasetMapperTTA.from_config(cfg)
        self.collator = PaddedBatchCollator(size_divisibility=32, size_bucket=max(cfg.TPU.SIZE_BUCKET, 32))

    def __call__(self, batched_inputs: List[dict]) -> List[dict]:
        return [self._inference_one_image(x) for x in batched_inputs]

    def _batch(self, image) -> Dict[str, torch.Tensor]:
        return self.collator([torch.as_tensor(np.ascontiguousarray(image) if isinstance(image, np.ndarray) else image,
                                              device=self.model.device)])

    def _inference_one_image(self, input_dict: dict) -> dict:
        orig_h, orig_w = input_dict["height"], input_dict["width"]
        augmented = self.tta_mapper(input_dict)
        tfms = [d.pop("transforms") for d in augmented]
        boxes, scores, classes = self._merge_detections(*self._get_augmented_boxes(augmented, tfms), (orig_h, orig_w))
        result = Instances((orig_h, orig_w), pred_boxes=Boxes(boxes), scores=scores, pred_classes=classes)
        if self.cfg.MODEL.MASK_ON and len(boxes):
            masks = self._reduce_pred_masks(augmented, tfms, boxes, classes)
            result.pred_masks = BitMasks(paste_masks_in_image(masks, boxes, (orig_h, orig_w)))
        return {"instances": result}

    def _get_augmented_boxes(self, augmented: List[dict], tfms):
        """Every copy's valid detections with their boxes mapped back to the
        original frame: float64 boxes ``[N, 4]``, scores, classes (host)."""
        all_boxes, all_scores, all_classes = [], [], []
        for aug_dict, tfm in zip(augmented, tfms):
            out = self.model(self._batch(aug_dict["image"]))
            valid = out["valid"][0]
            all_boxes.append(tfm.inverse().apply_box(out["pred_boxes"][0][valid].cpu().numpy()))
            all_scores.append(out["scores"][0][valid].cpu().numpy())
            all_classes.append(out["pred_classes"][0][valid].cpu().numpy())
        return np.concatenate(all_boxes), np.concatenate(all_scores), np.concatenate(all_classes).astype(np.int64)

    def _merge_detections(self, all_boxes, all_scores, all_classes, shape_hw):
        """d2's merge (test_time_augmentation.py:264-283): boxes clipped to
        the image, the empty and the unscored dropped, per-class NMS at
        ``NMS_THRESH_TEST``, the best ``DETECTIONS_PER_IMAGE`` kept in score
        order. Returns device tensors: float32 boxes, scores, int64 classes."""
        h, w = shape_hw
        boxes = all_boxes.astype(np.float32)
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
        keep = (
            (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1]) & (all_scores > 1e-8)
            & np.isfinite(boxes).all(axis=1)
        )
        device = self.model.device
        boxes = torch.as_tensor(boxes[keep], device=device)
        scores = torch.as_tensor(all_scores[keep].astype(np.float32), device=device)
        classes = torch.as_tensor(all_classes[keep], device=device)
        if len(boxes):
            kept = batched_nms_padded(boxes, scores, classes, self.cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST)
            idx = torch.nonzero(kept)[:, 0]
            idx = idx[torch.sort(scores[idx], descending=True, stable=True).indices]
            idx = idx[: self.cfg.TEST.DETECTIONS_PER_IMAGE]
            boxes, scores, classes = boxes[idx], scores[idx], classes[idx]
        return boxes, scores, classes

    def _reduce_pred_masks(self, augmented: List[dict], tfms, boxes: torch.Tensor, classes: torch.Tensor):
        """The mask head on the merged boxes in every augmented frame, the
        flipped copies' masks flipped back, averaged: ``[D, M, M]``."""
        D = len(boxes)
        host_boxes = boxes.cpu().numpy()
        mask_sum = None
        for aug_dict, tfm in zip(augmented, tfms):
            batch = self._batch(aug_dict["image"])
            aug_boxes = torch.as_tensor(tfm.apply_box(host_boxes).astype(np.float32), device=boxes.device)
            batch["given_boxes"] = aug_boxes.reshape(1, D, 4)
            batch["given_classes"] = classes.reshape(1, D)
            batch["given_valid"] = torch.ones((1, D), dtype=torch.bool, device=boxes.device)
            masks = self.model(batch)["pred_masks"][0].float()
            if _is_flipped(tfm):
                masks = masks.flip(-1)
            mask_sum = masks if mask_sum is None else mask_sum + masks
        return mask_sum / len(augmented)
