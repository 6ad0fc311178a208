"""DatasetMapper (counterpart of ``detectron2_tpu/data/dataset_mapper.py``):
dataset dict -> the per-image dict the collator batches. It reads the
image, applies the augmentations and returns the HWC uint8 image with the
record's metadata; in training also the ground truth as host
:class:`Instances` (crowd annotations dropped, empty instances filtered),
which the collator packs into fixed-shape arrays."""

import copy
import logging
from typing import List, Optional, Union

import numpy as np

from detectron2_tpu_torch.config import configurable
from detectron2_tpu_torch.data import detection_utils as utils
from detectron2_tpu_torch.data import transforms as T

__all__ = ["DatasetMapper"]


class DatasetMapper:
    """A callable which takes a dataset dict in Detectron2 Dataset format and
    maps it into a format used by the model:

    1. read the image from "file_name" in ``image_format``;
    2. apply the augmentations (drawing from ``rng`` when given) to the
       image and, in training, to the annotations;
    3. return the record with "image" (HWC uint8 numpy) and, in training,
       "instances"; without its annotations.
    """

    @configurable
    def __init__(
        self,
        is_train: bool,
        *,
        augmentations: List[Union[T.Augmentation, T.Transform]],
        image_format: str,
        use_instance_mask: bool = False,
        instance_mask_format: str = "polygon",
        recompute_boxes: bool = False,
        rng: Optional[np.random.RandomState] = None,
    ):
        if recompute_boxes:
            assert use_instance_mask, "recompute_boxes requires instance masks"
        self.is_train = is_train
        self.augmentations = T.AugmentationList(augmentations, rng=rng)
        self.image_format = image_format
        self.use_instance_mask = use_instance_mask
        self.instance_mask_format = instance_mask_format
        self.recompute_boxes = recompute_boxes
        mode = "training" if is_train else "inference"
        logging.getLogger(__name__).info(f"[DatasetMapper] Augmentations used in {mode}: {augmentations}")

    @classmethod
    def from_config(cls, cfg, is_train: bool = True):
        if is_train and cfg.MODEL.KEYPOINT_ON:
            raise NotImplementedError("keypoint targets are not ported yet (ROADMAP A7, keypoint training)")
        if cfg.MODEL.LOAD_PROPOSALS:
            raise NotImplementedError("precomputed proposals are not ported")
        augs = utils.build_augmentation(cfg, is_train)
        recompute_boxes = False
        if cfg.INPUT.CROP.ENABLED and is_train:
            augs.insert(0, T.RandomCrop(cfg.INPUT.CROP.TYPE, cfg.INPUT.CROP.SIZE))
            recompute_boxes = cfg.MODEL.MASK_ON
        return {
            "is_train": is_train,
            "augmentations": augs,
            "image_format": cfg.INPUT.FORMAT,
            "use_instance_mask": cfg.MODEL.MASK_ON,
            "instance_mask_format": cfg.INPUT.MASK_FORMAT,
            "recompute_boxes": recompute_boxes,
        }

    def _transform_annotations(self, dataset_dict: dict, transforms, image_shape) -> None:
        annos = []
        for obj in dataset_dict.pop("annotations"):
            if obj.get("iscrowd", 0) != 0:
                continue
            if not self.use_instance_mask:
                obj.pop("segmentation", None)
            obj.pop("keypoints", None)
            annos.append(utils.transform_instance_annotations(obj, transforms, image_shape))
        instances = utils.annotations_to_instances(annos, image_shape, mask_format=self.instance_mask_format)
        if self.recompute_boxes and instances.has("gt_masks"):
            instances.gt_boxes = instances.gt_masks.get_bounding_boxes()
        dataset_dict["instances"] = utils.filter_empty_instances(instances)

    def __call__(self, dataset_dict: dict) -> dict:
        dataset_dict = copy.deepcopy(dataset_dict)  # it will be modified below
        image = utils.read_image(dataset_dict["file_name"], format=self.image_format)
        utils.check_image_size(dataset_dict, image)
        aug_input = T.AugInput(image)
        transforms = self.augmentations(aug_input)
        image = aug_input.image
        dataset_dict["image"] = np.ascontiguousarray(image)
        dataset_dict.pop("sem_seg_file_name", None)
        if self.is_train and "annotations" in dataset_dict:
            self._transform_annotations(dataset_dict, transforms, image.shape[:2])
        dataset_dict.pop("annotations", None)
        return dataset_dict
