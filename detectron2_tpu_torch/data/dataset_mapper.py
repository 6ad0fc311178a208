"""DatasetMapper in test mode (counterpart of
``detectron2_tpu/data/dataset_mapper.py:22-155``): dataset dict -> the
per-image dict the collator batches. It reads the image, applies the
test-time augmentations and returns the HWC uint8 image with the record's
metadata. Training mode (annotations to instances) waits for the train half
of the data path (ROADMAP A2)."""

import copy
import logging
from typing import List, Union

import numpy as np

from detectron2_tpu_torch.config import configurable
from detectron2_tpu_torch.data import detection_utils as utils
from detectron2_tpu_torch.data import transforms as T

__all__ = ["DatasetMapper"]


class DatasetMapper:
    """A callable which takes a dataset dict in Detectron2 Dataset format and
    maps it into a format used by the model:

    1. read the image from "file_name" in ``image_format``;
    2. apply the augmentations (test time: the resize);
    3. return the record with "image" (HWC uint8 numpy) and without its
       annotations.
    """

    @configurable
    def __init__(
        self,
        is_train: bool,
        *,
        augmentations: List[Union[T.Augmentation, T.Transform]],
        image_format: str,
    ):
        if is_train:
            raise NotImplementedError("DatasetMapper in training mode is not ported yet (ROADMAP A2, train half)")
        self.is_train = is_train
        self.augmentations = T.AugmentationList(augmentations)
        self.image_format = image_format
        logging.getLogger(__name__).info(f"[DatasetMapper] Augmentations used in inference: {augmentations}")

    @classmethod
    def from_config(cls, cfg, is_train: bool = True):
        if is_train:
            raise NotImplementedError("DatasetMapper in training mode is not ported yet (ROADMAP A2, train half)")
        return {
            "is_train": is_train,
            "augmentations": utils.build_augmentation(cfg, is_train),
            "image_format": cfg.INPUT.FORMAT,
        }

    def __call__(self, dataset_dict: dict) -> dict:
        dataset_dict = copy.deepcopy(dataset_dict)  # it will be modified below
        image = utils.read_image(dataset_dict["file_name"], format=self.image_format)
        utils.check_image_size(dataset_dict, image)
        aug_input = T.AugInput(image)
        self.augmentations(aug_input)
        dataset_dict["image"] = np.ascontiguousarray(aug_input.image)
        dataset_dict.pop("annotations", None)
        dataset_dict.pop("sem_seg_file_name", None)
        return dataset_dict
