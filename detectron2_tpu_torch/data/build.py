"""The test-time data path (counterpart of ``detectron2_tpu/data/build.py``:
``get_detection_dataset_dicts`` :152, ``PaddedBatchCollator`` :199,
``build_detection_test_loader`` :426-478).

The test loader yields the fixed-shape batch dicts the model takes,

    {"image": [B, H, W, C] uint8, "image_sizes": [B, 2] int32,
     "metadata": [{"image_id", "file_name", "height", "width"}, ...]}

on the host; the model moves them to its device. The JAX collator makes the
images float32 (``build.py:234``); this one keeps them uint8, a quarter of
the bytes, and the model casts after normalizing. The train loader waits
for the train half of the data path (ROADMAP A2).
"""

import itertools
import logging
from typing import Any, Dict, List, Union

import numpy as np
import torch

from detectron2_tpu_torch.config import configurable
from detectron2_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.data.common import DatasetFromList, MapDataset
from detectron2_tpu_torch.data.dataset_mapper import DatasetMapper
from detectron2_tpu_torch.data.detection_utils import check_metadata_consistency
from detectron2_tpu_torch.data.samplers import InferenceSampler

logger = logging.getLogger(__name__)

__all__ = ["PaddedBatchCollator", "build_detection_test_loader", "get_detection_dataset_dicts"]


def filter_images_with_only_crowd_annotations(dataset_dicts: List[dict]) -> List[dict]:
    """Filter out images with none or crowd-only annotations."""
    num_before = len(dataset_dicts)

    def valid(anns):
        return any(ann.get("iscrowd", 0) == 0 for ann in anns)

    dataset_dicts = [x for x in dataset_dicts if valid(x["annotations"])]
    logger.info(f"Removed {num_before - len(dataset_dicts)} images with no usable annotations. {len(dataset_dicts)} images left.")
    return dataset_dicts


def print_instances_class_histogram(dataset_dicts: List[dict], class_names: List[str]) -> None:
    """Log the number of instances per category."""
    num_classes = len(class_names)
    histogram = np.zeros((num_classes,), dtype=np.int64)
    for entry in dataset_dicts:
        classes = np.asarray([x["category_id"] for x in entry["annotations"] if not x.get("iscrowd", 0)], dtype=np.int64)
        if len(classes):
            assert classes.min() >= 0 and classes.max() < num_classes
            histogram += np.histogram(classes, bins=num_classes, range=(0, num_classes))[0]
    top = sorted(zip(class_names, histogram.tolist()), key=lambda x: -x[1])[:20]
    logger.info(
        f"Distribution of instances among all {num_classes} categories (total {int(histogram.sum())}; "
        f"top-{len(top)}): " + ", ".join(f"{n}: {c}" for n, c in top)
    )


def get_detection_dataset_dicts(
    names: Union[str, List[str]], filter_empty: bool = True, check_consistency: bool = True
) -> List[dict]:
    """Load and concatenate the dataset dicts of registered datasets."""
    if isinstance(names, str):
        names = [names]
    assert len(names), names
    dataset_dicts = [DatasetCatalog.get(dataset_name) for dataset_name in names]
    for dataset_name, dicts in zip(names, dataset_dicts):
        assert len(dicts), f"Dataset '{dataset_name}' is empty!"
    dataset_dicts = list(itertools.chain.from_iterable(dataset_dicts))

    has_instances = "annotations" in dataset_dicts[0]
    if filter_empty and has_instances:
        dataset_dicts = filter_images_with_only_crowd_annotations(dataset_dicts)
    if check_consistency and has_instances:
        try:
            class_names = MetadataCatalog.get(names[0]).thing_classes
            check_metadata_consistency("thing_classes", names)
            print_instances_class_histogram(dataset_dicts, class_names)
        except AttributeError:  # class names are not available for this dataset
            pass
    assert len(dataset_dicts), f"No valid data found in {','.join(names)}."
    return dataset_dicts


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if m > 1 else x


class PaddedBatchCollator:
    """Pad images into one ``[B, H, W, C]`` batch, H and W rounded up to
    ``size_divisibility`` and then to ``size_bucket``. A positive
    ``square_size`` pads to that fixed square instead (ViT backbones:
    ``padding_constraints["square_size"]``; the JAX collator's ``square``).

    Takes either images (``[h, w, C]`` tensors, the predictor's call; the
    batch stays on their device) or the mapper's per-image dicts (their
    "image" a numpy array; the batch is made on the host and carries
    "metadata")."""

    def __init__(
        self, size_divisibility: int = 32, size_bucket: int = 32, pad_value: float = 0.0, square_size: int = 0
    ):
        self.size_divisibility = size_divisibility
        self.size_bucket = size_bucket
        self.pad_value = pad_value
        self.square_size = square_size

    def __call__(self, batch_list: List[Union[torch.Tensor, dict]]) -> Dict[str, Any]:
        records = isinstance(batch_list[0], dict)
        images = [torch.as_tensor(d["image"]) for d in batch_list] if records else batch_list
        sizes = [(im.shape[0], im.shape[1]) for im in images]
        max_h, max_w = max(s[0] for s in sizes), max(s[1] for s in sizes)
        if self.square_size > 0:
            if max(max_h, max_w) > self.square_size:
                raise ValueError(f"an image of {max_h}x{max_w} does not fit the {self.square_size} square")
            H = W = self.square_size
        else:
            H = _round_up(_round_up(max_h, self.size_divisibility), self.size_bucket)
            W = _round_up(_round_up(max_w, self.size_divisibility), self.size_bucket)
        first = images[0]
        batch = torch.full(
            (len(images), H, W, first.shape[2]), self.pad_value, dtype=first.dtype, device=first.device
        )
        for i, im in enumerate(images):
            batch[i, : im.shape[0], : im.shape[1]] = im
        out: Dict[str, Any] = {
            "image": batch,
            "image_sizes": torch.tensor(sizes, dtype=torch.int32, device=first.device),
        }
        if records:
            # host-side metadata for the evaluators
            out["metadata"] = [
                {k: d[k] for k in ("image_id", "file_name", "height", "width") if k in d} for d in batch_list
            ]
        return out


def _test_loader_from_config(cfg, dataset_name, mapper=None):
    if isinstance(dataset_name, str):
        dataset_name = [dataset_name]
    if cfg.MODEL.LOAD_PROPOSALS:
        raise NotImplementedError("precomputed proposals are not ported")
    dataset = get_detection_dataset_dicts(dataset_name, filter_empty=False)
    if mapper is None:
        mapper = DatasetMapper(cfg, False)
    collator = PaddedBatchCollator(
        size_divisibility=32, size_bucket=cfg.TPU.SIZE_BUCKET, square_size=cfg.TPU.FIXED_TEST_SIZE
    )
    return {
        "dataset": dataset,
        "mapper": mapper,
        "sampler": InferenceSampler(len(dataset)),
        "collator": collator,
    }


@configurable(from_config=_test_loader_from_config)
def build_detection_test_loader(dataset, *, mapper, sampler=None, batch_size: int = 1, collator=None):
    """The test loader: every index of ``sampler`` once, in order,
    ``batch_size`` images per batch (1 by default, as in d2), as a generator
    of padded batch dicts. Call it as ``build_detection_test_loader(cfg,
    dataset_name)`` or with the dataset (a list of dicts or a dataset),
    mapper, sampler and collator."""
    if isinstance(dataset, list):
        dataset = DatasetFromList(dataset, copy=False)
    if mapper is not None:
        dataset = MapDataset(dataset, mapper)
    if sampler is None:
        sampler = InferenceSampler(len(dataset))
    collator = collator or PaddedBatchCollator()

    def _gen():
        buf = []
        for idx in sampler:
            buf.append(dataset[idx])
            if len(buf) == batch_size:
                yield collator(buf)
                buf = []
        if buf:
            yield collator(buf)

    return _gen()
