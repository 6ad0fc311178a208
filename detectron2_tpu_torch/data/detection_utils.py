"""Image reading and the per-image data helpers (counterpart of
``detectron2_tpu/data/detection_utils.py``): ``read_image``,
``convert_PIL_to_numpy``, ``check_image_size``, ``build_augmentation``,
``check_metadata_consistency``, and for training
``transform_instance_annotations`` (with ``transform_keypoint_annotations``
and the flip indices of ``create_keypoint_hflip_indices``),
``annotations_to_instances``, ``filter_empty_instances`` and
``instances_to_padded_targets``, the port's batch contract for the ground
truth; ``transform_proposals`` for precomputed proposals.

``read_image`` decodes with PIL where PIL imports, as the JAX package does.
Where it does not (the card's machine has no PIL), PNG files are decoded by
``data/png.py`` and converted to the asked format with PIL's own integer
formulas, so the same pixels come out either way; any other format raises
``ImportError`` naming PIL.
"""

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from detectron2_tpu_torch.data import transforms as T
from detectron2_tpu_torch.data.catalog import MetadataCatalog
from detectron2_tpu_torch.data.png import is_png, read_png
from detectron2_tpu_torch.structures import (
    BitMasks,
    Boxes,
    BoxMode,
    Instances,
    Keypoints,
    PolygonMasks,
    polygons_to_bitmask,
)

__all__ = [
    "SizeMismatchError",
    "annotations_to_instances",
    "build_augmentation",
    "check_image_size",
    "check_metadata_consistency",
    "convert_PIL_to_numpy",
    "create_keypoint_hflip_indices",
    "filter_empty_instances",
    "instances_to_padded_proposals",
    "instances_to_padded_targets",
    "read_image",
    "transform_instance_annotations",
    "transform_keypoint_annotations",
    "transform_proposals",
]


class SizeMismatchError(ValueError):
    """When the loaded image has a different width/height than the annotation."""


# COCO-standard conversion matrix kept for YUV-BT.601 support
_M_RGB2YUV = [[0.299, 0.587, 0.114], [-0.14713, -0.28886, 0.436], [0.615, -0.51499, -0.10001]]


def convert_PIL_to_numpy(image, format: Optional[str]) -> np.ndarray:
    """PIL image -> numpy in the given format."""
    if format is not None:
        conversion_format = format
        if format in ["BGR", "YUV-BT.601"]:
            conversion_format = "RGB"
        image = image.convert(conversion_format)
    image = np.asarray(image)
    if format == "L":
        image = np.expand_dims(image, -1)
    elif format == "BGR":
        image = image[:, :, ::-1]
    elif format == "YUV-BT.601":
        image = image / 255.0
        image = np.dot(image, np.array(_M_RGB2YUV).T)
    return image


def _convert_decoded_png(pixels: np.ndarray, format: Optional[str]) -> np.ndarray:
    """:func:`convert_PIL_to_numpy` of a decoded PNG (``[H, W]`` gray or
    ``[H, W, C]`` gray + alpha, RGB, RGBA) by PIL's ``convert`` rules: gray
    is copied into R, G and B, alpha is dropped, and RGB -> L is
    ``(19595 R + 38470 G + 7471 B + 2^15) >> 16``."""
    if format is None:
        return pixels
    gray = pixels.ndim == 2 or pixels.shape[2] == 2
    if format == "L":
        if gray:
            out = pixels if pixels.ndim == 2 else pixels[:, :, 0]
        else:
            rgb = pixels[:, :, :3].astype(np.uint32)
            out = ((rgb[:, :, 0] * 19595 + rgb[:, :, 1] * 38470 + rgb[:, :, 2] * 7471 + 0x8000) >> 16).astype(np.uint8)
        return np.expand_dims(out, -1)
    if format not in ("RGB", "BGR", "YUV-BT.601"):
        raise ValueError(f"read_image without PIL: format {format!r} (RGB, BGR, L, YUV-BT.601 or None)")
    if gray:
        g = pixels if pixels.ndim == 2 else pixels[:, :, 0]
        rgb = np.repeat(g[:, :, None], 3, axis=2)
    else:
        rgb = pixels[:, :, :3]
    if format == "BGR":
        return rgb[:, :, ::-1]
    if format == "YUV-BT.601":
        return np.dot(rgb / 255.0, np.array(_M_RGB2YUV).T)
    return np.ascontiguousarray(rgb)


def read_image(file_name: str, format: Optional[str] = None) -> np.ndarray:
    """Read an image into the given format ("BGR", "RGB", "L", "YUV-BT.601"
    or None for the file's own channels), applying EXIF orientation."""
    try:
        from PIL import Image, ImageOps
    except ImportError:
        Image = None
    if Image is not None:
        with open(file_name, "rb") as f:
            image = Image.open(f)
            try:
                image = ImageOps.exif_transpose(image)
            except Exception:
                pass
            return convert_PIL_to_numpy(image, format)
    with open(file_name, "rb") as f:
        data = f.read()
    if not is_png(data):
        raise ImportError(
            f"read_image: {file_name} is not a PNG; reading other image formats needs PIL (Pillow), "
            "which is not installed"
        )
    return _convert_decoded_png(read_png(data), format)


def check_image_size(dataset_dict: dict, image: np.ndarray) -> None:
    """Raise if the loaded image mismatches the annotated width/height."""
    if "width" in dataset_dict or "height" in dataset_dict:
        image_wh = (image.shape[1], image.shape[0])
        expected_wh = (dataset_dict["width"], dataset_dict["height"])
        if not image_wh == expected_wh:
            raise SizeMismatchError(
                "Mismatched image shape{}, got {}, expect {}.".format(
                    " for image " + dataset_dict["file_name"] if "file_name" in dataset_dict else "",
                    image_wh,
                    expected_wh,
                )
            )
    if "width" not in dataset_dict:
        dataset_dict["width"] = image.shape[1]
    if "height" not in dataset_dict:
        dataset_dict["height"] = image.shape[0]


def check_metadata_consistency(key, dataset_names):
    """Check that the datasets have consistent metadata."""
    if len(dataset_names) == 0:
        return
    logger = logging.getLogger(__name__)
    entries_per_dataset = [MetadataCatalog.get(d).get(key) for d in dataset_names]
    for idx, entry in enumerate(entries_per_dataset):
        if entry != entries_per_dataset[0]:
            logger.error(f"Metadata '{key}' for dataset '{dataset_names[idx]}' is '{entry}'")
            logger.error(f"Metadata '{key}' for dataset '{dataset_names[0]}' is '{entries_per_dataset[0]}'")
            raise ValueError(f"Datasets have different metadata '{key}'!")


def transform_proposals(dataset_dict: dict, image_shape, transforms, *, proposal_topk: int) -> None:
    """Replace a record's precomputed proposals (``proposal_boxes``,
    ``proposal_objectness_logits``, ``proposal_bbox_mode``, sorted by the
    loader) with "proposals", an :class:`Instances` of ``proposal_boxes``
    and ``objectness_logits``: transformed with the image, clipped to it,
    the empty ones dropped, then the first ``proposal_topk`` (no sort, as in
    the JAX package)."""
    if "proposal_boxes" not in dataset_dict:
        return
    boxes = BoxMode.convert(
        np.asarray(dataset_dict.pop("proposal_boxes")), dataset_dict.pop("proposal_bbox_mode"), BoxMode.XYXY_ABS
    )
    boxes = Boxes(np.asarray(transforms.apply_box(boxes), np.float32))
    objectness_logits = np.asarray(dataset_dict.pop("proposal_objectness_logits"))
    boxes.clip(image_shape)
    keep = boxes.nonempty(threshold=0)
    proposals = Instances(image_shape)
    proposals.proposal_boxes = boxes[keep][:proposal_topk]
    proposals.objectness_logits = torch.as_tensor(objectness_logits[keep.numpy()][:proposal_topk])
    dataset_dict["proposals"] = proposals


def instances_to_padded_proposals(proposals: Instances, topk: int) -> Dict[str, np.ndarray]:
    """One image's proposals as ``topk`` fixed slots, the padding as the RPN
    pads: ``proposal_boxes`` ``[P, 4]`` float32 (zeros), ``proposal_logits``
    ``[P]`` float32 (-inf) and ``proposal_valid`` ``[P]`` bool."""
    n = len(proposals)
    if n > topk:
        raise ValueError(f"{n} proposals do not fit {topk} slots")
    out = {
        "proposal_boxes": np.zeros((topk, 4), np.float32),
        "proposal_logits": np.full((topk,), -np.inf, np.float32),
        "proposal_valid": np.zeros((topk,), bool),
    }
    out["proposal_boxes"][:n] = proposals.proposal_boxes.tensor.numpy()
    out["proposal_logits"][:n] = proposals.objectness_logits.numpy()
    out["proposal_valid"][:n] = True
    return out


def transform_instance_annotations(annotation: dict, transforms, image_size, *, keypoint_hflip_indices=None) -> dict:
    """Apply ``transforms`` to one annotation's box (made XYXY_ABS and
    clipped to ``image_size`` (h, w)), segmentation (polygons, an RLE dict
    or an ``[H, W]`` mask; the masks come back bool) and keypoints (see
    :func:`transform_keypoint_annotations`)."""
    if isinstance(transforms, (tuple, list)):
        transforms = T.TransformList(transforms)
    bbox = BoxMode.convert(annotation["bbox"], annotation["bbox_mode"], BoxMode.XYXY_ABS)
    bbox = transforms.apply_box(np.array([bbox]))[0]
    bbox = np.minimum(bbox, np.array(list(image_size + image_size))[::-1].astype(np.float64))
    annotation["bbox"] = np.maximum(bbox, 0)
    annotation["bbox_mode"] = BoxMode.XYXY_ABS

    if "segmentation" in annotation:
        segm = annotation["segmentation"]
        if isinstance(segm, list):
            polygons = [np.asarray(p).reshape(-1, 2) for p in segm]
            annotation["segmentation"] = [p.reshape(-1) for p in transforms.apply_polygons(polygons)]
        elif isinstance(segm, dict):
            from detectron2_tpu_torch.evaluation.rle import rle_to_mask

            mask = rle_to_mask(segm) if "counts" in segm else segm
            annotation["segmentation"] = transforms.apply_segmentation(mask.astype(np.uint8)).astype(bool)
        elif isinstance(segm, np.ndarray):
            annotation["segmentation"] = transforms.apply_segmentation(segm)
        else:
            raise ValueError(
                f"Cannot transform segmentation of type '{type(segm)}'! Supported types are: polygons as "
                "list[list[float] or ndarray], COCO-style RLE as a dict, or a binary segmentation mask in a 2D "
                "numpy array of shape HxW."
            )
    if "keypoints" in annotation:
        annotation["keypoints"] = transform_keypoint_annotations(
            annotation["keypoints"], transforms, image_size, keypoint_hflip_indices
        )
    return annotation


def transform_keypoint_annotations(keypoints, transforms, image_size, keypoint_hflip_indices=None) -> np.ndarray:
    """COCO's flat (x, y, v) keypoints through ``transforms``: ``[K, 3]``
    float64. An odd number of horizontal flips reorders them by
    ``keypoint_hflip_indices`` (left and right swap); a keypoint outside
    the ``image_size`` (h, w) image becomes unlabeled, all of its row 0."""
    if isinstance(transforms, (tuple, list)):
        transforms = T.TransformList(transforms)
    keypoints = np.asarray(keypoints, dtype="float64").reshape(-1, 3)
    keypoints[:, :2] = transforms.apply_coords(keypoints[:, :2])
    do_hflip = sum(isinstance(t, T.HFlipTransform) for t in getattr(transforms, "transforms", [])) % 2 == 1
    if do_hflip:
        if keypoint_hflip_indices is None:
            raise ValueError("Cannot flip keypoints without providing flip indices!")
        if len(keypoints) != len(keypoint_hflip_indices):
            raise ValueError(
                f"Keypoint data has {len(keypoints)} points, but metadata contains {len(keypoint_hflip_indices)} points!"
            )
        keypoints = keypoints[np.asarray(keypoint_hflip_indices, dtype=np.int32), :]
    inside = (
        (keypoints[:, 0] >= 0)
        & (keypoints[:, 0] <= image_size[1])
        & (keypoints[:, 1] >= 0)
        & (keypoints[:, 1] <= image_size[0])
    )
    keypoints[:, 2] = np.where(inside, keypoints[:, 2], 0)
    keypoints[keypoints[:, 2] == 0] = 0
    return keypoints


def annotations_to_instances(annos: List[dict], image_size, mask_format: str = "polygon") -> Instances:
    """The ground truth of one image from its transformed annotations:
    ``gt_boxes`` (Boxes, float32), ``gt_classes`` (int64), where the
    annotations have segmentations ``gt_masks`` (PolygonMasks, or BitMasks
    for ``mask_format="bitmask"``) and where they have keypoints
    ``gt_keypoints`` (Keypoints, ``[N, K, 3]``)."""
    if annos:
        boxes = np.stack([BoxMode.convert(obj["bbox"], obj["bbox_mode"], BoxMode.XYXY_ABS) for obj in annos])
    else:
        boxes = np.zeros((0, 4))
    target = Instances(image_size)
    target.gt_boxes = Boxes(torch.from_numpy(np.asarray(boxes, np.float32)))
    target.gt_classes = torch.tensor([int(obj["category_id"]) for obj in annos], dtype=torch.int64)

    if annos and "segmentation" in annos[0]:
        segms = [obj["segmentation"] for obj in annos]
        if mask_format == "polygon":
            try:
                masks = PolygonMasks(segms)
            except ValueError as e:
                raise ValueError("Failed to use mask_format=='polygon' from the given annotations!") from e
        else:
            assert mask_format == "bitmask", mask_format
            bitmasks = []
            for segm in segms:
                if isinstance(segm, list):
                    bitmasks.append(polygons_to_bitmask(segm, *image_size))
                elif isinstance(segm, dict):
                    from detectron2_tpu_torch.evaluation.rle import rle_to_mask

                    bitmasks.append(rle_to_mask(segm).astype(bool))
                elif isinstance(segm, np.ndarray):
                    assert segm.ndim == 2, f"Expect segmentation of 2 dimensions, got {segm.ndim}."
                    bitmasks.append(segm.astype(bool))
                else:
                    raise ValueError(f"Unsupported segmentation type {type(segm)}")
            masks = BitMasks(torch.from_numpy(np.stack(bitmasks)))
        target.gt_masks = masks
    if annos and "keypoints" in annos[0]:
        kpts = [obj.get("keypoints", []) for obj in annos]
        target.gt_keypoints = Keypoints(torch.from_numpy(np.asarray(kpts, np.float32).reshape(len(annos), -1, 3)))
    return target


def filter_empty_instances(
    instances: Instances, by_box: bool = True, by_mask: bool = True, box_threshold: float = 1e-5, return_mask=False
):
    """The instances whose box is wider and taller than ``box_threshold``
    and whose mask is not empty."""
    assert by_box or by_mask
    r = []
    if by_box:
        r.append(instances.gt_boxes.nonempty(threshold=box_threshold))
    if instances.has("gt_masks") and by_mask:
        r.append(instances.gt_masks.nonempty())
    if not r:
        return instances
    m = r[0]
    for x in r[1:]:
        m = m & x
    if return_mask:
        return instances[m], m
    return instances[m]


def create_keypoint_hflip_indices(dataset_names) -> np.ndarray:
    """Each keypoint's index after a horizontal flip, from the datasets'
    ``keypoint_names`` and ``keypoint_flip_map`` (which must agree across
    the datasets)."""
    if isinstance(dataset_names, str):
        dataset_names = [dataset_names]
    check_metadata_consistency("keypoint_names", dataset_names)
    check_metadata_consistency("keypoint_flip_map", dataset_names)
    meta = MetadataCatalog.get(dataset_names[0])
    names = meta.keypoint_names
    flip_map = dict(meta.keypoint_flip_map)
    flip_map.update({v: k for k, v in flip_map.items()})
    flipped_names = [i if i not in flip_map else flip_map[i] for i in names]
    return np.asarray([names.index(i) for i in flipped_names])


def get_fed_loss_cls_weights(dataset_names, freq_weight_power: float = 1.0) -> np.ndarray:
    """Each class's weight in the federated loss's draw of negative classes:
    its ``class_image_count`` (which must agree across the datasets) to the
    power ``freq_weight_power``, float32, in category id order."""
    if isinstance(dataset_names, str):
        dataset_names = [dataset_names]
    check_metadata_consistency("class_image_count", dataset_names)
    meta = MetadataCatalog.get(dataset_names[0])
    class_freq = np.asarray([c["image_count"] for c in sorted(meta.class_image_count, key=lambda x: x["id"])], np.float32)
    return class_freq**freq_weight_power


def build_augmentation(cfg, is_train: bool) -> List[T.Augmentation]:
    """The augmentations of ``cfg.INPUT``: ``ResizeShortestEdge`` (train:
    ``MIN_SIZE_TRAIN`` in ``MIN_SIZE_TRAIN_SAMPLING`` style, capped at
    ``MAX_SIZE_TRAIN``; test: ``MIN_SIZE_TEST``, ``MAX_SIZE_TEST``), then in
    training a ``RandomFlip`` unless ``RANDOM_FLIP`` is "none"."""
    if is_train:
        min_size, max_size = cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN
        sample_style = cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING
    else:
        min_size, max_size, sample_style = cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST, "choice"
    augmentation = [T.ResizeShortestEdge(min_size, max_size, sample_style)]
    if is_train and cfg.INPUT.RANDOM_FLIP != "none":
        augmentation.append(
            T.RandomFlip(horizontal=cfg.INPUT.RANDOM_FLIP == "horizontal", vertical=cfg.INPUT.RANDOM_FLIP == "vertical")
        )
    return augmentation


def instances_to_padded_targets(
    instances: Instances, max_instances: int, mask_size: int = 0, num_keypoints: int = 0
) -> Dict[str, np.ndarray]:
    """One image's ground truth as the fixed-shape arrays of the batch:
    ``gt_boxes`` ``[G, 4]`` float32, ``gt_classes`` ``[G]`` int32,
    ``gt_valid`` ``[G]`` bool (the first min(n, G) instances), with
    ``mask_size`` ``gt_masks`` ``[G, Ms, Ms]`` float32, each instance's mask
    cropped into its own gt box (the model resamples them per proposal),
    and with ``num_keypoints`` ``gt_keypoints`` ``[G, K, 3]`` float32."""
    G = max_instances
    n = min(len(instances), G)
    out: Dict[str, np.ndarray] = {
        "gt_boxes": np.zeros((G, 4), np.float32),
        "gt_classes": np.zeros((G,), np.int32),
        "gt_valid": np.zeros((G,), bool),
    }
    if n > 0:
        out["gt_boxes"][:n] = instances.gt_boxes.tensor[:n].numpy()
        out["gt_classes"][:n] = instances.gt_classes[:n].numpy()
        out["gt_valid"][:n] = True
    if mask_size > 0:
        out["gt_masks"] = np.zeros((G, mask_size, mask_size), np.float32)
        if n > 0 and instances.has("gt_masks"):
            crops = instances.gt_masks[list(range(n))].crop_and_resize(out["gt_boxes"][:n], mask_size)
            out["gt_masks"][:n] = crops.cpu().numpy()
    if num_keypoints > 0:
        out["gt_keypoints"] = np.zeros((G, num_keypoints, 3), np.float32)
        if n > 0 and instances.has("gt_keypoints"):
            out["gt_keypoints"][:n] = instances.gt_keypoints.tensor[:n].cpu().numpy()
    return out
