"""Image reading and the test-time data helpers (the part of
``detectron2_tpu/data/detection_utils.py`` that evaluation needs:
``read_image``, ``convert_PIL_to_numpy``, ``check_image_size``,
``build_augmentation``'s test branch and ``check_metadata_consistency``).

``read_image`` decodes with PIL where PIL imports, as the JAX package does.
Where it does not (the card's machine has no PIL), PNG files are decoded by
``data/png.py`` and converted to the asked format with PIL's own integer
formulas, so the same pixels come out either way; any other format raises
``ImportError`` naming PIL.
"""

import logging
from typing import List, Optional

import numpy as np

from detectron2_tpu_torch.data import transforms as T
from detectron2_tpu_torch.data.catalog import MetadataCatalog
from detectron2_tpu_torch.data.png import is_png, read_png

__all__ = [
    "SizeMismatchError",
    "build_augmentation",
    "check_image_size",
    "check_metadata_consistency",
    "convert_PIL_to_numpy",
    "read_image",
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


def build_augmentation(cfg, is_train: bool) -> List[T.Augmentation]:
    """The test-time augmentation from the config: ``ResizeShortestEdge``
    to ``INPUT.MIN_SIZE_TEST`` with the long edge capped at
    ``INPUT.MAX_SIZE_TEST``. The training augmentations wait for the train
    half of the data path (ROADMAP A2)."""
    if is_train:
        raise NotImplementedError("training augmentations are not ported yet (ROADMAP A2, train half)")
    return [T.ResizeShortestEdge(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST, "choice")]
