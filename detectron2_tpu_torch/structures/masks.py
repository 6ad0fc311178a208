"""Instance masks (counterpart of ``detectron2_tpu/structures/masks.py``):
``BitMasks`` :83, an ``[N, H, W]`` bool tensor, and ``PolygonMasks`` :191,
a list of polygons per instance, with what inference results and the
training data path need: ``nonempty``, ``get_bounding_boxes``, indexing,
``area`` and ``crop_and_resize`` into the gt boxes.

Both crops run on the host in the loader. ``PolygonMasks`` rasterizes each
instance's polygons inside its box with ``evaluation/rle.py``'s
``polygons_to_mask`` (OpenCV's ``fillPoly`` restated in numpy).
``BitMasks`` pools its masks with the plain RoIAlign (``aligned=True``,
``sampling_ratio=0``) and thresholds at 0.5, the function the JAX package
computes with ``roi_align_separable``, an XLA formulation and no Pallas
kernel.
"""

from typing import Any, List, Union

import numpy as np
import torch

from detectron2_tpu_torch.structures.boxes import Boxes

__all__ = ["BitMasks", "PolygonMasks", "polygons_to_bitmask", "rasterize_polygons_within_box", "polygon_area"]


def polygon_area(x: np.ndarray, y: np.ndarray) -> float:
    """The shoelace formula."""
    return 0.5 * np.abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def polygons_to_bitmask(polygons: List[np.ndarray], height: int, width: int) -> np.ndarray:
    """Fill flat (x0, y0, x1, y1, ...) polygons into an ``[height, width]``
    bool mask; no polygons give an empty mask."""
    if len(polygons) == 0:
        return np.zeros((height, width), dtype=bool)
    from detectron2_tpu_torch.evaluation.rle import polygons_to_mask

    return polygons_to_mask(polygons, height, width).astype(bool)


def rasterize_polygons_within_box(polygons: List[np.ndarray], box: np.ndarray, mask_size: int) -> np.ndarray:
    """The polygons shifted to ``box``'s corner and scaled by ``mask_size``
    over its size (at least 0.1 px), filled at ``mask_size`` x
    ``mask_size``: bool ``[mask_size, mask_size]``."""
    w, h = box[2] - box[0], box[3] - box[1]
    polygons = [np.asarray(p, dtype=np.float64).copy() for p in polygons]
    for p in polygons:
        p[0::2] = p[0::2] - box[0]
        p[1::2] = p[1::2] - box[1]
    ratio_h = mask_size / max(h, 0.1)
    ratio_w = mask_size / max(w, 0.1)
    for p in polygons:
        p[0::2] = p[0::2] * ratio_w
        p[1::2] = p[1::2] * ratio_h
    return polygons_to_bitmask(polygons, mask_size, mask_size)


def _boxes_array(boxes) -> np.ndarray:
    t = boxes.tensor if isinstance(boxes, Boxes) else boxes
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class BitMasks:
    """``tensor`` is ``[N, H, W]`` bool, one full-image mask per instance."""

    def __init__(self, tensor: Union[torch.Tensor, np.ndarray]):
        tensor = torch.as_tensor(tensor).bool()
        assert tensor.dim() == 3, tuple(tensor.shape)
        self.tensor = tensor

    def area(self) -> torch.Tensor:
        """Pixels set in each mask, ``[N]`` int64."""
        return self.tensor.flatten(1).sum(dim=1)

    def nonempty(self) -> torch.Tensor:
        """``[N]`` bool: the masks with a pixel set."""
        return self.tensor.flatten(1).any(dim=1)

    def get_bounding_boxes(self) -> Boxes:
        """The tight box of each mask (all zeros for an empty one)."""
        masks = self.tensor.cpu().numpy()
        boxes = np.zeros((masks.shape[0], 4), dtype=np.float32)
        x_any, y_any = masks.any(axis=1), masks.any(axis=2)
        for i in range(masks.shape[0]):
            x, y = np.where(x_any[i])[0], np.where(y_any[i])[0]
            if len(x) and len(y):
                boxes[i] = (x[0], y[0], x[-1] + 1, y[-1] + 1)
        return Boxes(torch.from_numpy(boxes))

    def crop_and_resize(self, boxes, mask_size: int) -> torch.Tensor:
        """Each mask pooled inside its box to ``mask_size`` x ``mask_size``
        by the plain RoIAlign (aligned, sampling ratio 0) and thresholded at
        0.5: ``[N, mask_size, mask_size]`` bool, on the masks' device."""
        from detectron2_tpu_torch.ops.roi_align import roi_align_separable

        n = self.tensor.shape[0]
        boxes_t = torch.as_tensor(_boxes_array(boxes), dtype=torch.float32, device=self.tensor.device)
        assert boxes_t.shape[0] == n, f"{boxes_t.shape[0]} != {n}"
        if n == 0:
            return torch.zeros((0, mask_size, mask_size), dtype=torch.bool, device=self.tensor.device)
        src = torch.arange(n, dtype=torch.int32, device=self.tensor.device)
        return roi_align_separable(self.tensor, boxes_t, src, (mask_size, mask_size), 0, True) >= 0.5

    def __getitem__(self, item) -> "BitMasks":
        """An int picks one mask (still ``[1, H, W]``); a slice, an index
        array or a bool mask picks several."""
        if isinstance(item, int):
            return BitMasks(self.tensor[item][None])
        if isinstance(item, np.ndarray):
            item = torch.from_numpy(item)
        return BitMasks(self.tensor[item])

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __repr__(self) -> str:
        return f"BitMasks(num_instances={len(self)})"


class PolygonMasks:
    """``polygons[i]`` is instance i's list of float64 flat (x0, y0, x1, y1,
    ...) polygons, each with at least 3 points."""

    def __init__(self, polygons: List[List[Union[np.ndarray, Any]]]):
        if not isinstance(polygons, list):
            raise ValueError(
                "Cannot create PolygonMasks: Expect a list of list of polygons per image. "
                f"Got '{type(polygons)}' instead."
            )

        def process_polygons(polygons_per_instance) -> List[np.ndarray]:
            if not isinstance(polygons_per_instance, list):
                raise ValueError(
                    "Cannot create polygons: Expect a list of polygons per instance. "
                    f"Got '{type(polygons_per_instance)}' instead."
                )
            out = [np.asarray(p).astype(np.float64) for p in polygons_per_instance]
            for polygon in out:
                if len(polygon) % 2 != 0 or len(polygon) < 6:
                    raise ValueError(f"Cannot create a polygon from {len(polygon)} coordinates.")
            return out

        self.polygons: List[List[np.ndarray]] = [process_polygons(p) for p in polygons]

    def get_bounding_boxes(self) -> Boxes:
        """The extent of each instance's polygons."""
        boxes = np.zeros((len(self.polygons), 4), dtype=np.float32)
        for i, polygons_per_instance in enumerate(self.polygons):
            minxy = np.array([float("inf"), float("inf")])
            maxxy = np.zeros(2)
            for polygon in polygons_per_instance:
                coords = polygon.reshape(-1, 2)
                minxy = np.minimum(minxy, coords.min(axis=0))
                maxxy = np.maximum(maxxy, coords.max(axis=0))
            boxes[i, :2] = minxy
            boxes[i, 2:] = maxxy
        return Boxes(torch.from_numpy(boxes))

    def nonempty(self) -> torch.Tensor:
        """``[N]`` bool: the instances with a polygon."""
        return torch.tensor([len(p) > 0 for p in self.polygons], dtype=torch.bool)

    def __getitem__(self, item) -> "PolygonMasks":
        """An int, a slice, a list of ints, or an index array or bool mask
        (numpy or tensor)."""
        if isinstance(item, int):
            selected = [self.polygons[item]]
        elif isinstance(item, slice):
            selected = self.polygons[item]
        elif isinstance(item, list):
            selected = [self.polygons[i] for i in item]
        else:
            idx = item.cpu().numpy() if isinstance(item, torch.Tensor) else np.asarray(item)
            if idx.dtype == np.bool_:
                assert idx.ndim == 1, idx.shape
                idx = np.nonzero(idx)[0]
            selected = [self.polygons[int(i)] for i in idx]
        return PolygonMasks(selected)

    def __len__(self) -> int:
        return len(self.polygons)

    def __repr__(self) -> str:
        return f"PolygonMasks(num_instances={len(self.polygons)})"

    def crop_and_resize(self, boxes, mask_size: int) -> torch.Tensor:
        """Each instance's polygons filled inside its box at ``mask_size`` x
        ``mask_size``: ``[N, mask_size, mask_size]`` bool."""
        boxes_np = _boxes_array(boxes)
        assert boxes_np.shape[0] == len(self), f"{boxes_np.shape[0]} != {len(self)}"
        results = [rasterize_polygons_within_box(p, box, mask_size) for p, box in zip(self.polygons, boxes_np)]
        if not results:
            return torch.zeros((0, mask_size, mask_size), dtype=torch.bool)
        return torch.from_numpy(np.stack(results))

    def area(self) -> np.ndarray:
        """Each instance's polygon area (COCO's "area")."""
        return np.asarray([sum(polygon_area(p[0::2], p[1::2]) for p in ps) for ps in self.polygons])
