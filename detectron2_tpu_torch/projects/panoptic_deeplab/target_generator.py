"""Panoptic-DeepLab's training targets on the host (counterpart of the JAX
package's ``projects/panoptic_deeplab/target_generator.py``), in numpy,
with the same arithmetic: a panoptic id map and its segments -> the
semantic map, the Gaussian center heatmap, each pixel's offset to its
instance's mass center, and the two loss weight maps."""

from typing import Dict, List

import numpy as np

__all__ = ["PanopticDeepLabTargetGenerator"]


class PanopticDeepLabTargetGenerator:
    def __init__(
        self,
        ignore_label: int,
        thing_ids: List[int],
        sigma: int = 8,
        ignore_stuff_in_offset: bool = True,
        small_instance_area: int = 4096,
        small_instance_weight: int = 3,
        ignore_crowd_in_semantic: bool = False,
    ):
        self.ignore_label = ignore_label
        self.thing_ids = set(thing_ids)
        self.sigma = sigma
        self.ignore_stuff_in_offset = ignore_stuff_in_offset
        self.small_instance_area = small_instance_area
        self.small_instance_weight = small_instance_weight
        self.ignore_crowd_in_semantic = ignore_crowd_in_semantic
        # the Gaussian stamp, 6 sigma + 3 on a side
        size = 6 * sigma + 3
        x = np.arange(size, dtype=np.float64)
        y = x[:, None]
        x0 = y0 = 3 * sigma + 1
        self.g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma**2))

    def __call__(self, panoptic: np.ndarray, segments_info: List[Dict]) -> Dict[str, np.ndarray]:
        """``panoptic`` ``[H, W]`` segment ids; ``segments_info`` dicts of
        ``id``, ``category_id`` (contiguous) and ``iscrowd``. Returns
        ``gt_sem_seg`` (int64), ``gt_center``, ``gt_offset`` ``[H, W, 2]``
        (dy, dx), ``gt_center_weights`` and ``gt_offset_weights``."""
        H, W = panoptic.shape
        sem = np.full((H, W), self.ignore_label, np.int64)
        center = np.zeros((H, W), np.float32)
        offset = np.zeros((H, W, 2), np.float32)
        center_w = np.zeros((H, W), np.float32)
        offset_w = np.zeros((H, W), np.float32)
        yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        for seg in segments_info:
            cat = seg["category_id"]
            crowd = seg.get("iscrowd", 0)
            mask = panoptic == seg["id"]
            if not mask.any():
                continue
            if not (crowd and self.ignore_crowd_in_semantic):
                sem[mask] = cat
            is_thing = cat in self.thing_ids
            if self.ignore_stuff_in_offset:
                if is_thing and not crowd:
                    offset_w[mask] = 1.0
            else:
                offset_w[mask] = 1.0
            center_w[mask] = 1.0
            if not is_thing or crowd:
                continue
            area = int(mask.sum())
            w = self.small_instance_weight if area < self.small_instance_area else 1
            center_w[mask] = w
            if self.ignore_stuff_in_offset:
                offset_w[mask] = w
            cy, cx = yy[mask].mean(), xx[mask].mean()
            # the stamp around (cy, cx), clipped to the frame
            s = self.sigma
            ul = (int(round(cx)) - 3 * s - 1, int(round(cy)) - 3 * s - 1)
            br = (ul[0] + 6 * s + 3, ul[1] + 6 * s + 3)
            gx0, gx1 = max(0, -ul[0]), min(br[0], W) - ul[0]
            gy0, gy1 = max(0, -ul[1]), min(br[1], H) - ul[1]
            ix0, ix1 = max(0, ul[0]), min(br[0], W)
            iy0, iy1 = max(0, ul[1]), min(br[1], H)
            if ix1 > ix0 and iy1 > iy0:
                center[iy0:iy1, ix0:ix1] = np.maximum(center[iy0:iy1, ix0:ix1], self.g[gy0:gy1, gx0:gx1])
            offset[mask, 0] = cy - yy[mask]
            offset[mask, 1] = cx - xx[mask]
        return {
            "gt_sem_seg": sem,
            "gt_center": center,
            "gt_offset": offset,
            "gt_center_weights": center_w,
            "gt_offset_weights": offset_w,
        }
