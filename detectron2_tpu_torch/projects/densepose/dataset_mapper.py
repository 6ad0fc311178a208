"""The DensePose data pipeline: mapper and padded-batch collator (counterpart of
``detectron2_tpu/projects/densepose/dataset_mapper.py:41,143,253``).

The mapper carries each person's ``dp_*`` chart annotations through the
augmentations as :class:`DensePoseDataRelative` (box-relative, so a resize
or crop moves the box and not the points; a flip swaps the part semantics)
and attaches fixed-size point arrays to the Instances. The collator stacks
them into the batch targets the DensePose loss reads:

    gt_dp_points [B, G, P, 2]  absolute (x, y) in the network input frame
    gt_dp_part   [B, G, P]     the points' parts dp_I, 1..24, -1 padding
    gt_dp_u/v    [B, G, P]     chart coordinates in [0, 1]

The CSE annotations (``dp_vertex``) and their splits are ROADMAP A10; the
JAX collator's ``gt_dp_vertex`` / ``gt_dp_mesh_id`` are all padding on
chart data, and the port does not emit them. The chart DensePose-COCO splits
are registered with the builtin datasets
(:func:`~detectron2_tpu_torch.data.datasets.builtin.register_densepose_coco`).
"""

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from detectron2_tpu_torch.config import configurable
from detectron2_tpu_torch.data import detection_utils as utils
from detectron2_tpu_torch.data.build import PaddedBatchCollator
from detectron2_tpu_torch.data.dataset_mapper import DatasetMapper
from detectron2_tpu_torch.data.datasets.builtin import register_densepose_coco
from detectron2_tpu_torch.projects.densepose.structures import DensePoseDataRelative, DensePoseTransformData

__all__ = ["DensePoseDatasetMapper", "DensePoseBatchCollator", "DP_MAX_POINTS", "register_densepose_coco"]

# the chart splits are builtin names of the port's catalog

# DensePose-COCO annotates at most ~184 points a person; the losses read all
DP_MAX_POINTS = 196


class DensePoseDatasetMapper(DatasetMapper):
    """DatasetMapper that also transforms and packs the ``dp_*``
    annotations. ``UV_SYMMETRY_PATH`` names a pickle of the UV symmetry
    tables; without it a flip leaves U and V as they are."""

    @configurable
    def __init__(
        self, *args, densepose_transform_data: Optional[DensePoseTransformData] = None,
        max_points: int = DP_MAX_POINTS, **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.densepose_transform_data = densepose_transform_data or DensePoseTransformData()
        self.max_points = max_points

    @classmethod
    def from_config(cls, cfg, is_train: bool = True):
        ret = super().from_config(cfg, is_train)
        fpath = cfg.MODEL.ROI_DENSEPOSE_HEAD.UV_SYMMETRY_PATH
        ret["densepose_transform_data"] = DensePoseTransformData.load(fpath) if fpath else None
        return ret

    def _transform_annotations(self, dataset_dict: dict, transforms, image_shape) -> None:
        # one entry per non-crowd annotation (the records the base keeps),
        # taken before the base transform drops the dp keys
        dp_datas = []
        for obj in dataset_dict["annotations"]:
            if obj.get("iscrowd", 0):
                continue
            ok, _ = DensePoseDataRelative.validate_annotation(obj)
            if ok and DensePoseDataRelative.I_KEY in obj:
                dp = DensePoseDataRelative(obj, cleanup=True)
                dp.apply_transform(transforms, self.densepose_transform_data)
                dp_datas.append(dp)
            else:
                DensePoseDataRelative.cleanup_annotation(obj)
                dp_datas.append(None)
        annos = [
            utils.transform_instance_annotations(
                obj, transforms, image_shape, keypoint_hflip_indices=self.keypoint_hflip_indices
            )
            for obj in dataset_dict.pop("annotations")
            if obj.get("iscrowd", 0) == 0
        ]
        instances = utils.annotations_to_instances(annos, image_shape, mask_format=self.instance_mask_format)
        if self.recompute_boxes and instances.has("gt_masks"):
            instances.gt_boxes = instances.gt_masks.get_bounding_boxes()
        assert len(dp_datas) == len(instances), (len(dp_datas), len(instances))

        G, P = len(instances), self.max_points
        pts = np.zeros((G, P, 2), np.float32)
        part = np.full((G, P), -1, np.int64)
        u = np.zeros((G, P), np.float32)
        v = np.zeros((G, P), np.float32)
        boxes = instances.gt_boxes.tensor.numpy().astype(np.float64) if G else np.zeros((0, 4))
        for g, dp in enumerate(dp_datas):
            if dp is None:
                continue
            n = min(len(dp.x), P)
            x0, y0, x1, y1 = boxes[g]
            w, h = max(x1 - x0, 1e-4), max(y1 - y0, 1e-4)
            # box-relative [0, 255] -> the input frame: x0 + x * w / 256
            pts[g, :n, 0] = x0 + dp.x[:n] * w / DensePoseDataRelative.MASK_SIZE
            pts[g, :n, 1] = y0 + dp.y[:n] * h / DensePoseDataRelative.MASK_SIZE
            part[g, :n] = dp.i[:n]
            u[g, :n] = np.clip(dp.u[:n], 0.0, 1.0)
            v[g, :n] = np.clip(dp.v[:n], 0.0, 1.0)
        instances.gt_dp_points = pts
        instances.gt_dp_part = part
        instances.gt_dp_u = u
        instances.gt_dp_v = v
        dataset_dict["instances"] = utils.filter_empty_instances(instances)


class DensePoseBatchCollator(PaddedBatchCollator):
    """PaddedBatchCollator that also stacks the per-instance point arrays
    into ``[B, max_gt_instances, P, ...]`` targets (-1 / 0 padding)."""

    def __call__(self, batch_list: List[dict]) -> Dict[str, Any]:
        out = super().__call__(batch_list)
        with_pts = [d["instances"] for d in batch_list if "instances" in d and d["instances"].has("gt_dp_points")]
        if not with_pts:
            return out
        B, G = len(batch_list), self.max_gt_instances
        P = max(inst.gt_dp_points.shape[1] for inst in with_pts)
        pts = np.zeros((B, G, P, 2), np.float32)
        part = np.full((B, G, P), -1, np.int64)
        u = np.zeros((B, G, P), np.float32)
        v = np.zeros((B, G, P), np.float32)
        for i, d in enumerate(batch_list):
            inst = d.get("instances")
            if inst is None or not inst.has("gt_dp_points"):
                continue
            g = min(len(inst), G)
            p = inst.gt_dp_points.shape[1]
            pts[i, :g, :p] = inst.gt_dp_points[:g]
            part[i, :g, :p] = inst.gt_dp_part[:g]
            u[i, :g, :p] = inst.gt_dp_u[:g]
            v[i, :g, :p] = inst.gt_dp_v[:g]
        out.update(
            gt_dp_points=torch.from_numpy(pts), gt_dp_part=torch.from_numpy(part),
            gt_dp_u=torch.from_numpy(u), gt_dp_v=torch.from_numpy(v),
        )
        return out
