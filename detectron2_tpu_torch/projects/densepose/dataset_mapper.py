"""The DensePose data pipeline: mapper and padded-batch collator (counterpart of
``detectron2_tpu/projects/densepose/dataset_mapper.py:41,143,253``).

The mapper carries each person's ``dp_*`` chart annotations through the
augmentations as :class:`DensePoseDataRelative` (box-relative, so a resize
or crop moves the box and not the points; a flip swaps the part semantics)
and attaches fixed-size point arrays to the Instances. The collator stacks
them into the batch targets the DensePose loss reads:

    gt_dp_points  [B, G, P, 2]  absolute (x, y) in the network input frame
    gt_dp_part    [B, G, P]     the points' parts dp_I, 1..24, -1 padding
    gt_dp_u/v     [B, G, P]     chart coordinates in [0, 1]
    gt_dp_vertex  [B, G, P]     CSE: the points' mesh vertex ids, -1 padding
    gt_dp_mesh_id [B, G]        CSE: the ``MeshCatalog`` id of each
                                instance's mesh (``ref_model``, SMPL when
                                absent, as in the JAX mapper), -1 padding

The CSE keys come only in batches with CSE annotations (the JAX collator
emits them all padding on chart data too). With
``COARSE_SEGM_TRAINED_BY_MASKS`` the mapper keeps the instance masks and
the collator rasterizes them at ``HEATMAP_SIZE`` (d2's DensePose mapper
turns the masks on for it). The DensePose splits are registered with the
builtin datasets
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
        ret["use_instance_mask"] = cfg.MODEL.MASK_ON or cfg.MODEL.ROI_DENSEPOSE_HEAD.COARSE_SEGM_TRAINED_BY_MASKS
        return ret

    def _transform_annotations(self, dataset_dict: dict, transforms, image_shape) -> None:
        # one entry per non-crowd annotation (the records the base keeps),
        # taken before the base transform drops the dp keys
        dp_datas = []
        for obj in dataset_dict["annotations"]:
            if obj.get("iscrowd", 0):
                continue
            ok, _ = DensePoseDataRelative.validate_annotation(obj)
            if ok and (DensePoseDataRelative.I_KEY in obj or DensePoseDataRelative.VERTEX_IDS_KEY in obj):
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

        from detectron2_tpu_torch.projects.densepose.meshes import MeshCatalog

        G, P = len(instances), self.max_points
        pts = np.zeros((G, P, 2), np.float32)
        part = np.full((G, P), -1, np.int64)
        u = np.zeros((G, P), np.float32)
        v = np.zeros((G, P), np.float32)
        vert = np.full((G, P), -1, np.int64)
        mesh_id = np.full((G,), -1, np.int64)
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
            if hasattr(dp, "i"):
                part[g, :n] = dp.i[:n]
                u[g, :n] = np.clip(dp.u[:n], 0.0, 1.0)
                v[g, :n] = np.clip(dp.v[:n], 0.0, 1.0)
            if hasattr(dp, "vertex_ids"):
                vert[g, :n] = dp.vertex_ids[:n]
                mesh_id[g] = MeshCatalog.mesh_ids.get(getattr(dp, "mesh_name", None) or "smpl_27554", -1)
        instances.gt_dp_points = pts
        instances.gt_dp_part = part
        instances.gt_dp_u = u
        instances.gt_dp_v = v
        if any(dp is not None and hasattr(dp, "vertex_ids") for dp in dp_datas):
            instances.gt_dp_vertex = vert
            instances.gt_dp_mesh_id = mesh_id
        dataset_dict["instances"] = utils.filter_empty_instances(instances)


class DensePoseBatchCollator(PaddedBatchCollator):
    """PaddedBatchCollator that also stacks the per-instance point arrays
    into ``[B, max_gt_instances, P, ...]`` targets (-1 / 0 padding), and the
    CSE vertex and mesh ids when a sample has them. ``dp_mask_size``: the gt
    masks' size when the config asks for none (``MASK_ON`` off) and the
    DensePose loss needs them."""

    def __init__(self, *args, dp_mask_size: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        if self.mask_size == 0:
            self.mask_size = dp_mask_size

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
        vert = np.full((B, G, P), -1, np.int64)
        mesh_id = np.full((B, G), -1, np.int64)
        has_cse = any(inst.has("gt_dp_vertex") for inst in with_pts)
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
            if inst.has("gt_dp_vertex"):
                vert[i, :g, :p] = inst.gt_dp_vertex[:g]
                mesh_id[i, :g] = inst.gt_dp_mesh_id[:g]
        out.update(
            gt_dp_points=torch.from_numpy(pts), gt_dp_part=torch.from_numpy(part),
            gt_dp_u=torch.from_numpy(u), gt_dp_v=torch.from_numpy(v),
        )
        if has_cse:
            out.update(gt_dp_vertex=torch.from_numpy(vert), gt_dp_mesh_id=torch.from_numpy(mesh_id))
        return out
