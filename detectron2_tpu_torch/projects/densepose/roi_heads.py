"""DensePoseROIHeads, the chart branch (counterpart of
``detectron2_tpu/projects/densepose/roi_heads.py:40``): StandardROIHeads
plus the DensePose IUV branch, registered in ``ROI_HEADS_REGISTRY``.

The pool: with ``DECODER_ON`` the FPN decoder's single stride-4 map, pooled
by :func:`~detectron2_tpu_torch.ops.roi_align.roi_align_separable_chan` (two
batched products; person boxes span hundreds of pixels there); otherwise the
FPN levels through ``ROIPooler``, the RoIAlign kernel on the card (the
``_legacy`` configs' 14x14 pool). Both take the box head's pooler type and
the DensePose head's resolution and sampling ratio.

Training: of the sampled slots, up to ``MAX_TRAIN_INSTANCES`` per image
that are foreground, whose IoU with their matched gt is at least
``FG_IOU_THRESHOLD`` and whose gt carries annotated points (the padded form
of d2's DensePoseDataFilter), through ``select_foreground_slots``. Each
slot's gt points go into its box frame and the predictor's maps are sampled
there (``point_sample``): cross entropy of the fine segmentation against
the point's part ``dp_I`` (1..24; 0 is the background channel), of the
coarse segmentation against channel 1 (every annotated point is on the
body), and smooth L1 of U and V at the part's channel, or with
``UV_CONFIDENCE`` the confidence loss. Losses ``loss_densepose_{I,S,U,V}``
(``loss_densepose_UV`` with confidences), each a mean over the valid
points. The JAX loss takes ``dp_I + 1`` as the class (ROADMAP C).

Inference: the branch runs on the first ``MAX_INFERENCE_INSTANCES``
detection slots (they come score-sorted); ``pred_densepose`` ``[B, D, M, M,
3]`` holds per pixel the part (the fine argmax where the coarse argmax is
foreground, else 0) and its U and V clipped to [0, 1], zeros on the slots
not run. ``RAW_OUTPUTS`` adds the predictor's maps as
``pred_densepose_raw`` (``[B, D, M, M, C]`` each, the bootstrap samplers'
input).

``COARSE_SEGM_TRAINED_BY_MASKS``: the coarse segmentation is trained by the
dense cross entropy against each slot's crop of its gt instance mask at the
segmentation's resolution (d2's ``MaskOrSegmentationLoss``), a mean over
the slots; a gt then qualifies with a mask as well as with points.

CSE (the embedding predictor, ``embedder`` of ``CSE.EMBEDDERS``, one
``roi_heads.embedder.<mesh>`` a mesh): the coarse segmentation as above,
and per mesh ``loss_densepose_E_<mesh>``, the embedding loss
(``EmbeddingLoss``, or ``SoftEmbeddingLoss`` with the mesh's geodesics) of
the points whose instance's mesh (``gt_dp_mesh_id``, a ``MeshCatalog`` id)
is that mesh, as one set of points (the JAX package masks the whole padded
set for every mesh; the masked mean is the same; a mesh without points
gives 0 and leaves its embedder without a gradient, as in d2). ``loss_shape2shape``: the
shape-to-shape cycle loss of one mesh pair drawn each step, on the vertex
subsample of ``build_cycle_mesh_data`` (``MAX_NUM_VERTICES``);
``loss_pix2shape``: the pixel-to-shape cycle loss of each slot against its
own mesh (every mesh with ``USE_ALL_MESHES_NOT_GT_ONLY``), a mean over the
(slot, mesh) pairs whose slot's mask has foreground. Inference writes
``pred_densepose_embedding`` ``[B, D, M, M, E]`` and ``pred_densepose_fg``
``[B, D, M, M]`` (the coarse argmax), zeros past the first
``MAX_INFERENCE_INSTANCES`` slots; ``DATASETS.CLASS_TO_MESH_NAME_MAPPING``
gives each class's mesh (:meth:`DensePoseROIHeads.mesh_vertex_embeddings`,
:meth:`DensePoseROIHeads.closest_vertices`).
"""

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers.losses import smooth_l1_loss
from detectron2_tpu_torch.modeling.poolers import ROIPooler
from detectron2_tpu_torch.modeling.roi_heads.roi_heads import (
    ROI_HEADS_REGISTRY,
    StandardROIHeads,
    _batch_index,
    crop_gt_masks_to_proposals,
    select_foreground_slots,
)
from detectron2_tpu_torch.projects.densepose import cse
from detectron2_tpu_torch.ops.roi_align import roi_align_separable_chan
from detectron2_tpu_torch.projects.densepose.config import is_cse
from detectron2_tpu_torch.projects.densepose.confidences import (
    iid_isotropic_gaussian_uv_loss,
    indep_anisotropic_gaussian_uv_loss,
)
from detectron2_tpu_torch.projects.densepose.densepose_head import (
    DensePoseDecoder,
    build_densepose_head,
    build_densepose_predictor,
)
from detectron2_tpu_torch.projects.point_rend.point_features import point_sample
from detectron2_tpu_torch.projects.point_sup.point_utils import get_point_coords_from_point_annotation

__all__ = ["DensePoseROIHeads"]


def draw_pair(n_pairs: int, generator: Optional[torch.Generator], device) -> int:
    """The shape-to-shape loss's mesh pair of a step, uniform over
    ``n_pairs`` (the JAX package draws it from its sampling key)."""
    return int(torch.randint(n_pairs, (), generator=generator, device=device).item())


def _cse_setup(cfg) -> dict:
    """The CSE keyword arguments of :class:`DensePoseROIHeads`: the
    embedder with its ``INIT_FILE`` features, each mesh's ``MeshCatalog``
    id, the losses' options and the class -> mesh mapping. The meshes'
    geodesics are read at the first step that needs them."""
    from detectron2_tpu_torch.projects.densepose.meshes import MeshCatalog

    h = cfg.MODEL.ROI_DENSEPOSE_HEAD
    specs = cse.embedder_specs_from_cfg(cfg)
    embedder = None
    if specs:
        embedder = cse.Embedder(specs)
        cse.load_embedder_features(embedder, cse.embedder_init_files_from_cfg(cfg))
    names = tuple(s[0] for s in specs)
    s2s, p2s = h.CSE.SHAPE_TO_SHAPE_CYCLE_LOSS, h.CSE.PIX_TO_SHAPE_CYCLE_LOSS
    class_to_mesh = {int(k): str(v) for k, v in cfg.DATASETS.CLASS_TO_MESH_NAME_MAPPING.items()}
    missing = sorted({m for m in class_to_mesh.values() if m not in names}) if embedder is not None else []
    if missing:
        raise ValueError(f"CLASS_TO_MESH_NAME_MAPPING names meshes without an embedder: {missing}")
    return dict(
        embedder=embedder,
        cse_mesh_ids=tuple(MeshCatalog.mesh_ids.get(n, -1) for n in names),
        embdist_gauss_sigma=h.CSE.EMBEDDING_DIST_GAUSS_SIGMA,
        embed_loss_weight=h.CSE.EMBED_LOSS_WEIGHT,
        embed_loss_name=h.CSE.EMBED_LOSS_NAME,
        geodist_gauss_sigma=h.CSE.GEODESIC_DIST_GAUSS_SIGMA,
        shape2shape_weight=s2s.WEIGHT if s2s.ENABLED else 0.0,
        shape2shape_temperature=s2s.TEMPERATURE,
        shape2shape_norm_p=int(s2s.NORM_P),
        shape2shape_max_num_vertices=int(s2s.MAX_NUM_VERTICES),
        pix2shape_weight=p2s.WEIGHT if p2s.ENABLED else 0.0,
        pix2shape_num_pixels=int(p2s.NUM_PIXELS_TO_SAMPLE),
        pix2shape_temp_pix2v=p2s.TEMPERATURE_PIXEL_TO_VERTEX,
        pix2shape_temp_v2pix=p2s.TEMPERATURE_VERTEX_TO_PIXEL,
        pix2shape_norm_p=int(p2s.NORM_P),
        pix2shape_all_meshes=bool(p2s.USE_ALL_MESHES_NOT_GT_ONLY),
        class_to_mesh_name=class_to_mesh,
    )


def _gather_slots(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, r]]`` for ``x`` ``[B, G, ...]`` and ``idx`` ``[B, R]``."""
    index = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, index)


def _matched_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """IoU of matched box pairs ``[..., 4]`` -> ``[...]``."""
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    wh = (torch.minimum(b1[..., 2:], b2[..., 2:]) - torch.maximum(b1[..., :2], b2[..., :2])).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(inter > 0, iou, torch.zeros_like(iou))


@ROI_HEADS_REGISTRY.register()
class DensePoseROIHeads(StandardROIHeads):
    def __init__(
        self,
        *,
        densepose_head: Optional[nn.Module] = None,
        densepose_predictor: Optional[nn.Module] = None,
        decoder: Optional[DensePoseDecoder] = None,
        densepose_pooler: Optional[ROIPooler] = None,
        densepose_pooler_resolution: int = 28,
        densepose_pooler_sampling_ratio: int = 2,
        index_weight: float = 5.0,
        part_weight: float = 1.0,
        point_regression_weight: float = 0.01,
        uv_confidence: str = "none",
        raw_outputs: bool = False,
        max_inference_instances: int = 24,
        max_train_instances: int = 32,
        densepose_fg_iou_threshold: float = 0.7,
        segm_trained_by_masks: bool = False,
        embedder: Optional[cse.Embedder] = None,
        cse_mesh_ids: tuple = (),
        embdist_gauss_sigma: float = 0.01,
        embed_loss_weight: float = 0.6,
        embed_loss_name: str = "EmbeddingLoss",
        geodist_gauss_sigma: float = 0.01,
        shape2shape_weight: float = 0.0,
        shape2shape_temperature: float = 0.05,
        shape2shape_norm_p: int = 2,
        shape2shape_max_num_vertices: int = 4936,
        pix2shape_weight: float = 0.0,
        pix2shape_num_pixels: int = 100,
        pix2shape_temp_pix2v: float = 0.05,
        pix2shape_temp_v2pix: float = 0.05,
        pix2shape_norm_p: int = 2,
        pix2shape_all_meshes: bool = False,
        class_to_mesh_name: Optional[Dict[int, str]] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.segm_trained_by_masks = segm_trained_by_masks
        # CSE: the embedder and the meshes' constants (non-persistent
        # buffers: they move with the model and stay out of checkpoints)
        self.embedder = embedder
        self.cse_mesh_names = embedder.mesh_names if embedder is not None else ()
        self.cse_mesh_ids = tuple(cse_mesh_ids)
        self.embdist_gauss_sigma = embdist_gauss_sigma
        self.embed_loss_weight = embed_loss_weight
        self.embed_loss_name = embed_loss_name
        self.geodist_gauss_sigma = geodist_gauss_sigma
        self.shape2shape_weight = shape2shape_weight
        self.shape2shape_temperature = shape2shape_temperature
        self.shape2shape_norm_p = shape2shape_norm_p
        self.shape2shape_max_num_vertices = shape2shape_max_num_vertices
        self.cycle_mesh_names = ()  # with their buffers, at the first shape-to-shape step
        self.pix2shape_weight = pix2shape_weight
        self.pix2shape_num_pixels = pix2shape_num_pixels
        self.pix2shape_temp_pix2v = pix2shape_temp_pix2v
        self.pix2shape_temp_v2pix = pix2shape_temp_v2pix
        self.pix2shape_norm_p = pix2shape_norm_p
        self.pix2shape_all_meshes = pix2shape_all_meshes
        self.class_to_mesh_name = dict(class_to_mesh_name or {})
        self._generator = None
        self.densepose_head = densepose_head
        self.densepose_predictor = densepose_predictor
        self.decoder = decoder
        self.densepose_pooler = densepose_pooler
        self.densepose_pooler_resolution = densepose_pooler_resolution
        self.densepose_pooler_sampling_ratio = densepose_pooler_sampling_ratio
        self.index_weight = index_weight
        self.part_weight = part_weight
        self.point_regression_weight = point_regression_weight
        self.uv_confidence = uv_confidence
        self.raw_outputs = raw_outputs
        self.max_inference_instances = max_inference_instances
        self.max_train_instances = max_train_instances
        self.densepose_fg_iou_threshold = densepose_fg_iou_threshold

    @classmethod
    def from_config(cls, cfg, input_shape) -> "DensePoseROIHeads":
        if not cfg.MODEL.DENSEPOSE_ON:
            return super().from_config(cfg, input_shape)
        h = cfg.MODEL.ROI_DENSEPOSE_HEAD
        in_features = cfg.MODEL.ROI_HEADS.IN_FEATURES
        bh = cfg.MODEL.ROI_BOX_HEAD
        decoder = DensePoseDecoder.from_config(cfg, input_shape, in_features) if h.DECODER_ON else None
        head = build_densepose_head(cfg, h.DECODER_NUM_CLASSES if decoder else input_shape[in_features[0]].channels)
        pooler = None
        if decoder is None:
            scales = tuple(1.0 / input_shape[f].stride for f in in_features)
            pooler = ROIPooler(h.POOLER_RESOLUTION, scales, h.POOLER_SAMPLING_RATIO, bh.POOLER_TYPE)
        return super().from_config(
            cfg, input_shape,
            densepose_head=head,
            densepose_predictor=build_densepose_predictor(cfg, h.CONV_HEAD_DIM),
            decoder=decoder,
            densepose_pooler=pooler,
            densepose_pooler_resolution=h.POOLER_RESOLUTION,
            densepose_pooler_sampling_ratio=h.POOLER_SAMPLING_RATIO,
            index_weight=h.INDEX_WEIGHTS,
            part_weight=h.PART_WEIGHTS,
            point_regression_weight=h.POINT_REGRESSION_WEIGHTS,
            uv_confidence=h.UV_CONFIDENCE.TYPE if h.UV_CONFIDENCE.ENABLED else "none",
            raw_outputs=h.RAW_OUTPUTS,
            max_inference_instances=h.MAX_INFERENCE_INSTANCES,
            max_train_instances=h.MAX_TRAIN_INSTANCES,
            densepose_fg_iou_threshold=h.FG_IOU_THRESHOLD,
            segm_trained_by_masks=h.COARSE_SEGM_TRAINED_BY_MASKS,
            **(_cse_setup(cfg) if is_cse(cfg) else {}),
        )

    def forward_with_given_boxes(self, features: Dict[str, torch.Tensor], detections: Dict) -> Dict:
        detections = super().forward_with_given_boxes(features, detections)
        if self.densepose_head is not None:
            detections = self._forward_densepose_inference([features[f] for f in self.in_features], detections)
        return detections

    def forward_train(self, features, proposal_boxes, proposal_logits, proposal_valid, targets, generator=None,
                      image_sizes=None):
        # the CSE cycle losses draw from the step's generator
        self._generator = generator
        try:
            return super().forward_train(
                features, proposal_boxes, proposal_logits, proposal_valid, targets, generator, image_sizes
            )
        finally:
            self._generator = None

    def _forward_mask_keypoint_train(self, feats, sampled, targets, generator=None):
        losses = super()._forward_mask_keypoint_train(feats, sampled, targets, generator)
        if self.densepose_head is not None and "gt_dp_points" in targets:
            losses.update(self._forward_densepose_train(feats, sampled, targets))
        return losses

    def _densepose_pool(self, feats: List[torch.Tensor], boxes: torch.Tensor, B: int, train: bool) -> torch.Tensor:
        """``[R, res, res, C]`` DensePose features of ``boxes`` ``[B * K, 4]``
        (K rois an image, in image order)."""
        if self.decoder is None:
            return self.densepose_pooler(feats, boxes, _batch_index(B, boxes.shape[0] // B, boxes.device))
        dec = self.decoder(feats, train)
        res = self.densepose_pooler_resolution
        out = roi_align_separable_chan(
            dec, boxes.reshape(B, -1, 4), res, spatial_scale=self.box_pooler.scales[0],
            sampling_ratio=self.densepose_pooler_sampling_ratio, aligned=self.box_pooler.aligned,
        )
        return out.reshape(-1, res, res, dec.shape[-1])

    def _densepose_outputs(self, feats, boxes, B, train) -> Dict[str, torch.Tensor]:
        return self.densepose_predictor(self.densepose_head(self._densepose_pool(feats, boxes, B, train), train))

    def _densepose_train_mask(self, sampled, targets) -> torch.Tensor:
        """The slots that qualify for the branch ``[B, S]``: foreground, IoU
        with the matched gt at least the threshold, and a gt with points."""
        gt_boxes = _gather_slots(targets["gt_boxes"].float(), sampled["gt_idx"])
        iou = _matched_iou(gt_boxes, sampled["boxes"])
        has_pts = (targets["gt_dp_part"] >= 0).any(-1)
        if "gt_dp_vertex" in targets:
            has_pts = has_pts | (targets["gt_dp_vertex"] >= 0).any(-1)
        if self.segm_trained_by_masks:
            has_pts = has_pts | targets["gt_valid"].bool()
        slot_has_pts = torch.gather(has_pts, 1, sampled["gt_idx"])
        return sampled["is_fg"] & (iou >= self.densepose_fg_iou_threshold) & slot_has_pts

    def _forward_densepose_train(self, feats, sampled, targets) -> Dict[str, torch.Tensor]:
        B = sampled["gt_classes"].shape[0]
        if self.max_train_instances > 0:
            Rf = min(self.max_train_instances, self.fg_budget)
            dp_mask = self._densepose_train_mask(sampled, targets)
        else:
            Rf, dp_mask = self.fg_budget, sampled["is_fg"]
        fg_idx, fg_valid = select_foreground_slots(dp_mask, Rf)
        boxes = _gather_slots(sampled["boxes"], fg_idx).reshape(-1, 4)
        fg_gt_idx = torch.gather(sampled["gt_idx"], 1, fg_idx)
        valid = fg_valid.reshape(-1).float()
        out = self._densepose_outputs(feats, boxes, B, True)
        if "embedding" in out:
            return self._cse_losses(out, boxes, fg_gt_idx, valid, targets)
        K = out["fine_segm"].shape[-1]

        # the matched gt's points, in the slot's box frame
        pts = _gather_slots(targets["gt_dp_points"].float(), fg_gt_idx).flatten(0, 1)  # [R, P, 2]
        part = _gather_slots(targets["gt_dp_part"], fg_gt_idx).flatten(0, 1).long()  # [R, P]
        gt_u = _gather_slots(targets["gt_dp_u"].float(), fg_gt_idx).flatten(0, 1)
        gt_v = _gather_slots(targets["gt_dp_v"].float(), fg_gt_idx).flatten(0, 1)
        coords, _, weights = get_point_coords_from_point_annotation(
            boxes, pts, torch.where(part >= 0, torch.ones_like(part), -torch.ones_like(part))
        )
        w = weights * valid[:, None]
        norm = w.sum().clamp_min(1.0)

        part_cls = part.clamp(0, K - 1)[..., None]
        logp = F.log_softmax(point_sample(out["fine_segm"], coords), dim=-1)
        loss_index = (-torch.gather(logp, -1, part_cls)[..., 0] * w).sum() / norm
        loss_coarse = self._coarse_segm_loss(out, coords, w, targets, fg_gt_idx, boxes, valid)

        def at_part(name):
            return torch.gather(point_sample(out[name], coords), -1, part_cls)[..., 0]

        u_at, v_at = at_part("u"), at_part("v")
        losses = {
            "loss_densepose_I": loss_index * self.part_weight,
            "loss_densepose_S": loss_coarse * self.index_weight,
        }
        if self.uv_confidence == "none":
            losses["loss_densepose_U"] = (smooth_l1_loss(u_at, gt_u, beta=0.0) * w).sum() / norm * self.point_regression_weight
            losses["loss_densepose_V"] = (smooth_l1_loss(v_at, gt_v, beta=0.0) * w).sum() / norm * self.point_regression_weight
        elif self.uv_confidence == "iid_iso":
            loss_uv = iid_isotropic_gaussian_uv_loss(u_at, v_at, at_part("sigma_2"), gt_u, gt_v, w)
            losses["loss_densepose_UV"] = loss_uv * self.point_regression_weight
        else:
            loss_uv = indep_anisotropic_gaussian_uv_loss(
                u_at, v_at, at_part("sigma_2"), at_part("kappa_u"), at_part("kappa_v"), gt_u, gt_v, w
            )
            losses["loss_densepose_UV"] = loss_uv * self.point_regression_weight
        return losses

    def _coarse_segm_loss(self, out, coords, w, targets, fg_gt_idx, boxes, valid) -> torch.Tensor:
        """The coarse segmentation's loss: cross entropy against channel 1
        at the annotated points, or with ``COARSE_SEGM_TRAINED_BY_MASKS``
        the dense cross entropy against each slot's gt mask crop at the
        segmentation's resolution, a mean over the valid slots."""
        if not self.segm_trained_by_masks:
            logp_c = F.log_softmax(point_sample(out["coarse_segm"], coords), dim=-1)
            return (-logp_c[..., 1] * w).sum() / w.sum().clamp_min(1.0)
        tgt = self._gt_mask_crops(targets, fg_gt_idx, boxes, out["coarse_segm"].shape[1]).long()
        nll = -torch.gather(F.log_softmax(out["coarse_segm"], dim=-1), -1, tgt[..., None])[..., 0]
        return (nll.mean((1, 2)) * valid).sum() / valid.sum().clamp_min(1.0)

    @staticmethod
    def _gt_mask_crops(targets, fg_gt_idx, boxes, size: int) -> torch.Tensor:
        """``[R, size, size]`` {0, 1}: each slot's crop of its matched gt
        mask."""
        if "gt_masks" not in targets:
            raise ValueError(
                "COARSE_SEGM_TRAINED_BY_MASKS and the pixel-to-shape loss need gt masks in the batch "
                "(the DensePose trainer's collator makes them)"
            )
        B, Rf = fg_gt_idx.shape
        m = crop_gt_masks_to_proposals(targets["gt_masks"], targets["gt_boxes"], fg_gt_idx, boxes.reshape(B, Rf, 4), size)
        return (m > 0.5).reshape(B * Rf, size, size)

    def _local_mesh_ids(self, targets, fg_gt_idx) -> Optional[torch.Tensor]:
        """``[R]`` index into ``cse_mesh_names`` of each slot's gt mesh (-1
        for another mesh or none); None without ``gt_dp_mesh_id``."""
        if "gt_dp_mesh_id" not in targets:
            return None
        gmid = torch.gather(targets["gt_dp_mesh_id"].long(), 1, fg_gt_idx).reshape(-1)
        local = torch.full_like(gmid, -1)
        for li, mid in enumerate(self.cse_mesh_ids):
            local = torch.where(gmid == mid, torch.full_like(gmid, li), local)
        return local

    def _set_cycle_mesh_data(self, data) -> None:
        """``build_cycle_mesh_data``'s tuples as non-persistent buffers."""
        device = next(self.embedder.parameters()).device
        for name, idx, geo in data:
            if idx is not None:
                idx = torch.as_tensor(idx, dtype=torch.long, device=device)
                self.register_buffer(f"cycle_idx_{name}", idx, persistent=False)
            self.register_buffer(f"cycle_geodists_{name}", torch.as_tensor(geo, device=device), persistent=False)
        self.cycle_mesh_names = tuple(name for name, _, _ in data)

    def _geodists(self, name: str) -> torch.Tensor:
        """The mesh's ``[K, K]`` geodesics, read at the first use
        (``meshes.load_mesh_geodists``) and kept as a non-persistent
        buffer."""
        if not hasattr(self, f"geodists_{name}"):
            from detectron2_tpu_torch.projects.densepose.meshes import load_mesh_geodists

            device = next(self.embedder.parameters()).device
            self.register_buffer(f"geodists_{name}", torch.from_numpy(load_mesh_geodists(name)).to(device), persistent=False)
        return getattr(self, f"geodists_{name}")

    def _embed_loss(self, emb, vert, name: str) -> torch.Tensor:
        mesh_emb = self.embedder(name)
        valid = torch.ones_like(vert, dtype=torch.bool)
        if self.embed_loss_name == "SoftEmbeddingLoss":
            return cse.cse_soft_embedding_loss(
                emb, vert, valid, mesh_emb, self._geodists(name), self.embdist_gauss_sigma, self.geodist_gauss_sigma
            )
        return cse.cse_embedding_loss(emb, vert, valid, mesh_emb, self.embdist_gauss_sigma)

    def _cse_losses(self, out, boxes, fg_gt_idx, valid, targets) -> Dict[str, torch.Tensor]:
        if self.embedder is None:
            raise ValueError("CSE training needs MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBEDDERS (the CSE base config has none)")
        pts = _gather_slots(targets["gt_dp_points"].float(), fg_gt_idx).flatten(0, 1)  # [R, P, 2]
        vert = _gather_slots(targets["gt_dp_vertex"], fg_gt_idx).flatten(0, 1).long()  # [R, P]
        coords, _, weights = get_point_coords_from_point_annotation(
            boxes, pts, torch.where(vert >= 0, torch.ones_like(vert), -torch.ones_like(vert))
        )
        w = weights * valid[:, None]
        losses = {
            "loss_densepose_S": self._coarse_segm_loss(out, coords, w, targets, fg_gt_idx, boxes, valid)
            * self.index_weight
        }
        emb = point_sample(out["embedding"], coords)  # [R, P, E]
        local = self._local_mesh_ids(targets, fg_gt_idx)
        for li, name in enumerate(self.cse_mesh_names):
            sel = w > 0
            if len(self.cse_mesh_names) > 1:
                if local is None:
                    raise ValueError("multi-mesh CSE training needs targets['gt_dp_mesh_id'] (DensePoseBatchCollator)")
                sel = sel & (local == li)[:, None]
            if sel.any():
                losses[f"loss_densepose_E_{name}"] = self._embed_loss(emb[sel], vert[sel], name) * self.embed_loss_weight
            else:  # no point on this mesh: 0, as the JAX masked mean gives, without reading its geodesics
                losses[f"loss_densepose_E_{name}"] = emb.new_zeros(())
        if self.shape2shape_weight > 0:
            losses["loss_shape2shape"] = self.shape2shape_weight * self._shape2shape_loss()
        if self.pix2shape_weight > 0:
            loss = self._pix2shape_loss(out, targets, fg_gt_idx, boxes, valid, local)
            losses["loss_pix2shape"] = self.pix2shape_weight * loss
        return losses

    def _shape2shape_loss(self) -> torch.Tensor:
        """The cycle loss of one mesh pair, drawn each step from the
        pairs of ``cycle_mesh_names`` (:func:`draw_pair`), on the vertex
        subsample of ``build_cycle_mesh_data`` (read at the first step)."""
        if not self.cycle_mesh_names:
            self._set_cycle_mesh_data(cse.build_cycle_mesh_data(self.embedder.specs, self.shape2shape_max_num_vertices))
        names = self.cycle_mesh_names
        if len(names) < 2:
            raise ValueError("the shape-to-shape cycle loss needs at least 2 meshes")
        pairs = [(i, j) for i in range(len(names)) for j in range(i + 1, len(names))]
        device = getattr(self, f"cycle_geodists_{names[0]}").device
        i, j = pairs[draw_pair(len(pairs), self._generator, device) if len(pairs) > 1 else 0]

        def sub(name):
            e = self.embedder(name)
            idx = getattr(self, f"cycle_idx_{name}", None)
            return (e if idx is None else e[idx]), getattr(self, f"cycle_geodists_{name}")

        (e1, g1), (e2, g2) = sub(names[i]), sub(names[j])
        return cse.shape_to_shape_cycle_loss(e1, g1, e2, g2, self.shape2shape_temperature, self.shape2shape_norm_p)

    def _pix2shape_loss(self, out, targets, fg_gt_idx, boxes, valid, local) -> torch.Tensor:
        """The pixel-to-shape cycle loss of every slot against each mesh,
        weighted to the (slot, mesh) pairs of the slots with a valid,
        non-empty mask: its own mesh, or every mesh with
        ``USE_ALL_MESHES_NOT_GT_ONLY``; the mean over them."""
        emb = out["embedding"]
        masks = self._gt_mask_crops(targets, fg_gt_idx, boxes, emb.shape[1])
        wm0 = valid * masks.flatten(1).any(-1).float()
        total = count = torch.zeros((), device=emb.device)
        for li, name in enumerate(self.cse_mesh_names):
            per_inst = cse.pix_to_shape_cycle_loss(
                emb, masks, self.embedder(name), self._generator, self.pix2shape_num_pixels,
                self.pix2shape_temp_pix2v, self.pix2shape_temp_v2pix, self.pix2shape_norm_p,
            )
            wm = wm0 if self.pix2shape_all_meshes or local is None else wm0 * (local == li).float()
            total = total + (per_inst * wm).sum()
            count = count + wm.sum()
        return total / count.clamp_min(1.0)

    def mesh_vertex_embeddings(self, class_id: int) -> torch.Tensor:
        """The ``[K, E]`` vertex embeddings of a class's mesh
        (``CLASS_TO_MESH_NAME_MAPPING``)."""
        return self.embedder(self.class_to_mesh_name[int(class_id)])

    @torch.no_grad()
    def closest_vertices(self, embedding: torch.Tensor, class_id: int) -> torch.Tensor:
        """Each pixel's nearest vertex ``[..., ]`` on the mesh of
        ``class_id`` for one detection's ``[..., E]`` embedding."""
        return cse.closest_vertices_from_embedding(embedding, self.mesh_vertex_embeddings(class_id))

    def _forward_densepose_inference(self, feats, detections: Dict) -> Dict:
        B, D = detections["pred_classes"].shape
        K = D if self.max_inference_instances <= 0 else min(D, self.max_inference_instances)
        out = self._densepose_outputs(feats, detections["pred_boxes"][:, :K].reshape(-1, 4), B, False)

        def pad_slots(x):
            """``[B * K, ...]`` -> ``[B, D, ...]``, zeros on the slots not run."""
            x = x.reshape((B, K) + x.shape[1:])
            if K == D:
                return x
            return torch.cat([x, x.new_zeros((B, D - K) + x.shape[2:])], dim=1)

        if "embedding" in out:
            detections["pred_densepose_embedding"] = pad_slots(out["embedding"])
            detections["pred_densepose_fg"] = pad_slots(out["coarse_segm"].argmax(dim=-1) > 0)
            return detections
        if self.raw_outputs:
            detections["pred_densepose_raw"] = {k: pad_slots(v) for k, v in out.items()}
        part = out["fine_segm"].argmax(dim=-1)  # [R, M, M]
        u = torch.gather(out["u"], -1, part[..., None])[..., 0]
        v = torch.gather(out["v"], -1, part[..., None])[..., 0]
        part = torch.where(out["coarse_segm"].argmax(dim=-1) > 0, part, torch.zeros_like(part))
        detections["pred_densepose"] = pad_slots(torch.stack([part.float(), u.clamp(0, 1), v.clamp(0, 1)], dim=-1))
        return detections
