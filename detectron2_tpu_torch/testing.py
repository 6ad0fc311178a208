"""What the CPU tests and the on-card smoke run share: the synthetic fixtures
of ``tests/goldens/`` (the Mask R-CNN R18-FPN of ``e2e_maskrcnn_r18.npz`` and
the ViT + SimpleFeaturePyramid of ``vitdet_backbone.npz``), the error
bounds the bfloat16 attention kernel is held to, synthetic COCO-format
datasets written to disk (:func:`write_synthetic_coco`,
:func:`write_synthetic_coco_panoptic`, :func:`write_synthetic_cityscapes`,
precomputed proposals :func:`write_synthetic_proposals`, and the train->AP
gate's color-coded rectangles :func:`write_synthetic_overfit_coco`, with
corner keypoints for the keypoint gate), DensePose data (the chart and CSE
splits, DensePose-LVIS, the SMPL evaluation files and the CSE meshes, in
the layouts of their downloads), and the gates' configs
(:func:`overfit_config`, :func:`overfit_keypoint_config`).

Each golden holds what the reference detectron2 produces on a fixed image
with deterministic synthetic weights. This module rebuilds those weights
from the golden's (name, shape) list and the model the golden was made
with, so the CPU tests and the on-card smoke run hold the port to the same
numbers.
"""

import json
import os
import zlib
from typing import Optional

import numpy as np

from detectron2_tpu_torch.config import CfgNode, get_cfg

__all__ = [
    "synth_weight_value",
    "golden_state_dict",
    "golden_r18_config",
    "golden_keypoint_config",
    "golden_semseg_config",
    "golden_panoptic_config",
    "golden_c4_config",
    "golden_cascade_config",
    "golden_tta_config",
    "golden_dense_config",
    "golden_deeplab_config",
    "golden_panoptic_deeplab_config",
    "golden_tridentnet_config",
    "compare_with_tridentnet_golden",
    "golden_tensormask_config",
    "compare_with_tensormask_golden",
    "compare_with_deeplab_golden",
    "same_panoptic_partition",
    "PANOPTIC_DEEPLAB_FIXTURE",
    "golden_vitdet_backbone",
    "compare_with_golden",
    "GOLDEN_TOLERANCES",
    "attention_bf16_bounds",
    "config_tree",
    "write_synthetic_coco",
    "write_synthetic_coco_panoptic",
    "write_synthetic_densepose_coco",
    "write_synthetic_densepose_cse",
    "write_synthetic_densepose_eval_data",
    "write_synthetic_cse_meshes",
    "synthetic_pdist_values",
    "golden_densepose_config",
    "write_synthetic_cityscapes",
    "write_synthetic_cityscapes_panoptic",
    "panoptic_deeplab_batch",
    "write_synthetic_proposals",
    "CITYSCAPES_SIZE",
    "write_synthetic_lvis",
    "write_synthetic_voc",
    "synthetic_train_batch",
    "ground_truth_detections",
    "densepose_ground_truth_outputs",
    "COCO_SIZES",
    "OVERFIT_SIZE",
    "overfit_config",
    "overfit_keypoint_config",
    "OVERFIT_KEYPOINT_NAMES",
    "write_synthetic_overfit_coco",
]

# tolerances of tests/parity/test_e2e_maskrcnn_golden.py:141-178
GOLDEN_TOLERANCES = {
    "scores": {"rtol": 1e-3, "atol": 1e-4},
    "boxes": {"rtol": 1e-3, "atol": 0.05},
    "mask_probs10": {"atol": 2e-4},
    "mask_iou10": 0.9,
}


def synth_weight_value(name: str, shape) -> np.ndarray:
    """The golden generator's weight rule (keyed by the tensor's name)."""
    rng = np.random.RandomState(zlib.crc32(name.encode()) & 0x7FFFFFFF)
    if name.endswith("running_var"):
        return (np.abs(rng.standard_normal(shape)) * 0.5 + 0.5).astype(np.float32)
    if name.endswith("running_mean"):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)
    if "cls_score" in name and name.endswith("weight"):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)
    if name.endswith("bbox_pred.weight") and len(shape) == 4 and shape[0] == 4:
        return (rng.standard_normal(shape) * 3.0).astype(np.float32)  # FCOS: boxes of real extent
    if name.endswith("ctrness.weight") and len(shape) == 4:
        return (rng.standard_normal(shape) * 2.0).astype(np.float32)
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def golden_state_dict(golden) -> dict:
    """d2 state dict of the golden's synthetic weights."""
    out = {}
    for name, shape_s in zip(golden["weight_names"], golden["weight_shapes"]):
        shape = tuple(int(x) for x in str(shape_s).split(",") if x)
        out[str(name)] = synth_weight_value(str(name), shape)
    return out


def golden_r18_config() -> CfgNode:
    """Mask R-CNN R18-FPN, FPN width 64, 7 classes, float32: the golden's model."""
    cfg = get_cfg()
    m = cfg.MODEL
    m.BACKBONE.NAME = "build_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.OUT_CHANNELS = 64
    m.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    m.RPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    m.RPN.PRE_NMS_TOPK_TEST = 200
    m.RPN.POST_NMS_TOPK_TEST = 100
    m.ROI_HEADS.NAME = "StandardROIHeads"
    m.ROI_HEADS.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    m.ROI_HEADS.NUM_CLASSES = 7
    m.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    m.ROI_BOX_HEAD.NAME = "FastRCNNConvFCHead"
    m.ROI_BOX_HEAD.NUM_FC = 2
    m.ROI_BOX_HEAD.FC_DIM = 128
    m.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    # static 2x2 sampling on both sides: the reference's sampling_ratio=0
    # adapts per roi, the fixed-shape RoIAlign does not
    m.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 2
    m.ROI_MASK_HEAD.NUM_CONV = 2
    m.ROI_MASK_HEAD.CONV_DIM = 64
    m.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
    m.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 2
    m.MASK_ON = True
    cfg.TEST.DETECTIONS_PER_IMAGE = 50
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def golden_semseg_config() -> CfgNode:
    """The SemanticSegmentor R18-FPN of ``e2e_semseg_r18.npz``: FPN width
    64, the head on p2-p5 at 32 channels, 9 classes, float32
    (``tests/parity/test_e2e_semseg_golden.py``)."""
    cfg = get_cfg()
    m = cfg.MODEL
    m.META_ARCHITECTURE = "SemanticSegmentor"
    m.BACKBONE.NAME = "build_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.OUT_CHANNELS = 64
    m.SEM_SEG_HEAD.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    m.SEM_SEG_HEAD.NUM_CLASSES = 9
    m.SEM_SEG_HEAD.CONVS_DIM = 32
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def golden_panoptic_config() -> CfgNode:
    """The PanopticFPN of ``e2e_panoptic_r18.npz``: an R18-FPN Mask R-CNN
    (FPN width 64, box pool 14x14 and 2 fc of 128, mask head 2 convs of 64,
    7 classes, test threshold 0.3, 20 detections) and the sem-seg head of
    :func:`golden_semseg_config`, float32
    (``tests/parity/test_e2e_panoptic_golden.py``)."""
    cfg = golden_semseg_config()
    m = cfg.MODEL
    m.META_ARCHITECTURE = "PanopticFPN"
    m.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    m.RPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    m.RPN.PRE_NMS_TOPK_TEST = 200
    m.RPN.POST_NMS_TOPK_TEST = 100
    m.ROI_HEADS.NAME = "StandardROIHeads"
    m.ROI_HEADS.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    m.ROI_HEADS.NUM_CLASSES = 7
    m.ROI_HEADS.SCORE_THRESH_TEST = 0.3
    m.ROI_BOX_HEAD.NAME = "FastRCNNConvFCHead"
    m.ROI_BOX_HEAD.NUM_FC = 2
    m.ROI_BOX_HEAD.FC_DIM = 128
    m.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 2
    m.ROI_MASK_HEAD.NUM_CONV = 2
    m.ROI_MASK_HEAD.CONV_DIM = 64
    m.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 2
    m.MASK_ON = True
    cfg.TEST.DETECTIONS_PER_IMAGE = 20
    return cfg


def golden_densepose_config(deeplab: bool = False) -> CfgNode:
    """The tiny DensePose R-CNN R18-FPN of ``tests/goldens/e2e_densepose_r18.npz``
    (``tests/parity/test_e2e_densepose_golden.py::_our_cfg``): the decoder,
    a 2-conv V1ConvX tower at 64 channels, 14x14 pool, one class; with
    ``deeplab`` the DeepLab head and the iid UV confidence of
    ``e2e_densepose_dl_r18.npz``."""
    from detectron2_tpu_torch.projects.densepose import add_densepose_config

    cfg = golden_r18_config()
    add_densepose_config(cfg)
    m = cfg.MODEL
    m.MASK_ON = False
    m.ROI_HEADS.NUM_CLASSES = 1
    m.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    m.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 2
    m.RPN.PRE_NMS_TOPK_TEST = 200
    m.RPN.POST_NMS_TOPK_TEST = 100
    h = m.ROI_DENSEPOSE_HEAD
    h.NUM_STACKED_CONVS = 2
    h.CONV_HEAD_DIM = 64
    h.POOLER_RESOLUTION = 14
    h.POOLER_SAMPLING_RATIO = 2
    h.DECODER_CONV_DIMS = 64
    h.DECODER_NUM_CLASSES = 64
    h.RAW_OUTPUTS = True
    cfg.TEST.DETECTIONS_PER_IMAGE = 20
    if deeplab:
        h.NAME = "DensePoseDeepLabHead"
        h.UV_CONFIDENCE.ENABLED = True
        h.UV_CONFIDENCE.TYPE = "iid_iso"
    return cfg


def golden_pointrend_config() -> CfgNode:
    """The PointRend R18-FPN of ``e2e_pointrend_r18.npz``: the golden R18's
    box branch, the coarse head on p2 (conv 32, two fc of 64, 7x7), the
    point head (three fc of 32) and 3 subdivision steps of 196 points, which
    d2's shortcut makes 14x14 and 2 steps: 56x56 masks
    (``tests/parity/test_e2e_pointrend_golden.py``)."""
    from detectron2_tpu_torch.projects.point_rend import add_pointrend_config

    cfg = golden_r18_config()
    add_pointrend_config(cfg)
    m = cfg.MODEL
    m.ROI_HEADS.NAME = "PointRendROIHeads"
    m.ROI_MASK_HEAD.NAME = "CoarseMaskHead"
    m.ROI_MASK_HEAD.IN_FEATURES = ["p2"]
    m.ROI_MASK_HEAD.FC_DIM = 64
    m.ROI_MASK_HEAD.NUM_FC = 2
    m.ROI_MASK_HEAD.OUTPUT_SIDE_RESOLUTION = 7
    m.ROI_MASK_HEAD.CONV_DIM = 32
    m.POINT_HEAD.NUM_CLASSES = 7
    m.POINT_HEAD.IN_FEATURES = ["p2"]
    m.POINT_HEAD.FC_DIM = 32
    m.POINT_HEAD.NUM_FC = 3
    m.POINT_HEAD.SUBDIVISION_STEPS = 3
    m.POINT_HEAD.SUBDIVISION_NUM_POINTS = 196
    return cfg


def compare_with_pointrend_golden(out: dict, golden) -> dict:
    """Image 0 of the port's padded detections against the PointRend
    golden at its parity test's bounds: scores rtol 1e-3 + 1e-4, classes
    equal, boxes rtol 1e-3 + 0.05 px, the top 10's 56x56 mask probabilities
    5e-4. Returns the max errors."""
    valid = out["valid"][0].cpu().numpy()
    scores = out["scores"][0].cpu().numpy()[valid]
    classes = out["pred_classes"][0].cpu().numpy()[valid]
    boxes = out["pred_boxes"][0].cpu().numpy()[valid]
    masks = out["pred_masks"][0].float().cpu().numpy()[valid]
    o = np.argsort(-scores, kind="stable")
    r = np.argsort(-golden["out_scores"], kind="stable")
    assert len(o) == len(r), (len(o), len(r))
    assert masks.shape[-1] == 56, masks.shape
    np.testing.assert_allclose(scores[o], golden["out_scores"][r], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(classes[o], golden["out_classes"][r])
    np.testing.assert_allclose(boxes[o], golden["out_boxes"][r], rtol=1e-3, atol=0.05)
    np.testing.assert_allclose(masks[o[:10]], golden["mask_probs10"][r[:10]], atol=5e-4)
    return {
        "scores": float(np.abs(scores[o] - golden["out_scores"][r]).max()),
        "boxes": float(np.abs(boxes[o] - golden["out_boxes"][r]).max()),
        "mask_probs10": float(np.abs(masks[o[:10]] - golden["mask_probs10"][r[:10]]).max()),
    }


def golden_deeplab_config() -> CfgNode:
    """The DeepLabV3+ R50 of ``e2e_deeplab_r50.npz``: the DeepLab stem (64
    channels), res5 dilated with multi-grid (1, 2, 4), BN, the decoder on
    res2 (48) and res5 (ASPP 64), fuse 64, 9 classes, no dropout, float32
    (``tests/parity/test_e2e_deeplab_golden.py``)."""
    from detectron2_tpu_torch.projects.deeplab import add_deeplab_config

    cfg = get_cfg()
    add_deeplab_config(cfg)
    m = cfg.MODEL
    m.META_ARCHITECTURE = "SemanticSegmentor"
    m.BACKBONE.NAME = "build_resnet_deeplab_backbone"
    m.RESNETS.DEPTH = 50
    m.RESNETS.OUT_FEATURES = ["res2", "res5"]
    m.RESNETS.RES5_DILATION = 2
    m.RESNETS.NORM = "BN"
    h = m.SEM_SEG_HEAD
    h.NAME = "DeepLabV3PlusHead"
    h.IN_FEATURES = ["res2", "res5"]
    h.PROJECT_FEATURES = ["res2"]
    h.PROJECT_CHANNELS = [48]
    h.ASPP_CHANNELS = 64
    h.ASPP_DROPOUT = 0.0
    h.CONVS_DIM = 64
    h.NUM_CLASSES = 9
    h.NORM = "BN"
    h.LOSS_TYPE = "cross_entropy"
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def golden_panoptic_deeplab_config() -> CfgNode:
    """The Panoptic-DeepLab R50 of ``e2e_panoptic_deeplab_r50.npz``: the
    golden DeepLab trunk with res3 too; the semantic decoder on res2 (16),
    res3 (32), res5 (ASPP 64), fuse and head 64, 9 classes; the instance
    decoder's projections 16 and 32, ASPP 64, fuse 32, heads 16; BN, no
    dropout, float32 (``tests/parity/test_e2e_panoptic_deeplab_golden.py``)."""
    from detectron2_tpu_torch.projects.panoptic_deeplab import add_panoptic_deeplab_config

    cfg = get_cfg()
    add_panoptic_deeplab_config(cfg)
    m = cfg.MODEL
    m.BACKBONE.NAME = "build_resnet_deeplab_backbone"
    m.RESNETS.DEPTH = 50
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res5"]
    m.RESNETS.RES5_DILATION = 2
    m.RESNETS.NORM = "BN"
    for h, project, fuse, head in ((m.SEM_SEG_HEAD, [16, 32], 64, 64), (m.INS_EMBED_HEAD, [16, 32], 32, 16)):
        h.IN_FEATURES = ["res2", "res3", "res5"]
        h.PROJECT_FEATURES = ["res2", "res3"]
        h.PROJECT_CHANNELS = project
        h.ASPP_CHANNELS = 64
        h.ASPP_DROPOUT = 0.0
        h.CONVS_DIM = fuse
        h.HEAD_CHANNELS = head
        h.NORM = "BN"
    m.SEM_SEG_HEAD.NUM_CLASSES = 9
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


# the Panoptic-DeepLab golden's fusion fixture (its parity test's arguments)
PANOPTIC_DEEPLAB_FIXTURE = {"thing_ids": [5, 6, 7, 8], "label_divisor": 1000, "stuff_area": 64, "threshold": 0.1,
                            "nms_kernel": 7, "top_k": 200}


def compare_with_deeplab_golden(out: dict, golden) -> dict:
    """Image 0 of a DeepLab model's float32 outputs against the golden at
    its parity test's bounds: logits (and Panoptic-DeepLab's center) within
    5e-3, the offsets within 2e-2, and for the logits the argmax agreeing on
    more than 99.9% of the pixels. Returns the max errors."""
    errs = {}
    sem = out["sem_seg"][0].float().cpu().numpy()
    ref = golden["sem_seg"].transpose(1, 2, 0)
    assert sem.shape == ref.shape, (sem.shape, ref.shape)
    errs["sem_seg"] = float(np.abs(sem - ref).max())
    assert errs["sem_seg"] < 5e-3, errs
    agree = float((sem.argmax(-1) == ref.argmax(-1)).mean())
    assert agree > 0.999, agree
    if "center" in golden:
        center = out["center"][0].float().cpu().numpy()
        errs["center"] = float(np.abs(center - golden["center"].reshape(center.shape)).max())
        offset = out["offset"][0].float().cpu().numpy()
        errs["offset"] = float(np.abs(offset - golden["offset"].transpose(1, 2, 0)).max())
        assert errs["center"] < 5e-3 and errs["offset"] < 2e-2, errs
    return errs


def golden_tridentnet_config() -> CfgNode:
    """The TridentNet-Fast R50-C4 of ``e2e_tridentnet_r50.npz``: BN (eval),
    the trident res4 at dilations (1, 2, 3) with the middle branch tested,
    the RPN over the three branch levels in training and ``res4`` in
    inference (300 / 100 proposals), Res5ROIHeads with 14x14 pools, 7
    classes, 30 detections, float32
    (``tests/parity/test_e2e_tridentnet_golden.py``)."""
    from detectron2_tpu_torch.projects.tridentnet import add_tridentnet_config

    cfg = get_cfg()
    add_tridentnet_config(cfg)
    m = cfg.MODEL
    m.BACKBONE.NAME = "build_trident_resnet_backbone"
    m.RESNETS.DEPTH = 50
    m.RESNETS.OUT_FEATURES = ["res4"]
    m.RESNETS.NORM = "BN"
    m.PROPOSAL_GENERATOR.NAME = "TridentRPN"
    m.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
    m.RPN.IN_FEATURES = ["res4_b0", "res4_b1", "res4_b2"]
    m.RPN.PRE_NMS_TOPK_TEST = 300
    m.RPN.POST_NMS_TOPK_TEST = 100
    m.ROI_HEADS.NAME = "Res5ROIHeads"
    m.ROI_HEADS.IN_FEATURES = ["res4"]
    m.ROI_HEADS.NUM_CLASSES = 7
    m.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    m.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
    m.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 2
    m.MASK_ON = False
    cfg.TEST.DETECTIONS_PER_IMAGE = 30
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def _match_golden_detections(out: dict, golden, max_count_diff: int, min_matched: int) -> list:
    """Image 0's detections against the golden's by the parity tests' set
    matching: each reference detection needs one of ours of its class with
    the score within 1e-3 relative + 1e-4 and the box within 0.05 px; one
    that finds none is forgiven only when an unmatched detection of ours
    ties its score to 2e-3 (random weights leave clusters of detections
    whose order is float32 noise). Returns the matched (reference, ours)
    index pairs, ours indexing the valid slots."""
    valid = out["valid"][0].cpu().numpy()
    scores = out["scores"][0].float().cpu().numpy()[valid]
    boxes = out["pred_boxes"][0].float().cpu().numpy()[valid]
    classes = out["pred_classes"][0].cpu().numpy()[valid]
    assert abs(len(scores) - len(golden["out_scores"])) <= max_count_diff, (len(scores), len(golden["out_scores"]))
    taken = np.zeros(len(scores), bool)
    pairs, unmatched = [], []
    for ri, (rs, rc, rbx) in enumerate(zip(golden["out_scores"], golden["out_classes"], golden["out_boxes"])):
        cand = (classes == rc) & ~taken & (np.abs(scores - rs) < 1e-3 * abs(rs) + 1e-4) & (
            np.abs(boxes - rbx).max(axis=1) < 0.05)
        idx = np.where(cand)[0]
        if len(idx) == 0:
            unmatched.append((rs, rc, rbx))
            continue
        taken[idx[0]] = True
        pairs.append((ri, int(idx[0])))
    extras = scores[~taken]
    hard = [u for u in unmatched if not (len(extras) and np.abs(extras - u[0]).min() < 2e-3)]
    assert not hard, hard
    assert len(pairs) >= min_matched, len(pairs)
    return pairs


def compare_with_tridentnet_golden(features: dict, out: dict, golden) -> dict:
    """The port's ``res4`` (the middle branch, NHWC) within 2e-3 of the
    golden's and image 0's detections by the parity test's set matching
    (the same count, at least 25 of 30 matched). Returns the max feature
    error and the matched count."""
    res4 = features["res4"][0].float().cpu().numpy()
    ref = golden["feat_res4"][0].transpose(1, 2, 0)
    assert res4.shape == ref.shape, (res4.shape, ref.shape)
    err = float(np.abs(res4 - ref).max())
    assert err < 2e-3, err
    pairs = _match_golden_detections(out, golden, 0, 25)
    return {"res4": err, "matched": len(pairs)}


def golden_tensormask_config() -> CfgNode:
    """The TensorMask R18-FPN of ``e2e_tensormask_r18.npz``: p2-p7 of width
    64 (the average fuse, p6 from res5), two anchor sizes a level (4 and 6
    px windows at p2), towers of two convs of 32, aligned and bipyramid
    masks, 7 classes, 500 candidates, 25 detections, float32
    (``tests/parity/test_e2e_tensormask_golden.py``)."""
    from detectron2_tpu_torch.projects.tensormask import add_tensormask_config

    cfg = get_cfg()
    add_tensormask_config(cfg)
    m = cfg.MODEL
    m.META_ARCHITECTURE = "TensorMask"
    m.MASK_ON = True
    m.BACKBONE.NAME = "build_retinanet_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.OUT_CHANNELS = 64
    m.FPN.FUSE_TYPE = "avg"
    m.ANCHOR_GENERATOR.SIZES = [[16, 24], [32, 48], [64, 96], [128, 192], [256, 384], [512, 768]]
    m.ANCHOR_GENERATOR.ASPECT_RATIOS = [[1.0]]
    m.ANCHOR_GENERATOR.OFFSET = 0.0
    t = m.TENSOR_MASK
    t.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6", "p7"]
    t.NUM_CLASSES = 7
    t.NUM_CONVS = 2
    t.CLS_CHANNELS = t.BBOX_CHANNELS = t.MASK_CHANNELS = 32
    t.ALIGNED_ON = t.BIPYRAMID_ON = True
    t.SCORE_THRESH_TEST = 0.05
    t.TOPK_CANDIDATES_TEST = 500
    cfg.TEST.DETECTIONS_PER_IMAGE = 25
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def compare_with_tensormask_golden(raw: dict, out: dict, golden) -> dict:
    """The port's raw head maps (``TensorMask.forward(raw=True)``) and
    detections against the TensorMask golden at its parity test's bounds:
    logits and deltas of every level within 2e-3, the aligned-to-natural
    mask maps of levels 0, 1 and 4 within 3e-3, the detections by set
    matching (count within 1, at least 20 matched), and each matched
    detection's 28x28 mask within 5e-3 of the reference's native window
    (its logits resized bilinearly to 28, then the sigmoid, the order the
    port's inference uses). Returns the max errors."""
    import torch

    from detectron2_tpu_torch.modeling.backbone.vit import resize_matrix

    errs = {"logits": 0.0, "deltas": 0.0, "masks": 0.0}
    for i, f in enumerate(("p2", "p3", "p4", "p5", "p6", "p7")):
        for key in ("logits", "deltas"):
            ours = raw[key][i][0].float().cpu().numpy()
            ref = golden[f"{key}_{f}"][0].transpose(1, 2, 0)
            assert ours.shape == ref.shape, (f, key, ours.shape, ref.shape)
            errs[key] = max(errs[key], float(np.abs(ours - ref).max()))
    for lvl in (0, 1, 4):
        for anc in range(2):
            ours = raw["masks"][lvl][anc][0].float().cpu().numpy()
            ref = golden[f"mask_l{lvl}_a{anc}"][0].transpose(1, 2, 0)
            assert ours.shape == ref.shape, (lvl, anc, ours.shape, ref.shape)
            errs["masks"] = max(errs["masks"], float(np.abs(ours - ref).max()))
    assert errs["logits"] < 2e-3 and errs["deltas"] < 2e-3 and errs["masks"] < 3e-3, errs
    pairs = _match_golden_detections(out, golden, 1, 20)
    sizes = golden["out_mask_sizes"]
    offs = np.concatenate([[0], np.cumsum(sizes**2)])
    masks = out["pred_masks"][0].float().cpu().numpy()[out["valid"][0].cpu().numpy()]
    S = masks.shape[-1]
    errs["window"] = 0.0
    for ri, oi in pairs:
        m = int(sizes[ri])
        win = golden["out_mask_windows"][offs[ri]:offs[ri + 1]].reshape(m, m).astype(np.float64)
        logit = torch.from_numpy(np.log(win) - np.log1p(-win)).float()
        r = resize_matrix(m, S, "linear")
        exp = torch.sigmoid(r @ logit @ r.T).numpy()
        errs["window"] = max(errs["window"], float(np.abs(exp - masks[oi]).max()))
    assert errs["window"] < 5e-3, errs
    errs["matched"] = len(pairs)
    return errs


def same_panoptic_partition(pan: np.ndarray, ref: np.ndarray, label_divisor: int = 1000) -> int:
    """The panoptic maps ``pan`` and ``ref`` partition the image alike: the
    void pixels and every stuff id equal, each class's thing segments the
    same pixel sets whatever their instance ids. Returns the number of
    segments."""
    assert pan.shape == ref.shape, (pan.shape, ref.shape)
    np.testing.assert_array_equal(pan < 0, ref < 0)
    segments = {}
    for name, arr in (("ours", pan), ("ref", ref)):
        flat = arr.reshape(-1)
        things = segments.setdefault(name, {})
        for pid in np.unique(flat):
            if pid < 0:
                continue
            cls, inst = divmod(int(pid), label_divisor)
            if inst > 0:
                things.setdefault(cls, set()).add(frozenset(np.flatnonzero(flat == pid).tolist()))
            else:
                np.testing.assert_array_equal(pan == pid, ref == pid)
    assert segments["ours"] == segments["ref"], "thing segments differ"
    return len(np.unique(ref[ref >= 0]))


def golden_keypoint_config() -> CfgNode:
    """Keypoint R-CNN R18-FPN of ``e2e_keypointrcnn_r18.npz``: the R18-FPN
    with a keypoint head of two 64-wide convs, 17 keypoints, no masks, 20
    detections (``tests/parity/test_e2e_keypoint_golden.py:25-33``)."""
    cfg = golden_r18_config()
    m = cfg.MODEL
    m.MASK_ON = False
    m.KEYPOINT_ON = True
    m.ROI_KEYPOINT_HEAD.CONV_DIMS = (64, 64)
    m.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 2
    m.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = 17
    cfg.TEST.DETECTIONS_PER_IMAGE = 20
    return cfg


def golden_c4_config() -> CfgNode:
    """Mask R-CNN R18-C4 of ``e2e_maskrcnn_c4_r18.npz``: a bare R18 to
    ``res4``, one RPN level with 5 anchor sizes, Res5ROIHeads (3 bottleneck
    blocks of 512 outputs) with 14x14 pools, a mask head without convs, 7
    classes, 30 detections, float32 (``tests/parity/test_e2e_c4_golden.py:23-48``)."""
    cfg = get_cfg()
    m = cfg.MODEL
    m.BACKBONE.NAME = "build_resnet_backbone"
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.OUT_FEATURES = ["res4"]
    m.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
    m.RPN.IN_FEATURES = ["res4"]
    m.RPN.PRE_NMS_TOPK_TEST = 300
    m.RPN.POST_NMS_TOPK_TEST = 100
    m.ROI_HEADS.NAME = "Res5ROIHeads"
    m.ROI_HEADS.IN_FEATURES = ["res4"]
    m.ROI_HEADS.NUM_CLASSES = 7
    m.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    m.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
    m.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 2
    m.ROI_MASK_HEAD.NUM_CONV = 0
    m.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
    m.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 2
    m.MASK_ON = True
    cfg.TEST.DETECTIONS_PER_IMAGE = 30
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def golden_cascade_config() -> CfgNode:
    """Cascade R-CNN R18-FPN of ``e2e_cascadercnn_r18.npz``: three box
    stages, class-agnostic regression, no masks, 30 detections
    (``tests/parity/test_e2e_cascade_golden.py:22-28``)."""
    cfg = golden_r18_config()
    cfg.MODEL.MASK_ON = False
    cfg.MODEL.ROI_HEADS.NAME = "CascadeROIHeads"
    cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = True
    cfg.TEST.DETECTIONS_PER_IMAGE = 30
    return cfg


def golden_tta_config() -> CfgNode:
    """The R18-FPN of ``e2e_tta_r18.npz`` under test-time augmentation:
    shortest edge 256 and 320 (long edge at most 512), each also flipped
    (``tests/parity/test_e2e_tta_golden.py:41-45``)."""
    cfg = golden_r18_config()
    cfg.TEST.AUG.ENABLED = True
    cfg.TEST.AUG.MIN_SIZES = (256, 320)
    cfg.TEST.AUG.MAX_SIZE = 512
    cfg.TEST.AUG.FLIP = True
    return cfg


def golden_dense_config(meta_architecture: str) -> CfgNode:
    """The R18-FPN one-stage models of ``e2e_retinanet_r18.npz`` and
    ``e2e_fcos_r18.npz``: p3-p7 from res3-res5 (p6 from ``res5``), FPN width
    64, two tower convs, 7 classes, float32; RetinaNet with two anchor sizes
    a level, test threshold 0.01, 200 candidates a level and 50 detections,
    FCOS with its own thresholds and 100 detections
    (``tests/parity/test_e2e_{retinanet,fcos}_golden.py``)."""
    cfg = get_cfg()
    m = cfg.MODEL
    m.META_ARCHITECTURE = meta_architecture
    m.BACKBONE.NAME = "build_retinanet_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res3", "res4", "res5"]
    m.FPN.OUT_CHANNELS = 64
    m.RETINANET.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
    m.RETINANET.NUM_CLASSES = 7
    m.RETINANET.NUM_CONVS = 2
    cfg.TEST.DETECTIONS_PER_IMAGE = 100
    if meta_architecture == "RetinaNet":
        m.ANCHOR_GENERATOR.SIZES = [[32, 40], [64, 81], [128, 161], [256, 323], [512, 645]]
        m.RETINANET.SCORE_THRESH_TEST = 0.01
        m.RETINANET.TOPK_CANDIDATES_TEST = 200
        cfg.TEST.DETECTIONS_PER_IMAGE = 50
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def golden_vitdet_backbone(device="cpu"):
    """The backbone ``vitdet_backbone.npz`` was made with: a ViT of width 64,
    4 blocks of 2 heads, 8x8 windows in blocks 0 and 2, relative positions,
    on 256x256 inputs (pretraining size 256: no position resize), under a
    SimpleFeaturePyramid of width 48 with LayerNorm. Its outputs are held to
    the golden's ``feat_p2``..``feat_p6`` (NCHW) within 2e-3."""
    from detectron2_tpu_torch.modeling.backbone import SimpleFeaturePyramid, ViT

    net = ViT(
        img_size=256, patch_size=16, embed_dim=64, depth=4, num_heads=2, window_size=8, mlp_ratio=4,
        qkv_bias=True, window_block_indexes=(0, 2), use_rel_pos=True, pretrain_img_size=256,
        out_feature="last_feat",
    )
    backbone = SimpleFeaturePyramid(
        net=net, in_feature="last_feat", out_channels=48, scale_factors=(4.0, 2.0, 1.0, 0.5),
        top_block_levels=1, norm="LN",
    )
    return backbone.to(device).eval()


def compare_with_golden(out: dict, golden) -> dict:
    """Hold image 0 of the port's padded detections to the golden at
    :data:`GOLDEN_TOLERANCES`; raises AssertionError outside them. Returns
    the measured max errors and the smallest pasted-mask IoU."""
    import torch

    from detectron2_tpu_torch.ops.paste_masks import paste_masks_in_image

    tol = GOLDEN_TOLERANCES
    valid = out["valid"][0].cpu().numpy()
    scores = out["scores"][0].cpu().numpy()[valid]
    classes = out["pred_classes"][0].cpu().numpy()[valid]
    boxes = out["pred_boxes"][0].cpu().numpy()[valid]
    masks = out["pred_masks"][0].float().cpu().numpy()[valid]
    o = np.argsort(-scores, kind="stable")
    r = np.argsort(-golden["out_scores"], kind="stable")
    assert len(o) == len(r), (len(o), len(r))
    np.testing.assert_allclose(scores[o], golden["out_scores"][r], **tol["scores"])
    np.testing.assert_array_equal(classes[o], golden["out_classes"][r])
    np.testing.assert_allclose(boxes[o], golden["out_boxes"][r], **tol["boxes"])
    np.testing.assert_allclose(masks[o[:10]], golden["mask_probs10"][r[:10]], **tol["mask_probs10"])
    H, W = golden["image"].shape[:2]
    pasted = paste_masks_in_image(
        torch.from_numpy(masks[o[:10]]), torch.from_numpy(boxes[o[:10]]), (H, W)
    ).numpy()
    ref = golden["out_masks10"].astype(bool)
    ious = [(pasted[i] & ref[i]).sum() / max((pasted[i] | ref[i]).sum(), 1) for i in range(len(ref))]
    assert min(ious) > tol["mask_iou10"], ious
    return {
        "scores": float(np.abs(scores[o] - golden["out_scores"][r]).max()),
        "boxes": float(np.abs(boxes[o] - golden["out_boxes"][r]).max()),
        "mask_probs10": float(np.abs(masks[o[:10]] - golden["mask_probs10"][r[:10]]).max()),
        "min_mask_iou10": float(min(ious)),
    }


def attention_bf16_bounds(ref32, weighted_abs_v, v_max: float, bias_max: float = 0.0):
    """Per-element bounds on the error of the bfloat16 attention kernel.

    The kernel forms scores and bias in float32 from bf16 inputs, rounds each
    probability to bf16 for the p.v product, sums the unrounded ones, divides
    last and rounds the output to bf16. With ``A = softmax(s) @ |v|``, which
    bounds what any relative error of the probabilities can move an output
    by, and ``ref32`` the plain version run in float32 on the same inputs (q
    scaled in bf16 first, as the kernel scales it):

    * against ``ref32``: ``2^-9 A`` (the probabilities' rounding, worst case)
      ``+ 2^-8 |ref32|`` (the output's rounding, 2^-9, doubled)
      ``+ 2e-5 v_max`` (sum order and the exponential, the float32 bound);
    * against the plain version in bfloat16, which rounds its own
      probabilities and output and also the summed bias (by up to
      ``2^-9 bias_max``, which moves a normalised probability by twice that):
      the first bound ``+ 2^-9 (1 + 2 bias_max) A + 2^-9 |ref32|``.

    Args:
        ref32, weighted_abs_v: float32 tensors of the output's shape, the
            plain version on ``v`` and on ``|v|``.
        v_max: max |v|.
        bias_max: max |rel_h| + max |rel_w|, 0 without a bias.

    Returns:
        ``(tol32, tol16)``, tensors of the output's shape.
    """
    tol32 = 2.0**-9 * weighted_abs_v + 2.0**-8 * ref32.abs() + 2e-5 * v_max
    tol16 = tol32 + 2.0**-9 * (1.0 + 2.0 * bias_max) * weighted_abs_v + 2.0**-9 * ref32.abs()
    return tol32, tol16


# (height, width) of common COCO images: landscape 640x480, portrait
# 480x640, 640x427 and 500x375
COCO_SIZES = ((480, 640), (640, 480), (427, 640), (375, 500))


def _synthetic_object(rng, h: int, w: int, rectangle: bool):
    """One object's polygon (flat x, y list) inside an h x w image, of a size
    drawn log-uniformly so that COCO's small, medium and large ranges all
    occur, with vertices off the pixel grid and, at times, on the border."""
    side = float(np.exp(rng.uniform(np.log(6), np.log(0.6 * min(h, w)))))
    bw, bh = side * rng.uniform(0.6, 1.6), side * rng.uniform(0.6, 1.6)
    bw, bh = min(bw, w - 1.0), min(bh, h - 1.0)
    x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
    if rng.rand() < 0.15:  # touching the image's right or bottom border
        x0, y0 = (w - bw, y0) if rng.rand() < 0.5 else (x0, h - bh)
    if rectangle:
        x1, y1 = x0 + bw, y0 + bh
        return [x0, y0, x1, y0, x1, y1, x0, y1]
    n = rng.randint(5, 11)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(0.55, 1.0, n)
    xs = x0 + bw / 2 * (1 + rad * np.cos(ang))
    ys = y0 + bh / 2 * (1 + rad * np.sin(ang))
    return np.stack([xs, ys], 1).ravel().tolist()


def write_synthetic_coco(
    root: str, n_images: int, seed: int = 0, sizes=COCO_SIZES, max_objects: int = 12, keypoints: bool = False
):
    """Write ``n_images`` PNGs (through ``data/png.py``, no PIL) and a COCO
    instances json over the 80 COCO categories under ``root``; returns
    ``(json_file, image_root)``.

    Image i has size ``sizes[i % len(sizes)]``, a smooth background, and
    1..``max_objects`` objects, each a rectangle or a polygon drawn on the
    image in a color of its category, with ``bbox`` the polygon's extent and
    ``area`` its area. Every eighth image also holds a crowd region given as
    compressed RLE.

    With ``keypoints`` the json is COCO's person keypoints instead: one
    category, ``person``, with the 17 keypoint names; every object is a
    person with 17 keypoints inside its box in COCO's flat (x, y, v) pixel
    index format, visibility 0 (at 0, 0), 1 or 2 and at least one labeled,
    and ``num_keypoints``; the crowd regions have 17 unlabeled ones."""
    from detectron2_tpu_torch.data.datasets.builtin_meta import COCO_CATEGORIES, COCO_PERSON_KEYPOINT_NAMES
    from detectron2_tpu_torch.data.png import write_png
    from detectron2_tpu_torch.evaluation.rle import mask_to_rle, polygons_to_mask, rle_area, rle_to_bbox

    things = [c for c in COCO_CATEGORIES if c["isthing"]]
    rng = np.random.RandomState(seed)
    image_root = os.path.join(root, "images")
    os.makedirs(image_root, exist_ok=True)
    images, annotations = [], []
    for i in range(n_images):
        h, w = sizes[i % len(sizes)]
        yy, xx = np.mgrid[0:h, 0:w]
        base = rng.randint(0, 256, 3)
        img = ((base[None, None, :] + (xx[..., None] * rng.randint(1, 4, 3) + yy[..., None]) // 4) % 256).astype(np.uint8)
        image_id = i + 1
        for k in range(rng.randint(1, max_objects + 1)):
            cat = things[0 if keypoints else rng.randint(len(things))]
            poly = _synthetic_object(rng, h, w, rectangle=k % 2 == 0)
            mask = polygons_to_mask([np.asarray(poly)], h, w).astype(bool)
            img[mask] = cat["color"]
            xs, ys = np.asarray(poly[0::2]), np.asarray(poly[1::2])
            area = 0.5 * abs(np.dot(xs, np.roll(ys, 1)) - np.dot(ys, np.roll(xs, 1)))
            annotations.append({
                "id": len(annotations) + 1, "image_id": image_id, "category_id": cat["id"], "iscrowd": 0,
                "bbox": [float(xs.min()), float(ys.min()), float(xs.max() - xs.min()), float(ys.max() - ys.min())],
                "area": float(area), "segmentation": [[float(v) for v in poly]],
            })
            if keypoints:
                annotations[-1].update(_synthetic_keypoints(rng, xs, ys, len(COCO_PERSON_KEYPOINT_NAMES)))
        if i % 8 == 0:
            cat = things[0 if keypoints else rng.randint(len(things))]
            crowd = np.zeros((h, w), bool)
            cy, cx = rng.randint(0, h // 2), rng.randint(0, w // 2)
            crowd[cy : cy + h // 3, cx : cx + w // 3] = True
            rle = mask_to_rle(crowd)
            rle["counts"] = rle["counts"].decode("ascii")
            annotations.append({
                "id": len(annotations) + 1, "image_id": image_id, "category_id": cat["id"], "iscrowd": 1,
                "bbox": rle_to_bbox(rle).tolist(), "area": float(rle_area(rle)), "segmentation": rle,
            })
            if keypoints:  # COCO's crowd persons carry unlabeled keypoints
                annotations[-1].update(keypoints=[0.0] * 3 * len(COCO_PERSON_KEYPOINT_NAMES), num_keypoints=0)
        file_name = f"{image_id:012d}.png"
        write_png(os.path.join(image_root, file_name), img)
        images.append({"id": image_id, "file_name": file_name, "height": h, "width": w})
    categories = [{"id": c["id"], "name": c["name"]} for c in things]
    if keypoints:
        categories = [{"id": 1, "name": "person", "keypoints": list(COCO_PERSON_KEYPOINT_NAMES), "skeleton": []}]
    json_file = os.path.join(root, "instances.json")
    with open(json_file, "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
    return json_file, image_root



def _synthetic_image(rng, h: int, w: int) -> np.ndarray:
    """A smooth uint8 background of ``h`` x ``w``."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = rng.randint(0, 256, 3)
    return ((base[None, None, :] + (xx[..., None] * rng.randint(1, 4, 3) + yy[..., None]) // 4) % 256).astype(np.uint8)


def _lvis_frequency(image_count: int) -> str:
    """LVIS's frequency band of a category: rare up to 10 training images,
    common up to 100, frequent beyond."""
    return "r" if image_count <= 10 else "c" if image_count <= 100 else "f"


def write_synthetic_lvis(root: str, n_images: int, seed: int = 0, train_repeat: int = 1, sizes=COCO_SIZES) -> dict:
    """An LVIS v1 tree in d2's builtin layout under ``root``:
    ``coco/{train,val}2017/<id>.jpg`` (``n_images`` PNGs each, through
    ``data/png.py``: the names are LVIS's, the bytes PNG, which the port's
    reader and PIL both open by content) and ``lvis/lvis_v1_{train,val}.json``
    with all 1203 categories, each with ``synonyms``, ``image_count`` from
    the release's table and its ``frequency`` band. Images carry
    ``coco_url`` (no ``file_name``), ``not_exhaustive_category_ids`` and
    ``neg_category_ids``. Objects are drawn as in
    :func:`write_synthetic_coco`; their categories are skewed: two thirds
    from 8 frequent categories, the rest from all 1203, so that rare
    categories appear in a single image; the val json's first three objects
    are of a rare, a common and a frequent category. The train json lists each train
    image ``train_repeat`` times under new ids, each time with new
    categories (at LVIS's repeat threshold 0.001, a category in one image of
    more than 1000 gets a repeat factor above 1); one train object in eight
    also carries a polygon the loader drops (4 numbers). Returns the root,
    the two jsons and the image root."""
    from detectron2_tpu_torch.data.datasets.lvis_v1_category_image_count import LVIS_V1_CATEGORY_IMAGE_COUNT
    from detectron2_tpu_torch.data.png import write_png
    from detectron2_tpu_torch.evaluation.rle import polygons_to_mask

    rng = np.random.RandomState(seed)
    counts = {c["id"]: c["image_count"] for c in LVIS_V1_CATEGORY_IMAGE_COUNT}
    categories = [
        {"id": i, "name": f"lvis_category_{i}", "synonyms": [f"lvis_category_{i}"], "image_count": counts[i],
         "frequency": _lvis_frequency(counts[i])}
        for i in sorted(counts)
    ]
    frequent = rng.choice([c["id"] for c in categories if c["frequency"] == "f"], 8, replace=False)
    by_band = {band: next(c["id"] for c in categories if c["frequency"] == band) for band in "rcf"}
    image_root = os.path.join(root, "coco")
    out = {"root": root, "image_root": image_root}
    next_id = 1
    for split, repeat in (("train", train_repeat), ("val", 1)):
        os.makedirs(os.path.join(image_root, f"{split}2017"), exist_ok=True)
        shapes = []
        for i in range(n_images):
            h, w = sizes[i % len(sizes)]
            img = _synthetic_image(rng, h, w)
            polys = [_synthetic_object(rng, h, w, rectangle=k % 2 == 0) for k in range(rng.randint(1, 9))]
            for poly in polys:
                img[polygons_to_mask([np.asarray(poly)], h, w).astype(bool)] = rng.randint(0, 256, 3)
            name = f"{split}2017/{seed * 100000 + next_id + i:012d}.jpg"
            write_png(os.path.join(image_root, name), img)
            shapes.append((name, h, w, polys))
        next_id += n_images
        images, annotations = [], []
        for r in range(repeat):
            for name, h, w, polys in shapes:
                image_id = len(images) + 1
                images.append({
                    "id": image_id, "coco_url": f"http://images.cocodataset.org/{name}", "height": h, "width": w,
                    "not_exhaustive_category_ids": np.sort(rng.choice(1203, 2, replace=False) + 1).tolist(),
                    "neg_category_ids": np.sort(rng.choice(1203, 3, replace=False) + 1).tolist(),
                })
                for poly in polys:
                    cat = int(frequent[rng.randint(8)]) if rng.rand() < 2 / 3 else int(rng.randint(1203) + 1)
                    if split == "val" and len(annotations) < 3:  # one category of each band
                        cat = by_band["rcf"[len(annotations)]]
                    xs, ys = np.asarray(poly[0::2]), np.asarray(poly[1::2])
                    segm = [[float(v) for v in poly]]
                    if split == "train" and rng.randint(8) == 0:
                        segm.append(segm[0][:4])
                    annotations.append({
                        "id": len(annotations) + 1, "image_id": image_id, "category_id": cat,
                        "bbox": [float(xs.min()), float(ys.min()), float(xs.max() - xs.min()), float(ys.max() - ys.min())],
                        "area": float(0.5 * abs(np.dot(xs, np.roll(ys, 1)) - np.dot(ys, np.roll(xs, 1)))),
                        "segmentation": segm,
                    })
        os.makedirs(os.path.join(root, "lvis"), exist_ok=True)
        json_file = os.path.join(root, "lvis", f"lvis_v1_{split}.json")
        with open(json_file, "w") as f:
            json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
        out[f"{split}_json"] = json_file
    return out


DENSEPOSE_SPLITS = {
    "densepose_coco_2014_train": ("train2014", "densepose_train2014.json"),
    "densepose_coco_2014_valminusminival": ("val2014", "densepose_valminusminival2014.json"),
    "densepose_coco_2014_minival": ("val2014", "densepose_minival2014.json"),
    "densepose_coco_2014_minival_100": ("val2014", "densepose_minival2014_100.json"),
}


def write_synthetic_densepose_coco(
    root: str, n_images: int, seed: int = 0, sizes=COCO_SIZES, splits=tuple(DENSEPOSE_SPLITS), max_persons: int = 4,
    max_points: int = 100,
) -> dict:
    """The chart DensePose-COCO splits in d2's builtin layout under ``root``
    (``$DETECTRON2_DATASETS``): ``coco/{train,val}2014/<split>_<id>.png``
    (PNGs through ``data/png.py``) and ``coco/annotations/densepose_*.json``,
    ``n_images`` images a split, one category, ``person``. Each image holds
    1..``max_persons`` persons, drawn as in :func:`write_synthetic_coco`;
    three in four carry DensePose annotations: 20..``max_points`` points
    (``dp_x`` / ``dp_y`` in the box's [0, 256) frame, ``dp_I`` in 1..24,
    ``dp_U`` / ``dp_V`` in [0, 1]) and ``dp_masks``, the 14 body parts'
    compressed RLEs on the 256x256 box grid (an empty part is ``[]``).
    Returns ``{split name: (json file, image root)}``."""
    from detectron2_tpu_torch.data.png import write_png
    from detectron2_tpu_torch.evaluation.rle import polygons_to_mask

    rng = np.random.RandomState(seed)
    person_color = (220, 20, 60)
    out = {}
    for split in splits:
        folder, json_name = DENSEPOSE_SPLITS[split]
        image_root = os.path.join(root, "coco", folder)
        os.makedirs(image_root, exist_ok=True)
        images, annotations = [], []
        for i in range(n_images):
            h, w = sizes[i % len(sizes)]
            img = _synthetic_image(rng, h, w)
            image_id = i + 1
            for k in range(rng.randint(1, max_persons + 1)):
                poly = _synthetic_object(rng, h, w, rectangle=k % 2 == 0)
                img[polygons_to_mask([np.asarray(poly)], h, w).astype(bool)] = person_color
                xs, ys = np.asarray(poly[0::2]), np.asarray(poly[1::2])
                ann = {
                    "id": len(annotations) + 1, "image_id": image_id, "category_id": 1, "iscrowd": 0,
                    "bbox": [float(xs.min()), float(ys.min()), float(xs.max() - xs.min()), float(ys.max() - ys.min())],
                    "area": float(0.5 * abs(np.dot(xs, np.roll(ys, 1)) - np.dot(ys, np.roll(xs, 1)))),
                    "segmentation": [[float(v) for v in poly]],
                }
                if k % 4 != 3:
                    n = rng.randint(20, max_points + 1)
                    masks = _synthetic_dp_masks(rng)
                    ann.update(
                        dp_x=(rng.rand(n) * 255).tolist(), dp_y=(rng.rand(n) * 255).tolist(),
                        dp_I=rng.randint(1, 25, n).astype(float).tolist(), dp_U=rng.rand(n).tolist(),
                        dp_V=rng.rand(n).tolist(), dp_masks=masks,
                    )
                annotations.append(ann)
            file_name = f"{split}_{image_id:08d}.png"
            write_png(os.path.join(image_root, file_name), img)
            images.append({"id": image_id, "file_name": file_name, "height": h, "width": w})
        json_file = os.path.join(root, "coco", "annotations", json_name)
        os.makedirs(os.path.dirname(json_file), exist_ok=True)
        with open(json_file, "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": [{"id": 1, "name": "person", "supercategory": "person"}]}, f)
        out[split] = (json_file, image_root)
    return out


def _synthetic_dp_masks(rng) -> list:
    """The 14 body parts' compressed RLEs on the 256x256 box grid, a
    rectangle each or ``[]`` (empty)."""
    from detectron2_tpu_torch.evaluation.rle import mask_to_rle

    masks = []
    for _ in range(14):
        if rng.rand() < 0.4:
            masks.append([])
            continue
        m = np.zeros((256, 256), np.uint8)
        y0, x0 = rng.randint(0, 200, 2)
        m[y0 : y0 + rng.randint(8, 57), x0 : x0 + rng.randint(8, 57)] = 1
        rle = mask_to_rle(m)
        masks.append({"size": rle["size"], "counts": rle["counts"].decode("ascii")})
    return masks


def _dump_large_pickle(path: str, key: str, shape, fill, chunk_rows: int) -> None:
    """``{key: float32 array of shape}`` pickled to ``path`` (protocol 5,
    the array in band) without the array in memory: ``fill(start, stop)``
    gives rows ``start:stop``, written into a file-backed map beside
    ``path`` that the pickle is then written from and that is removed."""
    import pickle

    tmp = path + ".rows"
    mm = np.memmap(tmp, dtype=np.float32, mode="w+", shape=tuple(shape))
    try:
        for start in range(0, shape[0], chunk_rows):
            stop = min(start + chunk_rows, shape[0])
            mm[start:stop] = fill(start, stop)
        mm.flush()
        with open(path, "wb") as f:
            pickle.dump({key: np.asarray(mm)}, f, protocol=5)
    finally:
        del mm
        os.remove(tmp)


SMPL_N_REDUCED = 27554  # d2's evaluation hard-codes the condensed matrix's n


def synthetic_pdist_values(k) -> np.ndarray:
    """The synthetic condensed geodesic matrix at indices ``k``: a hash of
    the index in [0, 0.5), ``((k * 2654435761) mod 2^32) mod 1000 / 1000 *
    0.5`` rounded to float32 (``tests/projects/densepose_eval_synth.py``'s
    ``VirtualPdist``)."""
    # the product mod 2^32 is uint32 arithmetic (it wraps); the 1000 values
    # it can take, as float64 / 1000 * 0.5 rounded to float32, by table
    v = (np.asarray(k).astype(np.uint32) * np.uint32(2654435761)) % np.uint32(1000)
    return _PDIST_VALUES[v]


_PDIST_VALUES = (np.arange(1000) / 1000.0 * 0.5).astype(np.float32)


def write_synthetic_densepose_eval_data(root: str, seed: int = 0, vertices_per_part: int = 1148) -> dict:
    """The DensePose SMPL evaluation files in the layout of their download,
    under ``root/densepose_eval_data``: ``SMPL_subdiv.mat``
    (``Part_ID_subdiv``, ``U_subdiv``, ``V_subdiv``, ``[1, V]``: 24 parts of
    ``vertices_per_part`` vertices with random UVs), ``SMPL_SUBDIV_TRANSFORM
    .mat`` (``index``: raw vertex -> distinct reduced ids in 1..27554) and
    ``Pdist_matrix.pkl`` (``{"Pdist_matrix": [n (n - 1) / 2, 1]}`` float32
    over the hard-coded n = 27554, ~1.5 GB, :func:`synthetic_pdist_values`,
    written in chunks). Returns the tables as written (``part_uvs``,
    ``part_vert_inds``, ``part_ids``, ``pdist_transform``, ``n_reduced``)
    and ``seconds``."""
    import time

    import scipy.io as sio

    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)
    data_dir = os.path.join(root, "densepose_eval_data")
    os.makedirs(data_dir, exist_ok=True)
    V = 24 * vertices_per_part
    part_ids = np.repeat(np.arange(1, 25), vertices_per_part).astype(np.int64)
    uv = rng.rand(2, V)
    transform = rng.choice(np.arange(1, SMPL_N_REDUCED + 1), size=V, replace=False).astype(np.int64)
    sio.savemat(os.path.join(data_dir, "SMPL_subdiv.mat"),
                {"Part_ID_subdiv": part_ids[None].astype(np.float64), "U_subdiv": uv[:1], "V_subdiv": uv[1:]})
    sio.savemat(os.path.join(data_dir, "SMPL_SUBDIV_TRANSFORM.mat"), {"index": transform[None].astype(np.float64)})
    n = SMPL_N_REDUCED
    total = n * (n - 1) // 2
    _dump_large_pickle(
        os.path.join(data_dir, "Pdist_matrix.pkl"), "Pdist_matrix", (total, 1),
        lambda a, b: synthetic_pdist_values(np.arange(a, b))[:, None], chunk_rows=1 << 24,
    )
    vert_inds = np.arange(V) + 1
    return {
        "part_uvs": [uv[:, part_ids == i + 1] for i in range(24)],
        "part_vert_inds": [vert_inds[part_ids == i + 1] for i in range(24)],
        "part_ids": part_ids,
        "pdist_transform": transform,
        "n_reduced": n,
        "seconds": time.perf_counter() - t0,
    }


def _mesh_stems():
    from detectron2_tpu_torch.projects.densepose.meshes import MeshCatalog

    return {name: {kind: os.path.basename(getattr(info, kind)) for kind in ("data", "geodists", "symmetry", "texcoords")}
            for name, info in MeshCatalog.items()}


def write_synthetic_cse_meshes(
    root: str, mesh_names, seed: int = 0, num_vertices: Optional[dict] = None, feature_dim: int = 256,
    device: str = "cpu", geodists: bool = True,
) -> dict:
    """The files of the CSE meshes ``mesh_names`` in the layout of their
    downloads, under ``root/densepose_meshes`` (where ``meshes.create_mesh``
    looks for a file named by URL): per mesh of V vertices (the number in
    its name, or ``num_vertices[name]``) ``<mesh>.pkl`` (``vertices`` on the
    unit sphere, half of them the mirror images in x of the other half,
    ``faces``), ``geodists_<mesh>.pkl`` (``[V, V]`` float32 great-circle
    distances, a true metric, computed on ``device`` and written in chunks),
    ``symmetry_<mesh>.pkl`` (``vertex_transforms``, the mirror involution),
    ``texcoords_<mesh>.pkl`` and the LBO features ``phi_<mesh>_<F>.pkl``
    (``{"features": [V, F]}``, an ``INIT_FILE``); the geodesics only with
    ``geodists`` (SMPL's are 3 GB). Returns ``{mesh: {"features": path,
    "geodists": path or None, "num_vertices": V}}`` and ``seconds``."""
    import pickle
    import time

    import torch

    t0 = time.perf_counter()
    out_dir = os.path.join(root, "densepose_meshes")
    os.makedirs(out_dir, exist_ok=True)
    stems = _mesh_stems()
    out = {}
    for mi, name in enumerate(mesh_names):
        rng = np.random.RandomState(seed + 1000 * mi)
        V = (num_vertices or {}).get(name) or int(name.rsplit("_", 1)[1])
        half = V // 2
        x = rng.standard_normal((half, 3))
        x[:, 0] = np.abs(x[:, 0])
        mirror = x * np.array([-1.0, 1.0, 1.0])
        mid = rng.standard_normal((V - 2 * half, 3))
        mid[:, 0] = 0.0
        verts = np.concatenate([x, mirror, mid])
        verts = (verts / np.linalg.norm(verts, axis=1, keepdims=True)).astype(np.float32)
        sym = np.concatenate([np.arange(half, 2 * half), np.arange(half), np.arange(2 * half, V)]).astype(np.int64)
        paths = {k: os.path.join(out_dir, v) for k, v in stems[name].items()}
        with open(paths["data"], "wb") as f:
            pickle.dump({"vertices": verts, "faces": rng.randint(0, V, (2 * V, 3)).astype(np.int64)}, f)
        with open(paths["symmetry"], "wb") as f:
            pickle.dump({"vertex_transforms": sym}, f)
        with open(paths["texcoords"], "wb") as f:
            pickle.dump({"texcoords": rng.rand(V, 2).astype(np.float32)}, f)
        features = os.path.join(out_dir, f"phi_{name}_{feature_dim}.pkl")
        with open(features, "wb") as f:
            pickle.dump({"features": (rng.standard_normal((V, feature_dim)) / np.sqrt(feature_dim)).astype(np.float32)}, f)
        if geodists:
            vt = torch.from_numpy(verts).to(device)

            def rows(a, b, vt=vt):
                d = torch.arccos((vt[a:b] @ vt.T).clamp(-1.0, 1.0))
                d[torch.arange(b - a), torch.arange(a, b)] = 0.0  # exact zeros on the diagonal
                return d.cpu().numpy()

            _dump_large_pickle(paths["geodists"], "geodists", (V, V), rows, chunk_rows=2048)
        out[name] = {"features": features, "geodists": paths["geodists"] if geodists else None, "num_vertices": V}
    out["seconds"] = time.perf_counter() - t0
    return out


DENSEPOSE_CSE_SPLITS = {
    "densepose_coco_2014_train_cse": ("train2014", "densepose_train2014_cse.json"),
    "densepose_coco_2014_valminusminival_cse": ("val2014", "densepose_valminusminival2014_cse.json"),
    "densepose_coco_2014_minival_cse": ("val2014", "densepose_minival2014_cse.json"),
    "densepose_coco_2014_minival_100_cse": ("val2014", "densepose_minival2014_100_cse.json"),
}
DENSEPOSE_LVIS_SPLITS = {
    "densepose_lvis_v1_ds1_train_v1": ("train2017", "densepose_lvis_v1_ds1_train_v1.json"),
    "densepose_lvis_v1_ds1_val_v1": ("val2017", "densepose_lvis_v1_ds1_val_v1.json"),
    "densepose_lvis_v1_ds2_train_v1": ("train2017", "densepose_lvis_v1_ds2_train_v1.json"),
    "densepose_lvis_v1_ds2_val_v1": ("val2017", "densepose_lvis_v1_ds2_val_v1.json"),
}
# the animals of the DensePose-LVIS configs' whitelists (LVIS v1 ids) and the
# mesh of their ref_model in ds1 and ds2 (ds2 has the 7466-vertex cat and dog)
DENSEPOSE_LVIS_ANIMALS = {
    76: ("bear", "bear_4936", "bear_4936"), 80: ("cow", "cow_5002", "cow_5002"), 225: ("cat", "cat_5001", "cat_7466"),
    378: ("dog", "dog_5002", "dog_7466"), 422: ("elephant", "elephant_5002", "elephant_5002"),
    496: ("giraffe", "giraffe_5002", "giraffe_5002"), 569: ("horse", "horse_5004", "horse_5004"),
    943: ("sheep", "sheep_5004", "sheep_5004"), 1202: ("zebra", "zebra_5002", "zebra_5002"),
}
# LVIS categories outside the whitelists, which the DensePose trainer drops
DENSEPOSE_LVIS_OTHERS = {3: "aerosol_can", 35: "bagel"}


def write_synthetic_densepose_cse(
    root: str, n_images: int, seed: int = 0, sizes=COCO_SIZES, coco_splits=tuple(DENSEPOSE_CSE_SPLITS),
    lvis_splits=tuple(DENSEPOSE_LVIS_SPLITS), max_objects: int = 4, max_points: int = 100,
    num_vertices: Optional[dict] = None,
) -> dict:
    """The CSE DensePose splits in d2's builtin layout under ``root``:
    ``coco/annotations/densepose_*_cse.json`` over ``coco/{train,val}2014``
    PNGs (one category, person) and ``lvis/densepose_lvis_v1_*.json`` (LVIS
    format, images by ``coco_url`` under ``coco_/{train,val}2017``, PNG bytes
    under ``.jpg`` names; the nine animal categories, and in the train
    splits two others).
    Objects as :func:`write_synthetic_coco` draws them, with a
    ``segmentation`` polygon; three in four carry CSE annotations: 20..
    ``max_points`` points (``dp_x`` / ``dp_y`` in the box's [0, 256)
    frame), ``dp_vertex`` below the mesh's vertex count (the number in its
    name, or ``num_vertices[mesh]``), ``ref_model`` (``smpl_27554`` for a
    person; an animal's mesh, the ds2 splits' 7466-vertex cat and dog) and
    ``dp_masks``. Returns ``{split name: (json file, image root)}``."""
    from detectron2_tpu_torch.data.png import write_png
    from detectron2_tpu_torch.evaluation.rle import polygons_to_mask

    rng = np.random.RandomState(seed)

    def n_verts(mesh):
        return (num_vertices or {}).get(mesh) or int(mesh.rsplit("_", 1)[1])

    def objects(h, w, img, pick_category):
        anns = []
        for k in range(rng.randint(1, max_objects + 1)):
            cat, mesh = pick_category(k)
            poly = _synthetic_object(rng, h, w, rectangle=k % 2 == 0)
            img[polygons_to_mask([np.asarray(poly)], h, w).astype(bool)] = (40 + 50 * (k % 4), 200, 120)
            xs, ys = np.asarray(poly[0::2]), np.asarray(poly[1::2])
            ann = {
                "category_id": cat, "iscrowd": 0,
                "bbox": [float(xs.min()), float(ys.min()), float(xs.max() - xs.min()), float(ys.max() - ys.min())],
                "area": float(0.5 * abs(np.dot(xs, np.roll(ys, 1)) - np.dot(ys, np.roll(xs, 1)))),
                "segmentation": [[float(v) for v in poly]],
            }
            if mesh is not None and k % 4 != 3:
                n = rng.randint(20, max_points + 1)
                ann.update(
                    dp_x=(rng.rand(n) * 255).tolist(), dp_y=(rng.rand(n) * 255).tolist(),
                    dp_vertex=rng.randint(0, n_verts(mesh), n).tolist(), ref_model=mesh, dp_masks=_synthetic_dp_masks(rng),
                )
            anns.append(ann)
        return anns

    out = {}
    for split in coco_splits:
        folder, json_name = DENSEPOSE_CSE_SPLITS[split]
        image_root = os.path.join(root, "coco", folder)
        os.makedirs(image_root, exist_ok=True)
        images, annotations = [], []
        for i in range(n_images):
            h, w = sizes[i % len(sizes)]
            img = _synthetic_image(rng, h, w)
            for ann in objects(h, w, img, lambda k: (1, "smpl_27554")):
                annotations.append({**ann, "id": len(annotations) + 1, "image_id": i + 1})
            file_name = f"{split}_{i + 1:08d}.png"
            write_png(os.path.join(image_root, file_name), img)
            images.append({"id": i + 1, "file_name": file_name, "height": h, "width": w})
        json_file = os.path.join(root, "coco", "annotations", json_name)
        os.makedirs(os.path.dirname(json_file), exist_ok=True)
        with open(json_file, "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": [{"id": 1, "name": "person", "supercategory": "person"}]}, f)
        out[split] = (json_file, image_root)

    animals = sorted(DENSEPOSE_LVIS_ANIMALS)
    for split in lvis_splits:
        folder, json_name = DENSEPOSE_LVIS_SPLITS[split]
        ds2, train = "_ds2_" in split, "_train_" in split
        # the train splits also hold categories outside the whitelists; the
        # val splits, which COCOEvaluator scores per category, the animals alone
        categories = [{"id": c, "name": DENSEPOSE_LVIS_ANIMALS[c][0], "synonyms": [DENSEPOSE_LVIS_ANIMALS[c][0]]}
                      for c in animals] + [{"id": c, "name": n, "synonyms": [n]}
                                           for c, n in DENSEPOSE_LVIS_OTHERS.items() if train]
        image_root = os.path.join(root, "coco_", folder)
        os.makedirs(image_root, exist_ok=True)
        images, annotations = [], []

        def pick(k, train=train):
            if train and k == 3 and rng.rand() < 0.5:  # a category outside the whitelist
                return int(rng.choice(list(DENSEPOSE_LVIS_OTHERS))), None
            cat = animals[rng.randint(len(animals))]
            return cat, DENSEPOSE_LVIS_ANIMALS[cat][2 if ds2 else 1]

        for i in range(n_images):
            h, w = sizes[i % len(sizes)]
            img = _synthetic_image(rng, h, w)
            image_id = 100000 * (2 if ds2 else 1) + i + 1
            for ann in objects(h, w, img, pick):
                annotations.append({**ann, "id": len(annotations) + 1, "image_id": image_id})
            file_name = f"{image_id:012d}.jpg"
            write_png(os.path.join(image_root, file_name), img)
            images.append({"id": image_id, "coco_url": f"http://images.cocodataset.org/{folder}/{file_name}",
                           "height": h, "width": w, "neg_category_ids": [], "not_exhaustive_category_ids": []})
        json_file = os.path.join(root, "lvis", json_name)
        os.makedirs(os.path.dirname(json_file), exist_ok=True)
        with open(json_file, "w") as f:
            json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
        out[split] = (json_file, os.path.join(root, "coco_"))  # the loader's root: coco_url's folder comes under it
    return out


def write_synthetic_voc(root: str, n_images: int, seed: int = 0, sizes=COCO_SIZES) -> str:
    """Pascal VOC 2007 and 2012 trees under ``root`` in d2's builtin layout:
    ``VOC2007`` with ``n_images`` images in ``trainval`` and ``n_images`` in
    ``test``, ``VOC2012`` with ``n_images`` in ``trainval`` (and each
    trainval split halved into ``train`` and ``val``); each image a PNG
    named ``JPEGImages/<id>.jpg`` and an ``Annotations/<id>.xml`` with VOC's
    1-based integer boxes, ``pose``, ``truncated`` and, for one object in
    six, ``difficult`` 1; the first 20 objects of a split are the 20 classes
    in order, none difficult, so that every class has ground truth.
    Returns ``root``."""
    from detectron2_tpu_torch.data.datasets.pascal_voc import CLASS_NAMES
    from detectron2_tpu_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    for year, splits in ((2007, ("trainval", "test")), (2012, ("trainval",))):
        d = os.path.join(root, f"VOC{year}")
        for sub in ("Annotations", os.path.join("ImageSets", "Main"), "JPEGImages"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        for split in splits:
            ids, k = [], 0
            for i in range(n_images):
                fileid = f"{year}_{split}_{i:06d}"
                h, w = sizes[i % len(sizes)]
                img = _synthetic_image(rng, h, w)
                objects = []
                for _ in range(rng.randint(1, 7)):
                    x0, y0 = rng.randint(1, w - 16), rng.randint(1, h - 16)
                    x1, y1 = rng.randint(x0 + 8, min(x0 + 0.7 * w, w) + 1), rng.randint(y0 + 8, min(y0 + 0.7 * h, h) + 1)
                    cls = k if k < len(CLASS_NAMES) else int(rng.randint(len(CLASS_NAMES)))
                    difficult = int(k >= len(CLASS_NAMES) and rng.randint(6) == 0)
                    k += 1
                    img[y0 - 1 : y1, x0 - 1 : x1] = (np.array([37, 91, 173]) * (cls + 1)) % 256
                    objects.append(
                        "  <object>\n"
                        f"    <name>{CLASS_NAMES[cls]}</name>\n    <pose>Unspecified</pose>\n"
                        f"    <truncated>{int(rng.rand() < 0.2)}</truncated>\n"
                        f"    <difficult>{difficult}</difficult>\n"
                        f"    <bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox>\n"
                        "  </object>\n"
                    )
                write_png(os.path.join(d, "JPEGImages", fileid + ".jpg"), img)
                with open(os.path.join(d, "Annotations", fileid + ".xml"), "w") as f:
                    f.write(
                        f"<annotation>\n  <folder>VOC{year}</folder>\n  <filename>{fileid}.jpg</filename>\n"
                        f"  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>\n"
                        + "".join(objects) + "</annotation>\n"
                    )
                ids.append(fileid)
            with open(os.path.join(d, "ImageSets", "Main", split + ".txt"), "w") as f:
                f.write("".join(x + "\n" for x in ids))
            if split == "trainval":
                for part, sub_ids in (("train", ids[0::2]), ("val", ids[1::2])):
                    with open(os.path.join(d, "ImageSets", "Main", part + ".txt"), "w") as f:
                        f.write("".join(x + "\n" for x in sub_ids))
    return root


# the builtin COCO panoptic splits: (images, instances json, panoptic PNGs, panoptic json, stuff labels)
_PANOPTIC_SPLITS = {
    "train": ("train2017", "instances_train2017.json", "panoptic_train2017", "panoptic_train2017.json", "panoptic_stuff_train2017"),
    "val": ("val2017", "instances_val2017.json", "panoptic_val2017", "panoptic_val2017.json", "panoptic_stuff_val2017"),
    "val_100": ("val2017", "instances_val2017_100.json", "panoptic_val2017_100", "panoptic_val2017_100.json",
                "panoptic_stuff_val2017_100"),
}


def _synthetic_panoptic_image(rng, h: int, w: int, max_objects: int):
    """One image's panoptic ground truth: ``(image, segment id map,
    segments)``. 2-4 stuff categories in vertical bands, at times a void
    strip at the bottom, then 1..``max_objects`` thing objects (rectangles
    and polygons) drawn over them; each segment in its category's color
    plus noise. Segments are dicts of id, category, polygon (things) and
    the mask's area and bbox; a thing hidden by later ones is dropped."""
    from detectron2_tpu_torch.data.datasets.builtin_meta import COCO_CATEGORIES
    from detectron2_tpu_torch.evaluation.rle import polygons_to_mask

    things = [c for c in COCO_CATEGORIES if c["isthing"]]
    stuff = [c for c in COCO_CATEGORIES if not c["isthing"]]
    ids = np.zeros((h, w), np.int64)
    cats = {}
    n_stuff = rng.randint(2, 5)
    cuts = np.sort(rng.choice(np.arange(1, w), n_stuff - 1, replace=False)).tolist()
    for k, (x0, x1) in enumerate(zip([0] + cuts, cuts + [w])):
        ids[:, x0:x1] = k + 1
        cats[k + 1] = (stuff[rng.randint(len(stuff))], None)
    if rng.rand() < 0.5:
        ids[h - rng.randint(2, max(3, h // 12)) :] = 0  # void
    for k in range(rng.randint(1, max_objects + 1)):
        poly = _synthetic_object(rng, h, w, rectangle=k % 2 == 0)
        seg_id = len(cats) + 1
        ids[polygons_to_mask([np.asarray(poly)], h, w).astype(bool)] = seg_id
        cats[seg_id] = (things[rng.randint(len(things))], poly)
    image = (rng.randint(0, 24, (h, w, 3))).astype(np.uint8)
    segments = []
    for seg_id, (cat, poly) in cats.items():
        mask = ids == seg_id
        if not mask.any():
            continue
        image[mask] += np.asarray(cat["color"], np.uint8) // 2
        ys, xs = np.nonzero(mask)
        x0, y0 = int(xs.min()), int(ys.min())
        segments.append({
            "id": seg_id, "category": cat, "polygon": poly, "area": int(mask.sum()),
            "bbox": [x0, y0, int(xs.max()) - x0 + 1, int(ys.max()) - y0 + 1],
        })
    return image, ids, segments


def write_synthetic_coco_panoptic(root: str, n_images: int, seed: int = 0, sizes=COCO_SIZES, max_objects: int = 8,
                                  val_100: int = 0) -> dict:
    """A COCO panoptic tree in d2's builtin layout under ``root`` (a
    ``$DETECTRON2_DATASETS``): ``coco/{train,val}2017/<id>.jpg``
    (``n_images`` each: PNG bytes under COCO's names, through
    ``data/png.py``), ``coco/annotations/instances_*.json`` (the things, as
    polygons), ``coco/annotations/panoptic_*.json`` (the segments of all 133
    categories), ``coco/panoptic_*/<id>.png`` (RGB-id PNGs, id = r + 256 g +
    256^2 b, 0 void) and ``coco/panoptic_stuff_*/<id>.png`` ("L": things 0,
    the 53 stuff categories 1..53, void 255), as d2's
    ``prepare_panoptic_fpn.py`` makes them. The ``val2017_100`` files list
    the first ``val_100`` val images (default all). Returns the paths by
    split."""
    from detectron2_tpu_torch.data.datasets.builtin_meta import COCO_CATEGORIES
    from detectron2_tpu_torch.data.png import write_png
    from detectron2_tpu_torch.evaluation.panoptic_evaluation import id2rgb

    rng = np.random.RandomState(seed)
    coco = os.path.join(root, "coco")
    os.makedirs(os.path.join(coco, "annotations"), exist_ok=True)
    stuff_label = {c["id"]: i + 1 for i, c in enumerate(c for c in COCO_CATEGORIES if not c["isthing"])}
    categories = [{"id": c["id"], "name": c["name"], "isthing": c["isthing"], "color": c["color"]} for c in COCO_CATEGORIES]
    instance_categories = [{"id": c["id"], "name": c["name"]} for c in COCO_CATEGORIES if c["isthing"]]
    out = {"root": root}
    records = {}
    for split in ("train", "val"):
        images_dir, _, pan_dir, _, stuff_dir = _PANOPTIC_SPLITS[split]
        for d in (images_dir, pan_dir, stuff_dir):
            os.makedirs(os.path.join(coco, d), exist_ok=True)
        records[split] = []
        for i in range(n_images):
            h, w = sizes[i % len(sizes)]
            image, ids, segments = _synthetic_panoptic_image(rng, h, w, max_objects)
            image_id = (1 if split == "train" else 2) * 1000000 + seed * 10000 + i + 1
            stem = f"{image_id:012d}"
            write_png(os.path.join(coco, images_dir, stem + ".jpg"), image)
            write_png(os.path.join(coco, pan_dir, stem + ".png"), id2rgb(ids))
            labels = np.full((h, w), 255, np.uint8)
            for seg in segments:
                cat = seg["category"]
                labels[ids == seg["id"]] = 0 if cat["isthing"] else stuff_label[cat["id"]]
            write_png(os.path.join(coco, stuff_dir, stem + ".png"), labels)
            records[split].append((stem, h, w, image_id, segments))
    records["val_100"] = records["val"][: val_100 or n_images]
    for split, recs in records.items():
        images_dir, inst_json, pan_dir, pan_json, stuff_dir = _PANOPTIC_SPLITS[split]
        if split == "val_100":
            for d, src in ((pan_dir, _PANOPTIC_SPLITS["val"][2]), (stuff_dir, _PANOPTIC_SPLITS["val"][4])):
                os.makedirs(os.path.join(coco, d), exist_ok=True)
                for stem, *_ in recs:
                    with open(os.path.join(coco, src, stem + ".png"), "rb") as f_in, \
                            open(os.path.join(coco, d, stem + ".png"), "wb") as f_out:
                        f_out.write(f_in.read())
        images = [{"id": image_id, "file_name": stem + ".jpg", "height": h, "width": w} for stem, h, w, image_id, _ in recs]
        annotations, panoptic = [], []
        for stem, h, w, image_id, segments in recs:
            for seg in segments:
                if seg["polygon"] is None:
                    continue
                poly = seg["polygon"]
                xs, ys = np.asarray(poly[0::2]), np.asarray(poly[1::2])
                annotations.append({
                    "id": len(annotations) + 1, "image_id": image_id, "category_id": seg["category"]["id"], "iscrowd": 0,
                    "bbox": [float(xs.min()), float(ys.min()), float(xs.max() - xs.min()), float(ys.max() - ys.min())],
                    "area": float(0.5 * abs(np.dot(xs, np.roll(ys, 1)) - np.dot(ys, np.roll(xs, 1)))),
                    "segmentation": [[float(v) for v in poly]],
                })
            panoptic.append({
                "image_id": image_id, "file_name": stem + ".png",
                "segments_info": [
                    {"id": seg["id"], "category_id": seg["category"]["id"], "iscrowd": 0, "area": seg["area"], "bbox": seg["bbox"]}
                    for seg in segments
                ],
            })
        with open(os.path.join(coco, "annotations", inst_json), "w") as f:
            json.dump({"images": images, "annotations": annotations, "categories": instance_categories}, f)
        with open(os.path.join(coco, "annotations", pan_json), "w") as f:
            json.dump({"images": images, "annotations": panoptic, "categories": categories}, f)
        out[split] = {
            "images": os.path.join(coco, images_dir),
            "instances_json": os.path.join(coco, "annotations", inst_json),
            "panoptic_json": os.path.join(coco, "annotations", pan_json),
            "panoptic_root": os.path.join(coco, pan_dir),
            "stuff_root": os.path.join(coco, stuff_dir),
        }
    return out


def write_synthetic_proposals(root: str, dataset_dicts, topk: int, seed: int = 0) -> str:
    """A d2 proposal pickle for ``dataset_dicts`` (records with
    ``image_id``, ``height``, ``width`` and ``annotations``) at
    ``root/proposals.pkl``: ``ids``, ``boxes`` (``topk`` XYXY_ABS boxes an
    image, float32), ``objectness_logits`` (float32) and ``bbox_mode``.
    About a third of the boxes are each gt box jittered by up to a quarter
    of its size, with the higher logits; the rest are random, some of them
    reaching past the image, some of zero width or wholly right of it, so
    that the loader's clip and its filter of empty boxes both act.
    Unsorted, as d2 writes them. Returns the path."""
    import pickle

    from detectron2_tpu_torch.structures import BoxMode

    rng = np.random.RandomState(seed)
    ids, all_boxes, all_logits = [], [], []
    for record in dataset_dicts:
        h, w = record["height"], record["width"]
        gt = np.asarray(
            [BoxMode.convert(np.asarray(a["bbox"], np.float64)[None], a["bbox_mode"], BoxMode.XYXY_ABS)[0]
             for a in record.get("annotations", [])] or np.zeros((0, 4)),
            np.float64,
        ).reshape(-1, 4)
        n_jit = min(topk // 3, 32 * len(gt))
        boxes = np.zeros((topk, 4), np.float64)
        logits = rng.standard_normal(topk) - 2.0
        if n_jit:
            src = gt[rng.randint(len(gt), size=n_jit)]
            size = np.concatenate([src[:, 2:] - src[:, :2]] * 2, axis=1)
            boxes[:n_jit] = src + rng.uniform(-0.25, 0.25, (n_jit, 4)) * size
            logits[:n_jit] += 4.0
        n_rand = topk - n_jit
        xy = rng.uniform([-0.1 * w, -0.1 * h], [w, h], (n_rand, 2))
        wh = np.exp(rng.uniform(np.log(2.0), np.log(0.8 * max(h, w)), (n_rand, 2)))
        wh[rng.rand(n_rand) < 0.05, 0] = 0.0  # empty
        xy[rng.rand(n_rand) < 0.05, 0] += w  # right of the image: empty once clipped
        boxes[n_jit:] = np.concatenate([xy, xy + wh], axis=1)
        perm = rng.permutation(topk)
        ids.append(record["image_id"])
        all_boxes.append(boxes[perm].astype(np.float32))
        all_logits.append(logits[perm].astype(np.float32))
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "proposals.pkl")
    with open(path, "wb") as f:
        pickle.dump(
            {"ids": ids, "boxes": all_boxes, "objectness_logits": all_logits, "bbox_mode": int(BoxMode.XYXY_ABS)}, f
        )
    return path


CITYSCAPES_SIZE = (1024, 2048)
# label ids of the Cityscapes classes the writer draws (the public label table)
_CITYSCAPES_LABEL_IDS = {
    "road": 7, "building": 11, "sky": 23, "person": 24, "rider": 25, "car": 26, "truck": 27, "bus": 28,
    "train": 31, "motorcycle": 32, "bicycle": 33,
}


def _synthetic_cityscapes_image(rng, h: int, w: int, max_objects: int):
    """One image and its ground truth: ``(image, label ids, objects)``. Sky,
    building and road in horizontal bands (the bands' polygons among the
    objects, as Cityscapes lists stuff), at times an unlabeled strip, then
    things drawn over them; at times a crowd (``cargroup`` or
    ``persongroup``), a ``"car group"``, a deleted object and a polygon of
    two points. Polygons are integer ``[[x, y], ...]`` as in
    ``*_gtFine_polygons.json``."""
    from detectron2_tpu_torch.data.datasets.cityscapes import CITYSCAPES_THING_CLASSES
    from detectron2_tpu_torch.evaluation.rle import polygons_to_mask

    ids = np.zeros((h, w), np.uint8)
    cuts = sorted(rng.randint(h // 6, 5 * h // 6, 2).tolist())
    objects = []
    for label, (y0, y1) in zip(("sky", "building", "road"), ((0, cuts[0]), (cuts[0], cuts[1]), (cuts[1], h))):
        ids[y0:y1] = _CITYSCAPES_LABEL_IDS[label]
        objects.append({"label": label, "polygon": [[0, y0], [w - 1, y0], [w - 1, y1 - 1], [0, y1 - 1]]})
    if rng.rand() < 0.5:
        ids[:, : rng.randint(2, max(3, w // 40))] = 0  # unlabeled
    things = [(c, 0) for c in CITYSCAPES_THING_CLASSES]
    draws = [things[rng.randint(len(things))] for _ in range(rng.randint(2, max_objects + 1))]
    if rng.rand() < 0.6:
        draws.append((("car", "person")[rng.randint(2)], 1))  # a crowd, labelled "<class>group"
    for k, (label, crowd) in enumerate(draws):
        flat = np.asarray(_synthetic_object(rng, h, w, rectangle=k % 3 == 0))
        poly = np.round(flat).astype(np.int64).reshape(-1, 2)
        ids[polygons_to_mask([poly.reshape(-1).astype(np.float64)], h, w).astype(bool)] = _CITYSCAPES_LABEL_IDS[label]
        objects.append({"label": label + "group" if crowd else label, "polygon": poly.tolist()})
    if rng.rand() < 0.5:
        objects.append({"label": "car group", "polygon": [[10, 10], [60, 10], [60, 40], [10, 40]]})
    if rng.rand() < 0.5:
        objects.append({"label": "person", "polygon": [[20, 20], [90, 20], [90, 200]], "deleted": 1})
    if rng.rand() < 0.5:
        objects.append({"label": "bicycle", "polygon": [[5, 5], [40, 30]]})
    image = _synthetic_image(rng, h, w)
    for label, lid in _CITYSCAPES_LABEL_IDS.items():
        image[ids == lid] = image[ids == lid] // 2 + (np.asarray([lid * 7, lid * 13, lid * 29]) % 128).astype(np.uint8)
    return image, ids, objects


def write_synthetic_cityscapes(
    root: str, n_images: int, seed: int = 0, n_val: Optional[int] = None, size=CITYSCAPES_SIZE, max_objects: int = 10
) -> dict:
    """A Cityscapes tree in d2's builtin layout under ``root`` (a
    ``$DETECTRON2_DATASETS``): ``n_images`` train and ``n_val`` (default
    half as many) val images of ``size`` (h, w; Cityscapes' 1024 x 2048 by
    default) in two cities each,
    ``cityscapes/leftImg8bit/<split>/<city>/<city>_000000_<k>_leftImg8bit.png``,
    and beside each under ``cityscapes/gtFine/<split>/<city>/`` its
    ``*_gtFine_polygons.json`` (``imgHeight``, ``imgWidth``, ``objects``),
    ``*_gtFine_labelIds.png`` and ``*_gtFine_labelTrainIds.png`` (255 off
    the 19 classes), all through ``data/png.py``. Returns the split
    directories."""
    from detectron2_tpu_torch.data.png import write_png
    from detectron2_tpu_torch.evaluation.cityscapes_evaluation import CITYSCAPES_ID_TO_TRAINID

    rng = np.random.RandomState(seed)
    h, w = size
    to_train = np.full(256, 255, np.uint8)
    for label_id, train_id in CITYSCAPES_ID_TO_TRAINID.items():
        to_train[label_id] = train_id
    out = {"root": root}
    cities = {"train": ("aachen", "bochum"), "val": ("frankfurt", "lindau")}
    for split, n in (("train", n_images), ("val", n_images // 2 if n_val is None else n_val)):
        image_dir = os.path.join(root, "cityscapes", "leftImg8bit", split)
        gt_dir = os.path.join(root, "cityscapes", "gtFine", split)
        for i in range(n):
            city = cities[split][i % 2]
            stem = f"{city}_000000_{i:06d}_"
            os.makedirs(os.path.join(image_dir, city), exist_ok=True)
            os.makedirs(os.path.join(gt_dir, city), exist_ok=True)
            image, ids, objects = _synthetic_cityscapes_image(rng, h, w, max_objects)
            write_png(os.path.join(image_dir, city, stem + "leftImg8bit.png"), image)
            write_png(os.path.join(gt_dir, city, stem + "gtFine_labelIds.png"), ids)
            write_png(os.path.join(gt_dir, city, stem + "gtFine_labelTrainIds.png"), to_train[ids])
            with open(os.path.join(gt_dir, city, stem + "gtFine_polygons.json"), "w") as f:
                json.dump({"imgHeight": h, "imgWidth": w, "objects": objects}, f)
        out[split] = {"image_dir": image_dir, "gt_dir": gt_dir}
    return out


def write_synthetic_cityscapes_panoptic(root: str) -> dict:
    """The panoptic ground truth of a :func:`write_synthetic_cityscapes`
    tree under ``root``, as Cityscapes' ``createPanopticImgs`` lays it out:
    ``cityscapes/gtFine/cityscapes_panoptic_<split>.json`` (``images``,
    ``annotations`` with ``segments_info`` of label ids, ``categories``:
    the 19 classes) and the RGB-id PNGs
    ``cityscapes/gtFine/cityscapes_panoptic_<split>/<stem>_gtFine_panoptic.png``.
    A thing object (a polygon of 3 points or more, not deleted) is one
    segment, ``label id * 1000 + k`` with ``k`` its 1-based number in its
    class, a crowd (``<class>group``) one of id ``label id``, as each stuff
    class's pixels are; other pixels 0. Returns the json paths by split."""
    from detectron2_tpu_torch.data.datasets.builtin_meta import CITYSCAPES_CATEGORIES
    from detectron2_tpu_torch.data.datasets.cityscapes import CITYSCAPES_THING_CLASSES
    from detectron2_tpu_torch.data.png import read_png, write_png
    from detectron2_tpu_torch.evaluation.panoptic_evaluation import id2rgb
    from detectron2_tpu_torch.evaluation.rle import polygons_to_mask

    stuff_ids = {c[0] for c in CITYSCAPES_CATEGORIES if not c[3]}
    label_ids = {c[2]: c[0] for c in CITYSCAPES_CATEGORIES}
    categories = [{"id": c[0], "name": c[2], "color": list(c[4]), "isthing": int(c[3]), "supercategory": ""}
                  for c in CITYSCAPES_CATEGORIES]
    out = {}
    for split in ("train", "val"):
        gt_root = os.path.join(root, "cityscapes", "gtFine")
        pan_dir = os.path.join(gt_root, f"cityscapes_panoptic_{split}")
        os.makedirs(pan_dir, exist_ok=True)
        images, annotations = [], []
        for city in sorted(os.listdir(os.path.join(gt_root, split))):
            for name in sorted(os.listdir(os.path.join(gt_root, split, city))):
                if not name.endswith("_gtFine_polygons.json"):
                    continue
                stem = name[: -len("_gtFine_polygons.json")]
                with open(os.path.join(gt_root, split, city, name)) as f:
                    poly_json = json.load(f)
                labels = read_png(os.path.join(gt_root, split, city, stem + "_gtFine_labelIds.png")).astype(np.int64)
                if labels.ndim == 3:
                    labels = labels[..., 0]
                h, w = labels.shape
                pan = np.where(np.isin(labels, list(stuff_ids)), labels, 0)
                counts = {}
                for obj in poly_json["objects"]:
                    label, poly = obj["label"], obj["polygon"]
                    crowd = label.endswith("group")
                    cls = label[: -len("group")] if crowd else label
                    if obj.get("deleted", 0) or cls not in CITYSCAPES_THING_CLASSES or len(poly) < 3:
                        continue
                    lid = label_ids[cls]
                    mask = polygons_to_mask([np.asarray(poly, np.float64).reshape(-1)], h, w).astype(bool)
                    mask &= labels == lid
                    if crowd:
                        pan[mask] = lid
                    else:
                        counts[lid] = counts.get(lid, 0) + 1
                        pan[mask] = lid * 1000 + counts[lid]
                segments = []
                for pid in np.unique(pan):
                    if pid == 0:
                        continue
                    ys, xs = np.nonzero(pan == pid)
                    cat = int(pid) // 1000 if pid >= 1000 else int(pid)
                    segments.append({
                        "id": int(pid), "category_id": cat, "area": int(len(ys)),
                        "iscrowd": int(pid < 1000 and cat not in stuff_ids),
                        "bbox": [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)],
                    })
                write_png(os.path.join(pan_dir, stem + "_gtFine_panoptic.png"), id2rgb(pan))
                images.append({"id": stem, "file_name": stem + "_leftImg8bit.png", "height": h, "width": w})
                annotations.append({"image_id": stem, "file_name": stem + "_gtFine_panoptic.png", "segments_info": segments})
        json_file = os.path.join(gt_root, f"cityscapes_panoptic_{split}.json")
        with open(json_file, "w") as f:
            json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
        out[split] = json_file
    return out


def panoptic_deeplab_batch(cfg, dataset_name: str, n: int, crop, seed: int = 0) -> dict:
    """A Panoptic-DeepLab training batch from the first ``n`` records of a
    registered panoptic dataset: each image (``cfg.INPUT.FORMAT``) and its
    panoptic PNG cut at one ``crop`` (h, w) window drawn from
    ``RandomState(seed)``, the targets made by the port's
    ``PanopticDeepLabTargetGenerator`` with ``cfg.INPUT``'s sigma and
    weights and the dataset's thing ids. (Neither package has
    Panoptic-DeepLab's train mapper: ROADMAP C.) Returns numpy arrays:
    ``image`` uint8 ``[n, h, w, 3]``, ``image_sizes``, ``gt_sem_seg``,
    ``gt_center``, ``gt_offset``, ``gt_center_weights``, ``gt_offset_weights``."""
    from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from detectron2_tpu_torch.data.detection_utils import read_image
    from detectron2_tpu_torch.evaluation.panoptic_evaluation import rgb2id
    from detectron2_tpu_torch.projects.panoptic_deeplab import PanopticDeepLabTargetGenerator

    meta = MetadataCatalog.get(dataset_name)
    gen = PanopticDeepLabTargetGenerator(
        meta.ignore_label, list(meta.thing_dataset_id_to_contiguous_id.values()), sigma=cfg.INPUT.GAUSSIAN_SIGMA,
        ignore_stuff_in_offset=cfg.INPUT.IGNORE_STUFF_IN_OFFSET, small_instance_area=cfg.INPUT.SMALL_INSTANCE_AREA,
        small_instance_weight=cfg.INPUT.SMALL_INSTANCE_WEIGHT,
    )
    rng = np.random.RandomState(seed)
    ch, cw = crop
    parts = []
    for d in DatasetCatalog.get(dataset_name)[:n]:
        image = read_image(d["file_name"], cfg.INPUT.FORMAT)
        pan = rgb2id(read_image(d["pan_seg_file_name"], "RGB"))
        y0, x0 = rng.randint(image.shape[0] - ch + 1), rng.randint(image.shape[1] - cw + 1)
        targets = gen(pan[y0 : y0 + ch, x0 : x0 + cw], d["segments_info"])
        parts.append({"image": image[y0 : y0 + ch, x0 : x0 + cw], **targets})
    batch = {k: np.stack([p[k] for p in parts]) for k in parts[0]}
    batch["image_sizes"] = np.asarray([[ch, cw]] * len(parts), np.int32)
    return batch


def _synthetic_keypoints(rng, xs, ys, num_keypoints: int) -> dict:
    """``num_keypoints`` keypoints inside the extent of the polygon ``xs``,
    ``ys``, as COCO's flat (x, y, v) pixel indices with ``num_keypoints``."""
    vis = rng.randint(0, 3, num_keypoints)
    vis[rng.randint(num_keypoints)] = 2  # at least one labeled
    x = np.floor(rng.uniform(xs.min(), xs.max(), num_keypoints))
    y = np.floor(rng.uniform(ys.min(), ys.max(), num_keypoints))
    flat = np.stack([np.where(vis > 0, x, 0), np.where(vis > 0, y, 0), vis], 1)
    return {"keypoints": [float(v) for v in flat.ravel()], "num_keypoints": int((vis > 0).sum())}


def synthetic_train_batch(B=2, H=64, W=64, G=5, num_classes=8, num_keypoints=0, seed=0, mask_size=28):
    """A padded training batch on the host, numpy arrays: ``G`` gt slots per
    image (the last one of image 1 padded), random 28x28 masks and, with
    ``num_keypoints``, keypoints drawn inside each gt box with visibility 0,
    1 or 2 (a third of them exactly on a box edge, which the encode maps to
    the last bin)."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(B, G, 2) * (W / 2)
    wh = rng.rand(B, G, 2) * (W / 2) + 4
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.ones((B, G), bool)
    valid[1, -1] = False
    boxes[1, -1] = 0
    batch = {
        "image": rng.randint(0, 255, (B, H, W, 3)).astype(np.uint8),
        "image_sizes": np.tile(np.array([[H, W]], np.int32), (B, 1)),
        "gt_boxes": boxes,
        "gt_classes": rng.randint(0, num_classes, (B, G)).astype(np.int32),
        "gt_valid": valid,
        "gt_masks": (rng.rand(B, G, mask_size, mask_size) > 0.5).astype(np.float32),
    }
    if num_keypoints:
        K = num_keypoints
        u = rng.rand(B, G, K, 2)
        u[:, :, : K // 3] = rng.randint(0, 2, (B, G, K // 3, 2))  # on the box's edges
        kxy = boxes[:, :, None, :2] + u * (boxes[:, :, None, 2:] - boxes[:, :, None, :2])
        vis = rng.randint(0, 3, (B, G, K, 1)).astype(np.float32)
        batch["gt_keypoints"] = np.concatenate([kxy, vis], -1).astype(np.float32)
    return batch


def add_synthetic_points(batch: dict, num_points: int = 5, seed: int = 0) -> dict:
    """PointSup's fields on a padded train batch (numpy): ``num_points``
    points an instance drawn uniformly inside its gt box, ``gt_point_coords``
    ``[B, G, P, 2]`` absolute xy and ``gt_point_labels`` ``[B, G, P]`` 1 or
    0 (-1 on padded gt slots)."""
    rng = np.random.RandomState(seed)
    boxes = np.asarray(batch["gt_boxes"], np.float32)
    B, G = boxes.shape[:2]
    frac = rng.rand(B, G, num_points, 2).astype(np.float32)
    pts = boxes[..., None, :2] + frac * (boxes[..., None, 2:] - boxes[..., None, :2])
    labels = rng.randint(0, 2, (B, G, num_points)).astype(np.int32)
    labels[~np.asarray(batch["gt_valid"], bool)] = -1
    return dict(batch, gt_point_coords=pts.astype(np.float32), gt_point_labels=labels)


def ground_truth_detections(json_file: str):
    """Detections that are the ground truth itself, as COCO results (score 1,
    the gt box, the gt mask as RLE from ``polygons_to_mask``, and the gt
    keypoints where the json has them), one per non-crowd annotation:
    COCOeval must give them AP 100."""
    from detectron2_tpu_torch.evaluation.rle import polygons_to_rle

    with open(json_file) as f:
        coco = json.load(f)
    sizes = {im["id"]: (im["height"], im["width"]) for im in coco["images"]}
    results = []
    for ann in coco["annotations"]:
        if ann.get("iscrowd", 0):  # LVIS has no crowd annotations and no such key
            continue
        rle = polygons_to_rle([np.asarray(p) for p in ann["segmentation"]], *sizes[ann["image_id"]])
        rle["counts"] = rle["counts"].decode("ascii")
        results.append({
            "image_id": ann["image_id"], "category_id": ann["category_id"], "bbox": list(ann["bbox"]),
            "score": 1.0, "segmentation": rle,
        })
        if "keypoints" in ann:
            results[-1]["keypoints"] = list(ann["keypoints"])
    return results


def densepose_ground_truth_outputs(dataset_dicts, fill: str, grid: int = 256, scale: float = 2.0, device="cpu"):
    """The DensePose ground truth of ``dataset_dicts`` fed back as the
    model's padded detections: one ``(inputs, outputs)`` pair a record, in
    the form ``DensePoseCOCOEvaluator.process`` takes, with the network
    input at ``scale`` times the record's size. Each annotation with
    DensePose points becomes a detection of score 1 at its box (XYXY in the
    input frame) and class, with a square (part, U, V) chart in its box
    frame, at least ``grid`` cells a side and as many as the record's
    largest box has pixels: ``fill`` "masks", part 1 where the union of its
    ``dp_masks``, zoomed to the box as d2's evaluation zooms it, lies in the
    box's pixel, 0 elsewhere (IOU mode must match each such gt at IoU 1);
    "points", every cell the part, U and V of the nearest annotated point
    (GPS mode must score it high)."""
    import torch
    from scipy.ndimage import zoom as spzoom

    from detectron2_tpu_torch.evaluation.rle import rle_to_mask
    from detectron2_tpu_torch.structures import BoxMode

    out = []
    for rec in dataset_dicts:
        anns = [a for a in rec["annotations"] if "dp_x" in a]
        boxes = [BoxMode.convert(list(a["bbox"]), a["bbox_mode"], BoxMode.XYWH_ABS) for a in anns]
        M = max([grid] + [int(v) + 1 for b in boxes for v in b[2:]])
        charts = np.zeros((len(anns), M, M, 3), np.float32)
        for chart, ann, (_, _, bw, bh) in zip(charts, anns, boxes):
            if fill == "masks":
                fg = np.zeros((256, 256))
                for m in ann["dp_masks"]:
                    if m:
                        fg[rle_to_mask(m) > 0] = 1.0
                fg = spzoom(fg, (max(bh, 1) / 256, max(bw, 1) / 256), order=1, prefilter=False) > 0.5
                # the evaluator zooms the chart to the int-truncated box by
                # nearest cell: cell c is read for pixel round(c (n - 1) / (M - 1))
                h, w = max(int(bh), 1), max(int(bw), 1)
                pad = np.zeros((h, w), bool)
                pad[: min(h, fg.shape[0]), : min(w, fg.shape[1])] = fg[:h, :w]
                rows = np.rint(np.arange(M) * (h - 1) / (M - 1)).astype(int)
                cols = np.rint(np.arange(M) * (w - 1) / (M - 1)).astype(int)
                chart[..., 0] = pad[np.ix_(rows, cols)]
            else:
                centres = np.arange(M) * 255.0 / (M - 1)
                x, y = np.asarray(ann["dp_x"]), np.asarray(ann["dp_y"])
                near = ((centres[:, None, None] - y) ** 2 + (centres[None, :, None] - x) ** 2).argmin(-1)
                for c, key in enumerate(("dp_I", "dp_U", "dp_V")):
                    chart[..., c] = np.asarray(ann[key], np.float32)[near]
        n = len(anns)
        xyxy = np.asarray([BoxMode.convert(b, BoxMode.XYWH_ABS, BoxMode.XYXY_ABS) for b in boxes], np.float32)
        h, w = rec["height"], rec["width"]
        outputs = {
            "pred_boxes": torch.tensor(xyxy.reshape(1, n, 4) * scale),
            "scores": torch.ones(1, n),
            "pred_classes": torch.tensor([a["category_id"] for a in anns], dtype=torch.int64).reshape(1, n),
            "valid": torch.ones(1, n, dtype=torch.bool),
            "pred_densepose": torch.tensor(charts[None]),
        }
        inputs = {"metadata": [{"image_id": rec["image_id"], "height": h, "width": w}],
                  "image_sizes": [[round(h * scale), round(w * scale)]]}
        out.append((inputs, {k: v.to(device) for k, v in outputs.items()}))
    return out


# the train->AP gate (tests/test_train_to_ap.py of the JAX package): 64x64
# images of solid rectangles whose fill color is the category
OVERFIT_SIZE = 64
_OVERFIT_COLORS = {0: (220, 50, 40), 1: (40, 210, 60), 2: (50, 70, 225)}  # red, green, blue


# the keypoint gate's 4 keypoints, the rectangles' corners (no left/right
# pairs: the dataset is registered with keypoint_flip_map=())
OVERFIT_KEYPOINT_NAMES = ("tl", "tr", "br", "bl")


def write_synthetic_overfit_coco(root: str, n_images: int = 16, seed: int = 0, keypoints: bool = False):
    """Write the gate's dataset under ``root`` through ``data/png.py`` (no
    PIL): ``n_images`` PNGs of 1-2 axis-aligned rectangles (two in
    non-overlapping halves for even ids) on a dark noisy background, the
    category given by the fill color, and ``synth.json``; returns
    ``(json_file, image_dir)``. With ``keypoints`` every rectangle also has
    4 visible keypoints, its corners inset by 2 px, and every category the
    names :data:`OVERFIT_KEYPOINT_NAMES`. The same draws and bytes as the
    JAX test's ``_make_synthetic_coco`` (``tests/test_train_to_ap.py:32-97``)."""
    from detectron2_tpu_torch.data.png import write_png

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    size = OVERFIT_SIZE
    images, annotations = [], []
    ann_id = 1
    for img_id in range(1, n_images + 1):
        img = (rng.rand(size, size, 3) * 40).astype(np.uint8)
        n_obj = 1 + (img_id % 2)
        for j in range(n_obj):
            w = int(rng.randint(18, 28))
            h = int(rng.randint(18, 28))
            if n_obj == 2:
                x0 = int(rng.randint(1, size // 2 - w - 1)) + (size // 2) * j
            else:
                x0 = int(rng.randint(1, size - w - 1))
            y0 = int(rng.randint(1, size - h - 1))
            cat = int(rng.randint(0, 3))
            img[y0 : y0 + h, x0 : x0 + w] = _OVERFIT_COLORS[cat]
            x1, y1 = x0 + w, y0 + h
            annotations.append({
                "id": ann_id, "image_id": img_id, "category_id": cat + 1, "bbox": [x0, y0, w, h],
                "area": w * h, "iscrowd": 0, "segmentation": [[x0, y0, x1, y0, x1, y1, x0, y1]],
            })
            if keypoints:
                corners = [(x0 + 2, y0 + 2), (x1 - 2, y0 + 2), (x1 - 2, y1 - 2), (x0 + 2, y1 - 2)]
                annotations[-1]["keypoints"] = [v for (kx, ky) in corners for v in (kx, ky, 2)]
                annotations[-1]["num_keypoints"] = 4
            ann_id += 1
        fname = f"synth_{img_id:03d}.png"
        write_png(os.path.join(img_dir, fname), img)
        images.append({"id": img_id, "file_name": fname, "height": size, "width": size})
    categories = [{"id": i + 1, "name": n} for i, n in enumerate(["red", "green", "blue"])]
    if keypoints:
        for c in categories:
            c["keypoints"] = list(OVERFIT_KEYPOINT_NAMES)
    json_file = os.path.join(root, "synth.json")
    with open(json_file, "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
    return json_file, img_dir


def overfit_config(output_dir: str, dataset_name: str) -> CfgNode:
    """The gate's config: the JAX package's dry-run Mask R-CNN
    (``__graft_entry__.py:6-35,81-110``: R18-FPN with GroupNorm, p3-p5, one
    fc and one mask conv, small RPN and ROI budgets) with the gate's
    settings (``tests/test_train_to_ap.py:100-135``): float32, 3 classes, 8
    images of 64x64 per batch, LR 0.02 with 100 warmup steps, 500
    iterations stepped down at 400, one evaluation after training, and the
    expected results bbox AP 96 +- 6 and segm AP 87 +- 8. ``dataset_name``
    is the registered dataset it trains and evaluates on; the device is
    ``MODEL.DEVICE``'s default, the card."""
    cfg = get_cfg()
    m = cfg.MODEL
    m.META_ARCHITECTURE = "GeneralizedRCNN"
    m.BACKBONE.NAME = "build_resnet_fpn_backbone"
    m.BACKBONE.FREEZE_AT = 0
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.NORM = "GN"
    m.FPN.NORM = "GN"
    m.FPN.OUT_CHANNELS = 64
    m.PIXEL_STD = [57.375, 57.120, 58.395]
    m.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res3", "res4", "res5"]
    m.ANCHOR_GENERATOR.SIZES = [[16], [32], [64]]
    m.RPN.IN_FEATURES = ["p3", "p4", "p5"]
    m.RPN.PRE_NMS_TOPK_TRAIN = 64
    m.RPN.PRE_NMS_TOPK_TEST = 256
    m.RPN.POST_NMS_TOPK_TRAIN = 32
    m.RPN.POST_NMS_TOPK_TEST = 128
    m.RPN.BATCH_SIZE_PER_IMAGE = 32
    m.ROI_HEADS.NAME = "StandardROIHeads"
    m.ROI_HEADS.IN_FEATURES = ["p3", "p4", "p5"]
    m.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 32
    m.ROI_HEADS.NUM_CLASSES = 3
    m.ROI_HEADS.SCORE_THRESH_TEST = 0.5
    m.ROI_BOX_HEAD.NUM_FC = 1
    m.ROI_BOX_HEAD.FC_DIM = 128
    m.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    m.ROI_MASK_HEAD.NUM_CONV = 1
    m.ROI_MASK_HEAD.CONV_DIM = 32
    m.ROI_MASK_HEAD.POOLER_RESOLUTION = 7
    m.MASK_ON = True
    cfg.TEST.DETECTIONS_PER_IMAGE = 32
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.MAX_GT_INSTANCES = 8
    cfg.DATASETS.TRAIN = (dataset_name,)
    cfg.DATASETS.TEST = (dataset_name,)
    cfg.DATALOADER.NUM_WORKERS = 0
    cfg.INPUT.MIN_SIZE_TRAIN = (OVERFIT_SIZE,)
    cfg.INPUT.MAX_SIZE_TRAIN = OVERFIT_SIZE
    cfg.INPUT.MIN_SIZE_TEST = OVERFIT_SIZE
    cfg.INPUT.MAX_SIZE_TEST = OVERFIT_SIZE
    cfg.SOLVER.IMS_PER_BATCH = 8
    cfg.SOLVER.BASE_LR = 0.02
    cfg.SOLVER.WARMUP_ITERS = 100
    cfg.SOLVER.MAX_ITER = 500
    cfg.SOLVER.STEPS = (400,)
    cfg.SOLVER.CHECKPOINT_PERIOD = 10_000  # the final checkpoint only
    cfg.TEST.EVAL_PERIOD = 0  # one evaluation, after the last iteration
    cfg.TEST.EXPECTED_RESULTS = [["bbox", "AP", 96.0, 6.0], ["segm", "AP", 87.0, 8.0]]
    cfg.OUTPUT_DIR = output_dir
    return cfg


def overfit_keypoint_config(output_dir: str, dataset_name: str) -> CfgNode:
    """The keypoint gate's config (``tests/test_train_to_ap.py:170-226``):
    :func:`overfit_config` without masks, with a keypoint head of two
    32-wide convs over 4 keypoints, no flips, OKS sigmas 0.1 and the
    expected results bbox AP 75 +- 25 and keypoints AP 60 +- 40 (the test
    also requires keypoints AP >= 20). Its dataset
    is :func:`write_synthetic_overfit_coco` with ``keypoints=True``,
    registered with ``keypoint_names`` :data:`OVERFIT_KEYPOINT_NAMES` and
    ``keypoint_flip_map`` ``()``."""
    cfg = overfit_config(output_dir, dataset_name)
    m = cfg.MODEL
    m.MASK_ON = False
    m.KEYPOINT_ON = True
    m.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = len(OVERFIT_KEYPOINT_NAMES)
    m.ROI_KEYPOINT_HEAD.CONV_DIMS = (32, 32)
    cfg.INPUT.RANDOM_FLIP = "none"
    cfg.TEST.KEYPOINT_OKS_SIGMAS = [0.1] * len(OVERFIT_KEYPOINT_NAMES)
    cfg.TEST.EXPECTED_RESULTS = [["bbox", "AP", 75.0, 25.0], ["keypoints", "AP", 60.0, 40.0]]
    return cfg


def config_tree(x, name_of):
    """A lazy config as JSON-able data, to compare two packages' loads of
    one file: mappings and sequences recursively, arrays as lists, callables
    as ``["callable", name_of(x)]``, other objects by their type's name."""
    from collections import abc

    if isinstance(x, abc.Mapping):
        return {str(k): config_tree(v, name_of) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [config_tree(v, name_of) for v in x]
    if isinstance(x, np.ndarray):
        return ["ndarray", x.tolist()]
    if x is None or isinstance(x, (str, bool, int, float)):
        return x
    if callable(x):
        return ["callable", name_of(x)]
    return ["object", type(x).__name__]
