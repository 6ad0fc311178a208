"""What the CPU tests and the on-card smoke run share: the synthetic fixtures
of ``tests/goldens/`` (the Mask R-CNN R18-FPN of ``e2e_maskrcnn_r18.npz`` and
the ViT + SimpleFeaturePyramid of ``vitdet_backbone.npz``) and the error
bounds the bfloat16 attention kernel is held to.

Each golden holds what the reference detectron2 produces on a fixed image
with deterministic synthetic weights. This module rebuilds those weights
from the golden's (name, shape) list and the model the golden was made
with, so the CPU tests and the on-card smoke run hold the port to the same
numbers.
"""

import zlib

import numpy as np

from detectron2_tpu_torch.config import CfgNode, get_cfg

__all__ = [
    "synth_weight_value",
    "golden_state_dict",
    "golden_r18_config",
    "golden_vitdet_backbone",
    "compare_with_golden",
    "GOLDEN_TOLERANCES",
    "attention_bf16_bounds",
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
