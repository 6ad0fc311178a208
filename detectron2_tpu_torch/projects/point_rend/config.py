"""PointRend config keys (counterpart of the JAX package's
``projects/point_rend/config.py``): every key of its
``add_pointrend_config``, with the same values. ``INPUT.CROP.
SINGLE_CATEGORY_MAX_AREA`` and ``INPUT.COLOR_AUG_SSD`` are read by neither
package (ROADMAP C)."""

from detectron2_tpu_torch.config.cfg_node import CfgNode as CN

__all__ = ["add_pointrend_config"]


def add_pointrend_config(cfg):
    """Add config for PointRend."""
    cfg.INPUT.CROP.SINGLE_CATEGORY_MAX_AREA = 1.0
    cfg.INPUT.COLOR_AUG_SSD = False

    cfg.MODEL.IMPLICIT_POINTREND = CN()
    cfg.MODEL.IMPLICIT_POINTREND.IMAGE_FEATURE_ENABLED = True
    cfg.MODEL.IMPLICIT_POINTREND.POS_ENC_ENABLED = True
    cfg.MODEL.IMPLICIT_POINTREND.PARAMS_L2_REGULARIZER = 0.00001

    cfg.MODEL.ROI_HEADS.NAME = "PointRendROIHeads"
    cfg.MODEL.ROI_MASK_HEAD.NAME = "CoarseMaskHead"
    # the side of the coarse prediction, which the subdivision upsamples
    cfg.MODEL.ROI_MASK_HEAD.OUTPUT_SIDE_RESOLUTION = 7
    cfg.MODEL.ROI_MASK_HEAD.IN_FEATURES = ["p2"]
    cfg.MODEL.ROI_MASK_HEAD.FC_DIM = 1024
    cfg.MODEL.ROI_MASK_HEAD.NUM_FC = 2
    cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14

    cfg.MODEL.POINT_HEAD = CN()
    cfg.MODEL.POINT_HEAD.NAME = "StandardPointHead"
    # the per-pixel head PointRendSemSegHead refines
    cfg.MODEL.POINT_HEAD.COARSE_SEM_SEG_HEAD_NAME = "SemSegFPNHead"
    cfg.MODEL.POINT_HEAD.NUM_CLASSES = 80
    cfg.MODEL.POINT_HEAD.IN_FEATURES = ["p2"]
    cfg.MODEL.POINT_HEAD.TRAIN_NUM_POINTS = 14 * 14
    cfg.MODEL.POINT_HEAD.OVERSAMPLE_RATIO = 3
    cfg.MODEL.POINT_HEAD.IMPORTANCE_SAMPLE_RATIO = 0.75
    # 2 steps take the 7x7 coarse mask to 28x28, the paste's input
    cfg.MODEL.POINT_HEAD.SUBDIVISION_STEPS = 2
    cfg.MODEL.POINT_HEAD.SUBDIVISION_NUM_POINTS = 28 * 28 // 4
    cfg.MODEL.POINT_HEAD.FC_DIM = 256
    cfg.MODEL.POINT_HEAD.NUM_FC = 3
    cfg.MODEL.POINT_HEAD.CLS_AGNOSTIC_MASK = False
    # the coarse logits joined to every fc layer's input, not just the first
    cfg.MODEL.POINT_HEAD.COARSE_PRED_EACH_LAYER = True
