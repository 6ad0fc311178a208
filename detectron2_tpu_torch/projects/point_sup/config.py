"""PointSup config keys (counterpart of the JAX package's
``projects/point_sup/config.py``). Neither package has PointSup's data path
(d2's point-annotation datasets and the mapper that draws
``SAMPLE_POINTS``): the keys merge and are read nowhere (ROADMAP C)."""

__all__ = ["add_point_sup_config"]


def add_point_sup_config(cfg):
    """Add config for point supervision."""
    # point annotations (not dense masks) train the mask branch
    cfg.INPUT.POINT_SUP = True
    # annotated points an instance that the loader samples
    cfg.INPUT.SAMPLE_POINTS = 5
    cfg.MODEL.ROI_HEADS.NAME = "PointSupROIHeads"
