from detectron2_tpu_torch.modeling.meta_arch.dense_detector import DenseDetector
from detectron2_tpu_torch.modeling.meta_arch.fcos import FCOS, FCOSHead
from detectron2_tpu_torch.modeling.meta_arch.rcnn import GeneralizedRCNN, ProposalNetwork
from detectron2_tpu_torch.modeling.meta_arch.retinanet import RetinaNet, RetinaNetHead

__all__ = ["DenseDetector", "FCOS", "FCOSHead", "GeneralizedRCNN", "ProposalNetwork", "RetinaNet", "RetinaNetHead"]
