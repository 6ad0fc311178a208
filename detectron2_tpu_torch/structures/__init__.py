from detectron2_tpu_torch.structures.boxes import Boxes, BoxMode
from detectron2_tpu_torch.structures.instances import Instances
from detectron2_tpu_torch.structures.masks import BitMasks

__all__ = ["Boxes", "BoxMode", "BitMasks", "Instances"]
