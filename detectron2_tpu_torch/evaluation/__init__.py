from detectron2_tpu_torch.evaluation.cityscapes_evaluation import (
    CityscapesInstanceEvaluator,
    CityscapesSemSegEvaluator,
)
from detectron2_tpu_torch.evaluation.coco_evaluation import COCOEvaluator, instances_to_coco_json
from detectron2_tpu_torch.evaluation.evaluator import DatasetEvaluator, DatasetEvaluators, inference_on_dataset
from detectron2_tpu_torch.evaluation.lvis_evaluation import LVISEvaluator
from detectron2_tpu_torch.evaluation.panoptic_evaluation import COCOPanopticEvaluator
from detectron2_tpu_torch.evaluation.pascal_voc_evaluation import PascalVOCDetectionEvaluator
from detectron2_tpu_torch.evaluation.sem_seg_evaluation import SemSegEvaluator
from detectron2_tpu_torch.evaluation.testing import flatten_results_dict, print_csv_format, verify_results

__all__ = [
    "CityscapesInstanceEvaluator",
    "CityscapesSemSegEvaluator",
    "COCOEvaluator",
    "COCOPanopticEvaluator",
    "DatasetEvaluator",
    "DatasetEvaluators",
    "flatten_results_dict",
    "inference_on_dataset",
    "instances_to_coco_json",
    "LVISEvaluator",
    "PascalVOCDetectionEvaluator",
    "print_csv_format",
    "SemSegEvaluator",
    "verify_results",
]
