"""DensePose, the chart family (counterpart of
``detectron2_tpu/projects/densepose/``): per person, the body part index I
and the part's (U, V) chart coordinates per pixel, from DensePose R-CNN
with the V1ConvX or DeepLab head, the FPN decoder and the UV confidences.
CSE, HRNet/HRFPN, the bootstrap, the evaluator and TTA are ROADMAP A10.

Train batch (padded per instance, P point slots): ``gt_dp_points`` [B, G,
P, 2] absolute xy, ``gt_dp_part`` [B, G, P] dp_I 1..24 (-1 padding),
``gt_dp_u`` / ``gt_dp_v`` [B, G, P] in [0, 1].
"""

from detectron2_tpu_torch.projects.densepose.config import (
    add_bootstrap_config,
    add_dataset_category_config,
    add_densepose_config,
    add_evaluation_config,
)
from detectron2_tpu_torch.projects.densepose.confidences import (
    iid_isotropic_gaussian_uv_loss,
    indep_anisotropic_gaussian_uv_loss,
)
from detectron2_tpu_torch.projects.densepose.dataset_mapper import (
    DensePoseBatchCollator,
    DensePoseDatasetMapper,
    register_densepose_coco,
)
from detectron2_tpu_torch.projects.densepose.densepose_head import (
    DensePoseChartPredictor,
    DensePoseDecoder,
    DensePoseDeepLabHead,
    DensePoseV1ConvXHead,
)
from detectron2_tpu_torch.projects.densepose.roi_heads import DensePoseROIHeads
from detectron2_tpu_torch.projects.densepose.structures import (
    DensePoseChartResult,
    DensePoseChartResultCompressed,
    DensePoseChartResultQuantized,
    DensePoseChartResultWithConfidences,
    DensePoseDataRelative,
    DensePoseList,
    DensePoseTransformData,
    compress_quantized_densepose_chart_result,
    decompress_compressed_densepose_chart_result,
    quantize_densepose_chart_result,
)
from detectron2_tpu_torch.projects.densepose.trainer import Trainer

__all__ = [
    "add_densepose_config",
    "add_bootstrap_config",
    "add_dataset_category_config",
    "add_evaluation_config",
    "iid_isotropic_gaussian_uv_loss",
    "indep_anisotropic_gaussian_uv_loss",
    "DensePoseBatchCollator",
    "DensePoseDatasetMapper",
    "register_densepose_coco",
    "DensePoseChartPredictor",
    "DensePoseDecoder",
    "DensePoseDeepLabHead",
    "DensePoseV1ConvXHead",
    "DensePoseROIHeads",
    "DensePoseChartResult",
    "DensePoseChartResultCompressed",
    "DensePoseChartResultQuantized",
    "DensePoseChartResultWithConfidences",
    "DensePoseDataRelative",
    "DensePoseList",
    "DensePoseTransformData",
    "compress_quantized_densepose_chart_result",
    "decompress_compressed_densepose_chart_result",
    "quantize_densepose_chart_result",
    "Trainer",
]
