"""DensePose (counterpart of ``detectron2_tpu/projects/densepose/``): per
person, the body part index I and the part's (U, V) chart coordinates per
pixel, or with continuous surface embeddings (CSE) an embedding per pixel
matched to a mesh's vertices, from DensePose R-CNN with the V1ConvX or
DeepLab head, the FPN decoder and the UV confidences; the DensePose
evaluator (GPS, GPSM, IOU), the mesh catalog and DensePose-LVIS, the HRNet
/ HRFPN backbone, and bootstrap training on pseudo-labels (the evolution
configs). The visualisers and the command-line tools are ROADMAP A10; the
DensePose TTA wrapper is in neither package.

Train batch (padded per instance, P point slots): ``gt_dp_points`` [B, G,
P, 2] absolute xy, ``gt_dp_part`` [B, G, P] dp_I 1..24 (-1 padding),
``gt_dp_u`` / ``gt_dp_v`` [B, G, P] in [0, 1].
"""

from detectron2_tpu_torch.projects.densepose.bootstrap import (
    FINE_TO_COARSE_SEGMENTATION,
    DensePoseConfidenceBasedSampler,
    DensePoseUniformSampler,
    InferenceBasedLoader,
    MaskFromDensePoseSampler,
    PredictionToGroundTruthSampler,
    ScoreBasedFilter,
)
from detectron2_tpu_torch.projects.densepose.build import (
    CombinedDataLoader,
    DatasetType,
    ImageListDataset,
    ImageResizeTransform,
    build_combined_train_loader,
    pseudo_to_train_sample,
)
from detectron2_tpu_torch.projects.densepose.config import (
    add_bootstrap_config,
    add_dataset_category_config,
    add_densepose_config,
    add_evaluation_config,
    get_bootstrap_dataset_config,
    load_bootstrap_config,
)
from detectron2_tpu_torch.projects.densepose.converters import (
    ToChartResultConverter,
    ToChartResultConverterWithConfidences,
    ToMaskConverter,
    densepose_chart_predictor_output_hflip,
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
from detectron2_tpu_torch.projects.densepose.cse import (
    Embedder,
    VertexDirectEmbedder,
    VertexFeatureEmbedder,
    closest_vertices_from_embedding,
    cse_embedding_loss,
    cse_soft_embedding_loss,
    embedder_specs_from_cfg,
    normalize_embeddings,
    pix_to_shape_cycle_loss,
    shape_to_shape_cycle_loss,
)
from detectron2_tpu_torch.projects.densepose.datasets import (
    densepose_dataset_dicts,
    load_densepose_lvis_json,
    register_chimpnsee,
)
from detectron2_tpu_torch.projects.densepose.densepose_head import (
    DensePoseChartPredictor,
    DensePoseDecoder,
    DensePoseEmbeddingPredictor,
    DensePoseDeepLabHead,
    DensePoseV1ConvXHead,
)
from detectron2_tpu_torch.projects.densepose.evaluation import (
    DensePoseCOCOEvaluator,
    MeshAlignmentEvaluator,
    load_smpl_mesh_tables,
)
from detectron2_tpu_torch.projects.densepose.hrfpn import HRFPN, build_hrfpn_backbone
from detectron2_tpu_torch.projects.densepose.hrnet import PoseHigherResolutionNet, build_pose_hrnet_backbone
from detectron2_tpu_torch.projects.densepose.meshes import MeshCatalog, create_mesh
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
from detectron2_tpu_torch.projects.densepose.trainer import (
    SampleCountingLoader,
    SampleCountMetricPrinter,
    Trainer,
    build_bootstrap_predictor,
)
from detectron2_tpu_torch.projects.densepose.video import VideoKeyframeDataset

# ChimpnSee, the evolution configs' bootstrap videos, under $DETECTRON2_DATASETS
register_chimpnsee()

__all__ = [
    "FINE_TO_COARSE_SEGMENTATION",
    "DensePoseConfidenceBasedSampler",
    "DensePoseUniformSampler",
    "InferenceBasedLoader",
    "MaskFromDensePoseSampler",
    "PredictionToGroundTruthSampler",
    "ScoreBasedFilter",
    "CombinedDataLoader",
    "DatasetType",
    "ImageListDataset",
    "ImageResizeTransform",
    "build_combined_train_loader",
    "pseudo_to_train_sample",
    "get_bootstrap_dataset_config",
    "load_bootstrap_config",
    "ToChartResultConverter",
    "ToChartResultConverterWithConfidences",
    "ToMaskConverter",
    "densepose_chart_predictor_output_hflip",
    "register_chimpnsee",
    "HRFPN",
    "build_hrfpn_backbone",
    "PoseHigherResolutionNet",
    "build_pose_hrnet_backbone",
    "SampleCountingLoader",
    "SampleCountMetricPrinter",
    "build_bootstrap_predictor",
    "VideoKeyframeDataset",
    "add_densepose_config",
    "add_bootstrap_config",
    "add_dataset_category_config",
    "add_evaluation_config",
    "iid_isotropic_gaussian_uv_loss",
    "indep_anisotropic_gaussian_uv_loss",
    "DensePoseBatchCollator",
    "DensePoseDatasetMapper",
    "register_densepose_coco",
    "Embedder",
    "VertexDirectEmbedder",
    "VertexFeatureEmbedder",
    "closest_vertices_from_embedding",
    "cse_embedding_loss",
    "cse_soft_embedding_loss",
    "embedder_specs_from_cfg",
    "normalize_embeddings",
    "pix_to_shape_cycle_loss",
    "shape_to_shape_cycle_loss",
    "densepose_dataset_dicts",
    "load_densepose_lvis_json",
    "DensePoseChartPredictor",
    "DensePoseDecoder",
    "DensePoseEmbeddingPredictor",
    "DensePoseDeepLabHead",
    "DensePoseV1ConvXHead",
    "DensePoseCOCOEvaluator",
    "MeshAlignmentEvaluator",
    "load_smpl_mesh_tables",
    "MeshCatalog",
    "create_mesh",
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
