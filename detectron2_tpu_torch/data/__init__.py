from detectron2_tpu_torch.data import transforms
from detectron2_tpu_torch.data.build import (
    PaddedBatchCollator,
    build_detection_test_loader,
    get_detection_dataset_dicts,
)
from detectron2_tpu_torch.data.catalog import DatasetCatalog, Metadata, MetadataCatalog
from detectron2_tpu_torch.data.common import DatasetFromList, MapDataset
from detectron2_tpu_torch.data.dataset_mapper import DatasetMapper
from detectron2_tpu_torch.data.transforms import ResizeShortestEdge

__all__ = [
    "DatasetCatalog",
    "DatasetFromList",
    "DatasetMapper",
    "MapDataset",
    "Metadata",
    "MetadataCatalog",
    "PaddedBatchCollator",
    "ResizeShortestEdge",
    "build_detection_test_loader",
    "get_detection_dataset_dicts",
    "transforms",
]
