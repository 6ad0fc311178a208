from detectron2_tpu_torch.data import transforms
from detectron2_tpu_torch.data.build import (
    PaddedBatchCollator,
    build_batch_data_loader,
    build_detection_test_loader,
    build_detection_train_loader,
    get_detection_dataset_dicts,
)
from detectron2_tpu_torch.data.catalog import DatasetCatalog, Metadata, MetadataCatalog
from detectron2_tpu_torch.data.common import AspectRatioGroupedDataset, DatasetFromList, MapDataset, ToIterableDataset
from detectron2_tpu_torch.data.dataset_mapper import DatasetMapper
from detectron2_tpu_torch.data.transforms import ResizeShortestEdge

__all__ = [
    "AspectRatioGroupedDataset",
    "DatasetCatalog",
    "DatasetFromList",
    "DatasetMapper",
    "MapDataset",
    "Metadata",
    "MetadataCatalog",
    "PaddedBatchCollator",
    "ResizeShortestEdge",
    "ToIterableDataset",
    "build_batch_data_loader",
    "build_detection_test_loader",
    "build_detection_train_loader",
    "get_detection_dataset_dicts",
    "transforms",
]

# the builtin datasets are registered on ``import detectron2_tpu_torch.data``
from detectron2_tpu_torch.data import datasets  # noqa: E402,F401  isort:skip
