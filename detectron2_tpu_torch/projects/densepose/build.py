"""The DensePose bootstrap training loader (counterpart of
``detectron2_tpu/projects/densepose/build.py``): ground-truth samples and
pseudo-labelled ones, mixed by ratio and padded into one batch.

The model takes one padded batch dict, so the streams are mixed one level
before collation: :class:`CombinedDataLoader` draws which stream fills each
slot of a step from its own ``RandomState(seed)``, and one
:class:`~.dataset_mapper.DensePoseBatchCollator` pads the mixed samples, so
every step's batch has the same layout whatever its mix. A pseudo-labelled
sample (from :class:`~.bootstrap.InferenceBasedLoader`) carries its targets
in ``gt_boxes``, ``gt_classes`` and ``gt_densepose`` (a
:class:`~.structures.DensePoseList`); :func:`pseudo_to_train_sample` packs
the sampled points into the ``gt_dp_*`` arrays the mapper gives real
annotations (:func:`pack_densepose_points`).

The ground-truth stream reads ``DATASETS.TRAIN`` through
:func:`~.datasets.densepose_dataset_dicts`, so ``WHITELISTED_CATEGORIES``
and ``CATEGORY_MAPS`` apply (ROADMAP C, correction 17; the JAX loader
reads the datasets as they are). The bootstrap datasets are a video list
(``VideoKeyframeDataset``) or an image list (:class:`ImageListDataset`,
``IMAGE_LOADER.TYPE: image_list``, a dataset registered with
``dataset_type`` ``DatasetType.IMAGE_LIST``, ``image_list_fpath``, and
optionally ``image_base_path`` and ``category``).
"""

import logging
from collections import deque
from enum import Enum
from typing import Any, Callable, Collection, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from detectron2_tpu_torch.data import MetadataCatalog
from detectron2_tpu_torch.data.build import build_detection_train_loader
from detectron2_tpu_torch.data.samplers import TrainingSampler
from detectron2_tpu_torch.projects.densepose.bootstrap import (
    DensePoseConfidenceBasedSampler,
    DensePoseUniformSampler,
    InferenceBasedLoader,
    MaskFromDensePoseSampler,
    PredictionToGroundTruthSampler,
    ScoreBasedFilter,
)
from detectron2_tpu_torch.projects.densepose.converters import resize_linear
from detectron2_tpu_torch.projects.densepose.dataset_mapper import (
    DP_MAX_POINTS,
    DensePoseBatchCollator,
    DensePoseDatasetMapper,
)
from detectron2_tpu_torch.projects.densepose.datasets import densepose_dataset_dicts
from detectron2_tpu_torch.projects.densepose.structures import DensePoseDataRelative
from detectron2_tpu_torch.projects.densepose.video import (
    FrameSelectionStrategy,
    VideoKeyframeDataset,
    frame_selector_from_strategy,
    maybe_prepend_base_path,
    video_list_from_file,
)
from detectron2_tpu_torch.structures import Boxes, Instances

__all__ = [
    "DatasetType",
    "ImageResizeTransform",
    "ImageListDataset",
    "CombinedDataLoader",
    "BootstrapDatasetFactoryCatalog",
    "build_frame_selector",
    "build_transform",
    "build_combined_loader",
    "build_bootstrap_dataset",
    "build_data_sampler",
    "build_data_filter",
    "build_inference_based_loader",
    "build_inference_based_loaders",
    "has_inference_based_loaders",
    "build_video_list_dataset",
    "build_image_list_dataset",
    "build_combined_train_loader",
    "pseudo_to_train_sample",
    "pack_densepose_points",
    "get_category_to_class_mapping",
]

logger = logging.getLogger(__name__)


class DatasetType(Enum):
    """The bootstrap dataset kinds (d2's, and the image list)."""

    VIDEO_LIST = "video_list"
    IMAGE_LIST = "image_list"


class ImageResizeTransform:
    """``[N, H, W, C]`` float32 images resized so that the short side is
    ``min_size`` and the long one at most ``max_size`` (the scale's
    ``int(h * scale)``), bilinear as OpenCV's ``INTER_LINEAR``."""

    def __init__(self, min_size: int = 800, max_size: int = 1333):
        self.min_size = min_size
        self.max_size = max_size

    def __call__(self, images: np.ndarray) -> np.ndarray:
        images = np.asarray(images, np.float32)
        h, w = images.shape[1:3]
        scale = min(self.min_size / min(h, w), self.max_size / max(h, w))
        nh, nw = int(h * scale), int(w * scale)
        return np.stack([resize_linear(im, nh, nw) for im in images]).reshape(len(images), nh, nw, images.shape[3])


class ImageListDataset:
    """Images from a list of paths: ``{"images": float32 [1, H, W, 3] BGR,
    "categories": [category]}``, or no image and no category when a file
    cannot be read."""

    _EMPTY_IMAGE = np.empty((0, 1, 1, 3), dtype=np.float32)

    def __init__(
        self,
        image_list: List[str],
        category_list=None,
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ):
        self.category_list = category_list if isinstance(category_list, list) else [category_list] * len(image_list)
        assert len(image_list) == len(self.category_list), "length of image and category lists must be equal"
        self.image_list = image_list
        self.transform = transform

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        from detectron2_tpu_torch.data.detection_utils import read_image

        fpath = self.image_list[idx]
        try:
            image = np.asarray(read_image(fpath, format="BGR"), np.float32)[None]
            if self.transform is not None:
                image = self.transform(image)
            return {"images": image, "categories": [self.category_list[idx]]}
        except (OSError, RuntimeError) as e:
            logger.warning(f"Error opening image file container {fpath}: {e}")
        return {"images": self._EMPTY_IMAGE, "categories": []}

    def __len__(self):
        return len(self.image_list)


class CombinedDataLoader:
    """Mixes loaders of sample lists: each output slot's loader is drawn
    with ``ratios`` from ``RandomState(seed)`` (``BATCH_COUNT`` batches of
    draws at a time), and each loader's leftover samples wait for its next
    draw, so none is dropped. Ends when a drawn loader ends."""

    BATCH_COUNT = 100

    def __init__(self, loaders: Collection[Iterable[List[Any]]], batch_size: int, ratios: Sequence[float],
                 seed: Optional[int] = None):
        self.loaders = loaders
        self.batch_size = batch_size
        self.ratios = np.asarray(ratios, np.float64) / float(np.sum(ratios))
        self._rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[List[Any]]:
        iters = [iter(loader) for loader in self.loaders]
        pools = [deque() for _ in iters]
        indices: List[int] = []

        def pooled_next(i):
            if not pools[i]:
                pools[i].extend(next(iters[i]))
            return pools[i].popleft()

        while True:
            if not indices:
                indices = self._rng.choice(len(iters), size=self.batch_size * self.BATCH_COUNT, p=self.ratios).tolist()
            try:
                batch = [pooled_next(i) for i in indices[: self.batch_size]]
            except StopIteration:
                return
            indices = indices[self.batch_size :]
            yield batch


def pack_densepose_points(dp_datas: Sequence[Optional[DensePoseDataRelative]], boxes_xyxy: np.ndarray,
                          max_points: int = DP_MAX_POINTS) -> Dict[str, np.ndarray]:
    """Each instance's box-relative points -> the padded ``gt_dp_points``
    (absolute xy), ``gt_dp_part`` (-1 padding), ``gt_dp_u`` and ``gt_dp_v``
    arrays of ``max_points`` slots, as the mapper packs annotations."""
    G, P = len(dp_datas), max_points
    pts = np.zeros((G, P, 2), np.float32)
    part = np.full((G, P), -1, np.int64)
    u = np.zeros((G, P), np.float32)
    v = np.zeros((G, P), np.float32)
    boxes = np.asarray(boxes_xyxy, np.float64).reshape(-1, 4)
    for g, dp in enumerate(dp_datas):
        if dp is None or getattr(dp, "i", None) is None or len(dp.i) == 0:
            continue
        n = min(len(dp.x), P)
        x0, y0, x1, y1 = boxes[g]
        w, h = max(x1 - x0, 1e-4), max(y1 - y0, 1e-4)
        pts[g, :n, 0] = x0 + dp.x[:n] * w / DensePoseDataRelative.MASK_SIZE
        pts[g, :n, 1] = y0 + dp.y[:n] * h / DensePoseDataRelative.MASK_SIZE
        part[g, :n] = dp.i[:n]
        u[g, :n] = np.clip(dp.u[:n], 0.0, 1.0)
        v[g, :n] = np.clip(dp.v[:n], 0.0, 1.0)
    return {"gt_dp_points": pts, "gt_dp_part": part, "gt_dp_u": u, "gt_dp_v": v}


def pseudo_to_train_sample(sample: Dict[str, Any], max_points: int = DP_MAX_POINTS) -> Dict[str, Any]:
    """One InferenceBasedLoader output -> a mapper-format training sample:
    the image as it is, ``gt_boxes``, ``gt_classes`` (0 when absent), the
    masks when present and the packed points."""
    instances: Instances = sample["instances"]
    out: Dict[str, Any] = {"image": np.asarray(sample["image"], np.float32)}
    if "dataset" in sample:
        out["dataset"] = sample["dataset"]
    G = len(instances)
    boxes = instances.gt_boxes if instances.has("gt_boxes") else Boxes(torch.zeros((0, 4)))
    if not isinstance(boxes, Boxes):
        boxes = Boxes(torch.as_tensor(np.asarray(boxes, np.float32).reshape(-1, 4)))
    new = Instances(instances.image_size)
    new.gt_boxes = boxes
    classes = instances.gt_classes if instances.has("gt_classes") else np.zeros((G,), np.int64)
    new.gt_classes = torch.as_tensor(np.asarray(classes.cpu() if hasattr(classes, "cpu") else classes), dtype=torch.int64)
    if instances.has("gt_masks"):
        new.gt_masks = instances.gt_masks
    dp_datas: List[Optional[DensePoseDataRelative]] = [None] * G
    if instances.has("gt_densepose"):
        dp_list = instances.gt_densepose
        dp_datas = [dp_list[i] for i in range(len(dp_list))] + [None] * (G - len(dp_list))
    for k, arr in pack_densepose_points(dp_datas[:G], boxes.tensor.numpy(), max_points).items():
        new.set(k, arr)
    out["instances"] = new
    return out


class _PseudoLabelSampleLoader:
    """An InferenceBasedLoader's batches as mapper-format sample lists."""

    def __init__(self, inference_loader: InferenceBasedLoader, max_points: int = DP_MAX_POINTS):
        self.inference_loader = inference_loader
        self.max_points = max_points

    def __iter__(self):
        for batch in self.inference_loader:
            out = [pseudo_to_train_sample(s, self.max_points) for s in batch]
            if out:
                yield out


def get_category_to_class_mapping(dataset_cfg) -> Dict[str, int]:
    return {category: int(class_id) for category, class_id in dataset_cfg.CATEGORY_TO_CLASS_MAPPING.items()}


def build_frame_selector(cfg):
    strategy = FrameSelectionStrategy(cfg.STRATEGY)
    if strategy == FrameSelectionStrategy.ALL:
        return None
    return frame_selector_from_strategy(strategy, cfg.NUM_IMAGES)


def build_transform(cfg, data_type: str):
    if cfg.TYPE == "resize" and data_type == "image":
        return ImageResizeTransform(cfg.MIN_SIZE, cfg.MAX_SIZE)
    raise ValueError(f"Unknown transform {cfg.TYPE} for data type {data_type}")


def build_combined_loader(cfg, loaders, ratios, seed: Optional[int] = None) -> CombinedDataLoader:
    """One process takes the whole ``SOLVER.IMS_PER_BATCH`` (ROADMAP A6)."""
    return CombinedDataLoader(loaders, cfg.SOLVER.IMS_PER_BATCH, ratios, seed=seed)


def build_video_list_dataset(meta, cfg):
    if cfg.TYPE != "video_keyframe":
        return None
    video_list = video_list_from_file(meta.video_list_fpath, meta.video_base_path)
    return VideoKeyframeDataset(
        video_list, meta.category, build_frame_selector(cfg.SELECT), build_transform(cfg.TRANSFORM, "image"),
        getattr(cfg, "KEYFRAME_HELPER", None) or None,
    )


def build_image_list_dataset(meta, cfg):
    """A list file of image paths, one a line, relative ones under
    ``meta.image_base_path``."""
    if cfg.TYPE != "image_list":
        return None
    base = meta.get("image_base_path", None)
    with open(meta.image_list_fpath) as f:
        image_list = [maybe_prepend_base_path(base, line.strip()) for line in f if line.strip()]
    return ImageListDataset(image_list, meta.get("category", None), build_transform(cfg.TRANSFORM, "image"))


class _BootstrapDatasetFactoryCatalog(dict):
    """DatasetType -> dataset factory ``(meta, IMAGE_LOADER cfg)``."""

    def register(self, dataset_type: DatasetType, factory: Callable[..., Any]):
        assert dataset_type not in self, f"Dataset '{dataset_type}' is already registered!"
        self[dataset_type] = factory


BootstrapDatasetFactoryCatalog = _BootstrapDatasetFactoryCatalog()
BootstrapDatasetFactoryCatalog.register(DatasetType.VIDEO_LIST, build_video_list_dataset)
BootstrapDatasetFactoryCatalog.register(DatasetType.IMAGE_LIST, build_image_list_dataset)


def build_bootstrap_dataset(dataset_name: str, cfg):
    """The bootstrap dataset ``dataset_name`` (``cfg``: its IMAGE_LOADER
    node), its metadata given the loader's category options."""
    meta = MetadataCatalog.get(dataset_name)
    meta.category_to_class_mapping = get_category_to_class_mapping(cfg)
    meta.categories = cfg.CATEGORIES
    meta.max_count_per_category = cfg.MAX_COUNT_PER_CATEGORY
    factory = BootstrapDatasetFactoryCatalog.get(meta.dataset_type)
    dataset = factory(meta, cfg) if factory is not None else None
    if dataset is None:
        logger.warning(f"Failed to create dataset {dataset_name} of type {meta.dataset_type}")
    return dataset


def _seed(cfg) -> Optional[int]:
    return max(getattr(cfg, "SEED", 0), 0) or None


def build_data_sampler(cfg, sampler_cfg) -> PredictionToGroundTruthSampler:
    """The pseudo-label sampler of ``DATA_SAMPLER.TYPE``: points by
    ``densepose_uniform`` or by a confidence, and the coarse masks; each
    point sampler seeded with ``SEED`` (d2's CSE samplers are in neither
    package)."""
    confidence_channels = {
        "densepose_UV_confidence": "sigma_2",
        "densepose_fine_segm_confidence": "fine_segm_confidence",
        "densepose_coarse_segm_confidence": "coarse_segm_confidence",
    }
    if sampler_cfg.TYPE == "densepose_uniform":
        points = DensePoseUniformSampler(count_per_class=sampler_cfg.COUNT_PER_CLASS, seed=_seed(cfg))
    elif sampler_cfg.TYPE in confidence_channels:
        points = DensePoseConfidenceBasedSampler(
            confidence_channels[sampler_cfg.TYPE], count_per_class=sampler_cfg.COUNT_PER_CLASS, seed=_seed(cfg)
        )
    else:
        raise ValueError(f"Unknown data sampler type {sampler_cfg.TYPE}")
    data_sampler = PredictionToGroundTruthSampler()
    data_sampler.register_sampler("pred_densepose", "gt_densepose", points)
    data_sampler.register_sampler("pred_densepose", "gt_masks", MaskFromDensePoseSampler())
    return data_sampler


def build_data_filter(cfg) -> ScoreBasedFilter:
    if cfg.TYPE == "detection_score":
        return ScoreBasedFilter(min_score=cfg.MIN_VALUE)
    raise ValueError(f"Unknown data filter type {cfg.TYPE}")


class _BootstrapImageBatchLoader:
    """Endless lists of ``batch_size`` bootstrap dataset elements in a
    seeded ``TrainingSampler``'s order."""

    def __init__(self, dataset, batch_size: int, seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = TrainingSampler(len(dataset), seed=seed)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(self.dataset[idx])
            if len(batch) == self.batch_size:
                yield batch
                batch = []


def build_inference_based_loader(cfg, dataset_cfg, predict_fn) -> InferenceBasedLoader:
    """The pseudo-label loader of one ``BOOTSTRAP_DATASETS`` entry;
    ``predict_fn`` maps per-image dicts to ``{"instances": Instances}``
    (:func:`~.trainer.build_bootstrap_predictor`). Its samples are stamped
    with the dataset's name."""
    dataset = build_bootstrap_dataset(dataset_cfg.DATASET, dataset_cfg.IMAGE_LOADER)
    assert dataset is not None, f"could not build bootstrap dataset {dataset_cfg.DATASET}"
    meta = MetadataCatalog.get(dataset_cfg.DATASET)
    data_sampler = build_data_sampler(cfg, dataset_cfg.DATA_SAMPLER)
    data_sampler.dataset_name = dataset_cfg.DATASET
    return InferenceBasedLoader(
        predict_fn,
        data_loader=_BootstrapImageBatchLoader(dataset, dataset_cfg.IMAGE_LOADER.BATCH_SIZE, seed=_seed(cfg)),
        data_sampler=data_sampler,
        data_filter=build_data_filter(dataset_cfg.FILTER),
        batch_size=dataset_cfg.INFERENCE.OUTPUT_BATCH_SIZE,
        inference_batch_size=dataset_cfg.INFERENCE.INPUT_BATCH_SIZE,
        category_to_class_mapping=meta.category_to_class_mapping,
        seed=_seed(cfg),
    )


def has_inference_based_loaders(cfg) -> bool:
    return len(cfg.BOOTSTRAP_DATASETS) > 0


def build_inference_based_loaders(cfg, predict_fn) -> Tuple[List[InferenceBasedLoader], List[float]]:
    """One loader and its ratio per ``BOOTSTRAP_DATASETS`` entry, each entry
    merged over :func:`~.config.get_bootstrap_dataset_config`."""
    from detectron2_tpu_torch.projects.densepose.config import get_bootstrap_dataset_config

    loaders, ratios = [], []
    for dataset_spec in cfg.BOOTSTRAP_DATASETS:
        dataset_cfg = get_bootstrap_dataset_config().clone()
        dataset_cfg.merge_from_other_cfg(type(dataset_cfg)(dataset_spec))
        loaders.append(build_inference_based_loader(cfg, dataset_cfg, predict_fn))
        ratios.append(dataset_cfg.RATIO)
    return loaders, ratios


def build_combined_train_loader(cfg, predict_fn, mapper=None, seed: Optional[int] = None,
                                wrap: Optional[Callable[[Iterable], Iterable]] = None):
    """The bootstrap training loader: ``DATASETS.TRAIN`` samples (ratio 1)
    and each bootstrap dataset's pseudo-labelled ones (its ``RATIO``),
    mixed by :class:`CombinedDataLoader`, seen by ``wrap`` (e.g. the
    trainer's ``SampleCountingLoader``) before collation, then padded into
    the batch dicts of the plain train loader. The ground-truth loader's
    ``RandomState(SEED)`` draws its sampler's seed and its mapper's
    augmentations, as the plain train loader's does."""
    dataset = densepose_dataset_dicts(cfg, cfg.DATASETS.TRAIN, filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS)
    rng = np.random.RandomState(cfg.SEED if cfg.SEED >= 0 else None)
    gt_loader = build_detection_train_loader(
        dataset,
        mapper=mapper if mapper is not None else DensePoseDatasetMapper(cfg, True, rng=rng),
        total_batch_size=cfg.SOLVER.IMS_PER_BATCH,
        aspect_ratio_grouping=cfg.DATALOADER.ASPECT_RATIO_GROUPING,
        collator=list,
        rng=rng,
    )
    loaders: List[Iterable] = [gt_loader]
    ratios: List[float] = [1.0]
    if has_inference_based_loaders(cfg):
        inference_loaders, inference_ratios = build_inference_based_loaders(cfg, predict_fn)
        loaders += [_PseudoLabelSampleLoader(loader) for loader in inference_loaders]
        ratios += inference_ratios
    combined = build_combined_loader(cfg, loaders, ratios, seed=seed)
    if wrap is not None:
        combined = wrap(combined)
    h = cfg.MODEL.ROI_DENSEPOSE_HEAD
    collator = DensePoseBatchCollator(
        size_divisibility=32,
        size_bucket=cfg.TPU.SIZE_BUCKET,
        max_gt_instances=cfg.TPU.MAX_GT_INSTANCES,
        mask_size=2 * cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION if cfg.MODEL.MASK_ON else 0,
        dp_mask_size=h.HEATMAP_SIZE if h.COARSE_SEGM_TRAINED_BY_MASKS else 0,
    )
    return (collator(batch) for batch in combined)
