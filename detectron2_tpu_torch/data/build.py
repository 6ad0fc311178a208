"""The data loaders (counterpart of ``detectron2_tpu/data/build.py``:
``get_detection_dataset_dicts`` :152, ``PaddedBatchCollator`` :199,
``build_batch_data_loader`` :271 with its prefetch thread :313,
``build_detection_train_loader`` :398 with its ``from_config`` :348, and
``build_detection_test_loader`` :426-478).

Both loaders yield the fixed-shape batch dicts the model takes,

    {"image": [B, H, W, C] uint8, "image_sizes": [B, 2] int32,
     train only: "gt_boxes" [B, G, 4] float32, "gt_classes" [B, G] int32,
     "gt_valid" [B, G] bool, "gt_masks" [B, G, Ms, Ms] float32 (masks on),
     "gt_keypoints" [B, G, K, 3] float32 (keypoints on),
     "gt_sem_seg" [B, H, W] int32 (SemanticSegmentor, PanopticFPN),
     with MODEL.LOAD_PROPOSALS: "proposal_boxes" [B, P, 4] float32,
     "proposal_logits" [B, P] float32, "proposal_valid" [B, P] bool,
     P = DATASETS.PRECOMPUTED_PROPOSAL_TOPK_{TRAIN,TEST},
     "metadata": [{"image_id", "file_name", "height", "width"}, ...]}

on the host; the model moves them to its device. The JAX collator makes the
images float32 (``build.py:234``); this one keeps them uint8, a quarter of
the bytes, and the model casts after normalizing. As in the JAX package,
the train loader maps and collates in one background thread, two batches
ahead of the step; worker processes wait for ROADMAP A5. The JAX collator
never writes the proposal keys its ``GeneralizedRCNN`` reads (``rcnn.py:105-107``),
so its loader cannot feed a ``PrecomputedProposals`` model; this one does
(ROADMAP C, a correction of the reference).
"""

import atexit
import itertools
import logging
import pickle
import queue
import threading
import weakref
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from detectron2_tpu_torch.config import configurable
from detectron2_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.data.common import AspectRatioGroupedDataset, DatasetFromList, MapDataset, ToIterableDataset
from detectron2_tpu_torch.data.dataset_mapper import DatasetMapper
from detectron2_tpu_torch.data.detection_utils import (
    check_metadata_consistency,
    instances_to_padded_proposals,
    instances_to_padded_targets,
)
from detectron2_tpu_torch.data.samplers import (
    InferenceSampler,
    RandomSubsetTrainingSampler,
    RepeatFactorTrainingSampler,
    TrainingSampler,
)
from detectron2_tpu_torch.structures import BoxMode

logger = logging.getLogger(__name__)

__all__ = [
    "PaddedBatchCollator",
    "build_batch_data_loader",
    "build_detection_test_loader",
    "build_detection_train_loader",
    "get_detection_dataset_dicts",
    "load_proposals_into_dataset",
]


def filter_images_with_only_crowd_annotations(dataset_dicts: List[dict]) -> List[dict]:
    """Filter out images with none or crowd-only annotations."""
    num_before = len(dataset_dicts)

    def valid(anns):
        return any(ann.get("iscrowd", 0) == 0 for ann in anns)

    dataset_dicts = [x for x in dataset_dicts if valid(x["annotations"])]
    logger.info(f"Removed {num_before - len(dataset_dicts)} images with no usable annotations. {len(dataset_dicts)} images left.")
    return dataset_dicts


def filter_images_with_few_keypoints(dataset_dicts: List[dict], min_keypoints_per_image: int) -> List[dict]:
    """The images with at least ``min_keypoints_per_image`` labeled (v > 0)
    keypoints over their annotations."""
    num_before = len(dataset_dicts)

    def visible_keypoints_in_image(dic):
        return sum(
            (np.array(ann["keypoints"][2::3]) > 0).sum() for ann in dic["annotations"] if "keypoints" in ann
        )

    dataset_dicts = [x for x in dataset_dicts if visible_keypoints_in_image(x) >= min_keypoints_per_image]
    logger.info(
        f"Removed {num_before - len(dataset_dicts)} images with fewer than {min_keypoints_per_image} keypoints."
    )
    return dataset_dicts


def print_instances_class_histogram(dataset_dicts: List[dict], class_names: List[str]) -> None:
    """Log the number of instances per category."""
    num_classes = len(class_names)
    histogram = np.zeros((num_classes,), dtype=np.int64)
    for entry in dataset_dicts:
        classes = np.asarray([x["category_id"] for x in entry["annotations"] if not x.get("iscrowd", 0)], dtype=np.int64)
        if len(classes):
            assert classes.min() >= 0 and classes.max() < num_classes
            histogram += np.histogram(classes, bins=num_classes, range=(0, num_classes))[0]
    top = sorted(zip(class_names, histogram.tolist()), key=lambda x: -x[1])[:20]
    logger.info(
        f"Distribution of instances among all {num_classes} categories (total {int(histogram.sum())}; "
        f"top-{len(top)}): " + ", ".join(f"{n}: {c}" for n, c in top)
    )


def load_proposals_into_dataset(dataset_dicts: List[dict], proposal_file: str) -> List[dict]:
    """Add each record's precomputed proposals from a d2 proposal pickle
    (``ids``, ``boxes``, ``objectness_logits``, optional ``bbox_mode``; D1's
    ``indexes`` and ``scores`` renamed), matched by ``str(image_id)`` and
    sorted by decreasing logit: ``proposal_boxes``,
    ``proposal_objectness_logits``, ``proposal_bbox_mode``."""
    logger.info(f"Loading proposals from: {proposal_file}")
    with open(proposal_file, "rb") as f:
        proposals = pickle.load(f, encoding="latin1")
    for old, new in {"indexes": "ids", "scores": "objectness_logits"}.items():
        if old in proposals:
            proposals[new] = proposals.pop(old)
    img_ids = {str(record["image_id"]) for record in dataset_dicts}
    id_to_index = {str(i): k for k, i in enumerate(proposals["ids"]) if str(i) in img_ids}
    bbox_mode = BoxMode(proposals["bbox_mode"]) if "bbox_mode" in proposals else BoxMode.XYXY_ABS
    for record in dataset_dicts:
        k = id_to_index[str(record["image_id"])]
        boxes, logits = proposals["boxes"][k], proposals["objectness_logits"][k]
        inds = logits.argsort()[::-1]
        record["proposal_boxes"] = boxes[inds]
        record["proposal_objectness_logits"] = logits[inds]
        record["proposal_bbox_mode"] = bbox_mode
    return dataset_dicts


def get_detection_dataset_dicts(
    names: Union[str, List[str]],
    filter_empty: bool = True,
    min_keypoints: int = 0,
    proposal_files=None,
    check_consistency: bool = True,
) -> List[dict]:
    """Load and concatenate the dataset dicts of registered datasets, with
    the proposals of ``proposal_files`` (one a name) when given; with
    ``filter_empty`` drop images without a non-crowd annotation, and with
    ``min_keypoints`` images with fewer labeled keypoints."""
    if isinstance(names, str):
        names = [names]
    assert len(names), names
    dataset_dicts = [DatasetCatalog.get(dataset_name) for dataset_name in names]
    for dataset_name, dicts in zip(names, dataset_dicts):
        assert len(dicts), f"Dataset '{dataset_name}' is empty!"
    if proposal_files is not None:
        assert len(names) == len(proposal_files), f"{len(names)} datasets and {len(proposal_files)} proposal files"
        dataset_dicts = [load_proposals_into_dataset(d, f) for d, f in zip(dataset_dicts, proposal_files)]
    dataset_dicts = list(itertools.chain.from_iterable(dataset_dicts))

    has_instances = "annotations" in dataset_dicts[0]
    if filter_empty and has_instances:
        dataset_dicts = filter_images_with_only_crowd_annotations(dataset_dicts)
    if min_keypoints > 0 and has_instances:
        dataset_dicts = filter_images_with_few_keypoints(dataset_dicts, min_keypoints)
    if check_consistency and has_instances:
        try:
            class_names = MetadataCatalog.get(names[0]).thing_classes
            check_metadata_consistency("thing_classes", names)
            print_instances_class_histogram(dataset_dicts, class_names)
        except AttributeError:  # class names are not available for this dataset
            pass
    assert len(dataset_dicts), f"No valid data found in {','.join(names)}."
    return dataset_dicts


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if m > 1 else x


class PaddedBatchCollator:
    """Pad images into one ``[B, H, W, C]`` batch, H and W rounded up to
    ``size_divisibility`` and then to ``size_bucket``. A positive
    ``square_size`` pads to that fixed square instead (ViT backbones:
    ``padding_constraints["square_size"]``; the JAX collator's ``square``).

    Takes either images (``[h, w, C]`` tensors, the predictor's call; the
    batch stays on their device) or the mapper's per-image dicts (their
    "image" a numpy array; the batch is made on the host and carries
    "metadata"). Dicts with "instances" (training) also give the gt arrays
    of :func:`instances_to_padded_targets`: ``max_gt_instances`` slots, and
    masks at ``mask_size`` and ``num_keypoints`` keypoints when they are
    positive. With ``with_sem_seg``, dicts with "sem_seg" also give
    ``gt_sem_seg`` ``[B, H, W]`` int32, padded with
    ``sem_seg_ignore_value``. With a positive ``proposal_topk`` the dicts'
    "proposals" give ``proposal_boxes``, ``proposal_logits`` and
    ``proposal_valid`` in that many slots
    (:func:`instances_to_padded_proposals`)."""

    def __init__(
        self,
        size_divisibility: int = 32,
        size_bucket: int = 32,
        pad_value: float = 0.0,
        square_size: int = 0,
        max_gt_instances: int = 100,
        mask_size: int = 0,
        num_keypoints: int = 0,
        with_sem_seg: bool = False,
        sem_seg_ignore_value: int = 255,
        proposal_topk: int = 0,
    ):
        self.size_divisibility = size_divisibility
        self.size_bucket = size_bucket
        self.pad_value = pad_value
        self.square_size = square_size
        self.max_gt_instances = max_gt_instances
        self.mask_size = mask_size
        self.num_keypoints = num_keypoints
        self.with_sem_seg = with_sem_seg
        self.sem_seg_ignore_value = sem_seg_ignore_value
        self.proposal_topk = proposal_topk

    def __call__(self, batch_list: List[Union[torch.Tensor, dict]]) -> Dict[str, Any]:
        records = isinstance(batch_list[0], dict)
        images = [torch.as_tensor(d["image"]) for d in batch_list] if records else batch_list
        sizes = [(im.shape[0], im.shape[1]) for im in images]
        max_h, max_w = max(s[0] for s in sizes), max(s[1] for s in sizes)
        if self.square_size > 0:
            if max(max_h, max_w) > self.square_size:
                raise ValueError(f"an image of {max_h}x{max_w} does not fit the {self.square_size} square")
            H = W = self.square_size
        else:
            H = _round_up(_round_up(max_h, self.size_divisibility), self.size_bucket)
            W = _round_up(_round_up(max_w, self.size_divisibility), self.size_bucket)
        first = images[0]
        batch = torch.full(
            (len(images), H, W, first.shape[2]), self.pad_value, dtype=first.dtype, device=first.device
        )
        for i, im in enumerate(images):
            batch[i, : im.shape[0], : im.shape[1]] = im
        out: Dict[str, Any] = {
            "image": batch,
            "image_sizes": torch.tensor(sizes, dtype=torch.int32, device=first.device),
        }
        if records and "instances" in batch_list[0]:
            targets = [
                instances_to_padded_targets(
                    d["instances"], self.max_gt_instances, mask_size=self.mask_size, num_keypoints=self.num_keypoints
                )
                for d in batch_list
            ]
            for k in targets[0]:
                out[k] = torch.from_numpy(np.stack([t[k] for t in targets]))
        if self.with_sem_seg and records and "sem_seg" in batch_list[0]:
            sem = np.full((len(images), H, W), self.sem_seg_ignore_value, np.int32)
            for i, d in enumerate(batch_list):
                h, w = sizes[i]
                sem[i, :h, :w] = d["sem_seg"]
            out["gt_sem_seg"] = torch.from_numpy(sem)
        if self.proposal_topk > 0 and records:
            props = [instances_to_padded_proposals(d["proposals"], self.proposal_topk) for d in batch_list]
            for k in props[0]:
                out[k] = torch.from_numpy(np.stack([p[k] for p in props]))
        if records:
            # host-side metadata for the evaluators
            out["metadata"] = [
                {k: d[k] for k in ("image_id", "file_name", "height", "width") if k in d} for d in batch_list
            ]
        return out


def build_batch_data_loader(
    dataset,
    sampler,
    total_batch_size: int,
    *,
    aspect_ratio_grouping: bool = True,
    num_workers: int = 0,
    collator: Optional[PaddedBatchCollator] = None,
):
    """An endless iterator of padded batches of ``total_batch_size`` records
    of ``dataset`` in ``sampler``'s order, grouped by orientation when
    ``aspect_ratio_grouping``; one thread maps and collates two batches
    ahead. ``num_workers`` is accepted for the config's sake and not used:
    there are no worker processes yet (ROADMAP A5)."""
    if num_workers > 0:
        logger.info(f"DATALOADER.NUM_WORKERS={num_workers}: the port's loader maps in one prefetch thread (ROADMAP A5)")
    iterable = ToIterableDataset(dataset, sampler)
    if aspect_ratio_grouping:
        batches = AspectRatioGroupedDataset(iterable, total_batch_size)
    else:

        def _chunks():
            it = iter(iterable)
            while True:
                yield [next(it) for _ in range(total_batch_size)]

        batches = _chunks()
    collator = collator or PaddedBatchCollator()

    return _ThreadPrefetcher((collator(batch) for batch in batches), depth=2)


class _ThreadPrefetcher:
    """Runs ``iterator`` in a daemon thread, ``depth`` items ahead of the
    consumer, so that the host's mapping overlaps the device's step. An
    exception in the thread is raised at the consumer's next ``next()``.
    ``close()`` stops the thread once the item it is making is done. Every
    prefetcher still running is closed at interpreter exit, before Python
    finalizes: a daemon thread caught inside a torch call then would abort
    the process (``terminate called without an active exception``)."""

    def __init__(self, iterator, depth: int = 2):
        self._q = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in iterator:
                    if not put(item):
                        return
            except Exception as e:  # handed to the consumer, which raises it
                if not put(e):
                    return
            put(self._done)

        self._thread = threading.Thread(target=worker, name="train-loader-prefetch", daemon=True)
        self._thread.start()
        _LIVE_PREFETCHERS.add(self)

    def close(self) -> None:
        self._stop.set()
        self._thread.join()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item


_LIVE_PREFETCHERS = weakref.WeakSet()


@atexit.register
def _close_prefetchers() -> None:
    for prefetcher in list(_LIVE_PREFETCHERS):
        prefetcher.close()


def _train_loader_from_config(
    cfg, mapper=None, *, dataset=None, sampler=None, mapper_class=DatasetMapper, collator_class=PaddedBatchCollator
):
    if dataset is None:
        dataset = get_detection_dataset_dicts(
            cfg.DATASETS.TRAIN,
            filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS,
            min_keypoints=cfg.MODEL.ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE if cfg.MODEL.KEYPOINT_ON else 0,
            proposal_files=cfg.DATASETS.PROPOSAL_FILES_TRAIN if cfg.MODEL.LOAD_PROPOSALS else None,
        )
    # the loader's RandomState draws the sampler's seed, then every
    # augmentation draw of its mapper (the JAX package draws both from
    # numpy's global state, seeded with SEED by default_setup)
    rng = np.random.RandomState(cfg.SEED if cfg.SEED >= 0 else None)
    if sampler is None:
        sampler_name = cfg.DATALOADER.SAMPLER_TRAIN
        logger.info(f"Using training sampler {sampler_name}")
        if sampler_name == "TrainingSampler":
            sampler = TrainingSampler(len(dataset), seed=rng.randint(2**31))
        elif sampler_name == "RepeatFactorTrainingSampler":
            repeat_factors = RepeatFactorTrainingSampler.repeat_factors_from_category_frequency(
                dataset, cfg.DATALOADER.REPEAT_THRESHOLD, sqrt=cfg.DATALOADER.REPEAT_SQRT
            )
            sampler = RepeatFactorTrainingSampler(repeat_factors, seed=rng.randint(2**31))
        elif sampler_name == "RandomSubsetTrainingSampler":
            seed_shuffle = rng.randint(2**31)
            sampler = RandomSubsetTrainingSampler(
                len(dataset), cfg.DATALOADER.RANDOM_SUBSET_RATIO, seed_shuffle=seed_shuffle, seed_subset=rng.randint(2**31)
            )
        else:
            raise ValueError(f"Unknown training sampler: {sampler_name}")
    if mapper is None:
        mapper = mapper_class(cfg, True, rng=rng)
    collator = collator_class(
        size_divisibility=32,
        size_bucket=cfg.TPU.SIZE_BUCKET,
        max_gt_instances=cfg.TPU.MAX_GT_INSTANCES,
        mask_size=2 * cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION if cfg.MODEL.MASK_ON else 0,
        num_keypoints=cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS if cfg.MODEL.KEYPOINT_ON else 0,
        with_sem_seg=cfg.MODEL.META_ARCHITECTURE in ("SemanticSegmentor", "PanopticFPN"),
        sem_seg_ignore_value=cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE,
        proposal_topk=cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN if cfg.MODEL.LOAD_PROPOSALS else 0,
    )
    return {
        "dataset": dataset,
        "sampler": sampler,
        "mapper": mapper,
        "total_batch_size": cfg.SOLVER.IMS_PER_BATCH,
        "aspect_ratio_grouping": cfg.DATALOADER.ASPECT_RATIO_GROUPING,
        "num_workers": cfg.DATALOADER.NUM_WORKERS,
        "collator": collator,
    }


@configurable(from_config=_train_loader_from_config)
def build_detection_train_loader(
    dataset,
    *,
    mapper,
    sampler=None,
    total_batch_size: int = 16,
    aspect_ratio_grouping: bool = True,
    num_workers: int = 0,
    collator=None,
    rng: Optional[np.random.RandomState] = None,
):
    """The training loader: an endless iterator of padded batch dicts (one
    process holds the whole batch until ROADMAP A6). Call it as
    ``build_detection_train_loader(cfg)``, or with the dataset (a list of
    dicts or a dataset), mapper, sampler and collator (a lazy config's
    keyword form; ``num_workers`` is accepted and unused: one prefetch
    thread). From a cfg, the loader's ``RandomState(SEED)`` draws the
    sampler's seed and the mapper's augmentations; in the keyword form
    ``rng`` does the same: a sampler made here takes its seed from it, and a
    mapper whose augmentations have no ``rng`` of their own draws from it."""
    if isinstance(dataset, list):
        dataset = DatasetFromList(dataset, copy=False)
    if rng is not None and mapper is not None and getattr(mapper, "augmentations", None) is not None:
        if mapper.augmentations.rng is None:
            mapper.augmentations.set_rng(rng)
    if mapper is not None:
        dataset = MapDataset(dataset, mapper)
    if sampler is None:
        sampler = TrainingSampler(len(dataset), seed=None if rng is None else rng.randint(2**31))
    return build_batch_data_loader(
        dataset,
        sampler,
        total_batch_size,
        aspect_ratio_grouping=aspect_ratio_grouping,
        num_workers=num_workers,
        collator=collator,
    )


def _test_loader_from_config(cfg, dataset_name, mapper=None):
    if isinstance(dataset_name, str):
        dataset_name = [dataset_name]
    proposal_files = None
    if cfg.MODEL.LOAD_PROPOSALS:
        proposal_files = [cfg.DATASETS.PROPOSAL_FILES_TEST[list(cfg.DATASETS.TEST).index(x)] for x in dataset_name]
    dataset = get_detection_dataset_dicts(dataset_name, filter_empty=False, proposal_files=proposal_files)
    if mapper is None:
        mapper = DatasetMapper(cfg, False)
    collator = PaddedBatchCollator(
        size_divisibility=32,
        size_bucket=cfg.TPU.SIZE_BUCKET,
        square_size=cfg.TPU.FIXED_TEST_SIZE,
        proposal_topk=cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST if cfg.MODEL.LOAD_PROPOSALS else 0,
    )
    return {
        "dataset": dataset,
        "mapper": mapper,
        "sampler": InferenceSampler(len(dataset)),
        "collator": collator,
    }


@configurable(from_config=_test_loader_from_config)
def build_detection_test_loader(
    dataset, *, mapper, sampler=None, batch_size: int = 1, num_workers: int = 0, collator=None
):
    """The test loader: every index of ``sampler`` once, in order,
    ``batch_size`` images per batch (1 by default, as in d2), as a generator
    of padded batch dicts. Call it as ``build_detection_test_loader(cfg,
    dataset_name)`` or with the dataset (a list of dicts or a dataset),
    mapper, sampler and collator; ``num_workers`` is accepted and unused."""
    if isinstance(dataset, list):
        dataset = DatasetFromList(dataset, copy=False)
    if mapper is not None:
        dataset = MapDataset(dataset, mapper)
    if sampler is None:
        sampler = InferenceSampler(len(dataset))
    collator = collator or PaddedBatchCollator()

    def _gen():
        buf = []
        for idx in sampler:
            buf.append(dataset[idx])
            if len(buf) == batch_size:
                yield collator(buf)
                buf = []
        if buf:
            yield collator(buf)

    return _gen()
