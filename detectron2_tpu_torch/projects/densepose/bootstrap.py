"""DensePose bootstrapping: model predictions turned into training
annotations (counterpart of ``detectron2_tpu/projects/densepose/
bootstrap.py``), host code in numpy.

- The samplers draw sparse DensePose points and a coarse 256x256 mask from
  each detection's chart maps: :class:`DensePoseUniformSampler` (uniform
  over each part's pixels), :class:`DensePoseConfidenceBasedSampler` (from
  the most confident share of them, by ``sigma_2`` or a segmentation
  confidence) and :class:`MaskFromDensePoseSampler` (full-image masks of
  the coarse foreground). Each draws from its own ``RandomState(seed)``,
  so the same seed gives the JAX package's points.
- :class:`PredictionToGroundTruthSampler` maps prediction fields onto gt
  fields through registered samplers.
- :class:`ScoreBasedFilter` drops low-scored detections and
  :class:`InferenceBasedLoader` runs a predictor over unlabelled image
  batches and yields pseudo-labelled samples.

A prediction's ``pred_densepose`` is a list (one entry a detection) of
dicts of ``[S, S, C]`` chart maps (``coarse_segm``, ``fine_segm``, ``u``,
``v`` and the confidences), as :func:`~.trainer.build_bootstrap_predictor`
returns them.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from detectron2_tpu_torch.projects.densepose.converters import (
    ToChartResultConverter,
    ToChartResultConverterWithConfidences,
    ToMaskConverter,
    make_int_box,
    resize_linear,
)
from detectron2_tpu_torch.projects.densepose.structures import DensePoseDataRelative, DensePoseList
from detectron2_tpu_torch.structures import BoxMode, Instances

__all__ = [
    "FINE_TO_COARSE_SEGMENTATION",
    "DensePoseBaseSampler",
    "DensePoseUniformSampler",
    "DensePoseConfidenceBasedSampler",
    "MaskFromDensePoseSampler",
    "PredictionToGroundTruthSampler",
    "ScoreBasedFilter",
    "InferenceBasedLoader",
]

# fine chart label (1..24) -> coarse body part (1..14)
FINE_TO_COARSE_SEGMENTATION = {
    1: 1, 2: 1,  # torso
    3: 2,  # right hand
    4: 3,  # left hand
    5: 4,  # left foot
    6: 5,  # right foot
    7: 6, 9: 6,  # upper leg right
    8: 7, 10: 7,  # upper leg left
    11: 8, 13: 8,  # lower leg right
    12: 9, 14: 9,  # lower leg left
    15: 10, 17: 10,  # upper arm left
    16: 11, 18: 11,  # upper arm right
    19: 12, 21: 12,  # lower arm left
    20: 13, 22: 13,  # lower arm right
    23: 14, 24: 14,  # head
}


def _boxes_xyxy(instances: Instances) -> np.ndarray:
    b = instances.pred_boxes
    b = b.tensor if hasattr(b, "tensor") else b
    b = b.detach().cpu().numpy() if hasattr(b, "detach") else b
    return np.asarray(b, np.float64).reshape(-1, 4)


class DensePoseBaseSampler:
    """At most ``count_per_class`` (x, y, u, v, part) points per fine part
    from each detection's maps, and the 256x256 coarse mask;
    ``_produce_index_sample`` picks the pixels."""

    def __init__(self, count_per_class: int = 8, seed: Optional[int] = None):
        self.count_per_class = count_per_class
        self._rng = np.random.RandomState(seed)

    def __call__(self, instances: Instances) -> DensePoseList:
        boxes_xyxy = _boxes_xyxy(instances)
        boxes_xywh = BoxMode.convert(boxes_xyxy.copy(), BoxMode.XYXY_ABS, BoxMode.XYWH_ABS)
        dp_datas = []
        for i in range(boxes_xywh.shape[0]):
            dp_map = instances.pred_densepose[i]
            annotation = self._sample(dp_map, boxes_xyxy[i], make_int_box(boxes_xywh[i]))
            annotation[DensePoseDataRelative.S_KEY] = self._resample_mask(dp_map)
            dp_datas.append(DensePoseDataRelative(annotation))
        return DensePoseList(dp_datas, boxes_xyxy, instances.image_size)

    def _sample(self, dp_map: Dict[str, np.ndarray], box_xyxy, box_xywh) -> Dict[str, List[Any]]:
        labels, dp_result = self._produce_labels_and_results(dp_map, box_xyxy)
        keys = (DensePoseDataRelative.X_KEY, DensePoseDataRelative.Y_KEY, DensePoseDataRelative.U_KEY,
                DensePoseDataRelative.V_KEY, DensePoseDataRelative.I_KEY)
        annotation: Dict[str, List[Any]] = {k: [] for k in keys}
        _, h, w = dp_result.shape
        for part_id in range(1, DensePoseDataRelative.N_PART_LABELS + 1):
            yy, xx = np.nonzero(labels == part_id)
            count = min(self.count_per_class, yy.shape[0])
            if count <= 0:
                continue
            values = dp_result[:, yy, xx]  # [n, k]
            index_sample = np.asarray(self._produce_index_sample(values, count))
            sampled = values[:, index_sample]
            # box-relative coordinates in [0, 256), pixel centres
            annotation[DensePoseDataRelative.X_KEY].extend(((xx[index_sample] + 0.5) / w * 256.0).tolist())
            annotation[DensePoseDataRelative.Y_KEY].extend(((yy[index_sample] + 0.5) / h * 256.0).tolist())
            annotation[DensePoseDataRelative.U_KEY].extend(np.clip(sampled[0], 0, 1).tolist())
            annotation[DensePoseDataRelative.V_KEY].extend(np.clip(sampled[1], 0, 1).tolist())
            annotation[DensePoseDataRelative.I_KEY].extend([part_id] * count)
        return annotation

    def _produce_index_sample(self, values: np.ndarray, count: int) -> np.ndarray:
        """``count`` column indices of ``values`` ``[n, k]``."""
        raise NotImplementedError

    def _produce_labels_and_results(self, dp_map: Dict[str, np.ndarray], box_xyxy) -> Tuple[np.ndarray, np.ndarray]:
        """(labels ``[h, w]``, results ``[2, h, w]``: U, V)."""
        result = ToChartResultConverter.convert(dp_map, box_xyxy)
        return result.labels, result.uv

    def _resample_mask(self, dp_map: Dict[str, np.ndarray]) -> np.ndarray:
        """The maps at 256x256 -> the coarse part mask (fine labels on the
        coarse foreground through :data:`FINE_TO_COARSE_SEGMENTATION`)."""
        sz = DensePoseDataRelative.MASK_SIZE
        coarse = resize_linear(dp_map["coarse_segm"], sz, sz).argmax(axis=-1)
        fine = resize_linear(dp_map["fine_segm"], sz, sz).argmax(axis=-1) * (coarse > 0)
        mask = np.zeros((sz, sz), np.int64)
        for fine_id, coarse_id in FINE_TO_COARSE_SEGMENTATION.items():
            mask[fine == fine_id] = coarse_id
        return mask


class DensePoseUniformSampler(DensePoseBaseSampler):
    """Uniform over each part's pixels, without replacement."""

    def _produce_index_sample(self, values: np.ndarray, count: int) -> np.ndarray:
        return self._rng.choice(values.shape[1], size=count, replace=False)


class DensePoseConfidenceBasedSampler(DensePoseBaseSampler):
    """Uniform over the most confident pixels of each part (the smallest
    values of ``confidence_channel``, a stable sort): the first
    ``search_proportion`` of them, at least ``count``."""

    def __init__(self, confidence_channel: str, count_per_class: int = 8, search_proportion: float = 0.5,
                 seed: Optional[int] = None):
        super().__init__(count_per_class, seed=seed)
        self.confidence_channel = confidence_channel
        self.search_proportion = search_proportion

    def _produce_index_sample(self, values: np.ndarray, count: int) -> np.ndarray:
        k = values.shape[1]
        if k == count:
            return np.arange(k)
        order = np.argsort(values[2], kind="stable")
        search_count = min(max(int(k * self.search_proportion), count), k)
        return order[:search_count][self._rng.choice(search_count, size=count, replace=False)]

    def _produce_labels_and_results(self, dp_map: Dict[str, np.ndarray], box_xyxy) -> Tuple[np.ndarray, np.ndarray]:
        """(labels ``[h, w]``, results ``[3, h, w]``: U, V, confidence)."""
        result = ToChartResultConverterWithConfidences.convert(dp_map, box_xyxy)
        conf = getattr(result, self.confidence_channel)
        assert conf is not None, f"prediction has no {self.confidence_channel} channel"
        return result.labels, np.concatenate([result.uv, conf[None]], axis=0)


class MaskFromDensePoseSampler:
    """Detections' coarse foreground -> full-image BitMasks."""

    def __call__(self, instances: Instances):
        coarse = np.stack([dp["coarse_segm"] for dp in instances.pred_densepose], axis=0)
        return ToMaskConverter.convert(coarse, _boxes_xyxy(instances), instances.image_size)


@dataclass
class _Sampler:
    src: str
    dst: Optional[str]
    func: Optional[Callable[[Any], Any]]


class PredictionToGroundTruthSampler:
    """Prediction fields -> gt fields: each registered (src, dst) copies the
    field or applies its sampler; the sources are then removed, and each
    output is stamped with ``dataset_name``."""

    def __init__(self, dataset_name: str = ""):
        self.dataset_name = dataset_name
        self._samplers: Dict[Tuple[str, Optional[str]], _Sampler] = {}
        self.register_sampler("pred_boxes", "gt_boxes", None)
        self.register_sampler("pred_classes", "gt_classes", None)
        self.register_sampler("scores")  # removed

    def __call__(self, model_output: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        for model_output_i in model_output:
            instances: Instances = model_output_i["instances"]
            for sampler in self._samplers.values():
                if not instances.has(sampler.src) or sampler.dst is None:
                    continue
                instances.set(sampler.dst, instances.get(sampler.src) if sampler.func is None else sampler.func(instances))
            for sampler in self._samplers.values():
                if sampler.src != sampler.dst and instances.has(sampler.src):
                    instances.remove(sampler.src)
            model_output_i["dataset"] = self.dataset_name
        return model_output

    def register_sampler(self, prediction_attr: str, gt_attr: Optional[str] = None,
                         func: Optional[Callable[[Any], Any]] = None) -> None:
        self._samplers[(prediction_attr, gt_attr)] = _Sampler(prediction_attr, gt_attr, func)


class ScoreBasedFilter:
    """Keeps the detections scored at least ``min_score``."""

    def __init__(self, min_score: float = 0.8):
        self.min_score = min_score

    def __call__(self, model_output: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        for model_output_i in model_output:
            instances = model_output_i["instances"]
            if not instances.has("scores"):
                continue
            scores = instances.scores
            scores = scores.detach().cpu().numpy() if hasattr(scores, "detach") else np.asarray(scores)
            model_output_i["instances"] = instances[scores >= self.min_score]
        return model_output


def _grouper(iterable: Iterable[Any], n: int, fillvalue=None) -> Iterator[Tuple[Any, ...]]:
    """Consecutive groups of ``n``, the last one filled with ``fillvalue``."""
    it = iter(iterable)
    while True:
        values = []
        for _ in range(n):
            try:
                values.append(next(it))
            except StopIteration:
                if values:
                    yield tuple(values + [fillvalue] * (n - len(values)))
                return
        yield tuple(values)


class InferenceBasedLoader:
    """Training samples whose annotations come from a model. The data
    loader yields lists of ``{"images": [N, H, W, 3], "categories": [N]}``;
    their images are shuffled (``RandomState(seed)``), run through
    ``predict_fn`` (per-image dicts with "image" and "category" -> per-image
    ``{"instances": Instances}``) ``inference_batch_size`` at a time,
    filtered, sampled, and yielded ``batch_size`` samples at a time, each
    with its image and ``dataset_classes`` (the category's class, from
    ``category_to_class_mapping``, 0 when absent)."""

    def __init__(
        self,
        predict_fn: Callable[[List[Dict[str, Any]]], List[Dict[str, Any]]],
        data_loader: Iterable[List[Dict[str, Any]]],
        data_sampler: Optional[Callable] = None,
        data_filter: Optional[Callable] = None,
        batch_size: int = 4,
        inference_batch_size: int = 4,
        category_to_class_mapping: Optional[dict] = None,
        seed: Optional[int] = None,
    ):
        self.predict_fn = predict_fn
        self.data_loader = data_loader
        self.data_sampler = data_sampler
        self.data_filter = data_filter
        self.batch_size = batch_size
        self.inference_batch_size = inference_batch_size
        self.category_to_class_mapping = category_to_class_mapping or {}
        self._rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[List[Dict[str, Any]]]:
        for batch in self.data_loader:
            images_and_categories = [
                {"image": image, "category": category}
                for element in batch
                for image, category in zip(element["images"], element["categories"])
            ]
            if not images_and_categories:
                continue
            self._rng.shuffle(images_and_categories)
            yield from self._produce_data(images_and_categories)

    def _produce_data(self, images_and_categories: List[Dict[str, Any]]) -> Iterator[List[Dict[str, Any]]]:
        data_batches: List[Dict[str, Any]] = []
        for group in _grouper(images_and_categories, self.inference_batch_size):
            batch = [ic for ic in group if ic is not None]
            if not batch:
                continue
            model_output = self.predict_fn(batch)
            for model_output_i, batch_i in zip(model_output, batch):
                model_output_i["image"] = batch_i["image"]
                instance_class = self.category_to_class_mapping.get(batch_i["category"], 0)
                inst = model_output_i["instances"]
                n_inst = len(inst) if inst.has("pred_boxes") else 0
                inst.set("dataset_classes", np.full((n_inst,), instance_class, np.int64))
            if self.data_filter is not None:
                model_output = self.data_filter(model_output)
            data = model_output if self.data_sampler is None else self.data_sampler(model_output)
            data_batches.extend(d for d in data if len(d["instances"]))
            if len(data_batches) >= self.batch_size:
                yield data_batches[: self.batch_size]
                data_batches = data_batches[self.batch_size :]
        if data_batches:
            yield data_batches
