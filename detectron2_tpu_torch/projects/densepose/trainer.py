"""The DensePose trainer (counterpart of
``detectron2_tpu/projects/densepose/trainer.py``): DefaultTrainer with the
DensePose mapper in the train and test loaders and the DensePose collator
in the train loader, which puts the point targets into the batch (the JAX
non-bootstrap loader keeps the default collator and its DensePose branch
gets no points: ROADMAP C). Both loaders read their datasets through
:func:`~.datasets.densepose_dataset_dicts`, which applies
``DATASETS.WHITELISTED_CATEGORIES`` and ``DATASETS.CATEGORY_MAPS`` (ROADMAP
C, correction 17).

With ``BOOTSTRAP_DATASETS`` the train loader is
:func:`~.build.build_combined_train_loader`: the ground truth mixed with
samples pseudo-labelled by the bootstrap model
(:func:`build_bootstrap_predictor`), each step's per-dataset instance
counts recorded as ``batch/<dataset>`` (:class:`SampleCountingLoader`) and
logged by :class:`SampleCountMetricPrinter`. The bootstrap model runs in
the train loop's thread, so its inference is part of ``data_time``.

The evaluator: ``COCOEvaluator`` and, for a chart DensePose model,
``DensePoseCOCOEvaluator`` with the SMPL tables of
``$DETECTRON2_DATASETS/densepose_eval_data``, in the modes of
``DENSEPOSE_EVALUATION.TYPE``, its ``MIN_IOU_THRESHOLD`` and its
``STORAGE`` spool, as the JAX ``build_evaluator`` reads them. A CSE model is
scored by ``COCOEvaluator`` alone: the CSE DensePose metric is in neither
package (ROADMAP C, a known difference: d2 has one)."""

import functools
import logging
import os
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from detectron2_tpu_torch.data import build_detection_test_loader, build_detection_train_loader
from detectron2_tpu_torch.data.build import PaddedBatchCollator
from detectron2_tpu_torch.engine import DefaultTrainer
from detectron2_tpu_torch.evaluation import COCOEvaluator, DatasetEvaluators
from detectron2_tpu_torch.projects.densepose.config import is_cse
from detectron2_tpu_torch.projects.densepose.dataset_mapper import DensePoseBatchCollator, DensePoseDatasetMapper
from detectron2_tpu_torch.projects.densepose.datasets import densepose_dataset_dicts
from detectron2_tpu_torch.utils.events import EventWriter, get_event_storage

__all__ = ["SampleCountingLoader", "SampleCountMetricPrinter", "Trainer", "build_bootstrap_predictor"]

logger = logging.getLogger(__name__)


class SampleCountingLoader:
    """Records, per mixed sample list, each source dataset's instances as
    ``batch/<dataset>`` in the event storage (``gt`` for a sample with no
    ``dataset``); wraps the uncollated stream, which still knows each
    sample's source."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        for batch in self.loader:
            try:
                storage = get_event_storage()
            except AssertionError:
                storage = None
            if storage is not None:
                counts: Dict[str, int] = {}
                for sample in batch:
                    name = sample.get("dataset", "gt")
                    inst = sample.get("instances")
                    counts[name] = counts.get(name, 0) + (len(inst) if inst is not None else 0)
                for name, n in counts.items():
                    storage.put_scalar(f"batch/{name}", n)
            yield batch


class SampleCountMetricPrinter(EventWriter):
    """Logs the ``batch/<dataset>`` counts, each averaged over 20 steps."""

    def write(self):
        storage = get_event_storage()
        stats = [f"{k} {buf.avg(20)}" for k, buf in storage.histories().items() if k.startswith("batch/")]
        if stats:
            logger.info(", ".join(stats))


def build_bootstrap_predictor(cfg, model=None) -> Callable[[List[Dict[str, Any]]], List[Dict[str, Any]]]:
    """The bootstrap model as the ``predict_fn`` of
    :class:`~.bootstrap.InferenceBasedLoader`: per-image dicts (an
    ``[H, W, 3]`` BGR float image) -> per-image ``{"instances": Instances}``
    with the valid detections' ``pred_boxes`` (clipped to the image),
    ``scores``, ``pred_classes`` and ``pred_densepose``, one dict of ``[S, S,
    C]`` float32 chart maps (numpy) a detection.

    The model is ``cfg``'s with ``RAW_OUTPUTS`` on, on ``MODEL.DEVICE``, in
    eval mode under ``torch.no_grad``, with ``BOOTSTRAP_MODEL.WEIGHTS``; with
    none, seeded weights (``SEED``) with the FrozenBN statistics calibrated
    on its first batch (``tools/train_net.py::load_or_init``'s rule).
    ``model`` replaces it (tests). Images are padded as the JAX predictor
    pads them (multiples of 32, then ``TPU.SIZE_BUCKET``)."""
    from detectron2_tpu_torch.checkpoint import DetectionCheckpointer
    from detectron2_tpu_torch.modeling import build_model, calibrate_frozen_bn, init_weights
    from detectron2_tpu_torch.structures import Boxes, Instances

    calibrate = False
    if model is None:
        bcfg = cfg.clone()
        bcfg.defrost()
        bcfg.MODEL.ROI_DENSEPOSE_HEAD.RAW_OUTPUTS = True
        model = build_model(bcfg)
        if cfg.BOOTSTRAP_MODEL.WEIGHTS:
            DetectionCheckpointer(model).load(cfg.BOOTSTRAP_MODEL.WEIGHTS)
        else:
            gen = torch.Generator(device=model.device)
            gen.manual_seed(max(cfg.SEED, 0))
            init_weights(model, gen)
            calibrate = True
    model.eval()
    collator = PaddedBatchCollator(size_divisibility=32, size_bucket=max(cfg.TPU.SIZE_BUCKET, 32))

    @torch.no_grad()
    def predict_fn(batch: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        nonlocal calibrate
        padded = collator([torch.as_tensor(np.asarray(d["image"], np.float32)).to(model.device) for d in batch])
        if calibrate:
            calibrate_frozen_bn(model, padded)
            calibrate = False
        out = model(padded)
        host = {k: v.float().cpu().numpy() if k != "pred_densepose_raw" else {m: t.float().cpu().numpy() for m, t in v.items()}
                for k, v in out.items() if k in ("valid", "pred_boxes", "scores", "pred_classes", "pred_densepose_raw")}
        results = []
        for i, d in enumerate(batch):
            h, w = d["image"].shape[:2]
            idx = np.nonzero(host["valid"][i] > 0)[0]
            boxes = host["pred_boxes"][i][idx].astype(np.float32)
            boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
            inst = Instances((h, w))
            inst.pred_boxes = Boxes(torch.from_numpy(boxes))
            inst.scores = host["scores"][i][idx].astype(np.float32)
            inst.pred_classes = host["pred_classes"][i][idx].astype(np.int64)
            raw = host.get("pred_densepose_raw")
            if raw is not None:
                inst.pred_densepose = [{k: v[i, j] for k, v in raw.items()} for j in idx]
            results.append({"instances": inst})
        return results

    return predict_fn


class Trainer(DefaultTrainer):
    @classmethod
    def build_train_loader(cls, cfg):
        if cfg.BOOTSTRAP_DATASETS:
            from detectron2_tpu_torch.projects.densepose.build import build_combined_train_loader

            return build_combined_train_loader(
                cfg, build_bootstrap_predictor(cfg), seed=max(cfg.SEED, 0) or None, wrap=SampleCountingLoader
            )
        h = cfg.MODEL.ROI_DENSEPOSE_HEAD
        dataset = densepose_dataset_dicts(cfg, cfg.DATASETS.TRAIN, filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS)
        # the mask-trained coarse segmentation (and the pixel-to-shape loss)
        # crop the gt masks, rasterized at the segmentation's size
        collator = functools.partial(
            DensePoseBatchCollator, dp_mask_size=h.HEATMAP_SIZE if h.COARSE_SEGM_TRAINED_BY_MASKS else 0
        )
        return build_detection_train_loader(
            cfg, dataset=dataset, mapper_class=DensePoseDatasetMapper, collator_class=collator
        )

    @classmethod
    def build_test_loader(cls, cfg, dataset_name):
        collator = PaddedBatchCollator(
            size_divisibility=32, size_bucket=cfg.TPU.SIZE_BUCKET, square_size=cfg.TPU.FIXED_TEST_SIZE
        )
        return build_detection_test_loader(
            densepose_dataset_dicts(cfg, [dataset_name], filter_empty=False),
            mapper=DensePoseDatasetMapper(cfg, False), collator=collator,
        )

    @classmethod
    def build_evaluator(cls, cfg, dataset_name, output_folder=None):
        output_folder = output_folder or os.path.join(cfg.OUTPUT_DIR, "inference")
        densepose = []
        if is_cse(cfg):
            logger.warning("a CSE model: COCOEvaluator only; neither this package nor the JAX package has a CSE "
                           "DensePose evaluation")
        elif cfg.MODEL.DENSEPOSE_ON:
            from detectron2_tpu_torch.projects.densepose.evaluation import DensePoseCOCOEvaluator, load_smpl_mesh_tables
            from detectron2_tpu_torch.projects.densepose.tensor_storage import build_densepose_evaluator_storage

            e = cfg.DENSEPOSE_EVALUATION
            # d2's "iou" (its chart evaluation) reports the three sections, as
            # d2's evaluator does; the JAX package's "iou" reports
            # densepose_segm alone (ROADMAP C); its "gps", "gpsm", "all" stay
            densepose.append(
                DensePoseCOCOEvaluator(
                    dataset_name, load_smpl_mesh_tables(), mode="all" if e.TYPE == "iou" else e.TYPE,
                    min_iou_threshold=e.MIN_IOU_THRESHOLD,
                    storage=build_densepose_evaluator_storage(e.STORAGE, cfg.OUTPUT_DIR),
                )
            )
        return DatasetEvaluators([COCOEvaluator(dataset_name, output_dir=output_folder)] + densepose)

    def build_writers(self):
        return super().build_writers() + [SampleCountMetricPrinter()]
