"""The DensePose trainer (counterpart of
``detectron2_tpu/projects/densepose/trainer.py``), without the bootstrap:
DefaultTrainer with the DensePose mapper in the train and test loaders and
the DensePose collator in the train loader, which puts the point targets
into the batch (the JAX non-bootstrap loader keeps the default collator and
its DensePose branch gets no points: ROADMAP C). Both loaders read their
datasets through :func:`~.datasets.densepose_dataset_dicts`, which applies
``DATASETS.WHITELISTED_CATEGORIES`` and ``DATASETS.CATEGORY_MAPS`` (ROADMAP
C, correction 17). The bootstrap loader (``BOOTSTRAP_DATASETS``) refuses,
naming ROADMAP A10.

The evaluator: ``COCOEvaluator`` and, for a chart DensePose model,
``DensePoseCOCOEvaluator`` with the SMPL tables of
``$DETECTRON2_DATASETS/densepose_eval_data``, in the modes of
``DENSEPOSE_EVALUATION.TYPE``, its ``MIN_IOU_THRESHOLD`` and its
``STORAGE`` spool, as the JAX ``build_evaluator`` reads them. A CSE model is
scored by ``COCOEvaluator`` alone: the CSE DensePose metric is in neither
package (ROADMAP A10)."""

import functools
import logging
import os

from detectron2_tpu_torch.data import build_detection_test_loader, build_detection_train_loader
from detectron2_tpu_torch.data.build import PaddedBatchCollator
from detectron2_tpu_torch.engine import DefaultTrainer
from detectron2_tpu_torch.evaluation import COCOEvaluator, DatasetEvaluators
from detectron2_tpu_torch.projects.densepose.config import is_cse
from detectron2_tpu_torch.projects.densepose.dataset_mapper import DensePoseBatchCollator, DensePoseDatasetMapper
from detectron2_tpu_torch.projects.densepose.datasets import densepose_dataset_dicts

__all__ = ["Trainer"]

logger = logging.getLogger(__name__)


class Trainer(DefaultTrainer):
    @classmethod
    def build_train_loader(cls, cfg):
        if cfg.BOOTSTRAP_DATASETS:
            raise NotImplementedError("bootstrap training (BOOTSTRAP_DATASETS) is not ported yet (ROADMAP A10)")
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
            logger.warning("a CSE model: COCOEvaluator only, the CSE DensePose evaluation is not ported (ROADMAP A10)")
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
