"""The DensePose trainer (counterpart of
``detectron2_tpu/projects/densepose/trainer.py``), without the bootstrap:
DefaultTrainer with the DensePose mapper in the train and test loaders and
the DensePose collator in the train loader, which puts the point targets
into the batch (the JAX non-bootstrap loader keeps the default collator and
its DensePose branch gets no points: ROADMAP C). The bootstrap loader
(``BOOTSTRAP_DATASETS``) and the DensePose evaluator refuse, naming ROADMAP
A10; a model without DensePose is evaluated by COCOEvaluator."""

import os

from detectron2_tpu_torch.data import build_detection_test_loader, build_detection_train_loader
from detectron2_tpu_torch.engine import DefaultTrainer
from detectron2_tpu_torch.evaluation import COCOEvaluator
from detectron2_tpu_torch.projects.densepose.dataset_mapper import DensePoseBatchCollator, DensePoseDatasetMapper

__all__ = ["Trainer"]


class Trainer(DefaultTrainer):
    @classmethod
    def build_train_loader(cls, cfg):
        if cfg.BOOTSTRAP_DATASETS:
            raise NotImplementedError("bootstrap training (BOOTSTRAP_DATASETS) is not ported yet (ROADMAP A10)")
        return build_detection_train_loader(
            cfg, mapper_class=DensePoseDatasetMapper, collator_class=DensePoseBatchCollator
        )

    @classmethod
    def build_test_loader(cls, cfg, dataset_name):
        return build_detection_test_loader(cfg, dataset_name, mapper=DensePoseDatasetMapper(cfg, False))

    @classmethod
    def build_evaluator(cls, cfg, dataset_name, output_folder=None):
        if cfg.MODEL.DENSEPOSE_ON:
            raise NotImplementedError("the DensePose evaluator is not ported yet (ROADMAP A10)")
        return COCOEvaluator(dataset_name, output_dir=output_folder or os.path.join(cfg.OUTPUT_DIR, "inference"))
