#!/usr/bin/env python
"""Train and evaluate a yacs-config model on registered COCO-format
datasets, on the card (counterpart of ``tools/train_net.py``):

    python -m detectron2_tpu_torch.tools.train_net \\
        --config-file configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml \\
        --dataset my_train /path/to/train.json /path/to/train_images \\
        --dataset my_val /path/to/val.json /path/to/val_images [--resume] \\
        DATASETS.TRAIN '("my_train",)' DATASETS.TEST '("my_val",)' OUTPUT_DIR out

    python -m detectron2_tpu_torch.tools.train_net --config-file ... \\
        --dataset my_val /path/to/val.json /path/to/val_images \\
        --eval-only MODEL.WEIGHTS /path/to/model_final.pkl DATASETS.TEST '("my_val",)'

``--dataset NAME JSON_FILE IMAGE_ROOT`` (repeatable) registers a COCO
instances json with ``register_coco_instances`` before the run; a program
can register datasets itself and call :func:`main`. Training runs
``DefaultTrainer``: seeded weights, then ``MODEL.WEIGHTS`` (a d2 ``.pkl``
or a port ``.pth``) when set, or with ``--resume`` the last checkpoint in
``OUTPUT_DIR``; checkpoints, ``metrics.json`` and the evaluation after
training go to ``OUTPUT_DIR``. ``--eval-only`` loads ``MODEL.WEIGHTS`` (or
with ``--resume`` the last checkpoint); without either the model takes
seeded random weights (``SEED``, 0 when negative) with its FrozenBN
statistics calibrated on the first test batch, which makes the run a smoke
test of the path and its AP meaningless. The model runs on ``MODEL.DEVICE``
(``cuda``; ``cpu`` only when asked).
"""

import logging
import os

import torch

from detectron2_tpu_torch.checkpoint import DetectionCheckpointer
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data import MetadataCatalog, build_detection_test_loader
from detectron2_tpu_torch.data.datasets import register_coco_instances
from detectron2_tpu_torch.engine import DefaultTrainer, default_argument_parser, default_setup
from detectron2_tpu_torch.evaluation import COCOEvaluator, DatasetEvaluators, verify_results
from detectron2_tpu_torch.modeling import build_model, calibrate_frozen_bn, init_weights

logger = logging.getLogger("detectron2_tpu_torch.tools.train_net")


def build_evaluator(cfg, dataset_name, output_folder=None):
    """The evaluator of the dataset's ``evaluator_type``: COCO (the other
    types of the JAX package wait for their evaluators)."""
    if output_folder is None:
        output_folder = os.path.join(cfg.OUTPUT_DIR, "inference")
    evaluator_type = MetadataCatalog.get(dataset_name).get("evaluator_type", "coco")
    evaluator_list = []
    if evaluator_type in ["coco", "coco_panoptic_seg"]:
        evaluator_list.append(COCOEvaluator(dataset_name, output_dir=output_folder))
    if len(evaluator_list) == 0:
        raise NotImplementedError(f"no Evaluator for the dataset {dataset_name} with the type {evaluator_type}")
    if len(evaluator_list) == 1:
        return evaluator_list[0]
    return DatasetEvaluators(evaluator_list)


class Trainer(DefaultTrainer):
    @classmethod
    def build_evaluator(cls, cfg, dataset_name, output_folder=None):
        return build_evaluator(cfg, dataset_name, output_folder)


def setup(args):
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    default_setup(cfg, args)
    return cfg


def load_or_init(cfg, model, resume: bool = False) -> str:
    """``MODEL.WEIGHTS`` (or, with ``resume``, the last checkpoint in
    ``OUTPUT_DIR``) into ``model``, or seeded random weights with the
    FrozenBN statistics calibrated on the first test batch; returns what was
    done."""
    checkpointer = DetectionCheckpointer(model, cfg.OUTPUT_DIR)
    if cfg.MODEL.WEIGHTS or (resume and checkpointer.has_checkpoint()):
        checkpointer.resume_or_load(cfg.MODEL.WEIGHTS, resume=resume)
        return checkpointer.last_report
    seed = max(cfg.SEED, 0)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    init_weights(model, gen)
    batch = next(iter(build_detection_test_loader(cfg, cfg.DATASETS.TEST[0])))
    calibrate_frozen_bn(model, {k: v for k, v in batch.items() if k != "metadata"})
    return f"No MODEL.WEIGHTS: seeded random weights (seed {seed}), FrozenBN calibrated on the first test batch."


def main(args):
    for name, json_file, image_root in args.dataset or []:
        register_coco_instances(name, {}, json_file, image_root)
    cfg = setup(args)
    if args.eval_only:
        model = build_model(cfg)
        logger.info(load_or_init(cfg, model, resume=args.resume))
        res = Trainer.test(cfg, model)
        verify_results(cfg, res)
        return res
    trainer = Trainer(cfg)
    trainer.resume_or_load(resume=args.resume)
    return trainer.train()


def argument_parser():
    parser = default_argument_parser()
    parser.add_argument(
        "--dataset",
        nargs=3,
        action="append",
        metavar=("NAME", "JSON_FILE", "IMAGE_ROOT"),
        help="register a COCO instances json as NAME before the run (repeatable)",
    )
    return parser


def invoke_main() -> None:
    main(argument_parser().parse_args())


if __name__ == "__main__":
    invoke_main()
