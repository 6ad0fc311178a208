"""DefaultPredictor, the command-line plumbing and DefaultTrainer's
evaluation (counterparts of ``detectron2_tpu/engine/defaults.py``:
``default_argument_parser``, ``default_setup``, ``DefaultPredictor`` :147
and ``DefaultTrainer.build_test_loader`` :283, ``build_evaluator`` :287,
``test`` :363)."""

import argparse
import logging
import os
import random
from collections import OrderedDict
from typing import Dict, Optional, Union

import numpy as np
import torch

from detectron2_tpu_torch.checkpoint import load_d2_checkpoint
from detectron2_tpu_torch.config import CfgNode
from detectron2_tpu_torch.data import PaddedBatchCollator, build_detection_test_loader
from detectron2_tpu_torch.data import transforms as T
from detectron2_tpu_torch.evaluation import DatasetEvaluator, inference_on_dataset, print_csv_format
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.modeling.backbone import padding_constraints
from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess

__all__ = ["DefaultPredictor", "DefaultTrainer", "default_argument_parser", "default_setup"]


def default_argument_parser(epilog=None) -> argparse.ArgumentParser:
    """The standard flags of ``tools/train_net.py``. The multi-process ones
    are accepted and must stay at one process until ROADMAP A6."""
    parser = argparse.ArgumentParser(
        epilog=epilog
        or "Examples:\n  python -m detectron2_tpu_torch.tools.train_net --config-file cfg.yaml "
        "--eval-only MODEL.WEIGHTS /path/to/model.pkl",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--config-file", default="", metavar="FILE", help="path to config file")
    parser.add_argument("--resume", action="store_true", help="resume from the checkpoint directory if any")
    parser.add_argument("--eval-only", action="store_true", help="perform evaluation only")
    parser.add_argument("--num-gpus", type=int, default=1, help="GPUs per machine (1 until the distributed slice)")
    parser.add_argument("--num-machines", type=int, default=1, help="total number of machines")
    parser.add_argument("--machine-rank", type=int, default=0, help="the rank of this machine")
    parser.add_argument("--dist-url", default="auto", help="initialization URL for distributed runs")
    parser.add_argument(
        "opts",
        help="Modify config options at the end of the command, using space-separated 'PATH.KEY VALUE' pairs",
        default=None,
        nargs=argparse.REMAINDER,
    )
    return parser


def default_setup(cfg: CfgNode, args) -> None:
    """Logging, the config dump to ``OUTPUT_DIR/config.yaml`` and the seeds
    (``SEED`` < 0: a random one), for one process."""
    if getattr(args, "num_gpus", 1) * getattr(args, "num_machines", 1) != 1:
        raise NotImplementedError("the port runs one process until the distributed slice (ROADMAP A6)")
    logger = logging.getLogger("detectron2_tpu_torch")
    if not logging.getLogger().handlers and not logger.handlers:
        logging.basicConfig(level=logging.INFO, format="[%(asctime)s %(name)s]: %(message)s")
    logger.setLevel(logging.INFO)
    output_dir = cfg.OUTPUT_DIR
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    logger.info("Command line arguments: " + str(args))
    if output_dir:
        path = os.path.join(output_dir, "config.yaml")
        with open(path, "w") as f:
            f.write(cfg.dump())
        logger.info(f"Full config saved to {path}")
    seed = cfg.SEED if cfg.SEED >= 0 else int.from_bytes(os.urandom(2), "big")
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


class DefaultPredictor:
    """Maps one HWC uint8 image to ``{"instances": Instances}`` at the
    image's original resolution.

    Given ``cfg``, builds its model on ``device`` (default
    ``cfg.MODEL.DEVICE``, ``"cuda"``), loads ``cfg.MODEL.WEIGHTS`` when set
    (``load_report`` says what the loader matched) and resizes as
    ``cfg.INPUT`` says. Given ``model`` instead, a model built in code
    (``model_zoo.mask_rcnn_vitdet_b()``), runs it on its device in eval mode
    with the test-time resize ``ResizeShortestEdge([min_size_test,
    min_size_test], max_size_test)``. The batch is padded as the model's backbone asks
    (``padding_constraints``: multiples of 32, or a ViT's fixed square)."""

    def __init__(
        self,
        cfg=None,
        device: Optional[Union[str, torch.device]] = None,
        *,
        model: Optional[torch.nn.Module] = None,
        min_size_test: Optional[int] = None,
        max_size_test: Optional[int] = None,
        size_bucket: int = 0,
    ):
        if (cfg is None) == (model is None):
            raise ValueError("DefaultPredictor takes a cfg or a model, not both")
        self.cfg = self.load_report = None
        if cfg is not None:
            self.cfg = cfg.clone()
            model = build_model(self.cfg, device=device)
            if cfg.MODEL.WEIGHTS:
                self.load_report = load_d2_checkpoint(model, cfg.MODEL.WEIGHTS)
            min_size_test, max_size_test = cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST
            size_bucket = cfg.TPU.SIZE_BUCKET
        elif min_size_test is None or max_size_test is None or device is not None:
            raise ValueError("with a model: min_size_test and max_size_test, and no device (the model has one)")
        self.model = model.eval()
        self.device = model.device
        self.aug = T.ResizeShortestEdge([min_size_test, min_size_test], max_size_test)
        self.input_format = model.input_format
        assert self.input_format in ("RGB", "BGR"), self.input_format
        constraints = padding_constraints(model.backbone)
        divisibility = constraints.get("size_divisibility", 32)
        self.collator = PaddedBatchCollator(
            size_divisibility=divisibility,
            size_bucket=max(size_bucket, divisibility),
            square_size=constraints.get("square_size", 0),
        )

    def __call__(self, original_image: np.ndarray) -> Dict:
        """original_image: ``[H, W, 3]`` uint8 in BGR order (OpenCV's)."""
        if self.input_format == "RGB":
            original_image = original_image[:, :, ::-1]
        height, width = original_image.shape[:2]
        image = torch.as_tensor(np.ascontiguousarray(original_image), device=self.device)
        batch = self.collator([self.aug.get_transform(image).apply_image(image)])
        outputs = self.model(batch)
        in_h, in_w = (int(v) for v in batch["image_sizes"][0].tolist())
        one = {k: v[0] for k, v in outputs.items()}
        with torch.inference_mode():
            instances = detector_postprocess(one, height, width, in_h, in_w)
        return {"instances": instances}


class DefaultTrainer:
    """DefaultTrainer's evaluation side: the test loader, the evaluator hook
    and :meth:`test` over ``cfg.DATASETS.TEST``. Training through it (its
    constructor, ``train()``, the hooks and the checkpointer) waits for
    ROADMAP A4; ``engine.SimpleTrainer`` trains meanwhile."""

    def __init__(self, cfg):
        raise NotImplementedError("DefaultTrainer's training loop is not ported yet (ROADMAP A4)")

    def train(self):
        raise NotImplementedError("DefaultTrainer's training loop is not ported yet (ROADMAP A4)")

    @classmethod
    def build_test_loader(cls, cfg, dataset_name):
        return build_detection_test_loader(cfg, dataset_name)

    @classmethod
    def build_evaluator(cls, cfg, dataset_name):
        raise NotImplementedError(
            "If you want DefaultTrainer to automatically run evaluation, "
            "please implement `build_evaluator()` in subclasses (see tools/train_net.py for example)."
        )

    @classmethod
    def test(cls, cfg, model, evaluators=None, timing: Optional[dict] = None) -> Dict:
        """Evaluate ``model`` (the port's module, on ``cfg.MODEL.DEVICE``) on
        each dataset of ``cfg.DATASETS.TEST``; returns the results dict (of
        the one dataset, when there is one). ``timing``, when given, receives
        per dataset what :func:`inference_on_dataset` measured."""
        logger = logging.getLogger(__name__)
        if model.device.type != torch.device(cfg.MODEL.DEVICE).type:
            raise ValueError(f"the model is on {model.device} but cfg.MODEL.DEVICE is {cfg.MODEL.DEVICE!r}")
        if isinstance(evaluators, DatasetEvaluator):
            evaluators = [evaluators]
        if evaluators is not None:
            assert len(cfg.DATASETS.TEST) == len(evaluators), f"{len(cfg.DATASETS.TEST)} != {len(evaluators)}"
        model.eval()

        def predict(batch):
            return model({k: v for k, v in batch.items() if k != "metadata"})

        results = OrderedDict()
        for idx, dataset_name in enumerate(cfg.DATASETS.TEST):
            data_loader = cls.build_test_loader(cfg, dataset_name)
            if evaluators is not None:
                evaluator = evaluators[idx]
            else:
                try:
                    evaluator = cls.build_evaluator(cfg, dataset_name)
                except NotImplementedError:
                    logger.warning(
                        "No evaluator found. Use `DefaultTrainer.test(evaluators=)`, "
                        "or implement its `build_evaluator` method."
                    )
                    results[dataset_name] = {}
                    continue
            measured = {}
            results_i = inference_on_dataset(predict, data_loader, evaluator, timing=measured)
            if timing is not None:
                timing[dataset_name] = measured
            results[dataset_name] = results_i
            assert isinstance(results_i, dict), f"Evaluator must return a dict. Got {results_i} instead."
            logger.info(f"Evaluation results for {dataset_name} in csv format:")
            print_csv_format(results_i)

        if len(results) == 1:
            results = list(results.values())[0]
        return results
