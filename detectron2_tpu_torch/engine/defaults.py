"""DefaultPredictor, DefaultTrainer and the command-line plumbing
(counterparts of ``detectron2_tpu/engine/defaults.py``:
``default_argument_parser``, ``default_setup``, ``default_writers`` :131,
``DefaultPredictor`` :147 and ``DefaultTrainer`` :217)."""

import argparse
import logging
import os
import random
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from detectron2_tpu_torch.checkpoint import DetectionCheckpointer, load_d2_checkpoint
from detectron2_tpu_torch.config import CfgNode
from detectron2_tpu_torch.data import PaddedBatchCollator, build_detection_test_loader, build_detection_train_loader
from detectron2_tpu_torch.data import transforms as T
from detectron2_tpu_torch.engine import hooks
from detectron2_tpu_torch.engine.train_loop import SimpleTrainer, TrainerBase
from detectron2_tpu_torch.evaluation import DatasetEvaluator, inference_on_dataset, print_csv_format, verify_results
from detectron2_tpu_torch.layers import get_bn_modules
from detectron2_tpu_torch.modeling import build_model, init_weights
from detectron2_tpu_torch.modeling.backbone import padding_constraints
from detectron2_tpu_torch.modeling.meta_arch.panoptic_fpn import add_panoptic_outputs
from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess, sem_seg_postprocess
from detectron2_tpu_torch.solver import build_lr_scheduler, build_optimizer
from detectron2_tpu_torch.utils.events import CommonMetricPrinter, JSONWriter

__all__ = [
    "DefaultPredictor",
    "DefaultTrainer",
    "default_argument_parser",
    "default_setup",
    "default_writers",
    "eval_predictor",
]


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


def default_setup(cfg, args) -> None:
    """Logging, the config dump to ``config.yaml`` in the output directory
    and the seeds, for one process. ``cfg`` is a :class:`CfgNode`
    (``OUTPUT_DIR``, ``SEED``; a negative seed draws one) or a lazy config
    (``train.output_dir``, ``train.seed`` when it has one, else a drawn
    seed), as the JAX package's ``default_setup`` reads them."""
    if getattr(args, "num_gpus", 1) * getattr(args, "num_machines", 1) != 1:
        raise NotImplementedError("the port runs one process until the distributed slice (ROADMAP A6)")
    logger = logging.getLogger("detectron2_tpu_torch")
    if not logging.getLogger().handlers and not logger.handlers:
        logging.basicConfig(level=logging.INFO, format="[%(asctime)s %(name)s]: %(message)s")
    logger.setLevel(logging.INFO)
    lazy = not isinstance(cfg, CfgNode)
    output_dir = cfg.train.output_dir if lazy else cfg.OUTPUT_DIR
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    logger.info("Command line arguments: " + str(args))
    if output_dir:
        path = os.path.join(output_dir, "config.yaml")
        if lazy:
            from detectron2_tpu_torch.config import LazyConfig

            LazyConfig.save(cfg, path)
        else:
            with open(path, "w") as f:
                f.write(cfg.dump())
        logger.info(f"Full config saved to {path}")
    seed = cfg.train.get("seed", -1) if lazy else cfg.SEED
    seed = seed if seed >= 0 else int.from_bytes(os.urandom(2), "big")
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def default_writers(output_dir: str, max_iter: Optional[int] = None) -> list:
    """The console printer, ``{output_dir}/metrics.json`` and, where
    ``torch.utils.tensorboard`` imports, a tensorboard writer."""
    os.makedirs(output_dir, exist_ok=True)
    writers = [CommonMetricPrinter(max_iter), JSONWriter(os.path.join(output_dir, "metrics.json"))]
    try:
        from detectron2_tpu_torch.utils.events import TensorboardXWriter

        writers.append(TensorboardXWriter(output_dir))
    except Exception:
        pass
    return writers


def eval_predictor(model: torch.nn.Module):
    """The evaluation loop's step, shared by ``DefaultTrainer.test`` and
    ``lazyconfig_train_net``: the model on a batch without its metadata,
    then, for a PanopticFPN, the panoptic fusion (``add_panoptic_outputs``)."""

    def predict(batch):
        return add_panoptic_outputs(model, batch, model({k: v for k, v in batch.items() if k != "metadata"}))

    return predict


class DefaultPredictor:
    """Maps one HWC uint8 image to d2's outputs at the image's original
    resolution: ``{"instances": Instances}`` for a detector; a
    SemanticSegmentor's ``{"sem_seg": [C, H, W] float32 logits}``; a
    PanopticFPN's both and, with ``COMBINE.ENABLED``, ``"panoptic_seg"``:
    ``(panoptic_seg [H, W] int32, segments_info)`` on the host.

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
        result = {}
        with torch.inference_mode():
            if "sem_seg" in outputs:
                result["sem_seg"] = sem_seg_postprocess(outputs["sem_seg"][0], (in_h, in_w), height, width).permute(2, 0, 1)
            if set(outputs) != {"sem_seg"}:  # a detector's outputs
                one = {k: v[0] for k, v in outputs.items() if k != "sem_seg"}
                result["instances"] = detector_postprocess(one, height, width, in_h, in_w)
            panoptic = add_panoptic_outputs(self.model, {**batch, "metadata": [{"height": height, "width": width}]}, outputs)
        if "panoptic_seg" in panoptic:
            result["panoptic_seg"] = panoptic["panoptic_seg"][0]
        return result


class DefaultTrainer(TrainerBase):
    """Training from a config: the model on ``cfg.MODEL.DEVICE`` (``cuda``)
    with seeded weights (``torch.Generator`` seeded with ``max(SEED, 0)``),
    SGD with d2's parameter groups and the LR schedule, the train loader of
    ``cfg.DATASETS.TRAIN``, a :class:`DetectionCheckpointer` on
    ``OUTPUT_DIR`` and the hook stack of :meth:`build_hooks`. The samplers of
    the model draw from the trainer's own generator (seeded with
    ``max(SEED, 0) + 7``, saved in checkpoints). Call
    :meth:`resume_or_load` before :meth:`train` to load
    ``MODEL.WEIGHTS`` or resume from ``OUTPUT_DIR``; :meth:`test` evaluates
    over ``cfg.DATASETS.TEST``."""

    def __init__(self, cfg):
        super().__init__()
        logger = logging.getLogger("detectron2_tpu_torch")
        if not logger.isEnabledFor(logging.INFO):
            logger.setLevel(logging.INFO)
        cfg = DefaultTrainer.auto_scale_workers(cfg, 1)
        self.cfg = cfg
        model = self.build_model(cfg)
        seed = max(cfg.SEED, 0)
        init_gen = torch.Generator(device=model.device)
        init_gen.manual_seed(seed)
        init_weights(model, init_gen)
        optimizer = self.build_optimizer(cfg, model)
        data_loader = self.build_train_loader(cfg)
        sampling_gen = torch.Generator(device=model.device)
        sampling_gen.manual_seed(seed + 7)
        self._trainer = SimpleTrainer(model, data_loader, optimizer, generator=sampling_gen)
        self.scheduler = self.build_lr_scheduler(cfg, optimizer)
        self.checkpointer = DetectionCheckpointer(model, cfg.OUTPUT_DIR, trainer=weakref.proxy(self))
        self.start_iter = 0
        self.max_iter = cfg.SOLVER.MAX_ITER
        self.register_hooks(self.build_hooks())

    @property
    def model(self) -> torch.nn.Module:
        return self._trainer.model

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        return self._trainer.optimizer

    def resume_or_load(self, resume: bool = True) -> None:
        """With ``resume`` and a checkpoint in ``OUTPUT_DIR``: load the last
        one (model, optimizer, scheduler, generator) and start after its
        iteration. Otherwise load ``MODEL.WEIGHTS`` (a d2 ``.pkl`` or a port
        ``.pth``) when set, as weights only."""
        extra = self.checkpointer.resume_or_load(self.cfg.MODEL.WEIGHTS, resume=resume)
        if resume and self.checkpointer.has_checkpoint():
            self.start_iter = extra.get("iteration", -1) + 1

    def build_hooks(self) -> List[hooks.HookBase]:
        """IterationTimer, LRScheduler, PreciseBN (with
        ``TEST.PRECISE_BN.ENABLED`` and a BN with batch statistics in the
        model: ``TEST.PRECISE_BN.NUM_ITER`` batches of a second train loader,
        at ``TEST.EVAL_PERIOD`` and after training), PeriodicCheckpointer
        (``SOLVER.CHECKPOINT_PERIOD``), EvalHook (``TEST.EVAL_PERIOD``, and
        after training) and PeriodicWriter (every 20 iterations), in that
        order, as d2's ``build_hooks``. The JAX package's reads no
        ``TEST.PRECISE_BN`` (ROADMAP C)."""
        cfg = self.cfg
        # the hooks' functions hold the trainer weakly: the trainer holds
        # the hooks, and a cycle would keep the model alive after the
        # trainer is dropped, until a gc.collect()
        trainer, cls = weakref.proxy(self), type(self)

        def test_and_save_results():
            trainer._last_eval_results = cls.test(cfg, trainer.model)
            return trainer._last_eval_results

        def precise_bn_batches():
            # built at the hook's first update, so that its prefetch thread
            # does not run beside the training loader's until then
            yield from cls.build_train_loader(cfg)

        precise_bn = None
        if cfg.TEST.PRECISE_BN.ENABLED and get_bn_modules(self.model):
            precise_bn = hooks.PreciseBN(cfg.TEST.EVAL_PERIOD, self.model, precise_bn_batches(), cfg.TEST.PRECISE_BN.NUM_ITER)
        return [
            hooks.IterationTimer(),
            hooks.LRScheduler(self.optimizer, self.scheduler),
            precise_bn,
            hooks.PeriodicCheckpointer(self.checkpointer, cfg.SOLVER.CHECKPOINT_PERIOD, max_iter=self.max_iter),
            hooks.EvalHook(cfg.TEST.EVAL_PERIOD, test_and_save_results),
            hooks.PeriodicWriter(self.build_writers(), period=20),
        ]

    def build_writers(self) -> list:
        return default_writers(self.cfg.OUTPUT_DIR, self.max_iter)

    def train(self):
        """Train from ``start_iter`` to ``SOLVER.MAX_ITER``; with
        ``TEST.EXPECTED_RESULTS`` set, :func:`verify_results` holds the last
        evaluation to them. Returns the last evaluation's results."""
        super().train(self.start_iter, self.max_iter)
        if len(self.cfg.TEST.EXPECTED_RESULTS):
            assert hasattr(self, "_last_eval_results"), "No evaluation results obtained during training!"
            verify_results(self.cfg, self._last_eval_results)
        return getattr(self, "_last_eval_results", None)

    def run_step(self):
        self._trainer.iter = self.iter
        self._trainer.run_step()

    def state_dict(self):
        ret = super().state_dict()
        ret["_trainer"] = self._trainer.state_dict()
        return ret

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        self._trainer.load_state_dict(state_dict["_trainer"])

    @classmethod
    def build_model(cls, cfg) -> torch.nn.Module:
        model = build_model(cfg)
        logging.getLogger(__name__).info(f"Model:\n{model}")
        return model

    @classmethod
    def build_optimizer(cls, cfg, model) -> torch.optim.Optimizer:
        return build_optimizer(cfg, model)

    @classmethod
    def build_lr_scheduler(cls, cfg, optimizer):
        return build_lr_scheduler(cfg, optimizer)

    @classmethod
    def build_train_loader(cls, cfg):
        return build_detection_train_loader(cfg)

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

        predict = eval_predictor(model)
        results = OrderedDict()
        for idx, dataset_name in enumerate(cfg.DATASETS.TEST):
            data_loader = cls.build_test_loader(cfg, dataset_name)
            if evaluators is not None:
                evaluator = evaluators[idx]
            else:
                try:
                    evaluator = cls.build_evaluator(cfg, dataset_name)
                except NotImplementedError as e:
                    logger.warning(
                        f"No evaluator found ({e}). Use `DefaultTrainer.test(evaluators=)`, "
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

    @staticmethod
    def auto_scale_workers(cfg, num_workers: int):
        """The config scaled linearly from ``SOLVER.REFERENCE_WORLD_SIZE``
        processes to ``num_workers``: batch, LR, iterations, warmup, steps,
        eval and checkpoint periods (unchanged when the reference size is 0
        or equal)."""
        old_world_size = cfg.SOLVER.REFERENCE_WORLD_SIZE
        if old_world_size == 0 or old_world_size == num_workers:
            return cfg
        cfg = cfg.clone()
        frozen = cfg.is_frozen()
        cfg.defrost()
        assert cfg.SOLVER.IMS_PER_BATCH % old_world_size == 0, "Invalid REFERENCE_WORLD_SIZE in config!"
        scale = num_workers / old_world_size
        bs = cfg.SOLVER.IMS_PER_BATCH = int(round(cfg.SOLVER.IMS_PER_BATCH * scale))
        lr = cfg.SOLVER.BASE_LR = cfg.SOLVER.BASE_LR * scale
        max_iter = cfg.SOLVER.MAX_ITER = int(round(cfg.SOLVER.MAX_ITER / scale))
        warmup_iter = cfg.SOLVER.WARMUP_ITERS = int(round(cfg.SOLVER.WARMUP_ITERS / scale))
        cfg.SOLVER.STEPS = tuple(int(round(s / scale)) for s in cfg.SOLVER.STEPS)
        cfg.TEST.EVAL_PERIOD = int(round(cfg.TEST.EVAL_PERIOD / scale))
        cfg.SOLVER.CHECKPOINT_PERIOD = int(round(cfg.SOLVER.CHECKPOINT_PERIOD / scale))
        cfg.SOLVER.REFERENCE_WORLD_SIZE = num_workers
        logging.getLogger(__name__).info(
            f"Auto-scaling the config to batch_size={bs}, learning_rate={lr}, max_iter={max_iter}, warmup={warmup_iter}."
        )
        if frozen:
            cfg.freeze()
        return cfg
