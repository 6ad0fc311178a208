#!/usr/bin/env python
"""Train and evaluate a model from a LazyConfig ``.py`` config on registered
COCO-format datasets, on the card (counterpart of
``tools/lazyconfig_train_net.py``):

    python -m detectron2_tpu_torch.tools.lazyconfig_train_net \\
        --config-file configs/ViTDet/mask_rcnn_vitdet_b_100ep.py \\
        --dataset my_train /path/to/train.json /path/to/train_images \\
        --dataset my_val /path/to/val.json /path/to/val_images [--resume] \\
        dataloader.train.dataset.names=my_train dataloader.test.dataset.names=my_val \\
        dataloader.evaluator.dataset_name=my_val train.output_dir=out

    ... --eval-only train.init_checkpoint=out/model_final.pth

``--dataset NAME JSON_FILE IMAGE_ROOT`` (repeatable) registers a COCO
instances json before the run; overrides are ``a.b.c=value``. A config that
has only ``model`` and ``train`` (``configs/COCO-Detection/fcos_R_50_FPN_1x.py``)
takes the top-level keys it lacks (``dataloader``, ``optimizer``,
``lr_multiplier``) from ``--recipe-from FILE``, as d2's FCOS config takes
them from ``common/``:

    python -m detectron2_tpu_torch.tools.lazyconfig_train_net \
        --config-file configs/COCO-Detection/fcos_R_50_FPN_1x.py \
        --recipe-from configs/COCO-Detection/retinanet_R_50_FPN_1x.py ... The model is
``instantiate(cfg.model)`` with seeded weights (``train.seed``, 0 when absent
or negative), then ``train.init_checkpoint`` (a d2 ``.pkl`` or a port
``.pth``) when set, or with ``--resume`` the last checkpoint in
``train.output_dir``. It runs on ``train.device``: ``cuda`` by default, and
for ``"tpu"``, the value ``configs/common/train.py`` carries for the JAX
package; ``train.device=cpu`` only when asked. ``train.amp`` is not read:
the compute dtype is the model's ``compute_dtype`` (bfloat16 unless the
config says otherwise).

Training is ``SimpleTrainer`` with the hooks IterationTimer, LRScheduler
(``cfg.lr_multiplier`` stepped on the optimizer, as d2 does; the JAX
package's lazy path only logs it), PeriodicCheckpointer, EvalHook and
PeriodicWriter. The optimizer is ``instantiate(cfg.optimizer)`` with the
model as ``params``: for the ViTDet configs their ``make_optimizer``
resolves to the port's layer-wise AdamW. The train batches carry the gt
masks (or keypoints) the model's heads need, cropped at twice the mask
pooler's resolution (the JAX lazy path's default collator carries none),
and for RetinaNet, FCOS or an RPN-only model boxes and classes only.
"""

import logging
import weakref
from typing import List, Optional

import numpy as np
import torch

from detectron2_tpu_torch.checkpoint import DetectionCheckpointer
from detectron2_tpu_torch.config import LazyConfig, instantiate
from detectron2_tpu_torch.data import PaddedBatchCollator
from detectron2_tpu_torch.data.datasets import register_coco_instances
from detectron2_tpu_torch.engine import (
    SimpleTrainer,
    default_argument_parser,
    default_setup,
    default_writers,
    eval_predictor,
    hooks,
)
from detectron2_tpu_torch.evaluation import inference_on_dataset, print_csv_format
from detectron2_tpu_torch.modeling import init_weights

logger = logging.getLogger("detectron2_tpu_torch.tools.lazyconfig_train_net")

# the JAX package's configs name its own device; the port runs those on the card
_DEVICES = {"tpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def device_of(cfg) -> torch.device:
    """``train.device`` mapped to the port's device: ``cuda`` unless the
    config asks for ``cpu``."""
    name = str(cfg.train.get("device", "cuda")).split(":")[0]
    if name not in _DEVICES:
        raise ValueError(f"train.device={name!r}: the port runs on cuda or, when asked, cpu")
    return torch.device(_DEVICES[name])


def seed_of(cfg) -> int:
    return max(int(cfg.train.get("seed", 0)), 0)


def build_model(cfg) -> torch.nn.Module:
    """``instantiate(cfg.model)`` on the config's device with seeded weights."""
    model = instantiate(cfg.model).to(device_of(cfg))
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed_of(cfg))
    init_weights(model, gen)
    return model


def train_collator(model) -> PaddedBatchCollator:
    """Batches with the targets ``model``'s heads read, as the model states
    them (``train_target_sizes``: gt masks at twice the mask pooler's
    resolution, keypoints; none for a dense detector or an RPN-only model)."""
    return PaddedBatchCollator(**model.train_target_sizes())


def do_test(cfg, model):
    """``cfg.dataloader.evaluator`` over ``cfg.dataloader.test``, each batch
    through :func:`eval_predictor` (the panoptic fusion for a PanopticFPN);
    the results."""
    if "evaluator" not in cfg.dataloader:
        return None
    model.eval()
    ret = inference_on_dataset(eval_predictor(model), instantiate(cfg.dataloader.test), instantiate(cfg.dataloader.evaluator))
    print_csv_format(ret)
    return ret


def build_trainer(args, cfg, extra_hooks: Optional[List[hooks.HookBase]] = None):
    """The model, optimizer, train loader, checkpointer and hooks of a run;
    returns ``(trainer, start_iter)`` with the weights loaded or resumed."""
    model = build_model(cfg)
    logger.info(f"Model:\n{model}")
    cfg.optimizer.params = model
    optimizer = instantiate(cfg.optimizer)
    # a config file's functions hold its namespace, so a loaded config is a
    # reference cycle: it must not keep the model alive after the trainer
    cfg.optimizer.params = None
    seed = seed_of(cfg)
    loader_cfg = cfg.dataloader.train
    if "collator" not in loader_cfg:
        loader_cfg.collator = train_collator(model)
    # the sampler's seed and every augmentation draw, as the yaml path's loader
    loader_cfg.rng = np.random.RandomState(seed)
    train_loader = instantiate(loader_cfg)
    sampling_gen = torch.Generator(device=model.device)
    sampling_gen.manual_seed(seed + 7)
    trainer = SimpleTrainer(model, train_loader, optimizer, generator=sampling_gen)
    # the trainer weakly: its checkpoint hook holds the checkpointer, and a
    # cycle would keep the model alive after the trainer is dropped
    checkpointer = DetectionCheckpointer(model, cfg.train.output_dir, trainer=weakref.proxy(trainer))
    scheduler = instantiate(cfg.lr_multiplier).bind(optimizer) if "lr_multiplier" in cfg else None
    trainer.register_hooks(
        [
            hooks.IterationTimer(),
            hooks.LRScheduler(optimizer, scheduler) if scheduler is not None else None,
            hooks.PeriodicCheckpointer(checkpointer, cfg.train.checkpointer.period, max_iter=cfg.train.max_iter),
            hooks.EvalHook(cfg.train.eval_period, lambda: do_test(cfg, model)),
            hooks.PeriodicWriter(default_writers(cfg.train.output_dir, cfg.train.max_iter), period=cfg.train.log_period),
        ]
        + list(extra_hooks or [])
    )
    extra = checkpointer.resume_or_load(cfg.train.init_checkpoint, resume=args.resume)
    start_iter = extra.get("iteration", -1) + 1 if args.resume and checkpointer.has_checkpoint() else 0
    return trainer, start_iter


def do_train(args, cfg, extra_hooks: Optional[List[hooks.HookBase]] = None) -> SimpleTrainer:
    trainer, start_iter = build_trainer(args, cfg, extra_hooks)
    trainer.train(start_iter, cfg.train.max_iter)
    return trainer


def register_datasets(args) -> None:
    for name, json_file, image_root in getattr(args, "dataset", None) or []:
        register_coco_instances(name, {}, json_file, image_root)


def load_config(args):
    """``--config-file``, with the top-level keys it lacks taken from
    ``--recipe-from`` when given."""
    cfg = LazyConfig.load(args.config_file)
    recipe = getattr(args, "recipe_from", None)
    if recipe:
        base = LazyConfig.load(recipe)
        for key in base.keys():
            if key not in cfg:
                cfg[key] = base[key]
    return cfg


def main(args, extra_hooks: Optional[List[hooks.HookBase]] = None):
    """Eval-only: the results; training: the trainer after its run."""
    cfg = load_config(args)
    cfg = LazyConfig.apply_overrides(cfg, args.opts)
    default_setup(cfg, args)
    register_datasets(args)
    if args.eval_only:
        model = build_model(cfg)
        checkpointer = DetectionCheckpointer(model, cfg.train.output_dir)
        if cfg.train.init_checkpoint or (args.resume and checkpointer.has_checkpoint()):
            checkpointer.resume_or_load(cfg.train.init_checkpoint, resume=args.resume)
        else:
            logger.info(f"No train.init_checkpoint: seeded random weights (seed {seed_of(cfg)})")
        return do_test(cfg, model)
    return do_train(args, cfg, extra_hooks)


def argument_parser():
    parser = default_argument_parser(
        "Examples:\n  python -m detectron2_tpu_torch.tools.lazyconfig_train_net "
        "--config-file configs/ViTDet/mask_rcnn_vitdet_b_100ep.py --dataset NAME JSON IMAGE_ROOT "
        "dataloader.train.dataset.names=NAME"
    )
    parser.add_argument(
        "--recipe-from",
        metavar="FILE",
        help="a config file whose top-level keys (dataloader, optimizer, lr_multiplier) fill those the config lacks",
    )
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
