#!/usr/bin/env python
"""Train a DensePose model on the card (counterpart of
``tools/densepose/train_net.py``): ``get_cfg()``, ``add_densepose_config``,
the yaml, the overrides, then the DensePose :class:`Trainer`:

    DETECTRON2_DATASETS=/path python -m detectron2_tpu_torch.tools.densepose_train_net \\
        --config-file configs/DensePose/densepose_rcnn_R_50_FPN_s1x.yaml \\
        MODEL.WEIGHTS /path/to/R-50.pkl OUTPUT_DIR out [--resume]

The datasets are the builtin DensePose names (``densepose_coco_2014_*``,
their ``_cse`` splits, ``densepose_lvis_v1_*``) under
``$DETECTRON2_DATASETS``. Training starts from seeded weights, then
``MODEL.WEIGHTS`` when set (a local d2 ``.pkl`` or a port ``.pth``; the
yamls name a download), or with ``--resume`` the last checkpoint in
``OUTPUT_DIR``. ``--eval-only`` runs the test loop with COCOEvaluator and,
for a chart model, the DensePose evaluator (GPS, GPSM, segm), which reads
the SMPL files under ``$DETECTRON2_DATASETS/densepose_eval_data``.
``MODEL.DEVICE cpu`` runs off the card.
"""

import logging

from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.engine import default_argument_parser, default_setup
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.projects.densepose import Trainer, add_densepose_config
from detectron2_tpu_torch.tools.train_net import load_or_init

logger = logging.getLogger("detectron2_tpu_torch.tools.densepose_train_net")


def setup(args):
    cfg = get_cfg()
    add_densepose_config(cfg)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    default_setup(cfg, args)
    return cfg


def main(args):
    cfg = setup(args)
    if args.eval_only:
        model = build_model(cfg)
        logger.info(load_or_init(cfg, model, resume=args.resume))
        return Trainer.test(cfg, model)
    trainer = Trainer(cfg)
    trainer.resume_or_load(resume=args.resume)
    return trainer.train()


def invoke_main() -> None:
    main(default_argument_parser().parse_args())


if __name__ == "__main__":
    invoke_main()
