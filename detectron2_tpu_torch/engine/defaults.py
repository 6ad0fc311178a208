"""DefaultPredictor (counterpart of ``detectron2_tpu/engine/defaults.py:147``):
single-image inference with the test-time resize and BGR handling."""

from typing import Dict, Optional, Union

import numpy as np
import torch

from detectron2_tpu_torch.checkpoint import load_d2_checkpoint
from detectron2_tpu_torch.data import PaddedBatchCollator, ResizeShortestEdge
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.modeling.backbone import padding_constraints
from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess

__all__ = ["DefaultPredictor"]


class DefaultPredictor:
    """Maps one HWC uint8 image to ``{"instances": Instances}`` at the
    image's original resolution.

    Given ``cfg``, builds its model on ``device`` (default
    ``cfg.MODEL.DEVICE``, ``"cuda"``), loads ``cfg.MODEL.WEIGHTS`` when set
    (``load_report`` says what the loader matched) and resizes as
    ``cfg.INPUT`` says. Given ``model`` instead, a model built in code
    (``model_zoo.mask_rcnn_vitdet_b()``), runs it on its device in eval mode
    with the test-time resize ``ResizeShortestEdge(min_size_test,
    max_size_test)``. The batch is padded as the model's backbone asks
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
        self.aug = ResizeShortestEdge(min_size_test, max_size_test)
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
        batch = self.collator([self.aug(image)])
        outputs = self.model(batch)
        in_h, in_w = (int(v) for v in batch["image_sizes"][0].tolist())
        one = {k: v[0] for k, v in outputs.items()}
        with torch.inference_mode():
            instances = detector_postprocess(one, height, width, in_h, in_w)
        return {"instances": instances}
