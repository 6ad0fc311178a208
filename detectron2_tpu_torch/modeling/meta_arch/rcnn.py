"""GeneralizedRCNN (counterpart of ``detectron2_tpu/modeling/meta_arch/rcnn.py``).

The forward takes the JAX package's fixed-shape batch dict

    {"image": [B, H, W, C] uint8 or float, NHWC, padded,
     "image_sizes": [B, 2] int (true h, w),
     for training: gt_boxes [B, G, 4], gt_classes [B, G], gt_valid [B, G],
     gt_masks [B, G, Ms, Ms], gt_keypoints [B, G, K, 3]}

and normalises inside the model, casting to the compute dtype; the weights
stay float32 and are cast per call. Inference (under
``torch.inference_mode``) returns the padded detections dict: pred_boxes
``[B, D, 4]`` in the network input frame, scores, pred_classes, valid
``[B, D]``, box_idx, pred_masks ``[B, D, M, M]``, pred_keypoints ``[B, D,
K, 4]`` (x, y, logit, prob) and, with ``mask_paste_in_graph``,
pred_masks_full ``[B, D, H, W]`` bool. A batch that carries
``given_boxes`` ``[B, D, 4]`` (network frame), ``given_classes`` and
``given_valid`` ``[B, D]`` (and optionally ``given_scores``) skips the RPN
and the box branch: the mask and keypoint branches run on those boxes
(``roi_heads.forward_with_given_boxes``, test-time augmentation's second
pass) and the dict comes back with their outputs, unpasted. Training
returns the RPN's ``loss_rpn_cls``, ``loss_rpn_loc`` and the heads' losses:
``loss_cls``, ``loss_box_reg`` (per stage, ``_stage{k}``, in a cascade),
``loss_mask`` with masks, ``loss_keypoint`` with keypoints. Without a
proposal generator (``PrecomputedProposals``) the proposals come from the
batch, ``proposal_boxes`` ``[B, P, 4]``, ``proposal_logits`` and
``proposal_valid`` ``[B, P]``, and there is no RPN loss.
"""

import copy
from typing import Dict, Optional

import torch
from torch import nn

from detectron2_tpu_torch.ops.paste_masks import paste_masks_in_image

__all__ = ["GeneralizedRCNN", "ProposalNetwork"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class GeneralizedRCNN(nn.Module):
    def __init__(
        self,
        *,
        backbone: nn.Module,
        proposal_generator: Optional[nn.Module],
        roi_heads: nn.Module,
        pixel_mean,
        pixel_std,
        input_format: str = "BGR",
        compute_dtype: str = "bfloat16",
        mask_paste_in_graph: bool = False,
    ):
        super().__init__()
        self.backbone = backbone
        self.proposal_generator = proposal_generator
        self.roi_heads = roi_heads
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, dtype=torch.float32), False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, dtype=torch.float32), False)
        self.input_format = input_format  # the channel order pixel_mean is in
        self.compute_dtype = _DTYPES[compute_dtype]
        self.mask_paste_in_graph = mask_paste_in_graph

    @property
    def device(self) -> torch.device:
        return self.pixel_mean.device

    def clone(self, **children) -> "GeneralizedRCNN":
        """A new model with the given children (``backbone``,
        ``proposal_generator``, ``roi_heads``) replaced and every other
        setting kept, as flax's ``Module.clone`` (the RegNet configs build
        ``GeneralizedRCNN.from_config(cfg).clone(backbone=...)``); the
        children it keeps are copied, so the two models share no parameter.
        A new backbone must give the heads it keeps the shapes they were
        built for."""
        parts = {"backbone": self.backbone, "proposal_generator": self.proposal_generator, "roi_heads": self.roi_heads}
        unknown = set(children) - set(parts)
        if unknown:
            raise TypeError(f"GeneralizedRCNN.clone replaces {sorted(parts)}, not {sorted(unknown)}")
        if "backbone" in children and set(children) != set(parts):
            old, new = self.backbone.output_shape(), children["backbone"].output_shape()
            if old != new:
                raise ValueError(f"the new backbone's outputs {new} are not the {old} the kept heads were built for")
        parts = {k: children[k] if k in children else copy.deepcopy(v) for k, v in parts.items()}
        model = GeneralizedRCNN(
            **parts,
            pixel_mean=self.pixel_mean.tolist(),
            pixel_std=self.pixel_std.tolist(),
            input_format=self.input_format,
            compute_dtype={v: k for k, v in _DTYPES.items()}[self.compute_dtype],
            mask_paste_in_graph=self.mask_paste_in_graph,
        )
        return model.to(self.device).train(self.training)

    def train_target_sizes(self) -> Dict[str, int]:
        """What a training batch carries beyond boxes and classes for these
        heads: gt masks cropped at twice the mask pooler's resolution and
        the keypoint count (0: none)."""
        heads = self.roi_heads
        mask = getattr(heads, "mask_head", None) is not None
        kh = getattr(heads, "keypoint_head", None)
        return {
            "mask_size": 2 * heads.mask_pooler.output_size[0] if mask else 0,
            "num_keypoints": kh.score_lowres.out_channels if kh is not None else 0,
        }

    def preprocess_image(self, image: torch.Tensor) -> torch.Tensor:
        """(x - mean) / std in float32, then the compute dtype."""
        return ((image.float() - self.pixel_mean) / self.pixel_std).to(self.compute_dtype)

    def forward(
        self, batch: Dict, train: bool = False, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """One padded batch; host inputs are moved to the model's device.
        ``train=True`` returns the loss dict; the backbone runs in training
        mode (DropPath on) and it and the samplers draw from ``generator`` (a
        generator on the model's device), or from the device's default
        generator (``torch.manual_seed``) when it is None."""
        if not train:
            return self._inference(batch)
        image = torch.as_tensor(batch["image"], device=self.device)
        image_sizes = torch.as_tensor(batch["image_sizes"], device=self.device)
        targets = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items() if k.startswith("gt_")}
        # DropPath in a ViT backbone draws from the same generator
        features = self.backbone(self.preprocess_image(image), train=True, generator=generator)
        detector_losses, losses = self._losses(batch, features, image_sizes, targets, generator)
        return {**detector_losses, **losses}

    def _given_proposals(self, batch: Dict):
        """The batch's precomputed proposals: boxes, logits and valid."""
        return (
            torch.as_tensor(batch["proposal_boxes"], device=self.device).float(),
            torch.as_tensor(batch["proposal_logits"], device=self.device).float(),
            torch.as_tensor(batch["proposal_valid"], device=self.device),
        )

    def _losses(self, batch, features, image_sizes, targets, generator):
        """The heads' losses and the RPN's, on the backbone's features."""
        if self.proposal_generator is None:
            (prop_boxes, prop_logits, prop_valid), losses = self._given_proposals(batch), {}
        else:
            (prop_boxes, prop_logits, prop_valid), losses = self.proposal_generator.forward_train(
                features, image_sizes, targets["gt_boxes"], targets["gt_valid"], generator=generator
            )
        detector_losses = self.roi_heads.forward_train(
            features, prop_boxes, prop_logits, prop_valid, targets, generator=generator, image_sizes=image_sizes
        )
        return detector_losses, losses

    @torch.inference_mode()
    def _inference(self, batch: Dict) -> Dict[str, torch.Tensor]:
        image = torch.as_tensor(batch["image"], device=self.device)
        image_sizes = torch.as_tensor(batch["image_sizes"], device=self.device)
        images = self.preprocess_image(image)
        return self._detect(batch, images, image_sizes, self.backbone(images))

    def _detect(self, batch: Dict, images: torch.Tensor, image_sizes: torch.Tensor, features) -> Dict[str, torch.Tensor]:
        """The detections dict of the backbone's ``features`` (inference)."""
        if "given_boxes" in batch:
            classes = torch.as_tensor(batch["given_classes"], device=self.device)
            scores = batch.get("given_scores")
            detections = {
                "pred_boxes": torch.as_tensor(batch["given_boxes"], device=self.device).float(),
                "pred_classes": classes,
                "scores": torch.ones(classes.shape, device=self.device) if scores is None
                else torch.as_tensor(scores, device=self.device),
                "valid": torch.as_tensor(batch["given_valid"], device=self.device),
            }
            return self.roi_heads.forward_with_given_boxes(features, detections)
        if self.proposal_generator is None:
            prop_boxes, _, prop_valid = self._given_proposals(batch)
        else:
            prop_boxes, _, prop_valid = self.proposal_generator(features, image_sizes)
        detections = self.roi_heads(features, prop_boxes, prop_valid, image_sizes)
        if self.mask_paste_in_graph and "pred_masks" in detections:
            H, W = images.shape[1], images.shape[2]
            detections["pred_masks_full"] = torch.stack(
                [
                    paste_masks_in_image(m, b, (H, W), fast=True, chunk=20)
                    for m, b in zip(detections["pred_masks"], detections["pred_boxes"])
                ]
            )
        return detections


class ProposalNetwork(nn.Module):
    """The RPN-only model: a backbone and the RPN. Training returns the
    RPN's ``loss_rpn_cls`` and ``loss_rpn_loc`` (no proposals are decoded);
    inference returns ``{"proposal_boxes": [B, P, 4], "proposal_logits":
    [B, P], "valid": [B, P]}`` in the network input frame, which
    ``COCOEvaluator`` scores as box proposals (AR)."""

    def __init__(
        self,
        *,
        backbone: nn.Module,
        proposal_generator: nn.Module,
        pixel_mean,
        pixel_std,
        input_format: str = "BGR",
        compute_dtype: str = "bfloat16",
    ):
        super().__init__()
        self.backbone = backbone
        self.proposal_generator = proposal_generator
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, dtype=torch.float32), False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, dtype=torch.float32), False)
        self.input_format = input_format
        self.compute_dtype = _DTYPES[compute_dtype]

    device = GeneralizedRCNN.device
    preprocess_image = GeneralizedRCNN.preprocess_image

    def train_target_sizes(self) -> Dict[str, int]:
        """Boxes only: no masks, no keypoints."""
        return {"mask_size": 0, "num_keypoints": 0}

    def forward(
        self, batch: Dict, train: bool = False, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """One padded batch, as :meth:`GeneralizedRCNN.forward`; the anchor
        sampler draws from ``generator``."""
        if not train:
            return self._inference(batch)
        image = torch.as_tensor(batch["image"], device=self.device)
        image_sizes = torch.as_tensor(batch["image_sizes"], device=self.device)
        features = self.backbone(self.preprocess_image(image), train=True, generator=generator)
        _, losses = self.proposal_generator.forward_train(
            features,
            image_sizes,
            torch.as_tensor(batch["gt_boxes"], device=self.device),
            torch.as_tensor(batch["gt_valid"], device=self.device),
            generator=generator,
            proposals=False,
        )
        return losses

    @torch.inference_mode()
    def _inference(self, batch: Dict) -> Dict[str, torch.Tensor]:
        image = torch.as_tensor(batch["image"], device=self.device)
        image_sizes = torch.as_tensor(batch["image_sizes"], device=self.device)
        boxes, logits, valid = self.proposal_generator(self.backbone(self.preprocess_image(image)), image_sizes)
        return {"proposal_boxes": boxes, "proposal_logits": logits, "valid": valid}
