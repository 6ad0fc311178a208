"""Rescale one image's padded detections to its original size (counterpart of
``detectron2_tpu/modeling/postprocessing.py:63``).

Runs on the detections' device. Padding slots are dropped, boxes are scaled
and clipped, boxes empty after clipping are dropped, and the 28x28 roi masks
are pasted at the original resolution with the exact float32 paste (a
TensorMask's in its anchor boxes, ``mask_boxes``: d2's frame; the JAX
function pastes them in the detections' boxes, ROADMAP C). Keypoints are scaled to the original frame and keep (x, y, prob). DensePose
charts (``pred_densepose`` ``[D, M, M, 3]``, box-relative) and CSE outputs
(``pred_densepose_embedding`` ``[D, M, M, E]``, ``pred_densepose_fg`` ``[D,
M, M]``) are carried as they are, as the JAX function carries them
(``postprocessing.py:132-134``).
:func:`sem_seg_postprocess` rescales one image's semantic logits.
"""

from typing import Dict, Sequence

import torch

from detectron2_tpu_torch.ops.paste_masks import paste_masks_in_image
from detectron2_tpu_torch.structures import BitMasks, Boxes, Instances

__all__ = ["detector_postprocess", "sem_seg_postprocess"]


def detector_postprocess(
    results: Dict[str, torch.Tensor],
    output_height: int,
    output_width: int,
    input_height: int,
    input_width: int,
    mask_threshold: float = 0.5,
) -> Instances:
    """
    Args:
        results: ONE image's slice of the padded detections dict: pred_boxes
            ``[D, 4]`` in the network input frame of size (input_height,
            input_width), scores, pred_classes, valid ``[D]``, optional
            pred_masks ``[D, M, M]``, pred_keypoints ``[D, K, 4]`` (x, y,
            logit, prob). With ``mask_boxes`` ``[D, 4]`` (TensorMask's
            anchor boxes, network frame) the masks are pasted in those,
            scaled to the output size and not clipped, instead of in the
            detections' boxes.
        output_height, output_width: the original image size.

    Returns:
        Instances with pred_boxes (:class:`Boxes`, ``[N, 4]`` float32),
        scores, pred_classes (int64) and, with masks, pred_masks
        (:class:`BitMasks`, ``[N, output_height, output_width]`` bool), with
        keypoints pred_keypoints (``[N, K, 3]`` float32 x, y, prob), with
        DensePose pred_densepose (``[N, M, M, 3]`` part, U, V), with CSE
        pred_densepose_embedding and pred_densepose_fg.
    """
    valid = results["valid"].bool()
    boxes = results["pred_boxes"].double()[valid]
    scores = results["scores"].float()[valid]
    classes = results["pred_classes"].long()[valid]

    scale_x = output_width / input_width
    scale_y = output_height / input_height
    scale_xyxy = torch.tensor([scale_x, scale_y, scale_x, scale_y], dtype=boxes.dtype, device=boxes.device)
    boxes = boxes * scale_xyxy
    boxes[:, 0::2] = boxes[:, 0::2].clamp(0, output_width)
    boxes[:, 1::2] = boxes[:, 1::2].clamp(0, output_height)
    nonempty = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    boxes = boxes[nonempty].float()

    out = Instances(
        (output_height, output_width),
        pred_boxes=Boxes(boxes),
        scores=scores[nonempty],
        pred_classes=classes[nonempty],
    )
    if "pred_masks" in results:
        roi_masks = results["pred_masks"][valid][nonempty]
        paste_boxes = boxes
        if "mask_boxes" in results:
            # TensorMask's masks are in their anchors' frame: pasted in the
            # scaled anchor boxes, unclipped, as d2 pastes them
            paste_boxes = (results["mask_boxes"].double()[valid][nonempty] * scale_xyxy).float()
        out.pred_masks = BitMasks(
            paste_masks_in_image(roi_masks, paste_boxes, (output_height, output_width), threshold=mask_threshold)
        )
    if "pred_keypoints" in results:
        kpts = results["pred_keypoints"].float()[valid][nonempty]
        scale = torch.tensor([scale_x, scale_y], dtype=kpts.dtype, device=kpts.device)
        # (x, y, logit, prob) -> (x, y, prob), d2's keypoint_results[:, :, [0, 1, 3]]
        out.pred_keypoints = torch.cat([kpts[..., :2] * scale, kpts[..., 3:]], dim=-1)
    # DensePose charts and CSE embeddings are box-relative: they ride along
    # unscaled
    if "pred_densepose" in results:
        out.pred_densepose = results["pred_densepose"].float()[valid][nonempty]
    if "pred_densepose_embedding" in results:
        out.pred_densepose_embedding = results["pred_densepose_embedding"].float()[valid][nonempty]
        out.pred_densepose_fg = results["pred_densepose_fg"].bool()[valid][nonempty]
    return out


def _linear_taps(in_size: int, out_size: int, device):
    """One axis of OpenCV's ``INTER_LINEAR``: the source coordinate
    ``(d + 0.5) * in / out - 0.5`` in float64 rounded to float32, its floor
    and fraction, clamped to the edge pixels with weight (1, 0)."""
    f = ((torch.arange(out_size, dtype=torch.float64, device=device) + 0.5) * (1.0 / (out_size / in_size)) - 0.5).float()
    lo = torch.floor(f)
    frac = f - lo
    lo = lo.long()
    edge = (lo < 0) | (lo >= in_size - 1)
    frac = torch.where(edge, torch.zeros_like(frac), frac)
    lo = lo.clamp(0, in_size - 1)
    return lo, (lo + 1).clamp_max(in_size - 1), 1 - frac, frac


def sem_seg_postprocess(result: torch.Tensor, img_size: Sequence[int], output_height: int, output_width: int) -> torch.Tensor:
    """One image's logits ``[H, W, C]`` in the padded network frame ->
    ``[output_height, output_width, C]`` float32 on their device: cropped to
    ``img_size`` (h, w), then resized bilinearly with half-pixel centres and
    no antialiasing, as the JAX function's ``cv2.resize(..., INTER_LINEAR)``
    (``detectron2_tpu/modeling/postprocessing.py:146``) computes it for more
    than four channels: float32 taps and weights per axis, the rows first,
    then the columns."""
    h, w = int(img_size[0]), int(img_size[1])
    x = result[:h, :w].float()
    x0, x1, a0, a1 = _linear_taps(w, int(output_width), x.device)
    y0, y1, b0, b1 = _linear_taps(h, int(output_height), x.device)
    rows = x[:, x0] * a0[None, :, None] + x[:, x1] * a1[None, :, None]
    return rows[y0] * b0[:, None, None] + rows[y1] * b1[:, None, None]
