"""Matcher: assign each prediction to a ground truth by IoU thresholds
(counterpart of ``detectron2_tpu/modeling/matcher.py``).

Fixed-shape: ground truth comes padded with a validity mask, and padded rows
get quality -inf so they never win a match. Batched over leading dims.
"""

from typing import List, Optional, Tuple

import torch

__all__ = ["Matcher"]


class Matcher:
    """Each prediction matches zero or one gt; each gt may match many.

    ``thresholds=[0.3, 0.7], labels=[0, -1, 1]`` labels quality below 0.3
    negative, from 0.7 positive and between ignored."""

    def __init__(self, thresholds: List[float], labels: List[int], allow_low_quality_matches: bool = False):
        thresholds = list(thresholds)
        assert thresholds[0] > 0
        thresholds.insert(0, -float("inf"))
        thresholds.append(float("inf"))
        assert all(low <= high for low, high in zip(thresholds[:-1], thresholds[1:]))
        assert all(label in (-1, 0, 1) for label in labels)
        assert len(labels) == len(thresholds) - 1
        self.thresholds = thresholds
        self.labels = list(labels)
        self.allow_low_quality_matches = allow_low_quality_matches

    def __call__(
        self, match_quality_matrix: torch.Tensor, gt_valid: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """
        Args:
            match_quality_matrix: ``[..., M, N]`` quality of (gt, prediction).
            gt_valid: ``[..., M]`` bool; False rows are padding.

        Returns:
            matches ``[..., N]`` int64, the best gt per prediction (0 when no
            gt is valid); match_labels ``[..., N]`` int8 in {-1, 0, 1}. With
            no valid gt every prediction gets ``labels[0]``.
        """
        quality = match_quality_matrix
        if gt_valid is not None:
            quality = torch.where(gt_valid[..., :, None], quality, torch.full_like(quality, float("-inf")))
        matched_vals, matches = quality.max(dim=-2)
        match_labels = torch.full_like(matches, self.labels[0], dtype=torch.int8)
        for label, low, high in zip(self.labels, self.thresholds[:-1], self.thresholds[1:]):
            in_band = (matched_vals >= low) & (matched_vals < high)
            match_labels = torch.where(in_band, torch.full_like(match_labels, label), match_labels)
        if self.allow_low_quality_matches:
            match_labels = self.set_low_quality_matches(match_labels, quality, gt_valid)
        return matches, match_labels

    @staticmethod
    def set_low_quality_matches(
        match_labels: torch.Tensor, quality: torch.Tensor, gt_valid: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Each valid gt with some overlap makes the prediction(s) of its
        highest quality positive, ties included."""
        highest = quality.max(dim=-1).values  # [..., M]
        is_best = quality == highest[..., None]
        has_overlap = highest > 0
        if gt_valid is not None:
            has_overlap = has_overlap & gt_valid
        forced = (is_best & has_overlap[..., None]).any(dim=-2)
        return torch.where(forced, torch.ones_like(match_labels), match_labels)
