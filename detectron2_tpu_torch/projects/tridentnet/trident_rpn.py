"""The trident RPN (counterpart of the JAX package's
``projects/tridentnet/trident_rpn.py``).

The branches are same-stride feature levels (``res4_b0`` ...), so training
runs the standard multi-level RPN over them: each level's top
``PRE_NMS_TOPK_TRAIN`` go into one NMS. In the fast approximation
(``TEST_BRANCH_IDX != -1``) inference runs over ``res4`` alone, the test
branch, as d2's does."""

from typing import Tuple

from detectron2_tpu_torch.modeling.proposal_generator.rpn import RPN

__all__ = ["TridentRPN"]


class TridentRPN(RPN):
    def __init__(self, *, trident_fast: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.trident_fast = trident_fast

    def _select_in_features(self, train: bool) -> Tuple[str, ...]:
        if not train and self.trident_fast:
            return ("res4",)
        return self.in_features
