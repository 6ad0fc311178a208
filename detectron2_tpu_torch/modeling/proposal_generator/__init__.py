from detectron2_tpu_torch.modeling.proposal_generator.proposal_utils import (
    find_top_rpn_proposals_padded,
)
from detectron2_tpu_torch.modeling.proposal_generator.rpn import (
    RPN,
    StandardRPNHead,
    build_proposal_generator,
    build_rpn,
)

__all__ = ["find_top_rpn_proposals_padded", "RPN", "StandardRPNHead", "build_rpn", "build_proposal_generator"]
