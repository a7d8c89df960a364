from prifit_torch.models import common, pointnet2_part_seg_msg
from prifit_torch.models.common import (
    SegOutput,
    nll_loss,
    pairwise_contrastive_loss,
)

__all__ = ["common", "pointnet2_part_seg_msg", "SegOutput", "nll_loss",
           "pairwise_contrastive_loss"]
