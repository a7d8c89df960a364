from prifit_torch.models import common, pointnet2_part_seg_msg

__all__ = ["common", "pointnet2_part_seg_msg"]
