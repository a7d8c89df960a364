from prifit_torch.nn import norm, pointnet2

__all__ = ["norm", "pointnet2"]
