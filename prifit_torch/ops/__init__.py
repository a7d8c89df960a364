from prifit_torch.ops import chamfer, pairwise, sampling

__all__ = ["chamfer", "pairwise", "sampling"]
