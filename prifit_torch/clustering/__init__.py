from prifit_torch.clustering import mean_shift

__all__ = ["mean_shift"]
