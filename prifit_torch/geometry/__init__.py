from prifit_torch.geometry import (
    convex_loss,
    fitting,
    losses,
    sampling,
    sdf,
)

__all__ = ["convex_loss", "fitting", "losses", "sampling", "sdf"]
