from prifit_torch.utils.device import resolve_device
from prifit_torch.utils.guard import guard_exp, guard_sqrt

__all__ = ["guard_exp", "guard_sqrt", "resolve_device"]
