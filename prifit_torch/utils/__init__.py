from prifit_torch.utils.device import resolve_device
from prifit_torch.utils.guard import guard_exp, guard_sqrt, guard_acos
from prifit_torch.utils.meters import (
    AverageValueMeter,
    adjust_learning_rate,
    get_colors,
)
from prifit_torch.utils.profiling import StepTimer, debug_nans, sync, trace

__all__ = [
    "guard_exp", "guard_sqrt", "guard_acos",
    "AverageValueMeter", "adjust_learning_rate", "get_colors",
    "StepTimer", "debug_nans", "sync", "trace",
    "resolve_device",
]
