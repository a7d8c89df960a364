from prifit_torch.clustering import mean_shift
from prifit_torch.clustering.mean_shift import (
    ClusterResult,
    compute_bandwidth,
    mean_shift_iterations,
    mean_shift_eff_iterations,
    nms_fixed_slots,
    membership,
    cluster_single,
    cluster_batch,
)

__all__ = [
    "mean_shift",
    "ClusterResult",
    "compute_bandwidth",
    "mean_shift_iterations",
    "mean_shift_eff_iterations",
    "nms_fixed_slots",
    "membership",
    "cluster_single",
    "cluster_batch",
]
