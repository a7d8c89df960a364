from prifit_torch.geometry import fitting, losses, sampling, sdf
from prifit_torch.geometry.sdf import (
    sdf_ellipsoid,
    sdf_cuboid,
    sdf_primitives,
)
from prifit_torch.geometry.fitting import (
    PrimitiveParams,
    eigh3_guarded,
    fit_ellipsoids_batch,
)
from prifit_torch.geometry.sampling import (
    box_surface_lattice,
    sample_ellipsoid_surface,
    sample_cuboid_surface,
    sample_primitives_batch,
)
from prifit_torch.geometry.losses import (
    entropy_loss,
    analytic_chamfer,
    intersection_loss,
    intersection_loss_surface,
    intersection_loss_volume,
    intersection_loss_v2,
    intersection_loss_v4,
    sample_axis,
    prune_mask,
)
from prifit_torch.geometry.convex_loss import ConvexLossOutput, convex_loss

__all__ = [
    "fitting",
    "losses",
    "sampling",
    "sdf",
    "sdf_ellipsoid",
    "sdf_cuboid",
    "sdf_primitives",
    "PrimitiveParams",
    "eigh3_guarded",
    "fit_ellipsoids_batch",
    "box_surface_lattice",
    "sample_ellipsoid_surface",
    "sample_cuboid_surface",
    "sample_primitives_batch",
    "entropy_loss",
    "analytic_chamfer",
    "intersection_loss",
    "intersection_loss_surface",
    "intersection_loss_volume",
    "intersection_loss_v2",
    "intersection_loss_v4",
    "sample_axis",
    "prune_mask",
    "ConvexLossOutput",
    "convex_loss",
]
