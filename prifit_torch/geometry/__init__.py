from prifit_torch.geometry import fitting, losses, sampling, sdf, \
    synthetic, transforms
from prifit_torch.geometry.sdf import (
    sdf_ellipsoid,
    sdf_cuboid,
    sdf_primitives,
)
from prifit_torch.geometry.fitting import (
    PrimitiveParams,
    eigh3_guarded,
    fit_ellipsoid_weighted,
    fit_ellipsoids,
    fit_ellipsoids_batch,
)
from prifit_torch.geometry.sampling import (
    box_surface_lattice,
    sample_ellipsoid_surface,
    sample_cuboid_surface,
    sample_primitives,
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
from prifit_torch.geometry.synthetic import SyntheticScene, \
    create_synthetic_dataset
from prifit_torch.geometry.convex_loss import ConvexLossOutput, convex_loss
from prifit_torch.geometry.transforms import (
    pca,
    rotation_matrix_a_to_b,
    standardize_point,
    standardize_points,
    reverse_all_transformation,
    reverse_all_transformations,
    project_to_plane,
    project_to_point_cloud,
)

__all__ = [
    "fitting",
    "losses",
    "sampling",
    "sdf",
    "synthetic",
    "transforms",
    "sdf_ellipsoid",
    "sdf_cuboid",
    "sdf_primitives",
    "PrimitiveParams",
    "eigh3_guarded",
    "fit_ellipsoid_weighted",
    "fit_ellipsoids",
    "fit_ellipsoids_batch",
    "box_surface_lattice",
    "sample_ellipsoid_surface",
    "sample_cuboid_surface",
    "sample_primitives",
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
    "SyntheticScene",
    "create_synthetic_dataset",
    "ConvexLossOutput",
    "convex_loss",
    "pca",
    "rotation_matrix_a_to_b",
    "standardize_point",
    "standardize_points",
    "reverse_all_transformation",
    "reverse_all_transformations",
    "project_to_plane",
    "project_to_point_cloud",
]
