from prifit_torch.ops import chamfer, pairwise, sampling
from prifit_torch.ops.pairwise import (
    square_distance,
    knn,
    knn_with_dilation,
    knn_points_normals,
)
from prifit_torch.ops.sampling import (
    index_points,
    farthest_point_sample,
    query_ball_point,
    sample_and_group,
    sample_and_group_all,
    three_nn_interpolate,
)
from prifit_torch.ops.chamfer import (
    chamfer_distance,
    chamfer_distance_one_side,
    chamfer_distance_single_shape,
    chamfer_distance_pairwise_batch,
    nn_squared_distance,
)
from prifit_torch.ops.lstsq import best_lambda, lstsq

__all__ = [
    "chamfer",
    "pairwise",
    "sampling",
    "square_distance",
    "knn",
    "knn_with_dilation",
    "knn_points_normals",
    "index_points",
    "farthest_point_sample",
    "query_ball_point",
    "sample_and_group",
    "sample_and_group_all",
    "three_nn_interpolate",
    "chamfer_distance",
    "chamfer_distance_one_side",
    "chamfer_distance_single_shape",
    "chamfer_distance_pairwise_batch",
    "nn_squared_distance",
    "best_lambda",
    "lstsq",
]
