"""The PRIFIT convex-approximation loss (default flags).

Port of ``prifit_tpu/geometry/convex_loss.py::convex_loss``: normalize the
embeddings, mean-shift clustering into fixed slots, weighted ellipsoid
fitting, primitive surface sampling, and the SDF/nearest-neighbour
analytic chamfer against the full-resolution cloud.  The entropy,
intersection, pruning and cuboid options are not ported yet; their terms
are 0 here, as with their flags off in the JAX package.
"""

from typing import NamedTuple

import torch
from torch.profiler import record_function

from prifit_torch.clustering.mean_shift import ClusterResult, cluster_batch
from prifit_torch.geometry.fitting import PrimitiveParams, \
    fit_ellipsoids_batch
from prifit_torch.geometry.losses import analytic_chamfer
from prifit_torch.geometry.sampling import sample_primitives_batch


class ConvexLossOutput(NamedTuple):
    total: torch.Tensor          # [] total loss
    chamfer: torch.Tensor        # [] analytic chamfer component
    entropy: torch.Tensor        # [] entropy component (pre-beta)
    intersection: torch.Tensor   # [] intersection component (pre-alpha)
    params: PrimitiveParams      # [B, K, ...] fitted primitives
    clusters: ClusterResult      # [B, ...] clustering byproducts
    samples: torch.Tensor        # [B, S, 3] primitive surface samples
    sample_w: torch.Tensor       # [B, S] sample weights


def convex_loss(points: torch.Tensor, chamfer_points: torch.Tensor,
                X: torch.Tensor, *, quantile: float = 0.01,
                iterations: int = 5, max_num_clusters: int = 25,
                n_per_prim: int = 400, num_bandwidth_candidates: int = 2,
                alpha: float = 1.0, beta=1.0,
                evaluation: bool = False) -> ConvexLossOutput:
    """``points [B, N, 3]`` (fit targets), ``chamfer_points [B, M, 3]``
    (chamfer targets), ``X [B, N, D]`` per-point embeddings."""
    X = X / torch.clamp_min(torch.linalg.norm(X, dim=2, keepdim=True),
                            1e-12)
    zero = torch.zeros((), dtype=torch.float32, device=X.device)
    # each stage is a profiler range (read by prifit_torch.profile_forward)
    with record_function("cluster_batch"):
        clusters = cluster_batch(
            X, quantile=quantile, iterations=iterations,
            max_num_clusters=max_num_clusters,
            num_candidates=num_bandwidth_candidates)
    with record_function("fit_ellipsoids_batch"):
        params = fit_ellipsoids_batch(points, clusters.weights,
                                      clusters.valid)
    with record_function("sample_primitives_batch"):
        samples, sample_w = sample_primitives_batch(params, n_per_prim)
    with record_function("analytic_chamfer"):
        cham = zero if evaluation else analytic_chamfer(
            params, samples, sample_w, chamfer_points)
    ent = inter = zero
    total = cham + alpha * inter + beta * ent
    return ConvexLossOutput(total=total, chamfer=cham, entropy=ent,
                            intersection=inter, params=params,
                            clusters=clusters, samples=samples,
                            sample_w=sample_w)
