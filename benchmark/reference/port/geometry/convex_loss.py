# Frozen copy of prifit_torch/geometry/convex_loss.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""The PRIFIT convex-approximation loss, on the recipe's path (the copy
leaves out the program's entropy regularizer, intersection loss,
pruning and cuboids, which the recipe leaves off, and raises if one is
asked for).

Port of ``prifit_tpu/geometry/convex_loss.py::convex_loss``: normalize
the embeddings, mean-shift clustering into fixed slots, weighted
fitting, ellipsoid surface sampling, and the SDF/nearest-neighbour
analytic chamfer against the full-resolution cloud.
"""

from typing import NamedTuple

import torch
from torch.profiler import record_function

from benchmark.reference.port.clustering.mean_shift import ClusterResult, cluster_batch
from benchmark.reference.port.geometry.fitting import PrimitiveParams, \
    fit_ellipsoids_batch
from benchmark.reference.port.geometry.losses import analytic_chamfer
from benchmark.reference.port.geometry.sampling import sample_primitives_batch


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
                include_intersect_loss: bool = False,
                include_entropy_loss: bool = False,
                include_pruning: bool = False,
                alpha: float = 1.0, beta=1.0, if_cuboid: bool = False,
                evaluation: bool = False,
                generator: torch.Generator | None = None,
                entropy_sub: torch.Tensor | None = None,
                jitter: torch.Tensor | None = None,
                group=None) -> ConvexLossOutput:
    """``points [B, N, 3]`` (fit targets), ``chamfer_points [B, M, 3]``
    (chamfer targets), ``X [B, N, D]`` per-point embeddings.  The
    options past ``num_bandwidth_candidates`` are the program's; the
    reference takes them off only."""
    if include_intersect_loss or include_entropy_loss or include_pruning \
            or if_cuboid:
        raise ValueError("the reference's convex loss is the recipe's: no "
                         "entropy, intersection, pruning or cuboids")
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
        samples, sample_w = sample_primitives_batch(params, n_per_prim,
                                                    if_cuboid)
    with record_function("analytic_chamfer"):
        cham = zero if evaluation else analytic_chamfer(
            params, samples, sample_w, chamfer_points, if_cuboid, group)
    # the program adds alpha * 0 + beta * 0: the same value
    total = cham + alpha * zero + beta * zero
    return ConvexLossOutput(total=total, chamfer=cham, entropy=zero,
                            intersection=zero, params=params,
                            clusters=clusters, samples=samples,
                            sample_w=sample_w)
