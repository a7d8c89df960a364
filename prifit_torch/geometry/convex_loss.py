"""The PRIFIT convex-approximation loss.

Port of ``prifit_tpu/geometry/convex_loss.py::convex_loss``: normalize
the embeddings, (optionally) the entropy regularizer on a quarter of the
points, mean-shift clustering into fixed slots, weighted fitting,
ellipsoid or cuboid surface sampling, (optionally) pruning of the samples
inside the union, the SDF/nearest-neighbour analytic chamfer against the
full-resolution cloud, and (optionally) the intersection loss at inward
jittered points: ``total = chamfer + alpha * intersection + beta *
entropy``.

Randomness (the entropy subsample and the jitter) comes from a
``torch.Generator``, where the JAX package takes a key; without one, the
JAX package's deterministic fallbacks.  ``entropy_sub`` and ``jitter``
give the draws themselves, for runs that must draw the same bits.
``group`` (data parallelism) makes every mean over shapes global
(:mod:`prifit_torch.geometry.losses`).
"""

from typing import NamedTuple

import torch
from torch.profiler import record_function

from prifit_torch.clustering.mean_shift import ClusterResult, cluster_batch
from prifit_torch.geometry.fitting import PrimitiveParams, \
    fit_ellipsoids_batch
from prifit_torch.geometry.losses import analytic_chamfer, entropy_loss, \
    intersection_loss, prune_mask
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
    (chamfer targets), ``X [B, N, D]`` per-point embeddings.

    ``entropy_sub``: the ``N // 4`` point ids of the entropy subsample,
    else ``randperm(N)[:N // 4]`` from ``generator``, else every 4th
    point.  ``jitter``: what is subtracted from ``chamfer_points`` for the
    intersection loss, else ``U[0, 1) * 0.2`` of their shape from
    ``generator``, else 0.1."""
    N = X.shape[1]
    X = X / torch.clamp_min(torch.linalg.norm(X, dim=2, keepdim=True),
                            1e-12)
    zero = torch.zeros((), dtype=torch.float32, device=X.device)

    # each stage is a profiler range (read by prifit_torch.profile_forward
    # and by the benchmark's cluster_ms and fit_chamfer_ms)
    ent = zero
    if include_entropy_loss:
        with record_function("entropy_loss"):
            if entropy_sub is None and generator is not None:
                entropy_sub = torch.randperm(
                    N, generator=generator,
                    device=generator.device)[:N // 4].to(X.device)
            elif entropy_sub is None:
                entropy_sub = torch.arange(0, N, 4, device=X.device)[:N // 4]
            ent = entropy_loss(X[:, entropy_sub], group=group)
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
    if include_pruning:
        with record_function("prune_mask"):
            sample_w = sample_w * prune_mask(samples, params, if_cuboid)
    with record_function("analytic_chamfer"):
        cham = zero if evaluation else analytic_chamfer(
            params, samples, sample_w, chamfer_points, if_cuboid, group)
    inter = zero
    if include_intersect_loss:
        with record_function("intersection_loss"):
            if jitter is None and generator is not None:
                jitter = torch.rand(
                    chamfer_points.shape, generator=generator,
                    device=generator.device).to(X.device) * 0.2
            elif jitter is None:
                jitter = 0.1
            inter = intersection_loss(params, chamfer_points - jitter,
                                      if_cuboid, group=group)
    total = cham + alpha * inter + beta * ent
    return ConvexLossOutput(total=total, chamfer=cham, entropy=ent,
                            intersection=inter, params=params,
                            clusters=clusters, samples=samples,
                            sample_w=sample_w)
