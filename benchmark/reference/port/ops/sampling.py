# Frozen copy of prifit_torch/ops/sampling.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""Point sampling, grouping and interpolation (PointNet++ ops).

Port of ``prifit_tpu/ops/sampling.py``.  ``gather_neighbors`` and
``farthest_points`` go to the hand-written kernels
(:mod:`prifit_torch.kernels`) for CUDA tensors; every other op is plain
PyTorch.  The TPU's width-based gather dispatch (one-hot matmul vs lane
gather) has no counterpart here: every neighbourhood gather on the card is
the gather kernel.
"""

import torch

from benchmark.reference.port.kernels.fps import farthest_point_sample as _fps
from benchmark.reference.port.kernels.gather import gather_rows
from benchmark.reference.port.ops.pairwise import min_k, square_distance


def gather_neighbors(points: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """Neighbourhood gather, bit-exact: the gather kernel on CUDA, with
    the f32 scatter-add as its backward on either device."""
    return gather_rows(points.contiguous(), idx)


# the JAX package's name for the same batched gather (``out[b, ...] =
# points[b, idx[b, ...], :]``)


def farthest_points(xyz: torch.Tensor, npoint: int,
                    start: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Iterative farthest point sampling, ``[B, N, 3] -> (idx [B, npoint]
    int64, new_xyz [B, npoint, 3] f32)``, ``new_xyz`` the sampled points'
    coordinates (one kernel launch on the card).  ``start [B]`` gives each
    shape's first index (0 when None, the JAX package's
    ``deterministic=True``)."""
    return _fps(xyz.float().contiguous(), npoint, start)


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The indices of :func:`farthest_points`, ``[B, npoint]`` int64."""
    return farthest_points(xyz, npoint, start)[0]


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """Up to ``nsample`` in-radius points per query in ascending INDEX
    order; empty slots repeat the first hit (reference semantics).
    Returns ``[B, S, nsample]`` int64."""
    N = xyz.shape[1]
    sqrdists = square_distance(new_xyz, xyz)
    arange = torch.arange(N, device=xyz.device)
    keys = torch.where(sqrdists <= radius ** 2, arange, N)
    k = min(nsample, N)
    group_idx = torch.sort(keys, dim=-1).values[..., :k]
    first = group_idx[..., :1]
    if k < nsample:
        pad = first.expand(group_idx.shape[:-1] + (nsample - k,))
        group_idx = torch.cat([group_idx, pad], dim=-1)
    group_idx = torch.where(group_idx == N, first, group_idx)
    # a center with no in-radius point (impossible for FPS centers of the
    # same cloud) falls back to index 0
    return torch.where(group_idx == N, 0, group_idx)


def ball_query_nearest_shared(radius_list, nsample_list, xyz: torch.Tensor,
                              new_xyz: torch.Tensor):
    """The ``nsample`` NEAREST in-radius points for several radii from one
    distance matrix and one sort (the JAX package's documented deviation
    from first-k-by-index); empty slots take the nearest point.  Returns a
    list of ``[B, S, nsample_i]`` int64."""
    d = square_distance(new_xyz, xyz)
    k_max = min(max(nsample_list), xyz.shape[1])
    dists, idx = min_k(d, k_max)
    out = []
    for r, k in zip(radius_list, nsample_list):
        kk = min(k, k_max)
        idx_k = idx[..., :kk]
        first = idx_k[..., :1]
        sel = torch.where(dists[..., :kk] <= r * r, idx_k, first)
        if kk < k:
            pad = first.expand(sel.shape[:-1] + (k - kk,))
            sel = torch.cat([sel, pad], dim=-1)
        out.append(sel)
    return out


def sample_and_group_all(xyz: torch.Tensor, points: torch.Tensor | None):
    """One global group: ``new_xyz [B, 1, 3]`` zeros and
    ``new_points [B, 1, N, 3 (+D)]`` (xyz first)."""
    B, N, C = xyz.shape
    new_xyz = torch.zeros((B, 1, C), dtype=xyz.dtype, device=xyz.device)
    grouped = xyz[:, None]
    if points is None:
        return new_xyz, grouped
    dt = torch.promote_types(xyz.dtype, points.dtype)
    return new_xyz, torch.cat([grouped.to(dt), points[:, None].to(dt)],
                              dim=-1)


def three_nn_interpolate(xyz_dst: torch.Tensor, xyz_src: torch.Tensor,
                         feats_src: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weighted 3-NN interpolation of ``feats_src
    [B, S, D]`` from ``xyz_src [B, S, 3]`` onto ``xyz_dst [B, N, 3]``."""
    B, S, _ = xyz_src.shape
    if S == 1:
        return feats_src.expand(B, xyz_dst.shape[1], feats_src.shape[-1])
    dists = square_distance(xyz_dst, xyz_src)
    d, idx = min_k(dists, 3)
    w = 1.0 / (d + 1e-8)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    gathered = gather_neighbors(feats_src, idx)  # [B, N, 3, D]
    return torch.sum(gathered * w[..., None].to(gathered.dtype), dim=2)
