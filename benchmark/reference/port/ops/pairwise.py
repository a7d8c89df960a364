# Frozen copy of prifit_torch/ops/pairwise.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""Pairwise distances, exact k-smallest selection and kNN graphs.

Port of ``prifit_tpu/ops/pairwise.py``: ``square_distance``, ``min_k``,
``knn``, ``knn_with_dilation`` and ``knn_points_normals``.
``min_k_packed`` there is a TPU trick (indices packed into mantissa bits
for a values-only sort); off the TPU it is exactly ``min_k``, which is
what the port keeps, so the kNN graphs here take ``min_k``.
"""

import torch


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``dist[..., n, m] = ||src[..., n] - dst[..., m]||^2`` via the
    expanded form ``|s|^2 - 2 s.d + |d|^2`` in f32, clamped at 0."""
    src = src.float()
    dst = dst.float()
    inner = torch.matmul(src, dst.transpose(-1, -2))
    s2 = torch.sum(src * src, dim=-1, keepdim=True)
    d2 = torch.sum(dst * dst, dim=-1, keepdim=True)
    dist = s2 - 2.0 * inner + d2.transpose(-1, -2)
    return torch.clamp_min(dist, 0.0)


def min_k(dist: torch.Tensor, k: int):
    """Exact ``k`` smallest values and their int64 indices along the last
    axis, ascending; equal values keep ascending index order (what
    ``lax.top_k`` does off the TPU)."""
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices ``[..., N, k]`` (int64) of the ``k`` nearest neighbours of
    each point of ``x [..., N, C]``, nearest first, the point itself
    included."""
    return min_k(square_distance(x, x), k)[1]


def _dilate(idx: torch.Tensor, k1: int, k2: int) -> torch.Tensor:
    """Every ``max(k2 // k1, 1)``-th of the ``k2`` nearest, at most
    ``k1`` of them."""
    return idx[..., ::max(k2 // k1, 1)][..., :k1]


def knn_with_dilation(x: torch.Tensor, k1: int, k2: int) -> torch.Tensor:
    """Dilated kNN (reference ``src/dgcnn.py:9-27``): of the ``k2``
    nearest neighbours keep indices ``0, step, 2 step, ...`` with ``step =
    k2 // k1``, ``k1`` of them."""
    return _dilate(knn(x, k2), k1, k2)


def knn_points_normals(x: torch.Tensor, k1: int, k2: int) -> torch.Tensor:
    """Normals-aware dilated kNN of ``x [..., N, 6]`` (xyz, normal), on
    ``d = d_xyz (1 + 2 - 2 <n_i, n_j>)`` (reference ``src/dgcnn.py:
    30-71``), with the step ``max(k2 // k1, 1)``."""
    p, n = x[..., :3], x[..., 3:6].float()
    d_n = 2.0 - 2.0 * torch.matmul(n, n.transpose(-1, -2))
    return _dilate(min_k(square_distance(p, p) * (1.0 + d_n), k2)[1], k1, k2)
