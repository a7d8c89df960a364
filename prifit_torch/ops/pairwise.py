"""Pairwise distances and exact k-smallest selection.

Port of ``prifit_tpu/ops/pairwise.py``: ``square_distance`` and ``min_k``.
``min_k_packed`` there is a TPU trick (indices packed into mantissa bits
for a values-only sort); off the TPU it is exactly ``min_k``, which is
what the port keeps.
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
