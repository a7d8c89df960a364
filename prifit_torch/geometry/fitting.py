"""Weighted ellipsoid fitting into fixed cluster slots.

Port of ``prifit_tpu/geometry/fitting.py`` (forward), batched over shapes
and slots: weighted center and covariance, descending eigendecomposition,
condition-number and minimum-weight validity, reflection fix, and axis
lengths from the weight-scaled points in the eigenbasis.  Invalid slots get
unit radii, identity axes and a zero center.  The guarded eigh backward of
the JAX package is not ported yet.
"""

from typing import NamedTuple

import torch

COND_MAX = 1e5     # reference's condition-number cutoff
WSUM_EPS = 1e-6    # minimum total weight for a slot to count


class PrimitiveParams(NamedTuple):
    r: torch.Tensor        # [..., K, 3] principal-axis half-lengths
    V: torch.Tensor        # [..., K, 3, 3] principal axes (columns)
    center: torch.Tensor   # [..., K, 3]
    valid: torch.Tensor    # [..., K] bool


def eigh3_guarded(A: torch.Tensor):
    """Eigendecomposition of symmetric 3x3 matrices ``[..., 3, 3]`` with
    DESCENDING eigenvalues: ``(s [..., 3], V [..., 3, 3])``,
    ``A = V diag(s) V^T``."""
    w, v = torch.linalg.eigh(A)
    return w.flip(-1), v.flip(-1)


def fix_reflection(V: torch.Tensor) -> torch.Tensor:
    """Flip the third eigencolumn where ``det(V) < 0``."""
    flip = torch.where(torch.linalg.det(V) < 0, -1.0, 1.0)
    return torch.cat([V[..., :2], V[..., 2:] * flip[..., None, None]],
                     dim=-1)


def fit_ellipsoids_batch(points: torch.Tensor, weights: torch.Tensor,
                         slot_valid: torch.Tensor | None = None
                         ) -> PrimitiveParams:
    """One weighted ellipsoid per slot: ``points [B, N, 3]``, ``weights
    [B, N, K]``, ``slot_valid [B, K]`` -> :class:`PrimitiveParams`
    ``[B, K, ...]``."""
    w = weights.transpose(1, 2)[..., None]                  # [B, K, N, 1]
    sum_w = weights.sum(dim=1)                              # [B, K]
    safe = torch.clamp_min(sum_w, WSUM_EPS)[..., None]
    p = points[:, None]                                     # [B, 1, N, 3]
    center = torch.sum(p * w, dim=2) / safe                 # [B, K, 3]
    centered = p - center[:, :, None, :]                    # [B, K, N, 3]
    cov = torch.matmul((centered * w).transpose(-1, -2), centered) \
        / safe[..., None]
    s, V = eigh3_guarded(cov)
    s = s.detach()   # the condition check is no-grad in the reference
    cond_ok = s[..., 0] / torch.clamp_min(s[..., 2], 1e-30) <= COND_MAX
    valid = cond_ok & (sum_w > WSUM_EPS)
    V = fix_reflection(V)
    transformed = torch.matmul(centered * w, V)             # [B, K, N, 3]
    r = (transformed.amax(dim=2) - transformed.amin(dim=2)) / 2.0
    if slot_valid is not None:
        valid = valid & slot_valid
    m = valid[..., None]
    eye = torch.eye(3, dtype=V.dtype, device=V.device)
    return PrimitiveParams(
        r=torch.where(m, r, torch.ones_like(r)),
        V=torch.where(m[..., None], V, eye),
        center=torch.where(m, center, torch.zeros_like(center)),
        valid=valid)
