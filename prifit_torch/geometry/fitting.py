"""Weighted ellipsoid fitting into fixed cluster slots.

Port of ``prifit_tpu/geometry/fitting.py``, batched over shapes and
slots: weighted center and covariance, descending eigendecomposition with
the guarded backward, condition-number and minimum-weight validity,
reflection fix, and axis lengths from the weight-scaled points in the
eigenbasis.  Invalid slots get unit radii, identity axes and a zero
center.

The eigendecomposition reads the solver's error flags back to the host,
so it synchronizes with the device: it is the profiler range
``sync.eigh`` (read by the benchmark's ``sync_wait_ms`` and
``sync_idle_ms``).
"""

from typing import NamedTuple

import torch
from torch.profiler import record_function

GAP_EPS = 1e-6     # reference's eigen-gap guard
COND_MAX = 1e5     # reference's condition-number cutoff
WSUM_EPS = 1e-6    # minimum total weight for a slot to count


class PrimitiveParams(NamedTuple):
    r: torch.Tensor        # [..., K, 3] principal-axis half-lengths
    V: torch.Tensor        # [..., K, 3, 3] principal axes (columns)
    center: torch.Tensor   # [..., K, 3]
    valid: torch.Tensor    # [..., K] bool


class Eigh3Guarded(torch.autograd.Function):
    """``torch.linalg.eigh`` in descending order, with the guarded
    backward of ``prifit_tpu/geometry/fitting.py:80-97``: the symmetric
    eigh pullback whose eigenvalue gaps ``s_j - s_i`` are replaced by a
    sign-preserving ``max(|gap|, 1e-6)``.  Repeated eigenvalues (an empty
    slot's zero covariance) give large but finite gradients, where
    torch's own backward forms ``inf * 0 = NaN``."""

    @staticmethod
    def forward(ctx, A):
        with record_function("sync.eigh"):
            w, v = torch.linalg.eigh(A)
        s, V = w.flip(-1), v.flip(-1)
        ctx.save_for_backward(s, V)
        return s, V

    @staticmethod
    def backward(ctx, gs, gV):
        s, V = ctx.saved_tensors
        diff = s[..., None, :] - s[..., :, None]         # s_j - s_i
        guarded = torch.sign(diff) * torch.clamp_min(diff.abs(), GAP_EPS)
        guarded = torch.where(
            diff.abs() < GAP_EPS,
            torch.where(diff < 0, -GAP_EPS, GAP_EPS).to(diff.dtype),
            guarded)
        eye = torch.eye(3, dtype=torch.bool, device=s.device)
        F = torch.where(eye, torch.zeros_like(diff), 1.0 / guarded)
        Vt = V.transpose(-1, -2)
        inner = F * torch.matmul(Vt, gV)
        inner = (inner + inner.transpose(-1, -2)) / 2.0
        gA = torch.matmul(torch.matmul(V, inner + torch.diag_embed(gs)), Vt)
        return (gA + gA.transpose(-1, -2)) / 2.0


def eigh3_guarded(A: torch.Tensor):
    """Eigendecomposition of symmetric 3x3 matrices ``[..., 3, 3]`` with
    DESCENDING eigenvalues: ``(s [..., 3], V [..., 3, 3])``,
    ``A = V diag(s) V^T``, with the guarded backward."""
    return Eigh3Guarded.apply(A)


def fix_reflection(V: torch.Tensor) -> torch.Tensor:
    """Flip the third eigencolumn where ``det(V) < 0``."""
    flip = torch.where(torch.linalg.det(V) < 0, -1.0, 1.0)
    return torch.cat([V[..., :2], V[..., 2:] * flip[..., None, None]],
                     dim=-1)


def _fit_slots(points: torch.Tensor, weights: torch.Tensor):
    """The unmasked fit of every slot: ``points [B, N, 3]``, ``weights
    [B, N, K]`` -> ``(r, V, center, valid)``, ``[B, K, ...]``; ``valid``
    combines the minimum-weight and condition-number checks."""
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
    return r, V, center, valid


def fit_ellipsoid_weighted(points: torch.Tensor, weights: torch.Tensor):
    """The weighted fit of one cluster: ``points [N, 3]``, ``weights
    [N]`` -> ``(r [3], V [3, 3], center [3], valid [])``, unmasked (a
    view of the batched fit at one shape and one slot)."""
    r, V, center, valid = _fit_slots(points[None], weights[None, :, None])
    return r[0, 0], V[0, 0], center[0, 0], valid[0, 0]


def fit_ellipsoids(points: torch.Tensor, weights: torch.Tensor,
                   slot_valid: torch.Tensor | None = None
                   ) -> PrimitiveParams:
    """One primitive per slot of one shape: ``points [N, 3]``, ``weights
    [N, K]``, ``slot_valid [K]`` -> :class:`PrimitiveParams` ``[K, ...]``
    (a view of :func:`fit_ellipsoids_batch` at one shape)."""
    out = fit_ellipsoids_batch(
        points[None], weights[None],
        None if slot_valid is None else slot_valid[None])
    return PrimitiveParams(*(t[0] for t in out))


def fit_ellipsoids_batch(points: torch.Tensor, weights: torch.Tensor,
                         slot_valid: torch.Tensor | None = None
                         ) -> PrimitiveParams:
    """One weighted ellipsoid per slot: ``points [B, N, 3]``, ``weights
    [B, N, K]``, ``slot_valid [B, K]`` -> :class:`PrimitiveParams`
    ``[B, K, ...]``."""
    r, V, center, valid = _fit_slots(points, weights)
    if slot_valid is not None:
        valid = valid & slot_valid
    m = valid[..., None]
    eye = torch.eye(3, dtype=V.dtype, device=V.device)
    return PrimitiveParams(
        r=torch.where(m, r, torch.ones_like(r)),
        V=torch.where(m[..., None], V, eye),
        center=torch.where(m, center, torch.zeros_like(center)),
        valid=valid)
