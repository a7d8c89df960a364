"""Approximate ellipsoid signed distance, batched over slots.

Port of ``prifit_tpu/geometry/sdf.py`` (ellipsoid):
``k0 = |p / r|, k1 = |p / r^2|, sdf = k0 (k0 - 1) / (k1 + 1e-6)`` in the
primitive frame ``(p - center) @ V``.
"""

import torch


def sdf_ellipsoid(points, r, V, center) -> torch.Tensor:
    """``points [..., M, 3]`` against ellipsoids ``r [..., 3]``,
    ``V [..., 3, 3]``, ``center [..., 3]`` -> ``[..., M]``."""
    local = torch.matmul(points - center[..., None, :], V)
    k0 = torch.linalg.norm(local / (r[..., None, :] + 1e-6), dim=-1)
    k1 = torch.linalg.norm(local / (r[..., None, :] ** 2 + 1e-6), dim=-1)
    return k0 * (k0 - 1.0) / (k1 + 1e-6)


def sdf_primitives(points, r, V, center) -> torch.Tensor:
    """SDF of each of K slots at each point: ``points [B, M, 3]``,
    ``r [B, K, 3]``, ``V [B, K, 3, 3]``, ``center [B, K, 3]`` ->
    ``[B, M, K]``."""
    return sdf_ellipsoid(points[:, None], r, V, center).transpose(1, 2)
