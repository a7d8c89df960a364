"""Primitive surface sampling with area weights (ellipsoids).

Port of ``prifit_tpu/geometry/sampling.py``: a deterministic Fibonacci
lattice of directions is scaled by each slot's radii, rotated and shifted;
each sample carries the local area element of that map as a weight, so the
weight sums are the surface areas.  The directions and the weights carry no
gradient; the points do, to r, V and center.
"""

import math

import torch

from prifit_torch.geometry.fitting import PrimitiveParams


def fibonacci_sphere(n: int, device=None) -> torch.Tensor:
    """Deterministic near-uniform unit-sphere directions ``[n, 3]``."""
    golden = (1.0 + math.sqrt(5.0)) / 2.0
    i = torch.arange(n, dtype=torch.float32, device=device)
    z = 1.0 - (2.0 * i + 1.0) / n
    theta = 2.0 * math.pi * i / golden
    rho = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([rho * torch.cos(theta), rho * torch.sin(theta), z],
                       dim=1)


def sample_ellipsoid_surface(r, V, center, dirs):
    """Samples of ellipsoids ``r [..., 3]``, ``V [..., 3, 3]``,
    ``center [..., 3]`` along ``dirs [S, 3]`` -> ``(points [..., S, 3],
    area_w [..., S])``."""
    d = dirs.detach()
    local = d * r[..., None, :]
    world = torch.matmul(local, V.transpose(-1, -2)) + center[..., None, :]
    rs = r.detach()
    scale = torch.abs(rs[..., 0] * rs[..., 1] * rs[..., 2])
    area_w = scale[..., None] * torch.linalg.norm(
        d / (torch.abs(rs)[..., None, :] + 1e-6), dim=-1)
    area_w = area_w * (4.0 * math.pi / d.shape[0])
    return world, area_w


def sample_primitives_batch(params: PrimitiveParams, n_per_prim: int = 400):
    """``n_per_prim`` samples for each of the K slots of each shape ->
    ``(points [B, K * n, 3], weights [B, K * n])``, zero weight for
    invalid slots."""
    dirs = fibonacci_sphere(n_per_prim, device=params.r.device)
    pts, w = sample_ellipsoid_surface(params.r, params.V, params.center,
                                      dirs)
    w = w * params.valid[..., None]
    B = pts.shape[0]
    return pts.reshape(B, -1, 3), w.reshape(B, -1)
