# Frozen copy of prifit_torch/geometry/sampling.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""Primitive surface sampling with area weights.

Port of ``prifit_tpu/geometry/sampling.py``.  A deterministic lattice on
the unit shape (a Fibonacci lattice of directions for ellipsoids, a
centered grid on each face of ``[-1, 1]^3`` for cuboids) is scaled by each
slot's radii, rotated and shifted; each sample carries the area element of
that map as a weight, so the weight sums are the surface areas.  The
lattice and the weights carry no gradient; the points do, to r, V and
center.
"""

import math

import torch

from benchmark.reference.port.geometry.fitting import PrimitiveParams


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


def sample_primitives_batch(params: PrimitiveParams, n_per_prim: int = 400,
                            cuboid: bool = False):
    """Samples of each of the K slots of each shape -> ``(points
    [B, K * S, 3], weights [B, K * S])``, zero weight for invalid slots;
    ``S = n_per_prim`` (ellipsoids; the copy leaves out the program's
    cuboids)."""
    if cuboid:
        raise ValueError("the reference fits no cuboids")
    pts, w = sample_ellipsoid_surface(
        params.r, params.V, params.center,
        fibonacci_sphere(n_per_prim, device=params.r.device))
    w = w * params.valid[..., None]
    B = pts.shape[0]
    return pts.reshape(B, -1, 3), w.reshape(B, -1)


