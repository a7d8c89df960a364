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


def box_surface_lattice(n: int, device=None):
    """A centered ``g x g`` grid on each face of the unit box
    ``[-1, 1]^3``, ``g = isqrt(max(n // 6, 1))`` (at least 1): ``(points
    [6 g^2, 3], face_axis [6 g^2])``, where ``face_axis`` (int64) is the
    axis whose coordinate is frozen at +-1 on that face.  So ``n = 256``
    gives 216 points, not 256."""
    g = max(math.isqrt(max(n // 6, 1)), 1)
    u = (torch.arange(g, dtype=torch.float32, device=device) + 0.5) \
        / g * 2.0 - 1.0
    uu, vv = torch.meshgrid(u, u, indexing="ij")
    uu, vv = uu.reshape(-1), vv.reshape(-1)
    ones = torch.ones_like(uu)
    faces = [(ones, uu, vv), (-ones, uu, vv), (uu, ones, vv),
             (uu, -ones, vv), (uu, vv, ones), (uu, vv, -ones)]
    pts = torch.cat([torch.stack(f, 1) for f in faces])
    axis = torch.arange(3, device=device).repeat_interleave(2 * g * g)
    return pts, axis


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


def sample_cuboid_surface(r, V, center, lattice, face_axis):
    """Samples of cuboids with sides ``2 r [..., 3]``, axes
    ``V [..., 3, 3]`` and centers ``center [..., 3]`` at the unit-box
    points ``lattice [S, 3]`` on faces ``face_axis [S]`` -> ``(points
    [..., S, 3], area_w [..., S])``: each sample weighs its face's area
    over the samples a face holds."""
    u = lattice.detach()
    local = u * r[..., None, :]
    world = torch.matmul(local, V.transpose(-1, -2)) + center[..., None, :]
    rs = torch.abs(r.detach())
    face_areas = 4.0 * torch.stack(
        [rs[..., 1] * rs[..., 2], rs[..., 0] * rs[..., 2],
         rs[..., 0] * rs[..., 1]], dim=-1)
    area_w = face_areas[..., face_axis] / (u.shape[0] / 6.0)
    return world, area_w


def sample_primitives_batch(params: PrimitiveParams, n_per_prim: int = 400,
                            cuboid: bool = False):
    """Samples of each of the K slots of each shape -> ``(points
    [B, K * S, 3], weights [B, K * S])``, zero weight for invalid slots;
    ``S = n_per_prim`` for ellipsoids, the :func:`box_surface_lattice`
    count for cuboids."""
    device = params.r.device
    if cuboid:
        lattice, face_axis = box_surface_lattice(n_per_prim, device)
        pts, w = sample_cuboid_surface(params.r, params.V, params.center,
                                       lattice, face_axis)
    else:
        pts, w = sample_ellipsoid_surface(
            params.r, params.V, params.center,
            fibonacci_sphere(n_per_prim, device=device))
    w = w * params.valid[..., None]
    B = pts.shape[0]
    return pts.reshape(B, -1, 3), w.reshape(B, -1)


def sample_primitives(params: PrimitiveParams, n_per_prim: int = 400,
                      cuboid: bool = False):
    """Samples of the K slots of one shape (``params`` ``[K, ...]``) ->
    ``(points [K * S, 3], weights [K * S])``: a view of
    :func:`sample_primitives_batch` at one shape."""
    pts, w = sample_primitives_batch(
        PrimitiveParams(*(t[None] for t in params)), n_per_prim, cuboid)
    return pts[0], w[0]
