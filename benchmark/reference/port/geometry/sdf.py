# Frozen copy of prifit_torch/geometry/sdf.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""Signed distances of fitted ellipsoids, batched over slots (the copy
leaves out the program's cuboids, which no cell fits).

Port of ``prifit_tpu/geometry/sdf.py``, in the primitive frame
``(p - center) @ V``: ``k0 = |p / r|, k1 = |p / r^2|,
sdf = k0 (k0 - 1) / (k1 + 1e-6)`` (approximate).
"""

import torch


def _to_local(points, center, V) -> torch.Tensor:
    """``points [..., M, 3]`` into the frames of ``center [..., 3]``,
    ``V [..., 3, 3]`` -> ``[..., M, 3]``."""
    return torch.matmul(points - center[..., None, :], V)


def sdf_ellipsoid(points, r, V, center) -> torch.Tensor:
    """``points [..., M, 3]`` against ellipsoids ``r [..., 3]``,
    ``V [..., 3, 3]``, ``center [..., 3]`` -> ``[..., M]``."""
    local = _to_local(points, center, V)
    k0 = torch.linalg.norm(local / (r[..., None, :] + 1e-6), dim=-1)
    k1 = torch.linalg.norm(local / (r[..., None, :] ** 2 + 1e-6), dim=-1)
    return k0 * (k0 - 1.0) / (k1 + 1e-6)


def sdf_primitives(points, r, V, center, cuboid: bool = False
                   ) -> torch.Tensor:
    """SDF of each of K slots at each point: ``points [B, M, 3]``,
    ``r [B, K, 3]``, ``V [B, K, 3, 3]``, ``center [B, K, 3]`` ->
    ``[B, M, K]``."""
    if cuboid:
        raise ValueError("the reference fits no cuboids")
    return sdf_ellipsoid(points[:, None], r, V, center).transpose(1, 2)
