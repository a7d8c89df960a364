"""Signed distances of fitted primitives, batched over slots.

Port of ``prifit_tpu/geometry/sdf.py``, in the primitive frame
``(p - center) @ V``:

  - ellipsoid (approximate): ``k0 = |p / r|, k1 = |p / r^2|,
    sdf = k0 (k0 - 1) / (k1 + 1e-6)``;
  - cuboid (exact, half-sides ``r``): ``q = |p| - r``,
    ``sdf = |relu(q)| + min(max(q), 0)``.
"""

import torch


def _to_local(points, center, V) -> torch.Tensor:
    """``points [..., M, 3]`` into the frames of ``center [..., 3]``,
    ``V [..., 3, 3]`` -> ``[..., M, 3]``."""
    return torch.matmul(points - center[..., None, :], V)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with JAX's gradient at 0 (``+g``; torch's ``abs`` gives 0
    there)."""
    return torch.where(x >= 0, x, -x)


def sdf_ellipsoid(points, r, V, center) -> torch.Tensor:
    """``points [..., M, 3]`` against ellipsoids ``r [..., 3]``,
    ``V [..., 3, 3]``, ``center [..., 3]`` -> ``[..., M]``."""
    local = _to_local(points, center, V)
    k0 = torch.linalg.norm(local / (r[..., None, :] + 1e-6), dim=-1)
    k1 = torch.linalg.norm(local / (r[..., None, :] ** 2 + 1e-6), dim=-1)
    return k0 * (k0 - 1.0) / (k1 + 1e-6)


def sdf_cuboid(points, r, V, center) -> torch.Tensor:
    """``points [..., M, 3]`` against cuboids with half-sides
    ``r [..., 3]``, axes ``V [..., 3, 3]`` and centers ``center [..., 3]``
    -> ``[..., M]``.  ``amax`` and ``minimum`` split a tie's gradient
    evenly, as ``jnp.max`` and ``jnp.minimum`` do."""
    q = _abs(_to_local(points, center, V)) - r[..., None, :]
    outside = torch.linalg.norm(torch.relu(q), dim=-1)
    inside = torch.minimum(torch.amax(q, dim=-1), q.new_zeros(()))
    return outside + inside


def sdf_primitives(points, r, V, center, cuboid: bool = False
                   ) -> torch.Tensor:
    """SDF of each of K slots at each point: ``points [B, M, 3]``,
    ``r [B, K, 3]``, ``V [B, K, 3, 3]``, ``center [B, K, 3]`` ->
    ``[B, M, K]``."""
    fn = sdf_cuboid if cuboid else sdf_ellipsoid
    return fn(points[:, None], r, V, center).transpose(1, 2)
