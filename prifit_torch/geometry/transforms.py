"""Point-cloud standardization, PCA and projection helpers.

Port of ``prifit_tpu/geometry/transforms.py`` (the reference's
``fitting_utils.py`` helpers).  Each single-shape function also takes a
leading batch axis, so the batched names are the same functions:
``eigh`` of the covariance for PCA, a determinant-guarded identity where
``rotation_matrix_a_to_b``'s frame is singular.
"""

import torch

EPS = 1.1920929e-07  # float32 machine eps, as in the reference


def pca(X: torch.Tensor):
    """Eigendecomposition of ``X^T X`` for ``X [..., N, C]``:
    ``(eigenvalues [..., C], eigenvectors [..., C, C])``, ascending."""
    return torch.linalg.eigh(torch.matmul(X.transpose(-1, -2), X))


def rotation_matrix_a_to_b(A: torch.Tensor, B: torch.Tensor
                           ) -> torch.Tensor:
    """The rotation ``R`` with ``B = R A`` for unit 3-vectors ``A, B
    [..., 3]``; the identity where the frame ``(A, B - <A, B> A,
    B x A)`` is singular."""
    cos = torch.sum(A * B, dim=-1)
    cross = torch.linalg.cross(B, A, dim=-1)
    sin = torch.linalg.norm(cross, dim=-1)
    v = B - cos[..., None] * A
    v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + EPS)
    w = cross / (sin[..., None] + EPS)
    F = torch.stack([A, v, w], dim=-1)
    zero, one = torch.zeros_like(cos), torch.ones_like(cos)
    G = torch.stack([torch.stack([cos, -sin, zero], -1),
                     torch.stack([sin, cos, zero], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand_as(F)
    ok = (torch.abs(torch.linalg.det(F)) > 1e-8)[..., None, None]
    F_safe = torch.where(ok, F, eye)
    R = F_safe @ G @ torch.linalg.inv(F_safe)
    return torch.where(ok, R, eye)


def standardize_point(point: torch.Tensor):
    """Center ``point [..., N, 3]``, rotate its smallest principal axis
    onto x and scale each axis to unit extent (the JAX package subtracts
    the full centroid, where the reference subtracts its x coordinate).
    Returns ``(points [..., N, 3], std [..., 1, 3], mean [..., 3], R
    [..., 3, 3])``."""
    mean = point.mean(dim=-2)
    centered = point - mean[..., None, :]
    S, U = pca(centered)
    idx = torch.argmin(S, dim=-1)[..., None, None].expand(
        U.shape[:-1] + (1,))
    smallest = torch.gather(U, -1, idx)[..., 0]
    x_axis = torch.zeros_like(smallest)
    x_axis[..., 0] = 1.0
    R = rotation_matrix_a_to_b(smallest, x_axis)
    rotated = torch.matmul(centered, R.transpose(-1, -2))
    std = torch.abs(rotated.amax(dim=-2) - rotated.amin(dim=-2))[..., None, :]
    return rotated / (std + EPS), std, mean, R


standardize_points = standardize_point


def reverse_all_transformation(point, mean, std, R):
    """Invert :func:`standardize_point`: ``point [..., N, 3]``, ``mean
    [..., 3]``, ``std [..., 1, 3]``, ``R [..., 3, 3]``."""
    scaled = point * std.reshape(std.shape[:-2] + (1, 3))
    unrot = torch.matmul(scaled, torch.linalg.inv(R).transpose(-1, -2))
    return unrot + mean[..., None, :]


def reverse_all_transformations(points, means, stds, Rs):
    """Batched :func:`reverse_all_transformation` (the reference's
    argument order)."""
    return reverse_all_transformation(points, means, stds, Rs)


def project_to_plane(points: torch.Tensor, a: torch.Tensor,
                     d: torch.Tensor) -> torch.Tensor:
    """Project ``points [N, 3]`` onto the plane ``<a, x> = d``."""
    a = a.reshape(3)
    a = a / torch.linalg.norm(a)
    proj = points - torch.outer(points @ a, a)
    return proj + a[None, :] * d


def project_to_point_cloud(points: torch.Tensor,
                           surface: torch.Tensor) -> torch.Tensor:
    """Snap each of ``points [N, 3]`` to its nearest ``surface [M, 3]``
    point (ties to the lowest index)."""
    d = torch.sum((points[:, None, :] - surface[None, :, :]) ** 2, dim=2)
    return surface[torch.argmin(d, dim=1)]
