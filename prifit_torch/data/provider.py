"""Batch point-cloud augmentations (numpy, host-side).

The port's copy of ``prifit_tpu/data/provider.py``; the on-device
counterparts are in :mod:`prifit_torch.data.augment_torch`.

Reference-compatible port of ``provider.py`` with two deliberate changes:

- every random function takes an explicit ``rng: np.random.Generator``
  (the reference draws from the global ``np.random`` state; explicit
  generators are required for the per-host sharded input pipeline and for
  reproducibility — SURVEY.md §7 hard-part 5);
- the per-shape Python loops are vectorized with einsum/broadcasting
  (identical math, one kernel per batch).

Function names, argument names, defaults, and math match the reference
one-to-one (citations inline).  Unlike the reference, inputs are never
mutated in place.
"""

import numpy as np


def _rot_y(angles: np.ndarray) -> np.ndarray:
    """Per-shape rotation matrices about +y, shaped [B, 3, 3].

    Matches the reference's matrix layout (``provider.py:57-60``) used with
    ``points @ R``.
    """
    c, s = np.cos(angles), np.sin(angles)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([c, zeros, s], -1),
        np.stack([zeros, ones, zeros], -1),
        np.stack([-s, zeros, c], -1),
    ], -2)


def _rot_z(angles: np.ndarray) -> np.ndarray:
    """Reference layout ``provider.py:78-81``."""
    c, s = np.cos(angles), np.sin(angles)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([c, s, zeros], -1),
        np.stack([-s, c, zeros], -1),
        np.stack([zeros, zeros, ones], -1),
    ], -2)


def normalize_data(batch_data):
    """Center each cloud and scale to the unit sphere (``provider.py:3-20``)."""
    centroid = np.mean(batch_data, axis=1, keepdims=True)
    pc = batch_data - centroid
    m = np.max(np.sqrt(np.sum(pc ** 2, axis=2)), axis=1)
    return pc / m[:, None, None]


def shuffle_data(data, labels, rng: np.random.Generator):
    """Shuffle shapes (``provider.py:22-32``). Returns (data, labels, idx)."""
    idx = rng.permutation(len(labels))
    return data[idx, ...], labels[idx], idx


def shuffle_points(batch_data, rng: np.random.Generator):
    """One point permutation shared by the whole batch (``:34-44``)."""
    idx = rng.permutation(batch_data.shape[1])
    return batch_data[:, idx, :]


def rotate_point_cloud(batch_data, rng: np.random.Generator):
    """Random per-shape rotation about the up (y) axis (``:46-64``)."""
    angles = rng.uniform(size=batch_data.shape[0]) * 2 * np.pi
    return np.einsum("bnc,bcd->bnd", batch_data,
                     _rot_y(angles)).astype(np.float32)


def rotate_point_cloud_z(batch_data, rng: np.random.Generator):
    """Random per-shape rotation about z (``:66-85``)."""
    angles = rng.uniform(size=batch_data.shape[0]) * 2 * np.pi
    return np.einsum("bnc,bcd->bnd", batch_data,
                     _rot_z(angles)).astype(np.float32)


def rotate_point_cloud_y(batch_data, rng: np.random.Generator):
    """Random y rotation applied to xyz AND normal columns (``:87-106``)."""
    angles = rng.uniform(size=batch_data.shape[0]) * 2 * np.pi
    R = _rot_y(angles)
    out = np.zeros_like(batch_data, dtype=np.float32)
    out[:, :, 0:3] = np.einsum("bnc,bcd->bnd", batch_data[:, :, 0:3], R)
    if batch_data.shape[2] >= 6:
        out[:, :, 3:6] = np.einsum("bnc,bcd->bnd", batch_data[:, :, 3:6], R)
    return out


def rotate_point_cloud_y_pi4(batch_data, rng: np.random.Generator):
    """y rotation by a random NON-ZERO multiple of pi/4 (``:108-127``;
    the reference draws randint(1, 8) — never the identity)."""
    angles = rng.integers(1, 8, size=batch_data.shape[0]) * (np.pi / 4.0)
    R = _rot_y(angles)
    out = np.zeros_like(batch_data, dtype=np.float32)
    out[:, :, 0:3] = np.einsum("bnc,bcd->bnd", batch_data[:, :, 0:3], R)
    if batch_data.shape[2] >= 6:
        out[:, :, 3:6] = np.einsum("bnc,bcd->bnd", batch_data[:, :, 3:6], R)
    return out


def rotate_point_cloud_y_by_angle(batch_data, rotation_angle):
    """Fixed-angle y rotation of xyz (+ normals) (``:129-148``)."""
    B = batch_data.shape[0]
    R = _rot_y(np.full(B, rotation_angle))
    out = np.zeros_like(batch_data, dtype=np.float32)
    out[:, :, 0:3] = np.einsum("bnc,bcd->bnd", batch_data[:, :, 0:3], R)
    if batch_data.shape[2] >= 6:
        out[:, :, 3:6] = np.einsum("bnc,bcd->bnd", batch_data[:, :, 3:6], R)
    return out


def rotate_point_cloud_with_normal(batch_xyz_normal,
                                   rng: np.random.Generator):
    """Random y rotation of xyz+normal 6-channel clouds (``:150-168``)."""
    return rotate_point_cloud_y(batch_xyz_normal, rng)


def _perturb_rots(B, angle_sigma, angle_clip, rng):
    angles = np.clip(angle_sigma * rng.standard_normal((B, 3)),
                     -angle_clip, angle_clip)
    cx, sx = np.cos(angles[:, 0]), np.sin(angles[:, 0])
    cy, sy = np.cos(angles[:, 1]), np.sin(angles[:, 1])
    cz, sz = np.cos(angles[:, 2]), np.sin(angles[:, 2])
    zeros, ones = np.zeros(B), np.ones(B)
    Rx = np.stack([np.stack([ones, zeros, zeros], -1),
                   np.stack([zeros, cx, -sx], -1),
                   np.stack([zeros, sx, cx], -1)], -2)
    Ry = np.stack([np.stack([cy, zeros, sy], -1),
                   np.stack([zeros, ones, zeros], -1),
                   np.stack([-sy, zeros, cy], -1)], -2)
    Rz = np.stack([np.stack([cz, -sz, zeros], -1),
                   np.stack([sz, cz, zeros], -1),
                   np.stack([zeros, zeros, ones], -1)], -2)
    return Rz @ (Ry @ Rx)


def rotate_perturbation_point_cloud(batch_data, angle_sigma=0.06,
                                    angle_clip=0.18,
                                    rng: np.random.Generator = None):
    """Small random 3-axis rotations (``:240-263``)."""
    R = _perturb_rots(batch_data.shape[0], angle_sigma, angle_clip, rng)
    return np.einsum("bnc,bcd->bnd", batch_data, R).astype(np.float32)


def rotate_perturbation_point_cloud_with_normal(batch_data,
                                                angle_sigma=0.06,
                                                angle_clip=0.18,
                                                rng=None):
    """Small 3-axis rotations applied to xyz and normals (``:170-195``)."""
    R = _perturb_rots(batch_data.shape[0], angle_sigma, angle_clip, rng)
    out = np.zeros_like(batch_data, dtype=np.float32)
    out[:, :, 0:3] = np.einsum("bnc,bcd->bnd", batch_data[:, :, 0:3], R)
    out[:, :, 3:6] = np.einsum("bnc,bcd->bnd", batch_data[:, :, 3:6], R)
    return out


def rotate_point_cloud_by_angle(batch_data, rotation_angle):
    """Fixed-angle y rotation (``:197-214``)."""
    B = batch_data.shape[0]
    R = _rot_y(np.full(B, rotation_angle))
    return np.einsum("bnc,bcd->bnd", batch_data, R).astype(np.float32)


def rotate_point_cloud_by_angle_with_normal(batch_data, rotation_angle):
    """Fixed-angle y rotation with normals (``:216-238``)."""
    return rotate_point_cloud_y_by_angle(batch_data, rotation_angle)


def jitter_point_cloud(batch_data, sigma=0.01, clip=0.05,
                       rng: np.random.Generator = None):
    """Clipped per-point gaussian jitter (``:265-276``)."""
    assert clip > 0
    noise = np.clip(sigma * rng.standard_normal(batch_data.shape),
                    -clip, clip)
    return (batch_data + noise).astype(np.float32)


def shift_point_cloud(batch_data, shift_range=0.1,
                      rng: np.random.Generator = None):
    """Per-shape uniform translation in [-range, range]^3 (``:278-290``)."""
    shifts = rng.uniform(-shift_range, shift_range,
                         (batch_data.shape[0], 3))
    return (batch_data + shifts[:, None, :]).astype(np.float32)


def random_scale_point_cloud(batch_data, scale_low=0.8, scale_high=1.25,
                             rng: np.random.Generator = None):
    """Per-shape isotropic scale (``:292-304``)."""
    scales = rng.uniform(scale_low, scale_high, batch_data.shape[0])
    return (batch_data * scales[:, None, None]).astype(np.float32)


def random_anisotropic_scale_point_cloud(batch_data, scale_low=0.8,
                                         scale_high=1.25,
                                         rng: np.random.Generator = None):
    """Per-shape per-axis scale (``:306-318``)."""
    B, _, C = batch_data.shape
    scales = rng.uniform(scale_low, scale_high, (B, 1, C))
    return (batch_data * scales).astype(np.float32)


def random_point_dropout(batch_pc, max_dropout_ratio=0.875,
                         rng: np.random.Generator = None):
    """Replace a random fraction of points with the first point (``:320-327``)."""
    B, N, _ = batch_pc.shape
    out = batch_pc.copy()
    ratios = rng.random(B) * max_dropout_ratio
    drop = rng.random((B, N)) <= ratios[:, None]
    first = out[:, :1, :]
    return np.where(drop[:, :, None], first, out).astype(batch_pc.dtype)
