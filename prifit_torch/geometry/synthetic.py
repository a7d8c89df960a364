"""Synthetic known-parameter ellipsoid scenes: the fit-pipeline oracle.

The port's own copy of ``prifit_tpu/geometry/synthetic.py`` (numpy only),
kept line for line so that ``create_synthetic_dataset(B, seed)`` gives the
JAX package's arrays bit for bit: each shape is 3 random ellipsoids (axes
drawn from [2, 20)), each rotated about z by a random angle and translated
by a random center, 500 surface points each (a Fibonacci lattice resampled
by area element), with one-hot cluster weights.

Used by the ``fitting`` demo entry point (:mod:`prifit_torch.cli.fitting`)
and the tests as the ground truth of the cluster -> fit -> sample ->
chamfer -> backward pipeline.
"""

from typing import NamedTuple

import numpy as np


class SyntheticScene(NamedTuple):
    points: np.ndarray      # [B, 1500, 3]
    weights: np.ndarray     # [B, 1500, 32] one-hot cluster weights
    params: np.ndarray      # [B, 3, 3] true (a, b, c) per ellipsoid
    centers: np.ndarray     # [B, 3, 3]
    rotations: np.ndarray   # [B, 3, 3, 3] world-from-local (points @ R)


def _fibonacci_sphere_np(n: int) -> np.ndarray:
    golden = (1.0 + np.sqrt(5.0)) / 2.0
    i = np.arange(n, dtype=np.float64)
    z = 1.0 - (2.0 * i + 1.0) / n
    theta = 2.0 * np.pi * i / golden
    rho = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([rho * np.cos(theta), rho * np.sin(theta), z], axis=1)


def _rot_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _sample_ellipsoid_uniform(rng: np.random.Generator, abc: np.ndarray,
                              n: int) -> np.ndarray:
    """~Uniform-on-surface samples by area-weighted resampling of a lattice."""
    dirs = _fibonacci_sphere_np(4 * n)
    area = np.linalg.norm(dirs / abc[None, :], axis=1)  # ∝ dA_ell / dA_sph
    p = area / area.sum()
    idx = rng.choice(dirs.shape[0], size=n, replace=False, p=p)
    return dirs[idx] * abc[None, :]


def create_synthetic_dataset(batch_size: int, seed: int = 0,
                             points_per_ellipsoid: int = 500,
                             num_slots: int = 32) -> SyntheticScene:
    """Random 3-ellipsoid scenes with known parameters.

    Matches the reference fixture's distributions
    (``src/ellipsoid_fitting.py:144-193``): axes ~ choice([2, 20)),
    rotation ~ z-euler(U[0, 360)deg), center ~ U[0, 1)^3 * max(a, b, c).
    """
    rng = np.random.default_rng(seed)
    pts_b, wgt_b, par_b, ctr_b, rot_b = [], [], [], [], []
    for _ in range(batch_size):
        pts, wgts, pars, ctrs, rots = [], [], [], [], []
        for i in range(3):
            abc = rng.choice(np.arange(2, 20), size=3).astype(np.float64)
            local = _sample_ellipsoid_uniform(rng, abc, points_per_ellipsoid)
            rot = _rot_z(rng.random() * 2.0 * np.pi)
            center = rng.random((1, 3)) * abc.max()
            world = local @ rot + center
            w = np.zeros((points_per_ellipsoid, num_slots), dtype=np.float32)
            w[:, i] = 1.0
            pts.append(world)
            wgts.append(w)
            pars.append(abc)
            ctrs.append(center[0])
            rots.append(rot)
        pts_b.append(np.concatenate(pts))
        wgt_b.append(np.concatenate(wgts))
        par_b.append(np.stack(pars))
        ctr_b.append(np.stack(ctrs))
        rot_b.append(np.stack(rots))
    return SyntheticScene(
        points=np.stack(pts_b).astype(np.float32),
        weights=np.stack(wgt_b),
        params=np.stack(par_b).astype(np.float32),
        centers=np.stack(ctr_b).astype(np.float32),
        rotations=np.stack(rot_b).astype(np.float32),
    )
