"""On-device augmentations for the fused train steps.

The port's counterpart of ``prifit_tpu/data/augment_jax.py``: the math of
:mod:`prifit_torch.data.provider` on tensors, so ``--fused_augment``
augments on the device with no host work per step.  Each function takes
its draws from ``generator`` (on the generator's device, in the order the
docstring gives), or takes the draws themselves (``scales``, ``shifts``,
``noise``, ``angles``, ...), as ``convex_loss`` takes ``jitter``: a test
passes the JAX package's draws and compares the results.
"""

import math

import torch


def _uniform(generator, shape, low, high, like):
    if generator is None:
        raise ValueError("an augmentation needs a generator or its draws")
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u * (high - low) + low).to(like.device)


def random_scale_point_cloud(batch, scale_low=0.8, scale_high=1.25, *,
                             generator=None, scales=None):
    """Per-shape isotropic scale (provider.py:292-304); ``scales [B, 1,
    1]`` uniform in ``[scale_low, scale_high)``."""
    if scales is None:
        scales = _uniform(generator, (batch.shape[0], 1, 1), scale_low,
                          scale_high, batch)
    return batch * scales


def shift_point_cloud(batch, shift_range=0.1, *, generator=None,
                      shifts=None):
    """Per-shape translation (provider.py:278-290); ``shifts [B, 1, 3]``
    uniform in ``[-shift_range, shift_range)``."""
    if shifts is None:
        shifts = _uniform(generator, (batch.shape[0], 1, 3), -shift_range,
                          shift_range, batch)
    return batch + shifts


def jitter_point_cloud(batch, sigma=0.01, clip=0.05, *, generator=None,
                       noise=None):
    """Clipped per-point gaussian jitter (provider.py:265-276); ``noise``
    standard normal of ``batch``'s shape."""
    if noise is None:
        if generator is None:
            raise ValueError("jitter needs a generator or its noise")
        noise = torch.randn(batch.shape, generator=generator,
                            device=generator.device).to(batch.device)
    return batch + torch.clamp(sigma * noise, -clip, clip)


def _rot_y(angles):
    c, s = torch.cos(angles), torch.sin(angles)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1),
                        torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def _rot_z(angles):
    c, s = torch.cos(angles), torch.sin(angles)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, s, z], -1),
                        torch.stack([-s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _angles(generator, angles, batch):
    if angles is None:
        angles = _uniform(generator, (batch.shape[0],), 0.0, 1.0,
                          batch) * (2 * math.pi)
    return angles


def rotate_point_cloud(batch, *, generator=None, angles=None):
    """Random per-shape rotation about y (provider.py:46-64); ``angles
    [B]`` uniform in ``[0, 2 pi)``."""
    R = _rot_y(_angles(generator, angles, batch))
    return torch.einsum("bnc,bcd->bnd", batch, R)


def rotate_point_cloud_z(batch, *, generator=None, angles=None):
    """Random per-shape rotation about z (provider.py:66-85)."""
    R = _rot_z(_angles(generator, angles, batch))
    return torch.einsum("bnc,bcd->bnd", batch, R)


def random_anisotropic_scale_point_cloud(batch, scale_low=0.8,
                                         scale_high=1.25, *,
                                         generator=None, scales=None):
    """Per-shape per-axis scale (provider.py:306-318); ``scales [B, 1,
    C]``."""
    if scales is None:
        scales = _uniform(generator, (batch.shape[0], 1, batch.shape[2]),
                          scale_low, scale_high, batch)
    return batch * scales


def random_point_dropout(batch, max_dropout_ratio=0.875, *,
                         generator=None, ratios=None, uniforms=None):
    """Replace a random fraction of points with the first point
    (provider.py:320-327): ``ratios [B, 1]`` uniform in ``[0, 1)`` times
    ``max_dropout_ratio``, then ``uniforms [B, N]``; a point drops where
    its uniform is at most its shape's ratio."""
    if ratios is None:
        ratios = _uniform(generator, (batch.shape[0], 1), 0.0, 1.0,
                          batch) * max_dropout_ratio
    if uniforms is None:
        uniforms = _uniform(generator, batch.shape[:2], 0.0, 1.0, batch)
    drop = uniforms <= ratios
    return torch.where(drop[:, :, None], batch[:, :1, :], batch)


def standard_train_augment(points, *, generator=None, scales=None,
                           shifts=None):
    """The per-step augmentation pair every reference train loop applies
    (``train:372-373``): isotropic scale, then shift, of the xyz columns;
    other columns pass through.  Draws ``scales`` first, then
    ``shifts``."""
    xyz = random_scale_point_cloud(points[..., :3], generator=generator,
                                   scales=scales)
    xyz = shift_point_cloud(xyz, generator=generator, shifts=shifts)
    if points.shape[-1] > 3:
        return torch.cat([xyz, points[..., 3:]], dim=-1)
    return xyz


def augment_and_resample(chamfer_points, npoint: int, channels: int, *,
                         generator=None, scales=None, shifts=None,
                         choice=None):
    """The fused self-sup input (``prifit_tpu/train/steps.py:93-100``):
    :func:`standard_train_augment` of the full-resolution cloud
    ``chamfer_points [B, M, C]``, then the encoder input resampled from
    it: the xyz of ``npoint`` distinct points ``choice`` (the first
    ``npoint`` of a random permutation of ``M``, drawn after the
    augmentation's), with zero normals when the model takes ``channels``
    = 6.  Returns ``(chamfer_points, points)``."""
    chamfer_points = standard_train_augment(
        chamfer_points, generator=generator, scales=scales, shifts=shifts)
    if choice is None:
        if generator is None:
            raise ValueError("the resample needs a generator or a choice")
        choice = torch.randperm(chamfer_points.shape[1], generator=generator,
                                device=generator.device)[:npoint]
    points = chamfer_points[:, choice.to(chamfer_points.device), :3]
    if channels > 3:
        # normal-channel models get zero normals on self-sup data
        # (matching the host path, reference train:430)
        points = torch.cat([points, torch.zeros_like(points)], dim=-1)
    return chamfer_points, points
