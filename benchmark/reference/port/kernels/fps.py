# The plain versions of prifit_torch/kernels/fps.py at commit
# 0adee2a, for the benchmark's reference (the kernels' launches left
# out); see benchmark/reference/__init__.py.
"""Farthest point sampling, plain: the sampled indices and the sampled
points' coordinates."""

import torch


def fps_plain(xyz: torch.Tensor, npoint: int,
              start: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The serial scan of ``ops/sampling.py::farthest_point_sample`` in
    the JAX package: running min squared distance from 1e10, argmax
    (lowest index on ties) each step.  The distance is
    ``(dx*dx + dy*dy) + dz*dz``, the kernel's exact op order.  Returns
    ``(idx [B, npoint] int64, xyz[idx] [B, npoint, 3])``; ``start`` None
    starts every cloud at 0."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    ar = torch.arange(B, device=xyz.device)
    distance = torch.full((B, N), 1e10, dtype=torch.float32,
                          device=xyz.device)
    far = (torch.zeros(B, dtype=torch.int64, device=xyz.device)
           if start is None else start.to(torch.int64))
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        dx = x - x[ar, far][:, None]
        dy = y - y[ar, far][:, None]
        dz = z - z[ar, far][:, None]
        d = (dx * dx + dy * dy) + dz * dz
        distance = torch.minimum(distance, d)
        far = torch.argmax(distance, dim=1)
    return out, xyz[ar[:, None], out]


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[B, N, 3]`` f32, ``start [B]`` int64 (None: index 0) ->
    ``(idx [B, npoint] int64, new_xyz [B, npoint, 3] f32)``, ``new_xyz``
    the sampled points' coordinates bit for bit.  ``start`` must lie in
    ``0..N-1``.  The coordinates carry no gradient, so an ``xyz`` that
    requires one is refused."""
    if xyz.requires_grad:
        raise ValueError("fps: the sampled coordinates carry no gradient; "
                         "pass xyz.detach()")
    return fps_plain(xyz, npoint, start)


