"""Farthest point sampling: CUDA kernel (``csrc/fps.cu``) and plain
PyTorch version."""

import torch

from prifit_torch.kernels.build import I32, P, Kernel, check_cuda, \
    stream_handle

KERNEL = Kernel(
    "fps", "prifit_tpu/ops/pallas/fps.py:87",
    {"fps_forward": (P, P, P, I32, I32, I32, P)})

# 16 bytes of shared memory a point, within the 227 KB a block may use
MAX_POINTS = 14336


def fps_plain(xyz: torch.Tensor, npoint: int,
              start: torch.Tensor) -> torch.Tensor:
    """The serial scan of ``ops/sampling.py::farthest_point_sample`` in
    the JAX package: running min squared distance from 1e10, argmax
    (lowest index on ties) each step.  The distance is
    ``(dx*dx + dy*dy) + dz*dz``, the kernel's exact op order."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    ar = torch.arange(B, device=xyz.device)
    distance = torch.full((B, N), 1e10, dtype=torch.float32,
                          device=xyz.device)
    far = start.to(torch.int64)
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        dx = x - x[ar, far][:, None]
        dy = y - y[ar, far][:, None]
        dz = z - z[ar, far][:, None]
        d = (dx * dx + dy * dy) + dz * dz
        distance = torch.minimum(distance, d)
        far = torch.argmax(distance, dim=1)
    return out


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: torch.Tensor) -> torch.Tensor:
    """``[B, N, 3]`` f32, ``start [B]`` -> ``[B, npoint]`` int64 indices.

    Launches the kernel for a CUDA tensor; a CPU tensor takes the plain
    version."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint, start)
    check_cuda("fps xyz", xyz, torch.float32, 3)
    B, N, C = xyz.shape
    if C != 3 or N > MAX_POINTS or not 0 < npoint <= N:
        raise ValueError(f"fps: unsupported shape {tuple(xyz.shape)} "
                         f"npoint={npoint}")
    start = start.to(device=xyz.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    KERNEL.launch("fps_forward", xyz.data_ptr(), start.data_ptr(),
                  out.data_ptr(), B, N, npoint, stream_handle(xyz))
    return out.long()
