"""Farthest point sampling: CUDA kernel (``csrc/fps.cu``) and plain
PyTorch version.  Both return the sampled indices and the sampled points'
coordinates, which the kernel writes in the same launch."""

import torch

from prifit_torch.kernels.build import I32, P, Kernel, check_cuda, \
    stream_handle

KERNEL = Kernel(
    "fps", "prifit_tpu/ops/pallas/fps.py:87",
    {"fps_forward": (P, P, P, P, I32, I32, I32, I32, I32, P)})

# the kernel's block sizes and most points a thread (compile-time
# constants); the fewest threads win because each warp reads every
# thread's entry each step
THREADS = (128, 256, 512, 1024)
MAX_PER_THREAD = 16
MAX_POINTS = THREADS[-1] * MAX_PER_THREAD


def launch_shape(n: int) -> tuple[int, int]:
    """``(T, P)``, threads a block and points a thread, for a cloud of
    ``n`` points: the fewest threads that hold ``n`` points at up to
    ``MAX_PER_THREAD`` a thread, then the fewest points a thread with
    ``T * P >= n``.  Raises ``ValueError`` naming the limit for ``n``
    outside ``1..MAX_POINTS``."""
    if not 1 <= n <= MAX_POINTS:
        raise ValueError(f"fps: point count {n} outside 1..{MAX_POINTS}")
    t = next(t for t in THREADS if t * MAX_PER_THREAD >= n)
    return t, -(-n // t)


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
    requires one is refused.

    Launches the kernel for a CUDA tensor; a CPU tensor takes the plain
    version."""
    if xyz.requires_grad:
        raise ValueError("fps: the sampled coordinates carry no gradient; "
                         "pass xyz.detach()")
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint, start)
    check_cuda("fps xyz", xyz, torch.float32, 3, align=4)
    B, N, C = xyz.shape
    if C != 3 or not 0 < npoint <= N:
        raise ValueError(f"fps: unsupported shape {tuple(xyz.shape)} "
                         f"npoint={npoint}")
    t, p = launch_shape(N)
    if start is not None:
        check_cuda("fps start", start, torch.int64, 1, align=8)
        if start.shape[0] != B or start.device != xyz.device:
            raise ValueError(f"fps: start {tuple(start.shape)} on "
                             f"{start.device} for {B} clouds on "
                             f"{xyz.device}")
    return launch(xyz, npoint, start, t, p)


def launch(xyz: torch.Tensor, npoint: int, start: torch.Tensor | None,
           threads: int, per_thread: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch at the given ``(T, P)`` on checked inputs (the
    wrapper's last step; timing scripts call it with other shapes)."""
    B, N, _ = xyz.shape
    idx = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    new_xyz = torch.empty((B, npoint, 3), dtype=torch.float32,
                          device=xyz.device)
    KERNEL.launch("fps_forward", xyz.data_ptr(),
                  None if start is None else start.data_ptr(),
                  idx.data_ptr(), new_xyz.data_ptr(), B, N, npoint, threads,
                  per_thread, stream_handle(xyz))
    return idx, new_xyz
