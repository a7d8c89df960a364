"""The three distance passes of mode NMS: CUDA kernels (``csrc/nms.cu``)
and plain PyTorch version."""

import torch

from prifit_torch.kernels.bandwidth import chordal_sqdist
from prifit_torch.kernels.build import I32, P, Kernel, check_cuda, \
    stream_handle

KERNEL = Kernel(
    "nms", "prifit_tpu/ops/pallas/nms.py:112",
    {"nms_counts": (P, P, I32, I32, P),
     "nms_centers": (P, P, P, P, I32, I32, P),
     "nms_used": (P, P, P, I32, I32, P)})

D = 128        # embedding width the kernels take
ROW_TILE = 64  # N must be a multiple of this


def nms_passes_plain(modes: torch.Tensor, bw: torch.Tensor):
    """The jnp branch of ``clustering/mean_shift.py::nms_fixed_slots``
    (:326-346) in the JAX package, batched; ``bw [B]`` is compared
    unsquared against the squared distance (reference quirk).  Returns
    ``(counts [B, N] f32, is_center [B, N] bool, used [B, N] bool)``."""
    B, N, _ = modes.shape
    dist = chordal_sqdist(modes, modes)                       # [B, N, N]
    # argmin/argmax take the first occurrence, like jnp's
    assign = torch.argmin(dist, dim=-1)
    counts = torch.zeros((B, N), dtype=torch.float32, device=modes.device)
    counts.scatter_add_(1, assign, torch.ones_like(counts))
    occupied = counts > 0
    nbrs = (dist < bw[:, None, None]).float()
    rep = torch.argmax(nbrs * counts[:, None, :], dim=-1)     # [B, N]
    is_center = _any_at(rep, occupied, N)
    masked = torch.where(is_center[:, None, :], dist,
                         torch.full_like(dist, float("inf")))
    label = torch.argmin(masked, dim=-1)
    used = _any_at(label, torch.ones_like(occupied), N)
    return counts, is_center, used


def _any_at(index: torch.Tensor, flag: torch.Tensor, n: int
            ) -> torch.Tensor:
    """``out[b, j] = any_i (index[b, i] == j and flag[b, i])``."""
    hits = torch.zeros(index.shape[:-1] + (n,), dtype=torch.int32,
                       device=index.device)
    hits.scatter_add_(-1, index, flag.to(torch.int32))
    return hits > 0


def nms_passes(modes: torch.Tensor, bw: torch.Tensor):
    """``modes [B, N, D]`` unit rows, ``bw [B]`` -> ``(counts [B, N] f32,
    is_center [B, N] bool, used [B, N] bool)``.

    Launches the three kernels for a CUDA tensor; a CPU tensor takes the
    plain version."""
    if modes.device.type == "cpu":
        return nms_passes_plain(modes, bw)
    check_cuda("nms modes", modes, torch.float32, 3)
    check_cuda("nms bw", bw, torch.float32, 1)
    B, N, d = modes.shape
    if bw.shape[0] != B or d != D or N % ROW_TILE:
        raise ValueError(f"nms: unsupported shapes {tuple(modes.shape)} / "
                         f"{tuple(bw.shape)}")
    counts = torch.zeros((B, N), dtype=torch.int32, device=modes.device)
    is_center = torch.zeros_like(counts)
    used = torch.zeros_like(counts)
    stream = stream_handle(modes)
    KERNEL.launch("nms_counts", modes.data_ptr(), counts.data_ptr(), B, N,
                  stream)
    KERNEL.launch("nms_centers", modes.data_ptr(), counts.data_ptr(),
                  bw.data_ptr(), is_center.data_ptr(), B, N, stream)
    KERNEL.launch("nms_used", modes.data_ptr(), is_center.data_ptr(),
                  used.data_ptr(), B, N, stream)
    return counts.float(), is_center > 0, used > 0
