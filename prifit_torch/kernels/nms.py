"""The three distance passes of mode NMS: CUDA kernels (``csrc/nms.cu``)
and plain PyTorch version."""

import torch

from prifit_torch.kernels.bandwidth import chordal_sqdist
from prifit_torch.kernels.build import I32, P, Kernel, check_cuda, \
    stream_handle
from prifit_torch.kernels.shapes import padded_width

KERNEL = Kernel(
    "nms", "prifit_tpu/ops/pallas/nms.py:112",
    {"nms_counts": (P, P, I32, I32, I32, I32, P),
     "nms_centers": (P, P, P, P, I32, I32, I32, I32, P),
     "nms_used": (P, P, P, I32, I32, I32, I32, P)})


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


def nms_passes_compact_plain(modes: torch.Tensor, bw: torch.Tensor):
    """:func:`nms_passes_plain` computed as the kernels do: passes 2 and
    3 shape by shape over the listed modes only, in ascending index order
    (pass 2: the occupied rows against the occupied columns, with rep 0
    where every score is 0; pass 3: every row against the center
    columns).  Equal to :func:`nms_passes_plain` wherever the distances
    of the sub-products round as those of the full one; for the tests."""
    B, N, _ = modes.shape
    assign = torch.argmin(chordal_sqdist(modes, modes), dim=-1)
    counts = torch.zeros((B, N), dtype=torch.float32, device=modes.device)
    counts.scatter_add_(1, assign, torch.ones_like(counts))
    is_center = torch.zeros((B, N), dtype=torch.bool, device=modes.device)
    used = torch.zeros_like(is_center)
    for b in range(B):
        occ = torch.nonzero(counts[b] > 0)[:, 0]
        m = modes[b, occ]
        score = torch.where(chordal_sqdist(m, m) < bw[b], counts[b, occ],
                            0.0)
        rep = occ[torch.argmax(score, dim=-1)]
        is_center[b, torch.where(score.amax(-1) > 0, rep, 0)] = True
        cen = torch.nonzero(is_center[b])[:, 0]
        label = torch.argmin(chordal_sqdist(modes[b], modes[b, cen]), dim=-1)
        used[b, cen[label]] = True
    return counts, is_center, used


def nms_passes(modes: torch.Tensor, bw: torch.Tensor):
    """``modes [B, N, D]`` unit rows, ``bw [B]`` -> ``(counts [B, N] f32,
    is_center [B, N] bool, used [B, N] bool)``.

    Launches the three kernels for a CUDA tensor, which write these
    outputs in place (one zero fill of one buffer before them); a CPU
    tensor takes the plain version.  Raises ``ValueError`` for D > 128 or
    N > 8192 (``shapes.padded_width``)."""
    if modes.device.type == "cpu":
        return nms_passes_plain(modes, bw)
    check_cuda("nms modes", modes, torch.float32, 3)
    check_cuda("nms bw", bw, torch.float32, 1)
    B, N, d = modes.shape
    if bw.shape[0] != B:
        raise ValueError(f"nms: mismatched shapes {tuple(modes.shape)} / "
                         f"{tuple(bw.shape)}")
    dp = padded_width("nms", N, d)
    out = torch.zeros(6 * B * N, dtype=torch.uint8, device=modes.device)
    counts = out[:4 * B * N].view(torch.float32).view(B, N)
    is_center = out[4 * B * N:5 * B * N].view(torch.bool).view(B, N)
    used = out[5 * B * N:].view(torch.bool).view(B, N)
    stream = stream_handle(modes)
    KERNEL.launch("nms_counts", modes.data_ptr(), counts.data_ptr(), B, N,
                  d, dp, stream)
    KERNEL.launch("nms_centers", modes.data_ptr(), counts.data_ptr(),
                  bw.data_ptr(), is_center.data_ptr(), B, N, d, dp, stream)
    KERNEL.launch("nms_used", modes.data_ptr(), is_center.data_ptr(),
                  used.data_ptr(), B, N, d, dp, stream)
    return counts, is_center, used
