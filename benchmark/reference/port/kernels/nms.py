# The plain versions of prifit_torch/kernels/nms.py at commit
# 0adee2a, for the benchmark's reference (the kernels' launches left
# out); see benchmark/reference/__init__.py.
"""The three distance passes of mode NMS, plain."""

import torch

from benchmark.reference.port.kernels.bandwidth import chordal_sqdist


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
    is_center [B, N] bool, used [B, N] bool)``."""
    return nms_passes_plain(modes, bw)
