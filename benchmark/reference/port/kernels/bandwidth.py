# The plain versions of prifit_torch/kernels/bandwidth.py at commit
# 0adee2a, for the benchmark's reference (the kernels' launches left
# out); see benchmark/reference/__init__.py.
"""K-th nearest chordal distance: the counting bisection (the plain
version of the program's radix-select kernel)."""

import torch


ITERS = 24


def chordal_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``2 - 2 <a, b>`` for unit rows (squared chordal distance),
    batched: ``[..., N, D] x [..., M, D] -> [..., N, M]``."""
    return 2.0 - 2.0 * torch.matmul(a, b.transpose(-1, -2))


def kth_smallest_bisect(dist: torch.Tensor, ks, iters: int = ITERS
                        ) -> torch.Tensor:
    """``clustering/mean_shift.py::_kth_smallest_bisect`` of the JAX
    package, batched: ``dist [B, N, M]`` (values in [0, 4]) ->
    ``[B, C, N]``, keeping ``count(d <= mid) >= K`` and returning ``hi``."""
    B, N, _ = dist.shape
    kt = torch.tensor(list(ks), device=dist.device)[None, :, None]
    lo = torch.zeros((B, len(ks), N), dtype=torch.float32,
                     device=dist.device)
    hi = torch.full_like(lo, 4.0)
    for _ in range(iters):
        mid = (lo + hi) / 2.0
        cnt = (dist[:, None] <= mid[..., None]).sum(-1)
        ge = cnt >= kt
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    return hi


def kth_nn_plain(X: torch.Tensor, ks) -> torch.Tensor:
    return kth_smallest_bisect(chordal_sqdist(X, X), ks)


def kth_nn_distance(X: torch.Tensor, ks) -> torch.Tensor:
    """``X [B, N, D]`` unit rows, ``ks`` ranks -> ``[B, C, N]`` K-th
    smallest squared chordal distance of each row, for each rank."""
    ks = [int(k) for k in ks]
    return kth_nn_plain(X, ks)
