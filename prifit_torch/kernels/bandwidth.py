"""K-th nearest chordal distance: CUDA kernel (``csrc/bandwidth.cu``, a
radix select over the bisection's integer keys) and plain PyTorch version
(the counting bisection, its oracle)."""

import torch

from prifit_torch.kernels.build import I32, P, Kernel, check_cuda, \
    stream_handle
from prifit_torch.kernels.shapes import padded_width

KERNEL = Kernel(
    "bandwidth", "prifit_tpu/ops/pallas/bandwidth.py:69",
    {"kth_nn_distance": (P, P, I32, I32, I32, I32, I32, I32, I32, I32, I32,
                         I32, P)})

RANKS_PER_LAUNCH = 4
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
    smallest squared chordal distance of each row, for each rank.

    Launches the kernel for a CUDA tensor, once for every 4 ranks; a CPU
    tensor takes the plain version.  Raises ``ValueError`` for D > 128 or
    N > 8192 (``shapes.padded_width``)."""
    ks = [int(k) for k in ks]
    if X.device.type == "cpu":
        return kth_nn_plain(X, ks)
    check_cuda("bandwidth X", X, torch.float32, 3)
    B, N, d = X.shape
    dp = padded_width("bandwidth", N, d)
    out = torch.empty((B, len(ks), N), dtype=torch.float32,
                      device=X.device)
    stream = stream_handle(X)
    for c0 in range(0, len(ks), RANKS_PER_LAUNCH):
        group = ks[c0:c0 + RANKS_PER_LAUNCH]
        kk = group + [0] * (RANKS_PER_LAUNCH - len(group))
        KERNEL.launch("kth_nn_distance", X.data_ptr(), out[:, c0].data_ptr(),
                      len(ks) * N, B, N, d, dp, len(group), *kk, stream)
    return out
