"""One Gaussian mean-shift step: CUDA kernel (``csrc/mean_shift.cu``) and
plain PyTorch version."""

import torch

from prifit_torch.kernels.bandwidth import chordal_sqdist
from prifit_torch.kernels.build import I32, P, Kernel, check_cuda, \
    stream_handle
from prifit_torch.utils.guard import guard_exp

KERNEL = Kernel(
    "mean_shift", "prifit_tpu/ops/pallas/mean_shift.py:158",
    {"mean_shift_forward": (P, P, P, P, P, I32, I32, P)})

D = 128        # embedding width the kernel takes
ROW_TILE = 32  # N must be a multiple of this


def mean_shift_step_plain(q: torch.Tensor, X: torch.Tensor,
                          bw2: torch.Tensor):
    """The jnp step of ``clustering/mean_shift.py:192-203`` in the JAX
    package (the kernel's ``(sim - 1) / b^2`` exponent is the same value,
    rounded differently): ``K = guard_exp(-(2 - 2 q.x) / b^2 / 2)``,
    ``s = sum_j K``, ``m = (K X) * (1 / s)``.  Returns ``(m, s)``."""
    dist = chordal_sqdist(q, X)
    K = guard_exp(-dist / bw2[:, None, None] / 2.0)
    s = K.sum(dim=-1)
    m = torch.matmul(K, X) * (1.0 / s)[..., None]
    return m, s


def mean_shift_step(q: torch.Tensor, X: torch.Tensor, bw2: torch.Tensor):
    """``q, X [B, N, D]`` unit rows, ``bw2 [B]`` squared bandwidths ->
    ``(m [B, N, D], s [B, N])``: the unnormalized kernel-weighted mean of
    each row of ``q`` and its kernel row sum.

    Launches the kernel for a CUDA tensor; a CPU tensor takes the plain
    version."""
    if q.device.type == "cpu":
        return mean_shift_step_plain(q, X, bw2)
    for name, t in (("q", q), ("X", X)):
        check_cuda(f"mean_shift {name}", t, torch.float32, 3)
    check_cuda("mean_shift bw2", bw2, torch.float32, 1)
    if torch.is_grad_enabled() and (q.requires_grad or X.requires_grad):
        raise NotImplementedError(
            "mean_shift: the backward kernel is not ported yet; run the "
            "CUDA forward under torch.no_grad()")
    B, N, d = X.shape
    if q.shape != X.shape or bw2.shape[0] != B or d != D or N % ROW_TILE:
        raise ValueError(f"mean_shift: unsupported shapes {tuple(q.shape)}"
                         f" / {tuple(X.shape)} / {tuple(bw2.shape)}")
    m = torch.empty_like(X)
    s = torch.empty((B, N), dtype=torch.float32, device=X.device)
    KERNEL.launch("mean_shift_forward", q.data_ptr(), X.data_ptr(),
                  bw2.data_ptr(), m.data_ptr(), s.data_ptr(), B, N,
                  stream_handle(X))
    return m, s
