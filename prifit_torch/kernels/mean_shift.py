"""One Gaussian mean-shift step and its backward: CUDA kernels
(``csrc/mean_shift.cu``, ``csrc/mean_shift_bwd.cu``), their plain PyTorch
versions, and the autograd function that joins them."""

import torch

from prifit_torch.kernels.bandwidth import chordal_sqdist
from prifit_torch.kernels.build import I32, P, Kernel, check_cuda, \
    stream_handle
from prifit_torch.kernels.shapes import padded_width
from prifit_torch.utils.guard import EXP_HI, EXP_LO, guard_exp

KERNEL = Kernel(
    "mean_shift", "prifit_tpu/ops/pallas/mean_shift.py:158",
    {"mean_shift_forward": (P, P, P, P, P, I32, I32, I32, I32, P)})
BWD_KERNEL = Kernel(
    "mean_shift_bwd", "prifit_tpu/ops/pallas/mean_shift.py:176",
    {"mean_shift_backward": (P, P, P, P, P, P, P, P, P, P, P, I32, I32,
                             I32, I32, P)})


def _exponent(q: torch.Tensor, X: torch.Tensor, bw2: torch.Tensor):
    """The plain step's exponent ``-(2 - 2 q.x) / b^2 / 2`` (the kernels'
    ``(sim - 1) / b^2`` is the same value, rounded differently)."""
    return -chordal_sqdist(q, X) / bw2[:, None, None] / 2.0


def mean_shift_step_plain(q: torch.Tensor, X: torch.Tensor,
                          bw2: torch.Tensor):
    """The jnp step of ``clustering/mean_shift.py:192-203`` in the JAX
    package: ``K = guard_exp(-(2 - 2 q.x) / b^2 / 2)``, ``s = sum_j K``,
    ``m = (K X) * (1 / s)``.  Returns ``(m, s)``."""
    K = guard_exp(_exponent(q, X, bw2))
    s = K.sum(dim=-1)
    m = torch.matmul(K, X) * (1.0 / s)[..., None]
    return m, s


def mean_shift_step_bwd_plain(q, X, bw2, m, s, g):
    """The closed-form backward of :func:`mean_shift_step_plain` for the
    cotangent ``g`` of ``m`` (``ops/pallas/mean_shift.py:15-26`` in the JAX
    package), materializing ``[B, N, N]``:

        c_i  = g_i . m_i
        t_ij = K_ij (g_i . x_j - c_i) / (s_i b^2), 0 where the exponent
               clamped
        dq_i = sum_j t_ij x_j
        dX_j = sum_i t_ij q_i + sum_i (K_ij / s_i) g_i

    Returns ``(dq, dX)``; ``b^2`` gets no gradient."""
    e = _exponent(q, X, bw2)
    K = torch.exp(torch.clamp(e, EXP_LO, EXP_HI))
    c = torch.sum(g * m, dim=-1)
    gx = torch.matmul(g, X.transpose(-1, -2))
    t = K * (gx - c[..., None]) / (s[..., None] * bw2[:, None, None])
    t = torch.where((e > EXP_LO) & (e < EXP_HI), t, torch.zeros_like(t))
    dq = torch.matmul(t, X)
    dX = torch.matmul(t.transpose(-1, -2), q) + torch.matmul(
        (K / s[..., None]).transpose(-1, -2), g)
    return dq, dX


def live_rows(g: torch.Tensor):
    """The live rows of a cotangent ``g [B, N, D]``, those with a nonzero
    entry, as the backward kernel takes them: ``order [B, N]`` int32, each
    shape's live rows first in ascending id, then the others, and ``count
    [B]`` int32.  A row that is not live adds exactly nothing to the
    backward (``c_i = 0``, ``t_ij = 0``).  Device ops only: ``count`` is
    never read on the host, so no synchronization."""
    live = (g != 0).any(dim=-1)
    order = torch.argsort(live.logical_not().to(torch.uint8), dim=-1,
                          stable=True).to(torch.int32)
    return order, live.sum(dim=-1, dtype=torch.int32)


def _check_shapes(q, X, bw2) -> int:
    """Raises unless the kernels take these tensors; returns the padded
    width."""
    for name, t in (("q", q), ("X", X)):
        check_cuda(f"mean_shift {name}", t, torch.float32, 3)
    check_cuda("mean_shift bw2", bw2, torch.float32, 1)
    B, N, d = X.shape
    if q.shape != X.shape or bw2.shape[0] != B:
        raise ValueError(f"mean_shift: mismatched shapes {tuple(q.shape)}"
                         f" / {tuple(X.shape)} / {tuple(bw2.shape)}")
    return padded_width("mean_shift", N, d)


def mean_shift_step_fwd(q: torch.Tensor, X: torch.Tensor,
                        bw2: torch.Tensor):
    """The forward alone, with no autograd: the kernel for a CUDA tensor,
    the plain version for a CPU tensor.  Returns ``(m, s)``."""
    if q.device.type == "cpu":
        return mean_shift_step_plain(q, X, bw2)
    dp = _check_shapes(q, X, bw2)
    B, N, d = X.shape
    m = torch.empty_like(X)
    s = torch.empty((B, N), dtype=torch.float32, device=X.device)
    KERNEL.launch("mean_shift_forward", q.data_ptr(), X.data_ptr(),
                  bw2.data_ptr(), m.data_ptr(), s.data_ptr(), B, N, d, dp,
                  stream_handle(X))
    return m, s


def mean_shift_step_bwd(q, X, bw2, m, s, g):
    """``(dq, dX)`` for the cotangent ``g [B, N, D]`` of ``m``: the
    backward kernel for CUDA tensors, over the live rows of ``g`` only
    (:func:`live_rows`), the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return mean_shift_step_bwd_plain(q, X, bw2, m, s, g)
    dp = _check_shapes(q, X, bw2)
    for name, t in (("m", m), ("g", g)):
        check_cuda(f"mean_shift_bwd {name}", t, torch.float32, 3)
    check_cuda("mean_shift_bwd s", s, torch.float32, 2)
    if m.shape != X.shape or g.shape != X.shape or s.shape != X.shape[:2]:
        raise ValueError(f"mean_shift_bwd: mismatched shapes "
                         f"{tuple(m.shape)} / {tuple(s.shape)} / "
                         f"{tuple(g.shape)}")
    B, N, d = X.shape
    dq = torch.empty_like(X)
    dX = torch.empty_like(X)
    c = torch.empty((B, N), dtype=torch.float32, device=X.device)
    order, count = live_rows(g)
    BWD_KERNEL.launch("mean_shift_backward", q.data_ptr(), X.data_ptr(),
                      bw2.data_ptr(), m.data_ptr(), s.data_ptr(),
                      g.data_ptr(), order.data_ptr(), count.data_ptr(),
                      c.data_ptr(), dq.data_ptr(), dX.data_ptr(), B, N, d,
                      dp, stream_handle(X))
    return dq, dX


class MeanShiftStep(torch.autograd.Function):
    """The step with its closed-form backward (the custom VJP of
    ``mean_shift_step_pallas``): gradients to ``q`` and ``X``, none to
    ``bw2``, and ``s`` non-differentiable."""

    @staticmethod
    def forward(ctx, q, X, bw2):
        m, s = mean_shift_step_fwd(q, X, bw2)
        ctx.save_for_backward(q, X, bw2, m, s)
        ctx.mark_non_differentiable(s)
        return m, s

    @staticmethod
    def backward(ctx, gm, _gs):
        q, X, bw2, m, s = ctx.saved_tensors
        dq, dX = mean_shift_step_bwd(q, X, bw2, m, s, gm.contiguous())
        return dq, dX, None


def mean_shift_step(q: torch.Tensor, X: torch.Tensor, bw2: torch.Tensor):
    """``q, X [B, N, D]`` unit rows, ``bw2 [B]`` squared bandwidths ->
    ``(m [B, N, D], s [B, N])``: the unnormalized kernel-weighted mean of
    each row of ``q`` and its kernel row sum, differentiable in ``q`` and
    ``X``.

    Launches the forward kernel for a CUDA tensor (and the backward kernel
    when a gradient is taken); a CPU tensor takes the plain versions.
    Raises ``ValueError`` for D > 128 or N > 8192
    (``shapes.padded_width``)."""
    return MeanShiftStep.apply(q, X, bw2)
