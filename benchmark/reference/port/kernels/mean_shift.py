# The plain versions of prifit_torch/kernels/mean_shift.py at commit
# 0adee2a, for the benchmark's reference (the kernels' launches left
# out); see benchmark/reference/__init__.py.
"""One Gaussian mean-shift step and its closed-form backward, plain, and
the autograd function that joins them."""

import torch

from benchmark.reference.port.kernels.bandwidth import chordal_sqdist
from benchmark.reference.port.utils.guard import EXP_HI, EXP_LO, guard_exp


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


def mean_shift_step_fwd(q: torch.Tensor, X: torch.Tensor,
                        bw2: torch.Tensor):
    """The forward alone, with no autograd.  Returns ``(m, s)``."""
    return mean_shift_step_plain(q, X, bw2)


def mean_shift_step_bwd(q, X, bw2, m, s, g):
    """``(dq, dX)`` for the cotangent ``g [B, N, D]`` of ``m``."""
    return mean_shift_step_bwd_plain(q, X, bw2, m, s, g)


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
    ``X``."""
    return MeanShiftStep.apply(q, X, bw2)
