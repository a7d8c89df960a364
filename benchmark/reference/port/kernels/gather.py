# The plain versions of prifit_torch/kernels/gather.py at commit
# 0adee2a, for the benchmark's reference (the kernels' launches left
# out); see benchmark/reference/__init__.py.
"""Batched row gather, plain, and the autograd function whose backward is
the scatter-add transpose."""

import torch


def gather_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, ...] = points[b, idx[b, ...], :]``."""
    B = points.shape[0]
    flat = idx.reshape(B, -1).long()
    out = points[torch.arange(B, device=points.device)[:, None], flat]
    return out.reshape(idx.shape + points.shape[2:])


def gather_fwd(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather alone, with no autograd."""
    return gather_plain(points, idx)


def scatter_accumulate(n: int, idx: torch.Tensor, g: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """The gather's transpose: ``out[b, i] = sum of g[b, p]`` over the
    positions ``p`` with ``idx[b, p] == i``, accumulated in f32 into a
    ``[B * n, C]`` buffer and cast to ``dtype`` (the JAX package's
    ``scatter_accumulate(exact_grad=True)``).  On the card ``index_add_``
    adds with atomics, so the f32 sums come out in a varying order."""
    B, C = idx.shape[0], g.shape[-1]
    rows = idx.reshape(B, -1).long() + n * torch.arange(
        B, device=idx.device)[:, None]
    out = torch.zeros((B * n, C), dtype=torch.float32, device=g.device)
    out.index_add_(0, rows.reshape(-1), g.reshape(-1, C).float())
    return out.view(B, n, C).to(dtype)


class GatherRows(torch.autograd.Function):
    """:func:`gather_fwd` with :func:`scatter_accumulate` as its backward,
    on either device."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n, ctx.dtype = points.shape[1], points.dtype
        return gather_fwd(points, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_accumulate(ctx.n, idx, g, ctx.dtype), None


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points [B, N, C]`` (any dtype), ``idx [B, ...]`` ->
    ``[B, ..., C]``, bit-exact, differentiable in ``points``.

    The backward is the f32 scatter-add; where no gradient is wanted the
    call skips the autograd function."""
    if torch.is_grad_enabled() and points.requires_grad:
        return GatherRows.apply(points, idx)
    return gather_fwd(points, idx)
