"""Batched row gather: CUDA kernel (``csrc/gather.cu``), plain PyTorch
version, and the autograd function whose backward is the scatter-add
transpose."""

import torch

from prifit_torch.kernels.build import I32, I64, P, Kernel, check_cuda, \
    stream_handle

KERNEL = Kernel(
    "gather", "prifit_tpu/ops/pallas/gather.py:116",
    {"gather_rows": (P, P, P, I32, I32, I64, I32, P)})


def gather_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, ...] = points[b, idx[b, ...], :]``."""
    B = points.shape[0]
    flat = idx.reshape(B, -1).long()
    out = points[torch.arange(B, device=points.device)[:, None], flat]
    return out.reshape(idx.shape + points.shape[2:])


def gather_fwd(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather alone, with no autograd: the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if points.device.type == "cpu":
        return gather_plain(points, idx)
    check_cuda("gather points", points, ndim=3, align=2)
    B, N, C = points.shape
    row_bytes = C * points.element_size()
    if idx.device != points.device or idx.shape[0] != B or row_bytes % 2:
        raise ValueError(f"gather: unsupported table {tuple(points.shape)}"
                         f" {points.dtype} / index {tuple(idx.shape)} on "
                         f"{idx.device}")
    flat = idx.reshape(B, -1).to(torch.int32).contiguous()
    R = flat.shape[1]
    out = torch.empty((B, R, C), dtype=points.dtype, device=points.device)
    KERNEL.launch("gather_rows", points.data_ptr(), flat.data_ptr(),
                  out.data_ptr(), B, N, R, row_bytes, stream_handle(points))
    return out.reshape(idx.shape + (C,))


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

    Launches the kernel for a CUDA tensor; a CPU tensor takes the plain
    version.  The backward is the f32 scatter-add on both."""
    return GatherRows.apply(points, idx)
