"""Batched row gather: CUDA kernel (``csrc/gather.cu``), plain PyTorch
version, and the autograd function whose backward is the scatter-add
transpose."""

import torch

from prifit_torch.kernels.build import I32, P, Kernel, check_cuda, \
    stream_handle

KERNEL = Kernel(
    "gather", "prifit_tpu/ops/pallas/gather.py:116",
    {"gather_rows_i32": (P, P, P, I32, I32, I32, I32, P),
     "gather_rows_i64": (P, P, P, I32, I32, I32, I32, P)})
ENTRY = {torch.int32: "gather_rows_i32", torch.int64: "gather_rows_i64"}
LIMIT = 2 ** 31  # bytes of a shape's table and of its output


def gather_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, ...] = points[b, idx[b, ...], :]``."""
    B = points.shape[0]
    flat = idx.reshape(B, -1).long()
    out = points[torch.arange(B, device=points.device)[:, None], flat]
    return out.reshape(idx.shape + points.shape[2:])


def gather_fwd(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather alone, with no autograd: the kernel for a CUDA tensor,
    the plain version for a CPU tensor.  The kernel reads ``idx`` in its
    own type, int32 or int64, with no copy when it is contiguous."""
    if points.device.type == "cpu":
        return gather_plain(points, idx)
    check_cuda("gather points", points, ndim=3, align=2)
    B, N, C = points.shape
    row_bytes = C * points.element_size()
    R = idx.numel() // B if B else 0
    if (idx.device != points.device or idx.dtype not in ENTRY
            or idx.shape[0] != B or row_bytes % 2
            or N * row_bytes >= LIMIT or R * row_bytes >= LIMIT):
        raise ValueError(f"gather: unsupported table {tuple(points.shape)}"
                         f" {points.dtype} / index {tuple(idx.shape)} "
                         f"{idx.dtype} on {idx.device}")
    idx = idx.contiguous()
    out = torch.empty(idx.shape + (C,), dtype=points.dtype,
                      device=points.device)
    KERNEL.launch(ENTRY[idx.dtype], points.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), B, N, R, row_bytes, stream_handle(points))
    return out


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
    version.  The backward is the f32 scatter-add on both; where no
    gradient is wanted the call skips the autograd function's host work."""
    if torch.is_grad_enabled() and points.requires_grad:
        return GatherRows.apply(points, idx)
    return gather_fwd(points, idx)
