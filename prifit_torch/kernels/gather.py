"""Batched row gather: CUDA kernel (``csrc/gather.cu``) and plain PyTorch
version."""

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


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points [B, N, C]`` (any dtype), ``idx [B, ...]`` ->
    ``[B, ..., C]``, bit-exact.

    Launches the kernel for a CUDA tensor; a CPU tensor takes the plain
    version."""
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
