# Frozen copy of prifit_torch/ops/chamfer.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""Nearest-neighbour squared distances (plain PyTorch; the copy keeps the
part of the program's chamfer module that the convex loss calls).

Port of ``prifit_tpu/ops/chamfer.py``.  The nearest neighbour is a
chunked argmin over the explicit difference form (ties to the lowest
index, invalid targets pushed out by a mask), then the value is
recomputed through the selected pair, so gradients flow through that pair
only (as the reference's KDTree + gather does).  The chunks bound the
largest temporary to ``[B, chunk, M]``.

Every function takes a batch axis where the JAX one does:
:func:`nn_squared_distance` one shape ``[N, 3]`` or a batch
``[B, N, 3]``.
"""

import torch

CHUNK = 1024
BIG = 1e10


def nn_idx_chunked(src: torch.Tensor, dst: torch.Tensor,
                   chunk: int = CHUNK,
                   dst_mask: torch.Tensor | None = None) -> torch.Tensor:
    """``argmin_m ||src[b, n] - dst[b, m]||^2`` over the valid ``m``
    (``dst_mask [B, M]``) -> ``[B, N]`` int64, in chunks of the src axis
    so ``[B, chunk, M]`` is the largest temporary."""
    out = []
    for s in torch.split(src.detach(), chunk, dim=1):
        d = None
        for c in range(s.shape[-1]):
            diff = s[:, :, None, c] - dst.detach()[:, None, :, c]
            d = diff * diff if d is None else d + diff * diff
        if dst_mask is not None:
            d = torch.where(dst_mask[:, None, :], d, torch.full_like(d, BIG))
        out.append(torch.argmin(d, dim=-1))
    return torch.cat(out, dim=1)


def _min_sqdist(src, dst, dst_mask=None, chunk: int = CHUNK):
    """``[B, N, 3] x [B, M, 3] -> [B, N]``: the squared distance to the
    nearest valid target, recomputed through the selected pair (``BIG``
    where a shape has no valid target)."""
    idx = nn_idx_chunked(src, dst, chunk, dst_mask)
    nn = torch.gather(dst, 1, idx[..., None].expand(-1, -1, dst.shape[-1]))
    d = torch.sum(torch.square(src - nn), dim=-1)
    if dst_mask is not None:
        d = torch.where(dst_mask.any(dim=1, keepdim=True), d,
                        torch.full_like(d, BIG))
    return d


def nn_squared_distance(src: torch.Tensor, dst: torch.Tensor,
                        dst_mask: torch.Tensor | None = None,
                        chunk: int = CHUNK) -> torch.Tensor:
    """Squared distance of each ``src [B, N, 3]`` point to its nearest
    ``dst [B, M, 3]`` point (among ``dst_mask [B, M]``) -> ``[B, N]``;
    unbatched ``[N, 3] x [M, 3] -> [N]`` as in the JAX package."""
    if src.dim() == 2:
        return _min_sqdist(src[None], dst[None], None if dst_mask is None
                           else dst_mask[None], chunk)[0]
    return _min_sqdist(src, dst, dst_mask, chunk)


