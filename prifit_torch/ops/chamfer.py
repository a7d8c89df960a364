"""Nearest-neighbour squared distance, chunked (plain PyTorch).

Port of ``prifit_tpu/ops/chamfer.py`` (``_nn_idx_chunked``,
``_min_sqdist_chunked``, ``nn_squared_distance``): a chunked argmin over
the explicit difference form (ties to the lowest index), then the value
recomputed through the selected pair, so gradients flow through that pair
only.
"""

import torch

CHUNK = 1024


def nn_idx_chunked(src: torch.Tensor, dst: torch.Tensor,
                   chunk: int = CHUNK) -> torch.Tensor:
    """``argmin_m ||src[b, n] - dst[b, m]||^2`` -> ``[B, N]`` int64, in
    chunks of the src axis so ``[B, chunk, M]`` is the largest temporary."""
    out = []
    for s in torch.split(src.detach(), chunk, dim=1):
        d = None
        for c in range(s.shape[-1]):
            diff = s[:, :, None, c] - dst.detach()[:, None, :, c]
            d = diff * diff if d is None else d + diff * diff
        out.append(torch.argmin(d, dim=-1))
    return torch.cat(out, dim=1)


def nn_squared_distance(src: torch.Tensor, dst: torch.Tensor,
                        chunk: int = CHUNK) -> torch.Tensor:
    """Squared distance of each ``src [B, N, 3]`` point to its nearest
    ``dst [B, M, 3]`` point -> ``[B, N]``."""
    idx = nn_idx_chunked(src, dst, chunk)
    nn = torch.gather(dst, 1, idx[..., None].expand(-1, -1, dst.shape[-1]))
    return torch.sum(torch.square(src - nn), dim=-1)
