"""Chamfer distances (plain PyTorch).

Port of ``prifit_tpu/ops/chamfer.py``.  The nearest neighbour is a
chunked argmin over the explicit difference form (ties to the lowest
index, invalid targets pushed out by a mask), then the value is
recomputed through the selected pair, so gradients flow through that pair
only (as the reference's KDTree + gather does).  The chunks bound the
largest temporary to ``[B, chunk, M]``.

Every function takes a batch axis where the JAX one does: the chamfer
family ``[B, N, 3]``; :func:`nn_squared_distance` and
:func:`chamfer_distance_single_shape` one shape ``[N, 3]`` (or a batch
``[B, N, 3]`` for the first).
"""

import torch

from prifit_torch.utils.guard import guard_sqrt

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


def _masked_mean(x: torch.Tensor, mask: torch.Tensor | None):
    """Mean of ``x [B, N]`` over the valid entries of each row -> ``[B]``."""
    if mask is None:
        return x.mean(dim=1)
    m = mask.to(x.dtype)
    return torch.sum(x * m, dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)


def chamfer_distance(pred: torch.Tensor, gt: torch.Tensor,
                     sqrt: bool = False,
                     pred_mask: torch.Tensor | None = None,
                     gt_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Symmetric chamfer of ``pred [B, N, 3]`` and ``gt [B, M, 3]``: per
    shape the masked mean over each side of the (``sqrt``: guarded root
    of the) squared distance to the other side's nearest valid point, the
    two sides added; the mean over the batch, halved."""
    pm = None if pred_mask is None else pred_mask.bool()
    gm = None if gt_mask is None else gt_mask.bool()
    d_pg = _min_sqdist(pred, gt, gm)
    d_gp = _min_sqdist(gt, pred, pm)
    if sqrt:
        d_pg, d_gp = guard_sqrt(d_pg), guard_sqrt(d_gp)
    return torch.mean(_masked_mean(d_pg, pm) + _masked_mean(d_gp, gm)) / 2.0


def chamfer_distance_one_side(pred: torch.Tensor, gt: torch.Tensor,
                              side: int = 1) -> torch.Tensor:
    """One-sided chamfer, the mean over the batch: ``side=0`` from each
    ``gt`` point to the nearest ``pred``, ``side=1`` from each ``pred``
    point to the nearest ``gt``."""
    if side == 0:
        return torch.mean(_min_sqdist(gt, pred).mean(dim=1))
    return torch.mean(_min_sqdist(pred, gt).mean(dim=1))


def chamfer_distance_single_shape(pred: torch.Tensor, gt: torch.Tensor,
                                  one_side: bool = False,
                                  sqrt: bool = False, reduce: bool = True):
    """Chamfer of one shape, ``pred [N, 3]`` and ``gt [M, 3]``: the mean
    of the two sides, halved (``one_side``: only the gt -> pred side);
    without ``reduce`` the per-point distances (both sides as a pair)."""
    d_pg = _min_sqdist(pred[None], gt[None])[0]
    d_gp = _min_sqdist(gt[None], pred[None])[0]
    if sqrt:
        d_pg, d_gp = guard_sqrt(d_pg), guard_sqrt(d_gp)
    if one_side:
        return torch.mean(d_gp) if reduce else d_gp
    if reduce:
        return (torch.mean(d_pg) + torch.mean(d_gp)) / 2.0
    return d_pg, d_gp


def chamfer_distance_pairwise_batch(source: torch.Tensor,
                                    target: torch.Tensor,
                                    sqrt: bool = False) -> torch.Tensor:
    """Symmetric chamfer per shape of ``source [B, N, 3]`` and ``target
    [B, M, 3]`` (the mean of the two sides, halved), the mean over the
    batch (the reference's KDTree chamfer)."""
    d_ts = _min_sqdist(target, source)
    d_st = _min_sqdist(source, target)
    if sqrt:
        d_ts, d_st = guard_sqrt(d_ts), guard_sqrt(d_st)
    return torch.mean((d_ts.mean(dim=1) + d_st.mean(dim=1)) / 2.0)
