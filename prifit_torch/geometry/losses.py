"""Self-supervision losses over fitted primitives.

Port of ``prifit_tpu/geometry/losses.py``, batched over shapes with
static slot counts and validity masks:

  - ``entropy_loss``: the embedding-similarity regularizer;
  - ``analytic_chamfer``: SDF / nearest-neighbour chamfer against the
    target cloud;
  - ``intersection_loss``: the overlap penalty the convex loss uses
    (mean squared clamped SDF of each point to every valid primitive but
    the one it belongs to), and the variants the JAX package exports
    beside it (``intersection_loss_surface``, ``intersection_loss_volume``
    with ``sample_axis``, ``intersection_loss_v2``,
    ``intersection_loss_v4``);
  - ``prune_mask``: the no-gradient mask of samples on or near the union
    surface.

Under data parallelism ``group`` (the data axis's process group) makes
each mean over shapes a mean over the global batch, replicated on every
rank (:mod:`prifit_torch.parallel.collectives`), as the JAX package's
partitioner computes it.
"""

import torch

from prifit_torch.geometry.fitting import PrimitiveParams
from prifit_torch.parallel.collectives import group_size, psum
from prifit_torch.geometry.sdf import sdf_primitives
from prifit_torch.ops.chamfer import nn_squared_distance


def _mean_over(losses: torch.Tensor, has: torch.Tensor,
               group=None) -> torch.Tensor:
    """Per-shape ``losses [B]`` zeroed where ``has [B]`` is False, summed
    and divided by the number of shapes that have it (at least 1), over
    the ranks of ``group``."""
    num = psum(torch.where(has, losses, torch.zeros_like(losses)).sum(),
               group)
    return num / torch.clamp_min(psum(has.sum().to(num.dtype), group), 1.0)


def _where_valid(valid, x, fill):
    """``x [B, M, K]`` where slot ``valid [B, K]``, else ``fill``."""
    return torch.where(valid[:, None, :], x, torch.full_like(x, fill))


def entropy_loss(X: torch.Tensor, margin: float = 1.8,
                 group=None) -> torch.Tensor:
    """``relu(mean_b[sum((1 + X_b X_b^T)^2) / n^2] - margin)`` of unit-norm
    embeddings ``X [B, n, D]`` (the mean over the ranks of ``group``):
    pushes identical embeddings apart so that the convex loss has clusters
    to find."""
    n = X.shape[1]
    sim = torch.matmul(X, X.transpose(1, 2))
    l = torch.sum((1.0 + sim) ** 2, dim=(1, 2)) / (n * n)
    if group_size(group) == 1:
        return torch.relu(torch.mean(l) - margin)
    return torch.relu(psum(l.sum(), group) / (l.shape[0] * group_size(group))
                      - margin)


def analytic_chamfer(params: PrimitiveParams, samples: torch.Tensor,
                     sample_w: torch.Tensor, target: torch.Tensor,
                     cuboid: bool = False, group=None) -> torch.Tensor:
    """Target side: mean over target points of ``(min_k |sdf_k|)^2``;
    source side: area-weighted mean over primitive samples of the squared
    distance to the nearest target point; per shape their average, then
    the mean over shapes with at least one valid primitive (0 if none).

    ``params [B, K, ...]``, ``samples [B, S, 3]``, ``sample_w [B, S]``,
    ``target [B, M, 3]``."""
    sdf = sdf_primitives(target, params.r, params.V, params.center, cuboid)
    asdf = _where_valid(params.valid, torch.abs(sdf), float("inf"))
    d_ts = torch.amin(asdf, dim=-1) ** 2                     # [B, M]
    d_st = nn_squared_distance(samples, target)              # [B, S]
    w_sum = torch.clamp_min(sample_w.sum(-1), 1e-12)
    mean_st = torch.sum(d_st * sample_w, dim=-1) / w_sum
    has = params.valid.any(-1)
    mean_ts = torch.mean(torch.where(has[:, None], d_ts,
                                     torch.zeros_like(d_ts)), dim=-1)
    return _mean_over((mean_st + mean_ts) / 2.0, has, group)


def clamped_sdf_owner(params: PrimitiveParams, points: torch.Tensor,
                      cuboid: bool = False, clamp: float = -1e-3):
    """Each point's SDF to each slot clamped from above at ``clamp``
    (``[B, M, K]``), and the valid slot of least clamped SDF it belongs to
    (``[B, M]``), the first of a tie: every slot a point lies outside of
    reads exactly ``clamp``, so ties are the rule."""
    sdf = sdf_primitives(points, params.r, params.V, params.center, cuboid)
    sdf = torch.minimum(sdf, sdf.new_full((), clamp))
    own = torch.argmin(_where_valid(params.valid, sdf, float("inf")),
                       dim=-1)
    return sdf, own


def intersection_loss(params: PrimitiveParams, points: torch.Tensor,
                      cuboid: bool = False, clamp: float = -1e-3,
                      group=None) -> torch.Tensor:
    """Primitive overlap penalty at ``points [B, M, 3]``: per point the
    mean clamped SDF (:func:`clamped_sdf_owner`) over the valid slots but
    its own, squared, averaged over the points; then the mean over shapes
    with more than one valid slot (0 if none)."""
    sdf, own = clamped_sdf_owner(params, points, cuboid, clamp)
    slots = torch.arange(sdf.shape[-1], device=own.device)
    others = (params.valid[:, None, :]
              & (own[..., None] != slots)).to(sdf.dtype)  # [B, M, K]
    denom = torch.clamp_min(others.sum(-1), 1.0)
    mean_others = torch.sum(sdf * others, dim=-1) / denom    # [B, M]
    loss = torch.mean(mean_others ** 2, dim=-1)
    return _mean_over(loss, params.valid.sum(-1) > 1, group)


def sample_axis(r: torch.Tensor, V: torch.Tensor, center: torch.Tensor,
                num_samples: int = 40):
    """``num_samples`` points along each principal axis of primitives
    ``r [..., 3]``, ``V [..., 3, 3]``, ``center [..., 3]``, at
    ``linspace(-0.9, 0.897)`` of its half-length, with no-gradient weights
    ``r_a / sum(r)`` -> ``(points [..., 3 S, 3], weights [..., 3 S])``,
    axis by axis."""
    ratios = torch.linspace(-0.9, 0.897, num_samples, device=r.device)
    scaled_axes = (V * r[..., None, :]).transpose(-1, -2)   # rows: axes
    pts = ratios[:, None] * scaled_axes[..., :, None, :]    # [..., 3, S, 3]
    pts = pts.flatten(-3, -2) + center[..., None, :]
    rs = r.detach()
    w = rs / torch.clamp_min(rs.sum(-1, keepdim=True), 1e-12)
    return pts, w.repeat_interleave(num_samples, dim=-1)


def intersection_loss_surface(params: PrimitiveParams, samples, sample_w,
                              cuboid: bool = False, clamp: float = -1e-3
                              ) -> torch.Tensor:
    """Surface-sample overlap penalty: per shape the squared weighted mean
    of the min SDF over the valid slots at its primitive surface samples
    ``samples [B, S, 3]`` (``sample_w [B, S]``), clamped from above; the
    mean over shapes with a valid slot."""
    sdf = sdf_primitives(samples, params.r, params.V, params.center, cuboid)
    m = torch.amin(_where_valid(params.valid, sdf, float("inf")), dim=-1)
    m = torch.minimum(m, m.new_full((), clamp))
    w_sum = torch.clamp_min(sample_w.sum(-1), 1e-12)
    mean = torch.sum(m * sample_w, -1) / w_sum
    return _mean_over(mean ** 2, params.valid.any(-1))


def intersection_loss_volume(params: PrimitiveParams,
                             num_axis_samples: int = 40,
                             clamp: float = -1e-3) -> torch.Tensor:
    """Axis-sample overlap penalty (ellipsoids): for each valid slot,
    the weighted mean over its :func:`sample_axis` points of their min SDF
    to every OTHER valid slot, clamped from above; per shape the sum of
    their squares over the valid count; the mean over shapes with more
    than one valid slot."""
    B, K = params.valid.shape
    S = 3 * num_axis_samples
    pts, w = sample_axis(params.r, params.V, params.center,
                         num_axis_samples)                 # [B, K, S, ...]
    w = w * params.valid[..., None]
    sdf = sdf_primitives(pts.reshape(B, K * S, 3), params.r, params.V,
                         params.center).reshape(B, K, S, K)
    mask = params.valid[:, None, :] & ~torch.eye(
        K, dtype=torch.bool, device=pts.device)            # [B, i, j]
    masked = torch.where(mask[:, :, None, :], sdf,
                         torch.full_like(sdf, float("inf")))
    m = torch.amin(masked, dim=-1)                          # [B, K, S]
    m = torch.minimum(m, m.new_full((), clamp))
    w_sum = torch.clamp_min(w.sum(-1), 1e-12)
    sdfs = torch.where(mask.any(-1), torch.sum(m * w, -1) / w_sum,
                       torch.zeros_like(w_sum))             # [B, K]
    cnt = torch.clamp_min(params.valid.sum(-1), 1)
    loss = torch.sum((sdfs * params.valid) ** 2, dim=-1) / cnt
    return _mean_over(loss, params.valid.sum(-1) > 1)


def intersection_loss_v2(params: PrimitiveParams, points: torch.Tensor,
                         cuboid: bool = False, clamp: float = -1e-3
                         ) -> torch.Tensor:
    """Overlap penalty v2: the clamped SDFs minus each point's (no
    gradient) least valid one, squared, averaged over the points and
    valid slots; the mean over shapes with more than one valid slot."""
    sdf = sdf_primitives(points, params.r, params.V, params.center, cuboid)
    sdf = torch.minimum(sdf, sdf.new_full((), clamp))
    mn = torch.amin(_where_valid(params.valid, sdf, float("inf")), dim=-1,
                    keepdim=True).detach()
    diff = _where_valid(params.valid, sdf - mn, 0.0)
    cnt = torch.clamp_min(params.valid.sum(-1), 1)
    loss = torch.sum(diff ** 2, dim=(1, 2)) / (points.shape[1] * cnt)
    return _mean_over(loss, params.valid.sum(-1) > 1)


def intersection_loss_v4(params: PrimitiveParams, points: torch.Tensor,
                         clamp: float = -1e-3) -> torch.Tensor:
    """Overlap penalty v4 (ellipsoids): per point the sum of the squared
    clamped SDFs over the valid slots minus the square of the least one,
    averaged over the points; the mean over shapes with more than one
    valid slot."""
    sdf = sdf_primitives(points, params.r, params.V, params.center)
    sdf = _where_valid(params.valid,
                       torch.minimum(sdf, sdf.new_full((), clamp)), 0.0)
    multi = params.valid.sum(-1) > 1
    # the min of a shape with no valid slot is inf; its square would
    # poison the gradient, so such shapes take 0
    mn = torch.amin(_where_valid(params.valid, sdf, float("inf")), dim=-1)
    mn = torch.where(multi[:, None], mn, torch.zeros_like(mn))
    loss = torch.mean(torch.sum(sdf ** 2, dim=-1) - mn ** 2, dim=-1)
    return _mean_over(loss, multi)


def prune_mask(samples: torch.Tensor, params: PrimitiveParams,
               cuboid: bool = False, thres: float = -1e-3) -> torch.Tensor:
    """``[B, S]`` bool, no gradient: the samples ``samples [B, S, 3]``
    whose least SDF over the valid slots is above ``thres`` (on or outside
    the union surface)."""
    with torch.no_grad():
        sdf = sdf_primitives(samples, params.r, params.V, params.center,
                             cuboid)
        return torch.amin(_where_valid(params.valid, sdf, float("inf")),
                          dim=-1) > thres
