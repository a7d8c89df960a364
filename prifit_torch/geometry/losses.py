"""SDF-based analytic chamfer between fitted primitives and a target cloud.

Port of ``prifit_tpu/geometry/losses.py::analytic_chamfer`` (ellipsoids).
The entropy, intersection and pruning terms are not ported yet.
"""

import torch

from prifit_torch.geometry.fitting import PrimitiveParams
from prifit_torch.geometry.sdf import sdf_primitives
from prifit_torch.ops.chamfer import nn_squared_distance


def analytic_chamfer(params: PrimitiveParams, samples: torch.Tensor,
                     sample_w: torch.Tensor, target: torch.Tensor
                     ) -> torch.Tensor:
    """Target side: mean over target points of ``(min_k |sdf_k|)^2``;
    source side: area-weighted mean over primitive samples of the squared
    distance to the nearest target point; per shape their average, then
    the mean over shapes with at least one valid primitive (0 if none).

    ``params [B, K, ...]``, ``samples [B, S, 3]``, ``sample_w [B, S]``,
    ``target [B, M, 3]``."""
    sdf = sdf_primitives(target, params.r, params.V, params.center)
    asdf = torch.where(params.valid[:, None, :], torch.abs(sdf),
                       torch.full_like(sdf, float("inf")))
    d_ts = torch.amin(asdf, dim=-1) ** 2                     # [B, M]
    d_st = nn_squared_distance(samples, target)              # [B, S]
    w_sum = torch.clamp_min(sample_w.sum(-1), 1e-12)
    mean_st = torch.sum(d_st * sample_w, dim=-1) / w_sum
    has = params.valid.any(-1)
    mean_ts = torch.mean(torch.where(has[:, None], d_ts,
                                     torch.zeros_like(d_ts)), dim=-1)
    dist = torch.where(has, (mean_st + mean_ts) / 2.0,
                       torch.zeros_like(mean_st))
    return dist.sum() / torch.clamp_min(has.sum(), 1)
