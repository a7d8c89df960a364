# Frozen copy of prifit_torch/geometry/losses.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""The chamfer loss over fitted primitives (the copy leaves out the
program's entropy, intersection and pruning terms, which the recipe
leaves off).

Port of ``prifit_tpu/geometry/losses.py``, batched over shapes with
static slot counts and validity masks: ``analytic_chamfer``, the SDF /
nearest-neighbour chamfer against the target cloud.

Under data parallelism ``group`` (the data axis's process group) makes
each mean over shapes a mean over the global batch, replicated on every
rank (:mod:`prifit_torch.parallel.collectives`), as the JAX package's
partitioner computes it.
"""

import torch

from benchmark.reference.port.geometry.fitting import PrimitiveParams
from benchmark.reference.port.parallel.collectives import psum
from benchmark.reference.port.geometry.sdf import sdf_primitives
from benchmark.reference.port.ops.chamfer import nn_squared_distance


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


