# Frozen copy of prifit_torch/nn/norm.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""Batch normalization over all axes but the last (channel-last).

Port of ``prifit_tpu/nn/norm.py::BatchNorm`` (and below it, flax's
``nn.GroupNorm`` as :class:`GroupNorm`).  Statistics follow the JAX
package, not ``F.batch_norm``: f32 ``E[x^2] - E[x]^2`` (floored at 0) over
every axis but the last, torch-convention running update
``running = (1 - m) running + m stat`` with the UNBIASED variance tracked,
and a momentum given per call.  The state_dict names are torch's
(``weight``, ``bias``, ``running_mean``, ``running_var``).

With ``charts``, one batch norm a chart of a chart-stacked input
``[charts, rows, F]``: parameters and statistics ``[charts, F]``, each
chart's statistics over its rows (the JAX package's ``BatchNorm`` under
``nn.vmap`` over a chart axis, as AtlasNet's decoder runs it).

Cross-replica statistics: ``process_group`` (the JAX package's
``axis_name``) sums the batch's ``sum x`` and ``sum x^2`` over the group's
ranks (a :func:`~prifit_torch.parallel.collectives.psum`, whose backward
sums the cotangents, so the gradient is that of the global statistics),
and the moments and the unbiased running variance take the global row
count: the statistics of the global batch, as the JAX package's
data-parallel step computes them under its partitioner.  The model owns
its group: :func:`set_process_group` sets it once, after the model is
built, and the train steps read it back (:func:`process_group_of`).
"""

import torch
from torch import nn

from benchmark.reference.port.parallel.collectives import group_size, psum


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5,
                 charts: int | None = None):
        super().__init__()
        self.eps = eps
        self.charts = charts
        self.process_group = None
        shape = (num_features,) if charts is None else (charts, num_features)
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))
        self.register_buffer("running_mean", torch.zeros(shape))
        self.register_buffer("running_var", torch.ones(shape))

    def forward(self, x: torch.Tensor, momentum: float = 0.1
                ) -> torch.Tensor:
        """Batch statistics (and a running update) in training mode,
        running statistics in eval mode; returns ``x.dtype``."""
        if self.charts is None:
            dims, rows = tuple(range(x.dim() - 1)), x.numel() // x.shape[-1]
        else:
            dims, rows = (1,), x.shape[1]
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            x32 = x.float()
            group = self.process_group
            if group_size(group) > 1:
                rows *= group_size(group)
                s = psum(torch.stack([x32.sum(dim=dims),
                                      (x32 * x32).sum(dim=dims)]), group)
                mean, mean2 = s[0] / rows, s[1] / rows
            else:
                mean = torch.mean(x32, dim=dims)
                mean2 = torch.mean(x32 * x32, dim=dims)
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            self.update_running(mean, var, momentum, rows)
        weight, bias = self.weight, self.bias
        if self.charts is not None:
            mean, var, weight, bias = (t[:, None] for t in
                                       (mean, var, weight, bias))
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * weight + bias).to(x.dtype)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor,
                       momentum: float, n: int) -> None:
        """Running update from batch statistics over ``n`` rows (also
        those a mixed-precision region computed), tracking the unbiased
        variance."""
        unbiased = var * (n / max(n - 1.0, 1.0))
        self.running_mean.mul_(1.0 - momentum).add_(momentum * mean)
        self.running_var.mul_(1.0 - momentum).add_(momentum * unbiased)


class GroupNorm(nn.Module):
    """Group normalization of a channel-last ``x [B, ..., F]`` with flax's
    ``nn.GroupNorm`` semantics (the JAX package's DGCNN), which differ
    from ``torch.nn.GroupNorm``'s: epsilon 1e-6, and f32 statistics
    ``E[x^2] - E[x]^2`` (floored at 0) over every axis but the batch
    axis, within each of ``num_groups`` groups of consecutive channels.
    No running statistics.  Parameters ``weight`` (1) and ``bias`` (0)
    ``[F]``."""

    eps = 1e-6

    def __init__(self, num_groups: int, num_features: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        F = x.shape[-1]
        g = x.float().reshape(x.shape[0], -1, self.num_groups,
                              F // self.num_groups)
        mean = torch.mean(g, dim=(1, 3), keepdim=True)
        mean2 = torch.mean(g * g, dim=(1, 3), keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        y = ((g - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight + self.bias).to(x.dtype)
