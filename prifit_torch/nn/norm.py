"""Batch normalization over all axes but the last (channel-last).

Port of ``prifit_tpu/nn/norm.py::BatchNorm``.  Statistics follow the JAX
package, not ``F.batch_norm``: f32 ``E[x^2] - E[x]^2`` (floored at 0) over
every axis but the last, torch-convention running update
``running = (1 - m) running + m stat`` with the UNBIASED variance tracked,
and a momentum given per call.  The state_dict names are torch's
(``weight``, ``bias``, ``running_mean``, ``running_var``).
"""

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, momentum: float = 0.1
                ) -> torch.Tensor:
        """Batch statistics (and a running update) in training mode,
        running statistics in eval mode; returns ``x.dtype``."""
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            dims = tuple(range(x.dim() - 1))
            x32 = x.float()
            mean = torch.mean(x32, dim=dims)
            mean2 = torch.mean(x32 * x32, dim=dims)
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            self.update_running(mean, var, momentum, x.numel() // x.shape[-1])
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor,
                       momentum: float, n: int) -> None:
        """Running update from batch statistics over ``n`` rows (also
        those a mixed-precision region computed), tracking the unbiased
        variance."""
        unbiased = var * (n / max(n - 1.0, 1.0))
        self.running_mean.mul_(1.0 - momentum).add_(momentum * mean)
        self.running_var.mul_(1.0 - momentum).add_(momentum * unbiased)
