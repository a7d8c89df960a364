"""AtlasNet reconstruction decoder.

Port of ``prifit_tpu/nn/atlasnet.py``: ``num_charts`` small MLP decoders,
each mapping (a point of a regular 2-d UV grid ++ the latent) to a 3-d
point.  The JAX decoder is one ``nn.vmap`` over a chart axis with its
params and batch statistics stacked on axis 0; here the weights are
chart-stacked too (``[charts, in, out]``) and each layer is one batched
product over the charts, not a loop of modules.  Charts share no weights;
each chart's batch norm takes its statistics over its own ``[B, G]``
rows (:class:`prifit_torch.nn.norm.BatchNorm` with ``charts``).

The grid is ``isqrt(num_points)``^2 points a chart: 11^2 = 121 at the
default 128, so 25 charts give 3025 points, not 25 x 128.

The repo knows no reference names for these parameters (the JAX
package's importer drops the reference's ``atlasnet.*`` entries), so the
port names them: ``decoder.convs.{j}.weight [charts, in, out]`` and
``.bias [charts, out]``, ``decoder.bns.{j}.*`` ``[charts, F]``.
"""

import math

import torch
from torch import nn

from prifit_torch.nn.norm import BatchNorm


class ChartDense(nn.Module):
    """One dense layer a chart: ``x [charts, rows, in] -> [charts, rows,
    out]`` by one batched product."""

    def __init__(self, charts: int, in_features: int, out_features: int):
        super().__init__()
        self.in_features = in_features
        self.weight = nn.Parameter(torch.randn(
            charts, in_features, out_features) / in_features ** 0.5)
        self.bias = nn.Parameter(torch.zeros(charts, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.baddbmm(self.bias[:, None, :], x, self.weight)


class PointGenCon(nn.Module):
    """The chart-stacked point-generation MLP (``PointGenCon`` of the
    JAX package under its chart ``vmap``): widths ``bottleneck ->
    bottleneck -> bottleneck // 2 -> bottleneck // 4 -> 3``, each hidden
    layer dense -> per-chart batch norm -> relu, then ``tanh``."""

    def __init__(self, bottleneck_size: int = 2500, charts: int = 25):
        super().__init__()
        sizes = [bottleneck_size, bottleneck_size // 2, bottleneck_size // 4]
        widths = [bottleneck_size] + sizes
        self.convs = nn.ModuleList(
            ChartDense(charts, a, b) for a, b in zip(widths, widths[1:]))
        self.convs.append(ChartDense(charts, sizes[-1], 3))
        self.bns = nn.ModuleList(BatchNorm(f, charts=charts) for f in sizes)

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1
                ) -> torch.Tensor:
        """``x [charts, rows, bottleneck] -> [charts, rows, 3]``."""
        for conv, bn in zip(self.convs, self.bns):
            x = torch.relu(bn(conv(x), bn_momentum))
        return torch.tanh(self.convs[-1](x))


class AtlasNet(nn.Module):
    """The multi-chart decoder: ``z [B, bottleneck] -> [B, charts * G,
    3]`` with ``G = isqrt(num_points)^2`` (the chart-major order of the
    JAX package's output)."""

    def __init__(self, bottleneck_size: int = 128, num_charts: int = 25,
                 num_points: int = 128):
        super().__init__()
        self.num_charts = num_charts
        g = math.isqrt(num_points)
        u, v = torch.meshgrid(torch.arange(g), torch.arange(g),
                              indexing="ij")
        uv = torch.stack([u, v], -1).reshape(-1, 2).float() / max(g - 1, 1)
        self.register_buffer("uv", uv, persistent=False)      # [G, 2]
        self.decoder = PointGenCon(2 + bottleneck_size, num_charts)

    def forward(self, z: torch.Tensor, bn_momentum: float = 0.1
                ) -> torch.Tensor:
        B, G = z.shape[0], self.uv.shape[0]
        y = torch.cat([self.uv[None].expand(B, G, 2),
                       z[:, None, :].expand(B, G, z.shape[-1])], dim=-1)
        # every chart decodes the same [B * G] rows
        y = y.reshape(1, B * G, -1).expand(self.num_charts, B * G, -1)
        pts = self.decoder(y, bn_momentum)               # [charts, B G, 3]
        return pts.reshape(self.num_charts, B, G, 3).transpose(0, 1) \
            .reshape(B, self.num_charts * G, 3)
