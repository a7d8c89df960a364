# Frozen copy of prifit_torch/nn/dgcnn.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""DGCNN edge-convolution encoder and segmentation head, channel-last.

Port of ``prifit_tpu/nn/dgcnn.py`` (reference ``src/dgcnn.py:74-267``).
Edge features are ``[x_j - x_i, x_i]`` over a (dilated) kNN graph
(:mod:`prifit_torch.ops.pairwise`); normalization is flax's GroupNorm
(:class:`prifit_torch.nn.norm.GroupNorm`), activations LeakyReLU 0.2 in
the edge convolutions and relu elsewhere.

An edge convolution never builds the ``[B, N, K, 2C]`` edge tensor: its
1x1 convolution is affine, so with ``W = [W_d, W_c]`` (``W_d`` the first
C input columns)

    [x_j - x_i, x_i] @ W^T = x_j W_d^T + x_i (W_c - W_d)^T

and it either projects every point first and gathers the ``F``-wide
projections (``"proj"``), or gathers the raw ``C``-wide neighbourhood
and projects the differences (``"edge"``).  The JAX package's ``auto``
rule picks ``"proj"`` unless the input is strictly narrower than the
output.  The gathers go through ``gather_neighbors``, the gather kernel
on the card.

State_dict names, with the JAX package's flax paths beside them:
``encoder.edge_convs.{i}.conv`` (``DGCNNEncoderGn_0/_EdgeConv_{i}``, a
bias-free 1x1 Conv2d ``[F, 2C]``) and ``.norm``; ``encoder.conv`` and
``encoder.norm`` (the 1024-d layer); ``convs.{j}`` and ``norms.{j}``
(``Dense_j``, ``GroupNorm_j``), ``seg`` (``Dense_3``) and the bias-free
``embed`` (``Dense_4``).
"""

import torch
from torch import nn
from torch.nn import functional as F

from benchmark.reference.port.nn.norm import GroupNorm
from benchmark.reference.port.nn.pointnet2 import conv_weight, dense
from benchmark.reference.port.ops.pairwise import knn_points_normals, knn_with_dilation
from benchmark.reference.port.ops.sampling import gather_neighbors


class EdgeConv(nn.Module):
    """One edge convolution: 1x1 conv -> GroupNorm -> LeakyReLU(0.2) ->
    max over the neighbours, ``(x [B, N, C], idx [B, N, K]) -> [B, N,
    features]``."""

    def __init__(self, in_channels: int, features: int, groups: int):
        super().__init__()
        self.conv = nn.Conv2d(2 * in_channels, features, 1, bias=False)
        self.norm = GroupNorm(groups, features)

    def forward(self, x: torch.Tensor, idx: torch.Tensor,
                order: str | None = None) -> torch.Tensor:
        """``order``: ``"proj"`` or ``"edge"`` (module docstring); None
        takes the JAX package's ``auto`` rule."""
        C = x.shape[-1]
        w = conv_weight(self.conv)
        w_d, w_c = w[:, :C], w[:, C:]
        if order is None:
            order = "proj" if C >= w.shape[0] else "edge"
        if order == "proj":
            y = gather_neighbors(dense(x, w_d), idx) \
                + dense(x, w_c - w_d)[:, :, None, :]
        else:
            diff = gather_neighbors(x, idx) - x[:, :, None, :]
            y = dense(diff, w_d) + dense(x, w_c)[:, :, None, :]
        y = F.leaky_relu(self.norm(y), 0.2)
        return torch.amax(y, dim=2)


class DGCNNEncoderGn(nn.Module):
    """Three edge convolutions and the 1024-d global feature: ``x [B, N,
    3 | 6] -> (global [B, 1024], per point [B, N, 256])``.  The third
    convolution reuses the second's graph (reference ``src/dgcnn.py:
    190``)."""

    def __init__(self, input_channels: int = 3, nn_nb: int = 80,
                 dilation: int = 1):
        super().__init__()
        self.input_channels = input_channels
        self.nn_nb = nn_nb
        self.dilation = dilation
        self.edge_convs = nn.ModuleList([
            EdgeConv(input_channels, 64, 2), EdgeConv(64, 64, 2),
            EdgeConv(64, 128, 2)])
        self.conv = nn.Conv1d(256, 1024, 1)
        self.norm = GroupNorm(8, 1024)

    def forward(self, x: torch.Tensor):
        k, normals = self.nn_nb, self.input_channels == 6
        if normals:
            idx = knn_points_normals(x, k, k)
        else:
            idx = knn_with_dilation(x, k, k * self.dilation)
        x1 = self.edge_convs[0](x, idx)
        idx = knn_with_dilation(x1, k, k if normals else k * self.dilation)
        x2 = self.edge_convs[1](x1, idx)
        x3 = self.edge_convs[2](x2, idx)
        feats = torch.cat([x1, x2, x3], dim=-1)
        y = torch.relu(self.norm(dense(feats, conv_weight(self.conv),
                                       self.conv.bias)))
        return torch.amax(y, dim=1), feats


class DGCNNGn(nn.Module):
    """The encoder, then per point ``[global, per point]`` through three
    [dense -> GroupNorm -> relu] layers: ``points [B, N, C] ->
    (embedding [B, N, emb_size], seg [B, N, num_seg])``."""

    def __init__(self, emb_size: int = 128, num_channels: int = 3,
                 nn_nb: int = 80, dilation: int = 1, num_seg: int = 3):
        super().__init__()
        self.encoder = DGCNNEncoderGn(num_channels, nn_nb, dilation)
        self.convs = nn.ModuleList([nn.Conv1d(1280, 512, 1),
                                    nn.Conv1d(512, 256, 1),
                                    nn.Conv1d(256, 256, 1)])
        self.norms = nn.ModuleList([GroupNorm(8, 512), GroupNorm(4, 256),
                                    GroupNorm(4, 256)])
        self.seg = nn.Conv1d(256, num_seg, 1)
        self.embed = nn.Conv1d(256, emb_size, 1, bias=False)

    def forward(self, points: torch.Tensor):
        B, N, _ = points.shape
        g, feats = self.encoder(points)
        x = torch.cat([g[:, None, :].expand(B, N, g.shape[-1]), feats],
                      dim=-1)
        for conv, norm in zip(self.convs, self.norms):
            x = torch.relu(norm(dense(x, conv_weight(conv), conv.bias)))
        return (dense(x, conv_weight(self.embed)),
                dense(x, conv_weight(self.seg), self.seg.bias))
