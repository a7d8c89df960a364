"""The original PointNet blocks, channel-last.

Port of ``prifit_tpu/nn/pointnet.py``: the spatial / feature transformer
(``STN``, the reference's ``STN3d`` and ``STNkd``, which differ only in
``k``), the shared encoder and the orthogonality regularizer.  The
modules carry the reference's state_dict names (``conv1..3``,
``fc1..3``, ``bn1..5`` in a transformer; ``stn``, ``conv1..3``,
``bn1..3``, ``fstn`` in the encoder); each 1x1 convolution runs as a
dense layer over the last axis.
"""

import torch
from torch import nn

from prifit_torch.nn.norm import BatchNorm
from prifit_torch.nn.pointnet2 import conv_weight, dense


def conv_bn(conv, bn, x, bn_momentum: float, relu: bool = True):
    """``relu(bn(x @ conv))`` over the last axis (without the relu when
    ``relu`` is false); ``conv`` a 1x1 ``Conv1d`` or an ``nn.Linear``."""
    w = conv.weight if isinstance(conv, nn.Linear) else conv_weight(conv)
    y = bn(dense(x, w, conv.bias), bn_momentum)
    return torch.relu(y) if relu else y


class STN(nn.Module):
    """Spatial transformer: ``x [B, N, channel] -> [B, k, k]``, the
    output of its last dense plus the identity.  :func:`prifit_torch.
    entry.init_weights` starts that dense at zero, so a fresh transformer
    is the identity, as the JAX package's is."""

    def __init__(self, k: int = 3, channel: int | None = None):
        super().__init__()
        self.k = k
        widths = [k if channel is None else channel, 64, 128, 1024]
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            setattr(self, f"conv{i + 1}", nn.Conv1d(a, b, 1))
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, k * k)
        for i, f in enumerate((64, 128, 1024, 512, 256)):
            setattr(self, f"bn{i + 1}", BatchNorm(f))

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1
                ) -> torch.Tensor:
        y = conv_bn(self.conv1, self.bn1, x, bn_momentum)
        y = conv_bn(self.conv2, self.bn2, y, bn_momentum)
        y = conv_bn(self.conv3, self.bn3, y, bn_momentum)
        y = torch.amax(y, dim=1)                         # [B, 1024]
        y = conv_bn(self.fc1, self.bn4, y, bn_momentum)
        y = conv_bn(self.fc2, self.bn5, y, bn_momentum)
        y = dense(y, self.fc3.weight, self.fc3.bias)
        eye = torch.eye(self.k, dtype=y.dtype, device=y.device).reshape(-1)
        return (y + eye).reshape(-1, self.k, self.k)


def transform(x: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """``x [B, N, C]`` with its first ``k`` channels multiplied by
    ``trans [B, k, k]`` and the others passed by."""
    k = trans.shape[-1]
    y = torch.matmul(x[..., :k].to(trans.dtype), trans)
    if x.shape[-1] == k:
        return y
    return torch.cat([y, x[..., k:].to(y.dtype)], dim=-1)


class PointNetEncoder(nn.Module):
    """The shared PointNet encoder: ``x [B, N, channel >= 3] -> (features,
    trans [B, 3, 3], trans_feat [B, 64, 64] or None)``, the features the
    1024-d global max (``global_feat``) or per point ``[global, point
    features]`` ``[B, N, 1088]``."""

    def __init__(self, global_feat: bool = True,
                 feature_transform: bool = False, channel: int = 3):
        super().__init__()
        self.global_feat = global_feat
        self.stn = STN(3, channel)
        self.conv1 = nn.Conv1d(channel, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.conv3 = nn.Conv1d(128, 1024, 1)
        self.bn1 = BatchNorm(64)
        self.bn2 = BatchNorm(128)
        self.bn3 = BatchNorm(1024)
        self.fstn = STN(64) if feature_transform else None

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1):
        B, N, _ = x.shape
        trans = self.stn(x, bn_momentum)
        x = conv_bn(self.conv1, self.bn1, transform(x, trans), bn_momentum)
        trans_feat = None
        if self.fstn is not None:
            trans_feat = self.fstn(x, bn_momentum)
            x = torch.matmul(x, trans_feat)
        pointfeat = x
        x = conv_bn(self.conv2, self.bn2, x, bn_momentum)
        x = conv_bn(self.conv3, self.bn3, x, bn_momentum, relu=False)
        x = torch.amax(x, dim=1)                         # [B, 1024]
        if self.global_feat:
            return x, trans, trans_feat
        g = x[:, None, :].expand(B, N, x.shape[-1])
        return torch.cat([g, pointfeat], dim=-1), trans, trans_feat


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """The orthogonality penalty ``mean_b ||T (T^T - I)||_F`` of
    ``trans [B, d, d]``, with the reference's ``T (T^T - I)`` where the
    textbook has ``T T^T - I`` (the same zero set)."""
    eye = torch.eye(trans.shape[1], dtype=trans.dtype, device=trans.device)
    m = torch.matmul(trans, trans.transpose(1, 2) - eye)
    return torch.mean(torch.linalg.norm(m.reshape(m.shape[0], -1), dim=1))
