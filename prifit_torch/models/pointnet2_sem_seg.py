"""PointNet++ scene semantic segmentation.

Port of ``prifit_tpu/models/pointnet2_sem_seg.py::get_model``: four SSG
layers SA(1024, r=0.1) -> SA(256, 0.2) -> SA(64, 0.4) -> SA(16, 0.8),
each with 32 neighbours, whose first layer's features are the whole input
(xyz again, then rgb), then FP4..FP1 back to every point, ``conv1`` +
``bn1`` + relu, dropout 0.5 and ``conv2`` to ``num_classes``
log-probabilities.  The forward returns ``(log-probs [B, N,
num_classes], l4_points [B, 16, 512])``.  f32; state_dict names
``sa1..4``, ``fp4..1``, ``conv1..2``, ``bn1``.  Randomness (the training
FPS start, the dropout mask) comes only from an explicit
``torch.Generator``; without one FPS starts at index 0.  ``channel`` is
the input width (6 with ``with_rgb``, else 3; see
:mod:`prifit_torch.models.pointnet_sem_seg`).
"""

import torch
from torch import nn

from prifit_torch.models.common import dropout
from prifit_torch.models.pointnet_sem_seg import check_channels, \
    weighted_nll
from prifit_torch.nn.norm import BatchNorm
from prifit_torch.nn.pointnet2 import FeaturePropagation, SetAbstraction, \
    conv_weight, dense
from prifit_torch.utils.device import resolve_device


class get_model(nn.Module):
    def __init__(self, num_classes: int, with_rgb: bool = True,
                 channel: int | None = None, max_region: bool = False,
                 device=None):
        """``device``: where the parameters live; CUDA unless the caller
        names another (raises without a GPU)."""
        super().__init__()
        self.with_rgb = with_rgb
        self.channel = channel or (6 if with_rgb else 3)
        self.dropout_rate = 0.5  # the JAX model's (tests set 0)
        sa = dict(max_region=max_region)
        self.sa1 = SetAbstraction(1024, 0.1, 32, self.channel, [32, 32, 64],
                                  **sa)
        self.sa2 = SetAbstraction(256, 0.2, 32, 64, [64, 64, 128], **sa)
        self.sa3 = SetAbstraction(64, 0.4, 32, 128, [128, 128, 256], **sa)
        self.sa4 = SetAbstraction(16, 0.8, 32, 256, [256, 256, 512], **sa)
        self.fp4 = FeaturePropagation(768, [256, 256])
        self.fp3 = FeaturePropagation(384, [256, 256])
        self.fp2 = FeaturePropagation(320, [256, 128])
        self.fp1 = FeaturePropagation(128, [128, 128, 128])
        self.conv1 = nn.Conv1d(128, 128, 1)
        self.bn1 = BatchNorm(128)
        self.conv2 = nn.Conv1d(128, num_classes, 1)
        self.to(resolve_device(device))

    def forward(self, xyz: torch.Tensor, *, bn_momentum: float = 0.1,
                generator: torch.Generator | None = None):
        """``xyz [B, N, channel]``, xyz first."""
        check_channels(self, xyz)
        l0_xyz = xyz[..., :3]
        l1_xyz, l1_points = self.sa1(l0_xyz, xyz, bn_momentum, generator)
        l2_xyz, l2_points = self.sa2(l1_xyz, l1_points, bn_momentum,
                                     generator)
        l3_xyz, l3_points = self.sa3(l2_xyz, l2_points, bn_momentum,
                                     generator)
        l4_xyz, l4_points = self.sa4(l3_xyz, l3_points, bn_momentum,
                                     generator)
        l3_points = self.fp4(l3_xyz, l4_xyz, l3_points, l4_points,
                             bn_momentum)
        l2_points = self.fp3(l2_xyz, l3_xyz, l2_points, l3_points,
                             bn_momentum)
        l1_points = self.fp2(l1_xyz, l2_xyz, l1_points, l2_points,
                             bn_momentum)
        l0_points = self.fp1(l0_xyz, l1_xyz, None, l1_points, bn_momentum)
        x = torch.relu(self.bn1(dense(l0_points, conv_weight(self.conv1),
                                      self.conv1.bias), bn_momentum))
        x = dropout(x, self.dropout_rate, self.training, generator)
        x = dense(x, conv_weight(self.conv2), self.conv2.bias)
        return torch.log_softmax(x, dim=-1), l4_points


def get_loss(pred, target, trans_feat=None, weight=None):
    """The NLL, each point weighted by ``weight[target]`` when given."""
    return weighted_nll(pred, target, weight)
