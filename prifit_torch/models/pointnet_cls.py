"""PointNet classification.

Port of ``prifit_tpu/models/pointnet_cls.py::get_model``: the shared
encoder with the feature transform (``feat``, global 1024-d), then
``fc1 -> bn1 -> relu -> fc2 -> dropout 0.4 -> bn2 -> relu -> fc3`` (the
dropout before ``bn2``, as in the JAX model and the reference) and ``k``
log-probabilities.  The forward returns ``(log-probs [B, k],
trans_feat [B, 64, 64])``, which :func:`get_loss` regularizes.  f32;
state_dict names ``feat.*``, ``fc1..3``, ``bn1..2``.  It draws only the
dropout mask, from an explicit ``torch.Generator``.
"""

import torch
from torch import nn

from prifit_torch.models.common import dropout, nll_loss
from prifit_torch.nn.norm import BatchNorm
from prifit_torch.nn.pointnet import PointNetEncoder, \
    feature_transform_regularizer
from prifit_torch.nn.pointnet2 import dense
from prifit_torch.utils.device import resolve_device


class get_model(nn.Module):
    def __init__(self, k: int = 40, normal_channel: bool = True,
                 device=None):
        """``device``: where the parameters live; CUDA unless the caller
        names another (raises without a GPU)."""
        super().__init__()
        self.dropout_rate = 0.4  # the JAX model's (tests set 0)
        self.feat = PointNetEncoder(global_feat=True, feature_transform=True,
                                    channel=6 if normal_channel else 3)
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, k)
        self.bn1 = BatchNorm(512)
        self.bn2 = BatchNorm(256)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, *, bn_momentum: float = 0.1,
                generator: torch.Generator | None = None):
        """``x [B, N, 3(+3)]``."""
        x, _, trans_feat = self.feat(x, bn_momentum)
        x = torch.relu(self.bn1(dense(x, self.fc1.weight, self.fc1.bias),
                                bn_momentum))
        x = dropout(dense(x, self.fc2.weight, self.fc2.bias),
                    self.dropout_rate, self.training, generator)
        x = torch.relu(self.bn2(x, bn_momentum))
        x = dense(x, self.fc3.weight, self.fc3.bias)
        return torch.log_softmax(x, dim=-1), trans_feat


def get_loss(pred, target, trans_feat, mat_diff_loss_scale: float = 0.001):
    """NLL plus ``mat_diff_loss_scale`` times the feature transform's
    orthogonality penalty."""
    return nll_loss(pred, target) + mat_diff_loss_scale * \
        feature_transform_regularizer(trans_feat)
