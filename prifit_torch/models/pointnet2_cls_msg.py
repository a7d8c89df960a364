"""PointNet++ MSG classification.

Port of ``prifit_tpu/models/pointnet2_cls_msg.py::get_model``: SA-MSG(512,
radii 0.1/0.2/0.4, K 16/32/128) -> SA-MSG(128, radii 0.2/0.4/0.8, K
32/64/128) -> SA-all(1024) -> the classification head of
:mod:`prifit_torch.models.pointnet2_cls_ssg` with dropout 0.4 / 0.5.  The
MSG layers group ``[features, xyz - center]``, features first, as in the
part-seg MSG model (whose neighbour counts differ).  The forward returns
``(log-probs [B, num_class], l3_points [B, 1, 1024])``; f32; state_dict
names ``sa1..3``, ``fc1..3``, ``bn1..2``.  Randomness as in the SSG
model.
"""

import torch
from torch import nn

from prifit_torch.models.common import nll_loss
from prifit_torch.models.pointnet2_cls_ssg import add_cls_head, cls_head
from prifit_torch.nn.pointnet2 import SetAbstractionAll, SetAbstractionMsg
from prifit_torch.utils.device import resolve_device


class get_model(nn.Module):
    def __init__(self, num_class: int, normal_channel: bool = True,
                 max_region: bool = False, device=None):
        """``device``: where the parameters live; CUDA unless the caller
        names another (raises without a GPU)."""
        super().__init__()
        self.normal_channel = normal_channel
        self.dropout_rates = (0.4, 0.5)
        extra = 3 if normal_channel else 0
        self.sa1 = SetAbstractionMsg(
            512, [0.1, 0.2, 0.4], [16, 32, 128], extra,
            [[32, 32, 64], [64, 64, 128], [64, 96, 128]],
            max_region=max_region)
        self.sa2 = SetAbstractionMsg(
            128, [0.2, 0.4, 0.8], [32, 64, 128], 64 + 128 + 128,
            [[64, 64, 128], [128, 128, 256], [128, 128, 256]],
            max_region=max_region)
        self.sa3 = SetAbstractionAll(128 + 256 + 256 + 3, [256, 512, 1024])
        add_cls_head(self, num_class)
        self.to(resolve_device(device))

    def forward(self, xyz: torch.Tensor, *, bn_momentum: float = 0.1,
                generator: torch.Generator | None = None):
        """``xyz [B, N, 3(+3)]`` (normals after the xyz)."""
        points = xyz[..., 3:] if self.normal_channel else None
        l0_xyz = xyz[..., :3]
        l1_xyz, l1_points = self.sa1(l0_xyz, points, bn_momentum, generator)
        l2_xyz, l2_points = self.sa2(l1_xyz, l1_points, bn_momentum,
                                     generator)
        _, l3_points = self.sa3(l2_xyz, l2_points, bn_momentum)
        x = l3_points.reshape(xyz.shape[0], 1024)
        return cls_head(self, x, self.dropout_rates, bn_momentum,
                        generator), l3_points


def get_loss(pred, target, trans_feat=None):
    """NLL over log-probabilities."""
    return nll_loss(pred, target)
