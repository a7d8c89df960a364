"""PointNet++ SSG classification.

Port of ``prifit_tpu/models/pointnet2_cls_ssg.py::get_model``:
SA(512, r=0.2, K=32) -> SA(128, r=0.4, K=64) -> SA-all(1024) -> fc 512 /
256 with batch norm, relu and dropout 0.4 / 0.4 -> ``num_class``
log-probabilities.  The forward returns ``(log-probs [B, num_class],
l3_points [B, 1, 1024])``, as the JAX model does.  The state_dict names
are the reference's (``sa1..3``, ``fc1..3``, ``bn1..2``);
:func:`prifit_torch.convert.state_dict_from_jax` output loads with
``strict=True``.  The model is f32, as the JAX one is.  Randomness (the
training FPS start and the dropout masks) comes only from an explicit
``torch.Generator``; without one FPS starts at index 0, and training at a
dropout rate above 0 raises.  ``dropout_rates`` holds the JAX model's
fixed rates (tests set the attribute to 0).
"""

import torch
from torch import nn

from prifit_torch.models.common import dropout, nll_loss
from prifit_torch.nn.norm import BatchNorm
from prifit_torch.nn.pointnet2 import SetAbstraction, SetAbstractionAll, \
    dense
from prifit_torch.utils.device import resolve_device


def add_cls_head(model: nn.Module, num_class: int) -> None:
    """The classification head's layers under the reference names:
    ``fc1`` (1024 -> 512), ``bn1``, ``fc2`` (512 -> 256), ``bn2``, ``fc3``
    (256 -> ``num_class``)."""
    model.fc1 = nn.Linear(1024, 512)
    model.bn1 = BatchNorm(512)
    model.fc2 = nn.Linear(512, 256)
    model.bn2 = BatchNorm(256)
    model.fc3 = nn.Linear(256, num_class)


def cls_head(model: nn.Module, x: torch.Tensor, rates, bn_momentum: float,
             generator: torch.Generator | None) -> torch.Tensor:
    """``x [B, 1024]`` through ``fc1 -> bn1 -> relu -> dropout -> fc2 ->
    bn2 -> relu -> dropout -> fc3`` to log-probabilities."""
    for i, rate in ((1, rates[0]), (2, rates[1])):
        fc, bn = getattr(model, f"fc{i}"), getattr(model, f"bn{i}")
        x = torch.relu(bn(dense(x, fc.weight, fc.bias), bn_momentum))
        x = dropout(x, rate, model.training, generator)
    x = dense(x, model.fc3.weight, model.fc3.bias)
    return torch.log_softmax(x, dim=-1)


class get_model(nn.Module):
    def __init__(self, num_class: int, normal_channel: bool = True,
                 max_region: bool = False, device=None):
        """``device``: where the parameters live; CUDA unless the caller
        names another (raises without a GPU)."""
        super().__init__()
        self.normal_channel = normal_channel
        self.dropout_rates = (0.4, 0.4)
        extra = 3 if normal_channel else 0
        self.sa1 = SetAbstraction(512, 0.2, 32, extra, [64, 64, 128],
                                  max_region=max_region)
        self.sa2 = SetAbstraction(128, 0.4, 64, 128, [128, 128, 256],
                                  max_region=max_region)
        self.sa3 = SetAbstractionAll(256 + 3, [256, 512, 1024])
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
