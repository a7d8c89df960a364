"""PointNet scene semantic segmentation.

Port of ``prifit_tpu/models/pointnet_sem_seg.py::get_model``: the shared
encoder with the feature transform (``feat``), per point ``[global
1024, point 64]`` features ``[B, N, 1088]``, then ``conv1..3`` (512, 256,
128) with batch norm and relu, and ``conv4`` to ``num_class``
log-probabilities.  The forward returns ``(log-probs [B, N, num_class],
trans_feat [B, 64, 64])``.  f32; state_dict names ``feat.*``,
``conv1..4``, ``bn1..3``; it draws nothing.

The JAX encoder sizes its first layer from the input it is first given;
the port's is built for ``channel`` inputs, by default 6 with
``with_rgb`` (xyz, rgb) and 3 without.  A JAX model initialized on
another width (its own tests feed 6 channels to ``with_rgb=False``) is
built here with ``channel=convert.input_channels(variables)``; an input
of another width raises.
"""

import torch
from torch import nn

from prifit_torch.models.common import nll_loss
from prifit_torch.nn.norm import BatchNorm
from prifit_torch.nn.pointnet import PointNetEncoder, conv_bn, \
    feature_transform_regularizer
from prifit_torch.nn.pointnet2 import conv_weight, dense
from prifit_torch.utils.device import resolve_device


def check_channels(model: nn.Module, x: torch.Tensor) -> None:
    if x.shape[-1] != model.channel:
        raise ValueError(
            f"{type(model).__module__} was built for {model.channel} input "
            f"channels (with_rgb={model.with_rgb}) and got {x.shape[-1]}; "
            f"build it with channel={x.shape[-1]}")


def weighted_nll(pred: torch.Tensor, target: torch.Tensor,
                 weight: torch.Tensor | None) -> torch.Tensor:
    """The NLL of ``target`` under ``pred``, each point weighted by
    ``weight[target]`` (the sum of weights floored at 1e-12), or the
    plain mean without ``weight``."""
    if weight is None:
        return nll_loss(pred, target)
    w = weight[target.long()]
    ll = torch.gather(pred, -1, target[..., None].long())[..., 0]
    return -torch.sum(ll * w) / torch.clamp_min(torch.sum(w), 1e-12)


class get_model(nn.Module):
    def __init__(self, num_class: int, with_rgb: bool = True,
                 channel: int | None = None, device=None):
        """``channel``: the input width, by default 6 with ``with_rgb``,
        else 3.  ``device``: where the parameters live; CUDA unless the
        caller names another (raises without a GPU)."""
        super().__init__()
        self.with_rgb = with_rgb
        self.channel = channel or (6 if with_rgb else 3)
        self.feat = PointNetEncoder(global_feat=False, feature_transform=True,
                                    channel=self.channel)
        for i, (a, b) in enumerate(((1088, 512), (512, 256), (256, 128))):
            setattr(self, f"conv{i + 1}", nn.Conv1d(a, b, 1))
            setattr(self, f"bn{i + 1}", BatchNorm(b))
        self.conv4 = nn.Conv1d(128, num_class, 1)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, *, bn_momentum: float = 0.1,
                generator: torch.Generator | None = None):
        """``x [B, N, channel]``; ``generator`` is unused (the model draws
        nothing), taken for the other models' call."""
        check_channels(self, x)
        x, _, trans_feat = self.feat(x, bn_momentum)
        for i in (1, 2, 3):
            x = conv_bn(getattr(self, f"conv{i}"), getattr(self, f"bn{i}"),
                        x, bn_momentum)
        x = dense(x, conv_weight(self.conv4), self.conv4.bias)
        return torch.log_softmax(x, dim=-1), trans_feat


def get_loss(pred, target, trans_feat, weight=None,
             mat_diff_loss_scale: float = 0.001):
    """The (class-weighted) NLL plus ``mat_diff_loss_scale`` times the
    feature transform's orthogonality penalty."""
    return weighted_nll(pred, target, weight) + mat_diff_loss_scale * \
        feature_transform_regularizer(trans_feat)
