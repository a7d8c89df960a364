"""The original PointNet part segmentation, a baseline.

Port of ``prifit_tpu/models/pointnet_part_seg.py::get_model``: the 3x3
input transform (``stn``), five conv stages, the 128x128 feature
transform (``fstn``) after the third, the 2048-d global max with the
16-d one-hot category, and the 4944-channel segmentation head
(``convs1..4``, ``bns1..3``).  It returns the feature transform as
``trans_feat``, which :func:`get_loss` regularizes.  The model has no
self-sup loss of its own: it takes the convex loss's arguments and
ignores them, so its ``total_loss`` is a constant 0.  It draws nothing:
no FPS, no dropout.
"""

import torch
from torch import nn

from prifit_torch.models.common import (
    SegOutput,
    nll_loss,
    pairwise_contrastive_loss,
)
from prifit_torch.nn.norm import BatchNorm
from prifit_torch.nn.pointnet import (
    STN,
    conv_bn,
    feature_transform_regularizer,
    transform,
)
from prifit_torch.nn.pointnet2 import conv_weight, dense
from prifit_torch.utils.device import resolve_device

# (name, in, out) of the conv stages and of the head
STAGES = (("1", None, 64), ("2", 64, 128), ("3", 128, 128), ("4", 128, 512),
          ("5", 512, 2048), ("s1", 4944, 256), ("s2", 256, 256),
          ("s3", 256, 128))


class get_model(nn.Module):
    def __init__(self, part_num: int = 50, normal_channel: bool = True,
                 device=None):
        """``device``: where the parameters live; CUDA unless the caller
        names another (raises without a GPU)."""
        super().__init__()
        channel = 6 if normal_channel else 3
        self.stn = STN(3, channel)
        for name, a, b in STAGES:
            setattr(self, f"conv{name}", nn.Conv1d(a or channel, b, 1))
            setattr(self, f"bn{name}", BatchNorm(b))
        self.fstn = STN(128)
        self.convs4 = nn.Conv1d(128, part_num, 1)
        self.to(resolve_device(device))

    def _block(self, name, x, bn_momentum, relu=True):
        return conv_bn(getattr(self, f"conv{name}"),
                       getattr(self, f"bn{name}"), x, bn_momentum, relu)

    def forward(self, point_cloud: torch.Tensor, label: torch.Tensor,
                chamfer_points: torch.Tensor | None = None, *,
                bn_momentum: float = 0.1, **_unused) -> SegOutput:
        """``point_cloud [B, N, 3(+3)]``, ``label [B, 16]`` one-hot."""
        B, N, _ = point_cloud.shape
        trans = self.stn(point_cloud, bn_momentum)
        x = transform(point_cloud, trans)
        out1 = self._block("1", x, bn_momentum)
        out2 = self._block("2", out1, bn_momentum)
        out3 = self._block("3", out2, bn_momentum)
        trans_feat = self.fstn(out3, bn_momentum)
        net_t = torch.matmul(out3, trans_feat)
        out4 = self._block("4", net_t, bn_momentum)
        out5 = self._block("5", out4, bn_momentum, relu=False)
        out_max = torch.cat([torch.amax(out5, dim=1), label.to(out5.dtype)],
                            dim=-1)                              # [B, 2064]
        expand = out_max[:, None, :].expand(B, N, out_max.shape[-1])
        net = torch.cat([expand, out1, out2, out3, out4, out5], dim=-1)
        net = self._block("s1", net, bn_momentum)
        net = self._block("s2", net, bn_momentum)
        feat = self._block("s3", net, bn_momentum)
        net = dense(feat, conv_weight(self.convs4), self.convs4.bias)
        zero = torch.zeros((), dtype=torch.float32,
                           device=point_cloud.device)
        return SegOutput(seg_logits=torch.log_softmax(net, dim=-1),
                         hidden=out_max, feat=feat, total_loss=zero,
                         chamfer_loss=zero, trans_feat=trans_feat)


def get_loss(pred, target, trans_feat, mat_diff_loss_scale: float = 0.001):
    """NLL plus ``mat_diff_loss_scale`` times the feature transform's
    orthogonality penalty."""
    return nll_loss(pred, target) + mat_diff_loss_scale * \
        feature_transform_regularizer(trans_feat)


def get_selfsup_loss(feat, target, generator=None, margin=0.5,
                     uniforms=None, group=None):
    """The ACD pairwise contrastive loss
    (:func:`prifit_torch.models.common.pairwise_contrastive_loss`)."""
    return pairwise_contrastive_loss(feat, target, generator, margin,
                                     uniforms=uniforms, group=group)
