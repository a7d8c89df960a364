"""AtlasNet reconstruction part segmentation, a baseline.

Port of ``prifit_tpu/models/reconstruction.py::get_model``: the MSG
encoder of :mod:`prifit_torch.models.pointnet2_part_seg_msg` at f32 (the
JAX model takes no dtype), its 128-d ``feat`` head, dropout and part
log-probabilities, and an AtlasNet (:mod:`prifit_torch.nn.atlasnet`, 25
charts of 11^2 points) that decodes ``mean(feat)`` in every forward into
``recon_points``.  ``hidden`` is ``(l1, l2, l3)``.  It has none of the
MSG model's self-sup layers (no ``extra_conv_emb``, no ``beta``); it
takes the convex loss's arguments and ignores them, so its
``total_loss`` is a constant 0.  Its own objectives are
:func:`get_selfsup_loss` (contrastive) and
:func:`get_rec_selfsup_loss` (contrastive plus the reconstruction's
chamfer).  State_dict names are the MSG model's and AtlasNet's.
"""

import torch
from torch import nn

from prifit_torch.models.common import (
    SegOutput,
    chamfer_loss_dense,
    dropout,
    nll_loss,
    pairwise_contrastive_loss,
)
from prifit_torch.nn.atlasnet import AtlasNet
from prifit_torch.nn.norm import BatchNorm
from prifit_torch.nn.pointnet2 import (
    FeaturePropagation,
    SetAbstractionAll,
    SetAbstractionMsg,
    conv_weight,
    dense,
)
from prifit_torch.utils.device import resolve_device


class get_model(nn.Module):
    def __init__(self, num_classes: int, normal_channel: bool = False,
                 dropout_rate: float = 0.5, max_region: bool = False,
                 device=None):
        """``num_classes``: the part count.  ``device``: where the
        parameters live; CUDA unless the caller names another (raises
        without a GPU)."""
        super().__init__()
        self.dropout_rate = dropout_rate
        extra = 3 if normal_channel else 0
        self.sa1 = SetAbstractionMsg(
            512, [0.1, 0.2, 0.4], [32, 64, 128], 3 + extra,
            [[32, 32, 64], [64, 64, 128], [64, 96, 128]],
            max_region=max_region)
        self.sa2 = SetAbstractionMsg(
            128, [0.4, 0.8], [64, 128], 128 + 128 + 64,
            [[128, 128, 256], [128, 196, 256]], max_region=max_region)
        self.sa3 = SetAbstractionAll(256 + 256 + 3, [256, 512, 1024])
        self.fp3 = FeaturePropagation(1536, [256, 256])
        self.fp2 = FeaturePropagation(576, [256, 128])
        self.fp1 = FeaturePropagation(150 + extra, [128, 128])
        self.conv1 = nn.Conv1d(128, 128, 1)
        self.bn1 = BatchNorm(128)
        self.conv2 = nn.Conv1d(128, num_classes, 1)
        self.atlasnet = AtlasNet()
        self.to(resolve_device(device))

    def _head(self, x, conv):
        return dense(x, conv_weight(conv), conv.bias)

    def forward(self, xyz: torch.Tensor, cls_label: torch.Tensor,
                chamfer_points: torch.Tensor | None = None, *,
                bn_momentum: float = 0.1,
                generator: torch.Generator | None = None,
                **_unused) -> SegOutput:
        """``xyz [B, N, 3(+3)]`` channel-last, ``cls_label [B, 16]``
        one-hot; ``generator`` draws the training FPS starts and the
        dropout mask."""
        B, N, _ = xyz.shape
        l0_points = xyz
        l0_xyz = xyz[..., :3]
        l1_xyz, l1_points = self.sa1(l0_xyz, l0_points, bn_momentum,
                                     generator)
        l2_xyz, l2_points = self.sa2(l1_xyz, l1_points, bn_momentum,
                                     generator)
        l3_xyz, l3_points = self.sa3(l2_xyz, l2_points, bn_momentum)
        l2_points = self.fp3(l2_xyz, l3_xyz, l2_points, l3_points,
                             bn_momentum)
        l1_points = self.fp2(l1_xyz, l2_xyz, l1_points, l2_points,
                             bn_momentum)
        cls_onehot = cls_label[:, None, :].expand(B, N, cls_label.shape[-1])
        skip = torch.cat([cls_onehot.float(), l0_xyz.float(),
                          l0_points.float()], dim=-1)
        l0_points = self.fp1(l0_xyz, l1_xyz, skip, l1_points, bn_momentum)

        feat = torch.relu(self.bn1(self._head(l0_points, self.conv1),
                                   bn_momentum))
        x = dropout(feat, self.dropout_rate, self.training, generator)
        x = torch.log_softmax(self._head(x, self.conv2), dim=-1)
        recon = self.atlasnet(feat.mean(dim=1), bn_momentum)
        zero = torch.zeros((), dtype=torch.float32, device=xyz.device)
        return SegOutput(seg_logits=x, hidden=(l1_points, l2_points,
                                               l3_points),
                         feat=feat, total_loss=zero, chamfer_loss=zero,
                         recon_points=recon)


def get_loss(pred, target, trans_feat=None):
    """NLL over log-probabilities."""
    return nll_loss(pred, target)


def get_selfsup_loss(feat, target, generator=None, margin=0.5,
                     uniforms=None, group=None):
    """The ACD pairwise contrastive loss
    (:func:`prifit_torch.models.common.pairwise_contrastive_loss`)."""
    return pairwise_contrastive_loss(feat, target, generator, margin,
                                     uniforms=uniforms, group=group)


def get_rec_selfsup_loss(feat, target, pts, gtpts, generator=None,
                         margin=0.5, lcont: float = 0.0, lrec: float = 1.0,
                         uniforms=None):
    """``lcont`` times the contrastive loss of ``feat`` plus ``lrec``
    times the dense chamfer of the reconstruction ``pts`` to ``gtpts``
    (reference ``models/reconstruction.py:169-201``)."""
    cont = pairwise_contrastive_loss(feat, target, generator, margin,
                                     uniforms=uniforms)
    return lcont * cont + lrec * chamfer_loss_dense(pts, gtpts)
