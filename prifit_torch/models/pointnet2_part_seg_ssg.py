"""PointNet++ SSG part segmentation, the few-shot baseline.

Port of ``prifit_tpu/models/pointnet2_part_seg_ssg.py::get_model``:
SA(512, r=0.2, K=32) -> SA(128, r=0.4, K=64) -> SA-all(1024) ->
FP3/FP2/FP1 (16-d one-hot category + xyz skip) -> 128-d feat head ->
dropout -> part log-probabilities.  ``hidden`` is sa3's global feature.
The model has no self-sup loss of its own: it takes the convex loss's
arguments and ignores them, so its ``total_loss`` is a constant 0.
Parameters and buffers carry the reference state_dict names (``sa1``,
``sa2``, ``sa3``, ``fp3``, ``fp2``, ``fp1``, ``conv1``, ``bn1``,
``conv2``); :func:`prifit_torch.convert.state_dict_from_jax` output
loads with ``strict=True``.

``compute_dtype`` means what it means for the MSG model
(:func:`prifit_torch.models.common.encoder_dtypes`, ``"auto"`` =
``mxsr``).  Training in ``mxsr`` takes one base key of two uint32 words
per forward, ``sr_key`` or drawn from the generator, and gives the six
encoder regions ``fold_in(base, i)`` in forward call order: sa1, sa2,
sa3, fp3, fp2, fp1.  Randomness (the training FPS start, dropout, the
rounding keys) comes only from an explicit ``torch.Generator``; without
one, FPS starts at index 0.
"""

import torch
from torch import nn

from prifit_torch.models.common import (
    SegOutput,
    dropout,
    encoder_dtypes,
    nll_loss,
    region_keys,
)
from prifit_torch.nn.norm import BatchNorm
from prifit_torch.nn.pointnet2 import (
    FeaturePropagation,
    SetAbstraction,
    SetAbstractionAll,
    conv_weight,
    dense,
)
from prifit_torch.utils.device import resolve_device


class get_model(nn.Module):
    def __init__(self, num_classes: int, normal_channel: bool = False,
                 dropout_rate: float = 0.5, compute_dtype: str = "auto",
                 max_region: bool = False, device=None):
        """``num_classes``: the part count (the JAX model's name for it).
        ``device``: where the parameters live; CUDA unless the caller
        names another (raises without a GPU)."""
        super().__init__()
        self.dropout_rate = dropout_rate
        extra = 3 if normal_channel else 0
        dt_sa, dt_fp = encoder_dtypes(compute_dtype)
        self.sa1 = SetAbstraction(512, 0.2, 32, 3 + extra, [64, 64, 128],
                                  dtype=dt_sa, max_region=max_region)
        self.sa2 = SetAbstraction(128, 0.4, 64, 128, [128, 128, 256],
                                  dtype=dt_sa, max_region=max_region)
        self.sa3 = SetAbstractionAll(256 + 3, [256, 512, 1024], dtype=dt_sa)
        self.fp3 = FeaturePropagation(1280, [256, 256], dtype=dt_fp)
        self.fp2 = FeaturePropagation(384, [256, 128], dtype=dt_fp)
        self.fp1 = FeaturePropagation(150 + extra, [128, 128, 128],
                                      dtype=dt_fp)
        self.conv1 = nn.Conv1d(128, 128, 1)
        self.bn1 = BatchNorm(128)
        self.conv2 = nn.Conv1d(128, num_classes, 1)
        self.to(resolve_device(device))

    def _head(self, x, conv):
        return dense(x, conv_weight(conv), conv.bias)

    def forward(self, xyz: torch.Tensor, cls_label: torch.Tensor,
                chamfer_points: torch.Tensor | None = None, *,
                bn_momentum: float = 0.1,
                generator: torch.Generator | None = None, sr_key=None,
                **_unused) -> SegOutput:
        """``xyz [B, N, 3(+3)]`` channel-last, ``cls_label [B, 16]``
        one-hot; ``sr_key`` the ``mxsr`` base key, drawn from
        ``generator`` when None."""
        B, N, _ = xyz.shape
        keys = region_keys((self.sa1, self.sa2, self.sa3, self.fp3,
                            self.fp2, self.fp1), self.training, 6,
                           generator, sr_key)
        l0_points = xyz
        l0_xyz = xyz[..., :3]
        l1_xyz, l1_points = self.sa1(l0_xyz, l0_points, bn_momentum,
                                     generator, keys[0])
        l2_xyz, l2_points = self.sa2(l1_xyz, l1_points, bn_momentum,
                                     generator, keys[1])
        l3_xyz, l3_points = self.sa3(l2_xyz, l2_points, bn_momentum, keys[2])
        l2_points = self.fp3(l2_xyz, l3_xyz, l2_points, l3_points,
                             bn_momentum, keys[3])
        l1_points = self.fp2(l1_xyz, l2_xyz, l1_points, l2_points,
                             bn_momentum, keys[4])
        cls_onehot = cls_label[:, None, :].expand(B, N, cls_label.shape[-1])
        skip = torch.cat([cls_onehot.float(), l0_xyz.float(),
                          l0_points.float()], dim=-1)
        l0_points = self.fp1(l0_xyz, l1_xyz, skip, l1_points, bn_momentum,
                             keys[5])

        # the head runs f32
        feat = torch.relu(self.bn1(self._head(l0_points.float(), self.conv1),
                                   bn_momentum))
        x = dropout(feat, self.dropout_rate, self.training, generator)
        x = torch.log_softmax(self._head(x, self.conv2), dim=-1)
        zero = torch.zeros((), dtype=torch.float32, device=xyz.device)
        return SegOutput(seg_logits=x, hidden=l3_points.float(), feat=feat,
                         total_loss=zero, chamfer_loss=zero)


def get_loss(pred, target, trans_feat=None):
    """NLL over log-probabilities."""
    return nll_loss(pred, target)

