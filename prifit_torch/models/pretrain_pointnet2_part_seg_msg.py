"""PointNet++ MSG pretraining model.

Port of ``prifit_tpu/models/pretrain_pointnet2_part_seg_msg.py``: the
backbone and heads of :mod:`prifit_torch.models.pointnet2_part_seg_msg`
with no ``extra_layers`` tower, under the same state_dict names, so a
pretrain checkpoint warm-starts the part-seg model.  Two differences:

- ``l2_norm`` normalizes ``extra_conv_emb``'s output (the norm floored
  at 1e-12) before the convex loss clusters it;
- ``reconstruct`` decodes ``z = mean(feat)`` with AtlasNet and makes its
  dense chamfer the ``total_loss``, and it runs only when the convex loss
  is off (the JAX model's ``elif``), where the part-seg model decodes
  fp1's output in every forward.
"""

import torch

from prifit_torch.models import pointnet2_part_seg_msg as msg
from prifit_torch.models.common import nll_loss, pairwise_contrastive_loss


class get_model(msg.get_model):
    def __init__(self, num_parts: int, normal_channel: bool = False,
                 l2_norm: bool = False, reconstruct: bool = False,
                 dropout_rate: float = 0.5, compute_dtype: str = "auto",
                 fused_ball_query: bool = True, stage_dtypes: str = "",
                 max_region: bool = False, device=None):
        """``device``: where the model's parameters live; CUDA unless the
        caller names another (raises without a GPU)."""
        super().__init__(num_parts, normal_channel,
                         reconstruct=reconstruct, dropout_rate=dropout_rate,
                         compute_dtype=compute_dtype,
                         fused_ball_query=fused_ball_query,
                         stage_dtypes=stage_dtypes, max_region=max_region,
                         device=device)
        self.l2_norm = l2_norm

    def _embed_for_loss(self, feat_embed):
        if not self.l2_norm:
            return feat_embed
        return feat_embed / torch.clamp_min(
            torch.linalg.norm(feat_embed, dim=-1, keepdim=True), 1e-12)

    def _reconstruct_input(self, feat, l0_points, include_convex_loss):
        # unlike the part-seg model: the mean of feat, and only when the
        # convex loss is off
        if self.reconstruct and not include_convex_loss:
            return feat.mean(dim=1)
        return None


def get_loss(pred, target, trans_feat=None):
    """NLL over log-probabilities."""
    return nll_loss(pred, target)


def get_selfsup_loss(feat, target, generator=None, margin=0.5,
                     uniforms=None, group=None):
    """The ACD pairwise contrastive loss
    (:func:`prifit_torch.models.common.pairwise_contrastive_loss`)."""
    return pairwise_contrastive_loss(feat, target, generator, margin,
                                     uniforms=uniforms, group=group)
