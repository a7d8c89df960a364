"""PointNet++ MSG part segmentation, the primary PRIFIT model.

Port of ``prifit_tpu/models/pointnet2_part_seg_msg.py::get_model``:
SA-MSG(512) -> SA-MSG(128) -> SA-all(1024) -> FP3/FP2/FP1 (16-d one-hot
category + xyz skip) -> 128-d feat head -> dropout -> part
log-probabilities, with the convex self-sup loss computed inside the
forward.  Parameters and buffers carry the reference state_dict names, so
:func:`prifit_torch.convert.state_dict_from_jax` output loads with
``strict=True``.

Two variants, as in the JAX model:

- ``extra_layers``: fp1 has no MLP; its output runs in f32 through the
  dense chain ``fp1_conv1 -> fp1_conv1_bn1 -> relu -> fp1_conv2 ->
  fp1_conv2_bn2 -> relu`` (the ``*_bn*`` layers are 1x1 convolutions, a
  reference quirk), and the embedding the convex loss clusters comes
  from a tower of its own (``fp1_embed_conv1``, the SHARED
  ``fp1_conv1_bn1``, ``fp1_embed_conv2``, ``fp1_embed_conv2_bn2``,
  ``conv1_embed`` + ``conv1_embed_bn``, ``conv2_embed`` +
  ``conv2_embed_bn``, ``extra_conv_emb``).  The encoder's default dtype
  does not reach fp1; an explicit ``stage_dtypes`` dtype for fp1 raises.
- ``reconstruct``: AtlasNet (:mod:`prifit_torch.nn.atlasnet`) decodes
  ``z = mean(l0_points)`` (fp1's f32 output, not ``feat``) in every
  forward, and its dense chamfer to the input cloud is added to
  ``total_loss`` (``chamfer_loss`` is then 0).

Mode follows ``module.train()`` / ``module.eval()``.  Randomness (the
training FPS start, dropout, the ``mxsr`` stochastic rounding and the
convex loss's entropy subsample and jitter) comes only from an explicit
``torch.Generator``; without one, FPS starts at index 0.  As in the JAX
package, the convex loss takes its randomness only in training: an eval
forward takes its deterministic fallbacks.

Training with ``mxsr`` stages (the default ``"auto"``) takes one base key
of two uint32 words per forward, ``sr_key`` or drawn from the generator,
and gives the nine encoder regions ``fold_in(base, i)`` in forward call
order: sa1's scales 0-2, sa2's scales 0-1, sa3, fp3, fp2, fp1.  The JAX
package draws a fresh ``make_rng("sampling")`` per region instead, which
torch cannot reproduce.

Each encoder stage's call is a profiler range, ``encoder.sa1`` ..
``encoder.fp1`` (read by :mod:`prifit_torch.profile_forward` and the
benchmark's ``encoder_fwd_ms``).
"""

import torch
from torch import nn
from torch.profiler import record_function

from prifit_torch.geometry.convex_loss import convex_loss
from prifit_torch.models.common import (
    SegOutput,
    chamfer_loss_dense,
    dropout,
    encoder_dtypes,
    maybe_quant,
    nll_loss,
    pairwise_contrastive_loss,
    region_keys,
    stage_cfg,
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


# the dense chain after fp1 and the embedding tower under extra_layers
FP1_CHAIN = ("fp1_conv1", "fp1_conv1_bn1", "fp1_conv2", "fp1_conv2_bn2")
EMBED_TOWER = ("fp1_embed_conv1", "fp1_embed_conv2", "fp1_embed_conv2_bn2",
               "conv1_embed", "conv2_embed")


class get_model(nn.Module):
    def __init__(self, num_parts: int, normal_channel: bool = False,
                 reconstruct: bool = False, extra_layers: bool = False,
                 dropout_rate: float = 0.5, compute_dtype: str = "auto",
                 fused_ball_query: bool = True, stage_dtypes: str = "",
                 max_region: bool = False, device=None):
        """``device``: where the model's parameters live; CUDA unless the
        caller names another (raises without a GPU).  AtlasNet under
        ``reconstruct`` has the JAX model's 25 charts of 11^2 points
        (:class:`prifit_torch.nn.atlasnet.AtlasNet`'s defaults).
        ``max_region``: the SA scales' closed-form K-max region outside
        ``mx``/``mxsr`` (:mod:`prifit_torch.nn.pointnet2`)."""
        super().__init__()
        self.num_parts = num_parts
        self.dropout_rate = dropout_rate
        self.reconstruct = reconstruct
        self.extra_layers = extra_layers
        extra = 3 if normal_channel else 0
        dt_sa, dt_fp = encoder_dtypes(compute_dtype)
        # extra_layers: fp1 has no MLP (the dense chain after it runs
        # f32), so the encoder default dtype does not apply; only an
        # explicit stage_dtypes dtype for fp1 is an error
        cfg = {s: stage_cfg(stage_dtypes, s, dt_sa if s.startswith("sa")
                            else None if s == "fp1" and extra_layers
                            else dt_fp)
               for s in ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1")}
        if extra_layers and cfg["fp1"][0] is not None:
            raise ValueError(
                "stage_dtypes fp1:bf16/fq is not supported with "
                "extra_layers (the extra fp1 dense chain runs f32); use "
                "fp1:q or drop the override")
        self.quant = {s: q for s, (_, q) in cfg.items()}
        self.sa1 = SetAbstractionMsg(
            512, [0.1, 0.2, 0.4], [32, 64, 128], 3 + extra,
            [[32, 32, 64], [64, 64, 128], [64, 96, 128]],
            fused=fused_ball_query, dtype=cfg["sa1"][0],
            max_region=max_region)
        self.sa2 = SetAbstractionMsg(
            128, [0.4, 0.8], [64, 128], 128 + 128 + 64,
            [[128, 128, 256], [128, 196, 256]],
            fused=fused_ball_query, dtype=cfg["sa2"][0],
            max_region=max_region)
        self.sa3 = SetAbstractionAll(256 + 256 + 3, [256, 512, 1024],
                                     dtype=cfg["sa3"][0])
        self.fp3 = FeaturePropagation(1536, [256, 256], dtype=cfg["fp3"][0])
        self.fp2 = FeaturePropagation(576, [256, 128], dtype=cfg["fp2"][0])
        self.fp1 = FeaturePropagation(
            150 + extra, [] if extra_layers else [128, 128],
            dtype=cfg["fp1"][0])
        if extra_layers:
            for name in FP1_CHAIN + EMBED_TOWER:
                first = name in ("fp1_conv1", "fp1_embed_conv1")
                setattr(self, name,
                        nn.Conv1d(150 + extra if first else 128, 128, 1))
            self.conv1_embed_bn = BatchNorm(128)
            self.conv2_embed_bn = BatchNorm(128)
        self.conv1 = nn.Conv1d(128, 128, 1)
        self.bn1 = BatchNorm(128)
        self.conv2 = nn.Conv1d(128, num_parts, 1)
        self.extra_conv_emb = nn.Conv1d(128, 128, 1)
        if reconstruct:
            self.atlasnet = AtlasNet()
        # entropy-weight decay beta *= 0.99 until 0.001 (the JAX
        # package's ``selfsup_state`` collection), in the state_dict
        self.register_buffer("beta", torch.ones(()))
        # data parallelism: the convex loss's means over shapes reduce
        # over this group (nn.norm.set_process_group sets it)
        self.process_group = None
        self.to(resolve_device(device))

    def _head(self, x, conv):
        return dense(x, conv_weight(conv), conv.bias)

    def _embedding(self, feat, fp1_out, bn_momentum):
        """The embedding the convex loss clusters: ``extra_conv_emb`` of
        ``feat``, or under ``extra_layers`` of the tower on fp1's output
        (which shares ``fp1_conv1_bn1`` with the dense chain)."""
        h = self._head
        if not self.extra_layers:
            return h(feat, self.extra_conv_emb)
        e = self._fp1_denses(fp1_out, self.fp1_embed_conv1,
                             self.fp1_embed_conv2, self.fp1_embed_conv2_bn2)
        e = torch.relu(self.conv1_embed_bn(h(e, self.conv1_embed),
                                           bn_momentum))
        e = torch.relu(self.conv2_embed_bn(h(e, self.conv2_embed),
                                           bn_momentum))
        return h(e, self.extra_conv_emb)

    def _fp1_denses(self, x, first, third, fourth):
        """``first -> fp1_conv1_bn1 -> relu -> third -> fourth -> relu``
        on fp1's output under ``extra_layers`` (the dense chain and the
        embedding tower share ``fp1_conv1_bn1``)."""
        h = self._head
        x = torch.relu(h(h(x, first), self.fp1_conv1_bn1))
        return torch.relu(h(h(x, third), fourth))

    def _embed_for_loss(self, feat_embed):
        """The embedding as the convex loss takes it (here unchanged)."""
        return feat_embed

    def _reconstruct_input(self, feat, l0_points, include_convex_loss):
        """AtlasNet's latent ``[B, 128]``, or None when it does not run:
        here, in every forward, the mean of fp1's f32 output."""
        return l0_points.mean(dim=1) if self.reconstruct else None

    def _region_keys(self, generator, sr_key):
        """The nine regions' stochastic-rounding keys, or Nones when no
        stage trains in ``mxsr``."""
        return region_keys((self.sa1, self.sa2, self.sa3, self.fp3,
                            self.fp2, self.fp1), self.training, 9,
                           generator, sr_key)

    def forward(self, xyz: torch.Tensor, cls_label: torch.Tensor,
                chamfer_points: torch.Tensor | None = None, *,
                bn_momentum: float = 0.1,
                include_convex_loss: bool = False,
                if_cuboid: bool = False,
                include_intersect_loss: bool = False,
                include_entropy_loss: bool = False,
                include_pruning: bool = False,
                quantile: float = 0.01, msc_iterations: int = 5,
                max_num_clusters: int = 25, n_per_prim: int = 400,
                num_bandwidth_candidates: int = 2, alpha: float = 1.0,
                evaluation: bool = False, embed: bool = False,
                generator: torch.Generator | None = None,
                sr_key=None, entropy_sub=None, jitter=None) -> SegOutput:
        """``xyz [B, N, 3(+3)]`` channel-last, ``cls_label [B, 16]``
        one-hot; ``sr_key`` the ``mxsr`` base key (two uint32 words),
        drawn from ``generator`` when None; ``entropy_sub`` and ``jitter``
        the convex loss's draws (``geometry/convex_loss.py``), taken from
        ``generator`` when None."""
        B, N, _ = xyz.shape
        q = self.quant
        keys = self._region_keys(generator, sr_key)
        l0_points = xyz
        l0_xyz = xyz[..., :3]

        with record_function("encoder.sa1"):
            l1_xyz, l1_points = self.sa1(l0_xyz, l0_points, bn_momentum,
                                         generator, keys[0:3])
        l1_points = maybe_quant(l1_points, q["sa1"])
        with record_function("encoder.sa2"):
            l2_xyz, l2_points = self.sa2(l1_xyz, l1_points, bn_momentum,
                                         generator, keys[3:5])
        l2_points = maybe_quant(l2_points, q["sa2"])
        with record_function("encoder.sa3"):
            l3_xyz, l3_points = self.sa3(l2_xyz, l2_points, bn_momentum,
                                         keys[5])
        l3_points = maybe_quant(l3_points, q["sa3"])

        with record_function("encoder.fp3"):
            l2_points = self.fp3(l2_xyz, l3_xyz, l2_points, l3_points,
                                 bn_momentum, keys[6])
        l2_points = maybe_quant(l2_points, q["fp3"])
        with record_function("encoder.fp2"):
            l1_points = self.fp2(l1_xyz, l2_xyz, l1_points, l2_points,
                                 bn_momentum, keys[7])
        l1_points = maybe_quant(l1_points, q["fp2"])
        cls_onehot = cls_label[:, None, :].expand(B, N, cls_label.shape[-1])
        skip = torch.cat([cls_onehot.float(), l0_xyz.float(),
                          l0_points.float()], dim=-1)
        with record_function("encoder.fp1"):
            fp1_out = l0_points = self.fp1(l0_xyz, l1_xyz, skip, l1_points,
                                           bn_momentum, keys[8])
        if self.extra_layers:
            fp1_out = fp1_out.float()
            l0_points = self._fp1_denses(fp1_out, self.fp1_conv1,
                                         self.fp1_conv2, self.fp1_conv2_bn2)
        l0_points = maybe_quant(l0_points, q["fp1"])

        # everything from the head on runs f32
        l0_points = l0_points.float()
        feat = torch.relu(self.bn1(self._head(l0_points, self.conv1),
                                   bn_momentum))
        zero = torch.zeros((), dtype=torch.float32, device=xyz.device)
        total_loss, chamfer, convex_out, feat_embed = zero, zero, None, None
        if embed and not include_convex_loss:
            feat_embed = self._embedding(feat, fp1_out, bn_momentum)
        if include_convex_loss:
            # entropy-weight decay beta *= 0.99 until 0.001, stored only in
            # training (the self-sup step), as JAX mutates selfsup_state
            # only there
            beta = self.beta
            new_beta = torch.where(beta > 0.001, beta * 0.99, beta)
            beta_eff = torch.where(beta > 0.001, new_beta,
                                   torch.zeros_like(beta))
            if self.training:
                with torch.no_grad():
                    self.beta.copy_(new_beta)
            feat_embed = self._embed_for_loss(
                self._embedding(feat, fp1_out, bn_momentum))
            draws = dict(generator=generator, entropy_sub=entropy_sub,
                         jitter=jitter) if self.training else {}
            convex_out = convex_loss(
                l0_xyz, chamfer_points, feat_embed, quantile=quantile,
                iterations=msc_iterations,
                max_num_clusters=max_num_clusters, n_per_prim=n_per_prim,
                num_bandwidth_candidates=num_bandwidth_candidates,
                include_intersect_loss=include_intersect_loss,
                include_entropy_loss=include_entropy_loss,
                include_pruning=include_pruning, alpha=alpha,
                beta=beta_eff, if_cuboid=if_cuboid, evaluation=evaluation,
                group=self.process_group, **draws)
            total_loss, chamfer = convex_out.total, convex_out.chamfer

        recon = None
        z = self._reconstruct_input(feat, l0_points, include_convex_loss)
        if z is not None:
            recon = self.atlasnet(z, bn_momentum)
            total_loss = total_loss + chamfer_loss_dense(recon, l0_xyz)
            chamfer = zero

        x = dropout(feat, self.dropout_rate, self.training, generator)
        x = torch.log_softmax(self._head(x, self.conv2), dim=-1)
        hidden = tuple(h.float() for h in (l1_points, l2_points, l3_points))
        return SegOutput(seg_logits=x, hidden=hidden, feat=feat,
                         total_loss=total_loss, chamfer_loss=chamfer,
                         convex=convex_out, recon_points=recon,
                         embedding=feat_embed)


def get_loss(pred, target, trans_feat=None):
    """NLL over log-probabilities (``get_loss`` of the JAX package's
    ``pointnet2_part_seg_msg``)."""
    return nll_loss(pred, target)


def get_selfsup_loss(feat, target, generator=None, margin=0.5,
                     uniforms=None, group=None):
    """The ACD pairwise contrastive loss
    (:func:`prifit_torch.models.common.pairwise_contrastive_loss`)."""
    return pairwise_contrastive_loss(feat, target, generator, margin,
                                     uniforms=uniforms, group=group)
