"""Model output contract and encoder dtype selection.

Port of ``prifit_tpu/models/common.py``: ``SegOutput``, ``nll_loss``,
``to_categorical``, ``pairwise_contrastive_loss``, ``chamfer_loss_dense``,
``encoder_dtypes``, ``stage_cfg`` and ``maybe_quant``; with the draws the
models share (``region_keys``, ``dropout``).
"""

from typing import Any, NamedTuple

import torch
from torch.profiler import record_function

from prifit_torch.nn.mixed import fold_in
from prifit_torch.parallel.collectives import all_reduce_, group_size, psum
from prifit_torch.nn.pointnet2 import FQ, MX, MXSR


class SegOutput(NamedTuple):
    """Part-segmentation forward output."""
    seg_logits: torch.Tensor       # [B, N, parts] log-probabilities
    hidden: Any                    # encoder intermediates
    feat: torch.Tensor             # [B, N, 128] pre-head features
    total_loss: torch.Tensor       # [] self-sup total (0 when disabled)
    chamfer_loss: torch.Tensor     # [] chamfer component (0 when disabled)
    convex: Any = None             # ConvexLossOutput | None
    trans_feat: Any = None         # STN feature transform (pointnet only)
    recon_points: Any = None       # AtlasNet reconstruction | None
    embedding: Any = None          # [B, N, 128] extra_conv_emb output


def nll_loss(pred_logprob: torch.Tensor, target: torch.Tensor
             ) -> torch.Tensor:
    """Mean negative log likelihood of ``target [...]`` (int labels)
    under ``pred_logprob [..., C]`` log-probabilities (the JAX package's
    ``nll_loss``, which corrects the reference's cross-entropy on
    log-probabilities)."""
    ll = torch.gather(pred_logprob, -1, target[..., None].long())[..., 0]
    return -torch.mean(ll)


def to_categorical(y: torch.Tensor, num_classes: int = 16) -> torch.Tensor:
    """One-hot f32 category labels of ``y`` (flattened)."""
    return torch.nn.functional.one_hot(y.reshape(-1).long(),
                                       num_classes).float()


def pairwise_contrastive_loss(feat: torch.Tensor, target: torch.Tensor,
                              generator: torch.Generator | None = None,
                              margin: float = 0.5, num_classes: int = 64,
                              uniforms: torch.Tensor | None = None,
                              group=None) -> torch.Tensor:
    """The ACD pairwise contrastive self-sup loss of per-point features
    ``feat [B, N, C]`` under component labels ``target [B, N]``: cosine
    similarity of the normalized features; pairs of one component pull
    toward 1, the others hinge at ``margin``; the diagonal is masked, and
    negatives are kept where ``uniforms [B, N, N]`` (else ``U[0, 1)`` from
    ``generator``) exceeds ``1 - `` the share of positive pairs.

    A label outside ``[0, num_classes)`` has no component, as under the
    JAX package's one-hot: its point pairs with no point, itself
    included.  ``group`` (data parallelism): the share of positive pairs
    and the mean are the global batch's."""
    with record_function("pairwise_contrastive_loss"):
        feat = feat / torch.clamp_min(
            torch.linalg.norm(feat, dim=-1, keepdim=True), 1e-12)
        pair_sim = torch.matmul(feat, feat.transpose(1, 2))
        known = (target >= 0) & (target < num_classes)
        # the pairs of one component; the JAX package's 0/1 pair_target
        pos = (target[:, :, None] == target[:, None, :]) & known[:, :, None]
        cosine = torch.where(pos, 1.0 - pair_sim,
                             torch.relu(pair_sim - margin))
        size = group_size(group)
        pos_fraction = all_reduce_(pos.sum().float(), group) \
            / (pos.numel() * size)
        if uniforms is None:
            if generator is None:
                raise ValueError("the contrastive loss needs a generator or "
                                 "uniforms to subsample its negatives")
            uniforms = torch.rand(pos.shape, generator=generator,
                                  device=generator.device).to(feat.device)
        keep = (pos | (uniforms > 1.0 - pos_fraction)) & ~torch.eye(
            pos.shape[1], dtype=torch.bool, device=feat.device)
        loss = 0.5 * torch.mean(torch.where(keep, cosine, 0.0))
        return loss if size == 1 else psum(loss, group) / size


def chamfer_loss_dense(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Symmetric dense chamfer of ``x [B, M, 3]`` and ``y [B, N, 3]``: the
    mean over ``x`` of the squared distance to the nearest point of ``y``
    plus the same from ``y`` to ``x``, with the distances from the
    expanded square clamped at 0 (the JAX package's
    ``chamfer_loss_dense``)."""
    d = torch.sum(x * x, -1)[..., :, None] \
        + torch.sum(y * y, -1)[..., None, :] \
        - 2.0 * torch.matmul(x, y.transpose(-1, -2))
    d = torch.clamp_min(d, 0.0)
    return torch.mean(torch.amin(d, dim=-1)) \
        + torch.mean(torch.amin(d, dim=-2))


def encoder_dtypes(compute_dtype: str):
    """(SA dtype, FP dtype) of the encoder MLP chains.  The default
    ``"auto"`` is ``"mxsr"``, which runs as plain bf16 in eval mode."""
    if compute_dtype in ("bf16", "bfloat16"):
        return torch.bfloat16, torch.bfloat16
    if compute_dtype == "sa_bf16":
        return torch.bfloat16, None
    if compute_dtype == "mx":
        return MX, MX
    if compute_dtype in ("mxsr", "auto"):
        return MXSR, MXSR
    return None, None


ENCODER_STAGES = ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1")
STAGE_MODES = ("f32", "bf16", "bfloat16", "q", "fq", "mx", "mxsr")


def stage_cfg(stage_dtypes: str, stage: str, default_dtype):
    """(mlp dtype, quantize_output) of one encoder stage of a
    ``stage_dtypes`` spec like ``"sa1:bf16,fp2:q"``.  Unknown stages or
    modes raise; unlisted stages keep ``default_dtype``."""
    if not stage_dtypes:
        return default_dtype, False
    spec = dict(kv.split(":") for kv in stage_dtypes.split(",") if kv)
    bad = set(spec) - set(ENCODER_STAGES)
    if bad:
        raise ValueError(f"stage_dtypes: unknown stage(s) {sorted(bad)}; "
                         f"valid: {ENCODER_STAGES}")
    bad_modes = set(spec.values()) - set(STAGE_MODES)
    if bad_modes:
        raise ValueError(f"stage_dtypes: unknown mode(s) "
                         f"{sorted(bad_modes)}; valid: {STAGE_MODES}")
    if stage not in spec:
        return default_dtype, False
    mode = spec[stage]
    if mode in ("bf16", "bfloat16"):
        return torch.bfloat16, False
    if mode == "q":
        return None, True
    if mode == "fq":
        return FQ, False
    if mode == "mx":
        return MX, False
    if mode == "mxsr":
        return MXSR, False
    return None, False


def maybe_quant(x: torch.Tensor, quant: bool) -> torch.Tensor:
    """bf16-round forward VALUES only; the backward is the identity."""
    if not quant:
        return x
    x = x.float()
    return x + (x.bfloat16().float() - x).detach()


def region_keys(stages, training: bool, n: int, generator, sr_key):
    """The ``n`` stochastic-rounding keys of an encoder's regions in
    forward call order, ``fold_in(base, i)``, or ``n`` Nones when no stage
    of ``stages`` trains in ``MXSR``.  The base key of two uint32 words
    is ``sr_key``, else drawn from ``generator`` (the step's one read of
    it to the host, the host sync ``sync.sr_key``)."""
    if not (training and any(s.dtype == MXSR for s in stages)):
        return [None] * n
    if sr_key is None:
        if generator is None:
            raise ValueError("training in mxsr needs a generator or an "
                             "sr_key for its stochastic rounding")
        drawn = torch.randint(0, 2 ** 32, (2,), generator=generator,
                              device=generator.device)
        with record_function("sync.sr_key"):
            sr_key = drawn.tolist()
    return [fold_in(sr_key, i) for i in range(n)]


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout of ``x`` at ``rate`` in training, its mask drawn
    from ``generator`` (which training at a rate above 0 needs)."""
    if not training or rate <= 0:
        return x
    if generator is None:
        raise ValueError("training with dropout needs a generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator,
                      device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))
