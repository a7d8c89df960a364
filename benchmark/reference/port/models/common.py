# Frozen copy of prifit_torch/models/common.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""Model output contract and encoder dtype selection.

Port of ``prifit_tpu/models/common.py``: ``SegOutput``, ``nll_loss``,
``pairwise_contrastive_loss`` and ``encoder_dtypes``, with the draws the
models share (``region_keys``, ``dropout``); the copy leaves out the
program's helpers that no cell's path calls.
"""

from typing import Any, NamedTuple

import torch
from torch.profiler import record_function

from benchmark.reference.port.nn.mixed import fold_in
from benchmark.reference.port.parallel.collectives import all_reduce_, group_size, psum
from benchmark.reference.port.nn.pointnet2 import MX, MXSR


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


def region_keys(stages, training: bool, n: int, generator, sr_key):
    """The ``n`` stochastic-rounding keys of an encoder's regions in
    forward call order, ``fold_in(base, i)``, or ``n`` Nones when no stage
    of ``stages`` trains in ``MXSR``.  The base key of two uint32 words
    is ``sr_key``, else drawn from ``generator`` (the step's one read of
    it to the host)."""
    if not (training and any(s.dtype == MXSR for s in stages)):
        return [None] * n
    if sr_key is None:
        if generator is None:
            raise ValueError("training in mxsr needs a generator or an "
                             "sr_key for its stochastic rounding")
        sr_key = torch.randint(0, 2 ** 32, (2,), generator=generator,
                               device=generator.device).tolist()
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
