"""Model output contract and encoder dtype selection.

Port of ``prifit_tpu/models/common.py``: ``SegOutput``, ``nll_loss``,
``encoder_dtypes``, ``stage_cfg`` and ``maybe_quant``.
"""

from typing import Any, NamedTuple

import torch

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
