"""Entry points of the port: the flagship model, its eval forward with
primitive fit, and its train steps (supervised, self-sup and contrastive).

Mirrors ``__graft_entry__._flagship`` / ``entry`` and the programs that
``bench.py`` times: ``pointnet2_part_seg_msg`` with 50 parts, in eval
mode, run with the convex self-sup loss against the input cloud itself;
and, in train mode, the supervised step and the self-sup step, at the
default encoder dtype (``"auto"`` = ``mxsr``, ``bench.py``'s headline
train fields) or with the f32 encoder (its secondary ones).  Weights are
random, made from a seed (lecun-normal kernels and zero biases, the JAX
package's initializers; fresh batch-norm statistics).
"""

import numpy as np
import torch

from prifit_torch.models.pointnet2_part_seg_msg import get_model
from prifit_torch.nn.atlasnet import ChartDense
from prifit_torch.nn.norm import GroupNorm
from prifit_torch.nn.pointnet import STN
from prifit_torch.train.state import create_train_state
from prifit_torch.utils.device import resolve_device

# the eval forward bench.py times (bench.py:71-88)
BENCH_KWARGS = dict(quantile=0.05, msc_iterations=10, max_num_clusters=25,
                    n_per_prim=256, num_bandwidth_candidates=2)
BENCH_BATCH, BENCH_NPOINT = 24, 2048
# the per-step scalars of bench.py's train steps (bench.py:143-159)
TRAIN_SETTINGS = dict(lr=0.001, bn_momentum=0.1, lmbda=1.0)
# every option of the convex loss, with the canonical recipe's alpha
# (prifit_tpu/cli/train_partseg.py:14); if_cuboid is the one left out
SELFSUP_OPTIONS = dict(include_entropy_loss=True, include_intersect_loss=True,
                       include_pruning=True, alpha=0.01)


def init_weights(model: torch.nn.Module, generator: torch.Generator
                 ) -> None:
    """The JAX package's initializers, drawn from ``generator`` on the
    CPU: lecun-normal weights (std 1/sqrt(fan_in)) and zero biases for
    every 1x1 conv, ``nn.Linear`` and chart dense; scale 1 and bias 0 for
    every group norm; and zero for a spatial transformer's last dense,
    which then outputs the identity."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv1d, torch.nn.Conv2d,
                                torch.nn.Linear, ChartDense)):
                fan_in = mod.in_channels if isinstance(
                    mod, (torch.nn.Conv1d, torch.nn.Conv2d)) \
                    else mod.in_features
                w = torch.randn(mod.weight.shape, generator=generator)
                mod.weight.copy_(w / fan_in ** 0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for mod in model.modules():
            if isinstance(mod, STN):
                mod.fc3.weight.zero_()


def flagship(batch: int, npoint: int, *, device=None):
    """``(model, points, cls)``: the eval-mode flagship model (default
    dtype, fused ball query) with random weights from seed 0, and a
    gaussian cloud ``[batch, npoint, 3]`` from seed 0 with category 0."""
    device = resolve_device(device)
    model = get_model(num_parts=50, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    rng = np.random.default_rng(0)
    points = torch.as_tensor(
        rng.normal(size=(batch, npoint, 3)).astype(np.float32),
        device=device)
    cls = torch.zeros((batch, 16), dtype=torch.float32, device=device)
    return model, points, cls


def train_flagship(batch: int, npoint: int, *, device=None,
                   compute_dtype: str = "auto", stage_dtypes: str = ""):
    """``(state, points, cls, target)``: the flagship with the encoder
    dtype ``compute_dtype`` (the JAX package's default ``"auto"`` =
    ``mxsr``; ``"f32"`` for the f32 encoder) and the per-stage overrides
    ``stage_dtypes`` (the trainer's ``--stage_dtypes``) in train mode,
    random weights from seed 0 and an Adam
    :class:`~prifit_torch.train.state.TrainState`; a gaussian cloud
    ``[batch, npoint, 3]`` from seed 0 (the one :func:`flagship` makes),
    category 0, and random part labels ``[batch, npoint]`` from the same
    seed."""
    device = resolve_device(device)
    model = get_model(num_parts=50, compute_dtype=compute_dtype,
                      stage_dtypes=stage_dtypes, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    state = create_train_state(model.to(device).train())
    rng = np.random.default_rng(0)
    points = torch.as_tensor(
        rng.normal(size=(batch, npoint, 3)).astype(np.float32),
        device=device)
    target = torch.as_tensor(rng.integers(0, 50, size=(batch, npoint)),
                             device=device)
    cls = torch.zeros((batch, 16), dtype=torch.float32, device=device)
    return state, points, cls, target


def acd_labels(points: torch.Tensor, n_anchors: int = 10, seed: int = 0
               ) -> torch.Tensor:
    """Component labels ``[B, N]`` (int64, on ``points``' device) that
    split each cloud ``points [B, N, 3]`` into parts, as the ACD
    components of the contrastive step do: each point takes the index of
    the nearest of ``n_anchors`` gaussian anchor points per cloud, drawn
    with numpy from ``seed``."""
    anchors = np.random.default_rng(seed).normal(
        size=(points.shape[0], n_anchors, 3)).astype(np.float32)
    anchors = torch.as_tensor(anchors, device=points.device)
    d = ((points[:, :, None, :3] - anchors[:, None]) ** 2).sum(-1)
    return d.argmin(-1)


def eval_forward(model, points, cls, **kwargs):
    """The eval forward with fit: seg logits and the convex loss against
    ``points`` itself."""
    with torch.no_grad():
        return model(points, cls, chamfer_points=points,
                     include_convex_loss=True, **kwargs)


def entry(device=None):
    """``(fn, args)``: the small flagship forward of
    ``__graft_entry__.entry`` (B=4, N=512, 5 mean-shift steps, 8 slots,
    64 samples per primitive); ``fn(*args)`` returns ``(seg_logits,
    total_loss)``."""
    model, points, cls = flagship(4, 512, device=device)
    kwargs = dict(quantile=0.05, msc_iterations=5, max_num_clusters=8,
                  n_per_prim=64)

    def fn(points, cls):
        out = eval_forward(model, points, cls, **kwargs)
        return out.seg_logits, out.total_loss

    return fn, (points, cls)
