"""Entry points of the port: the flagship model and its eval forward with
primitive fit.

Mirrors ``__graft_entry__._flagship`` / ``entry`` and the program that
``bench.py`` times: ``pointnet2_part_seg_msg`` with 50 parts, in eval
mode, run with the convex self-sup loss against the input cloud itself.
Weights are random, made from a seed (lecun-normal kernels and zero biases,
the JAX package's initializers; fresh batch-norm statistics).
"""

import numpy as np
import torch

from prifit_torch.models.pointnet2_part_seg_msg import get_model
from prifit_torch.utils.device import resolve_device

# the eval forward bench.py times (bench.py:71-88)
BENCH_KWARGS = dict(quantile=0.05, msc_iterations=10, max_num_clusters=25,
                    n_per_prim=256, num_bandwidth_candidates=2)
BENCH_BATCH, BENCH_NPOINT = 24, 2048


def init_weights(model: torch.nn.Module, generator: torch.Generator
                 ) -> None:
    """Lecun-normal conv weights (std 1/sqrt(fan_in)) and zero biases,
    drawn from ``generator`` on the CPU."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv1d, torch.nn.Conv2d)):
                w = torch.randn(mod.weight.shape, generator=generator)
                mod.weight.copy_(w / mod.in_channels ** 0.5)
                mod.bias.zero_()


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
