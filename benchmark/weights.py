"""The cell's weights, drawn from the run's seed on the card.

Adapted from ``prifit_torch/entry.py::init_weights`` and
``lecun_normal_`` at commit 0adee2a: the same distribution (the JAX
package's initializers: flax's lecun-normal kernels, a unit normal
truncated at +-2 times ``1 / (sqrt(fan_in) * TRUNC_STD)``, a grouped first
layer's feature and xyz columns drawn apart at their own fan-ins, zero
biases, scale 1 and bias 0 for every group norm), but every draw comes
from one uniform draw on the card, with a ``torch.Generator`` there, and
the normal is its inverse CDF.  The layout of the leaves is read from the
reference's copy of the model (:mod:`benchmark.reference.port`), whose
parameter names are the program's, so :func:`state_dict` loads into the
program's model with ``strict=True`` and into the reference's alike.
"""

import math

import torch

from benchmark.reference.port.nn.norm import GroupNorm
from benchmark.reference.port.nn.pointnet2 import SetAbstraction, \
    SetAbstractionMsg, gfl_weights

TRUNC_STD = 0.87962566103423978
# the seed of the weights' generator is the run's seed folded with this
WEIGHT_STREAM = 0x5EED_0001


def _grouped(model):
    out = {}
    for mod in model.modules():
        if isinstance(mod, SetAbstractionMsg):
            for convs in mod.conv_blocks:
                out[convs[0]] = (mod.d_in, False)
        elif isinstance(mod, SetAbstraction):
            out[mod.mlp_convs[0]] = (mod.d_in, True)
    return out


def _kernels(model):
    """``[(view, fan_in)]``: every weight the lecun-normal init fills, in
    module order, and ``[tensor, value]`` of what is filled with a
    constant."""
    grouped = _grouped(model)
    drawn, const = [], []
    for mod in model.modules():
        if mod in grouped:
            d_in, xyz_first = grouped[mod]
            w_feat, w_xyz = gfl_weights(mod, d_in, xyz_first)
            drawn.append((w_xyz, 3))
            if d_in:
                drawn.append((w_feat, d_in))
        elif isinstance(mod, (torch.nn.Conv1d, torch.nn.Conv2d)):
            drawn.append((mod.weight, mod.weight[0].numel()))
        elif isinstance(mod, torch.nn.Linear):
            drawn.append((mod.weight, mod.in_features))
        elif isinstance(mod, GroupNorm):
            const.append((mod.weight, 1.0))
        else:
            continue
        if mod.bias is not None:
            const.append((mod.bias, 0.0))
    return drawn, const


def init_(model: torch.nn.Module, seed: int, device) -> None:
    """Fill ``model``'s weights in place from ``seed`` (see the module
    docstring)."""
    drawn, const = _kernels(model)
    total = sum(w.numel() for w, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) ^ WEIGHT_STREAM) & 0xFFFF_FFFF_FFFF_FFFF)
    lo = 1.0 + math.erf(-2.0 / math.sqrt(2.0))
    z = torch.empty(total, device=device).uniform_(lo - 1.0, 1.0 - lo,
                                                   generator=gen)
    z = z.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    with torch.no_grad():
        at = 0
        for w, fan_in in drawn:
            n = w.numel()
            w.copy_(z[at:at + n].view(w.shape)
                    * (1.0 / (fan_in ** 0.5 * TRUNC_STD)))
            at += n
        for t, value in const:
            t.fill_(value)


def state_dict(model_factory, seed: int, device) -> dict:
    """The state dict of a fresh reference model from ``model_factory
    (device)`` with its weights drawn from ``seed``."""
    model = model_factory(device)
    init_(model, seed, device)
    return {k: v.detach() for k, v in model.state_dict().items()}
