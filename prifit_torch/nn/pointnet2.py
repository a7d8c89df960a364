"""PointNet++ building blocks, channel-last.

Port of ``prifit_tpu/nn/pointnet2.py`` (eval forward and the explicit
train-mode chain).  The modules hold the reference's 1x1 convolutions and
batch norms under the reference state_dict names
(``conv_blocks.{i}.{j}``, ``bn_blocks.{i}.{j}``, ``mlp_convs.{j}``,
``mlp_bns.{j}``), and apply each convolution as a dense layer over the
last axis.  A grouped first layer is the first convolution of each SA
block; its weight is ``[F, d_in + 3]``, split at run time into
``w_feat`` and ``w_xyz``: the features FIRST in an MSG layer, the xyz
first in the single-scale :class:`SetAbstraction` (the reference's
column orders).

Compute dtype (``dtype`` below): None runs f32; ``torch.bfloat16`` casts
each dense layer's input and parameters to bf16; ``FQ`` rounds matmul
inputs/outputs and BN outputs to bf16 straight-through; ``MX``/``MXSR``
run as bf16 in eval mode and, in training, each SA scale, the group-all
chain and each FP chain as one mixed-precision region
(:func:`prifit_torch.nn.mixed.mx_chain`).  ``MXSR`` regions round their
cotangents stochastically, with a key per region (``sr_key`` below: two
uint32 words), which training in that mode requires (``mx_chain`` raises
without one).

``max_region`` (the JAX package's ``PRIFIT_MAX_REGION=on``, off by
default there too): a training SA scale outside the ``mx``/``mxsr``
region runs its last layer and the K-max as the closed-form region
(:func:`max_region_last`, ``PointMLP.call_max`` in the JAX package), in
bf16 storage for a bf16 encoder and f32 storage otherwise; its backward
is kernels #7 and #8.

Eval epilogue: with a batch norm in eval mode (no ``charts``), no
gradient recorded and a dtype other than ``FQ``, a layer's dense bias,
batch norm, cast, relu and, where it ends an SA scale or the group-all
layer, the K-max run as one kernel
(:func:`prifit_torch.kernels.bn_eval.bn_relu_eval`) on the product; the
values are those of the op chain, bit for bit.  Training-mode batch norm
(batch statistics, autograd), the regions and ``FQ`` (which rounds
straight-through between the batch norm and the relu) keep the op chain.

Data parallelism: each batch norm's ``process_group`` (set by
:func:`prifit_torch.nn.norm.set_process_group`) makes its statistics,
and those of the regions it belongs to, global over the group.
"""

import torch
from torch import nn

from prifit_torch.kernels.bn_eval import bn_relu_eval
from prifit_torch.nn.mixed import MX, MXSR, mx_chain
from prifit_torch.nn.norm import BatchNorm
from prifit_torch.parallel.collectives import group_size
from prifit_torch.ops.sampling import (
    ball_query_nearest_shared,
    farthest_points,
    gather_neighbors,
    query_ball_point,
    sample_and_group_all,
    three_nn_interpolate,
)

FQ = "fq"


def stq(x: torch.Tensor) -> torch.Tensor:
    """bf16-round values, straight-through (identity) gradients."""
    x32 = x.float()
    return x32 + (x32.bfloat16().float() - x32).detach()


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """Apply a compute-dtype spec: a real dtype casts, ``FQ`` rounds
    straight-through, None passes through."""
    if dtype is None:
        return x
    if dtype == FQ:
        return stq(x)
    return x.to(dtype)


def eff(dtype):
    """Array dtype of the explicit chain: ``MX``/``MXSR`` are bf16 outside
    their training region."""
    return torch.bfloat16 if dtype in (MX, MXSR) else dtype


def _group_rows(bn, x) -> tuple:
    """``(group, global row count)`` of a region that holds batch norm
    ``bn`` and takes ``x`` (rows: every axis but the last)."""
    group = bn.process_group
    return group, x.numel() // x.shape[-1] * group_size(group)


def region(dtype, x, pre_bn, convs, bns, has_max: bool, bn_momentum: float,
           sr_key):
    """``x`` through the mixed-precision region of ``dtype`` (``MX`` or
    ``MXSR``): an optional batch norm ``pre_bn`` on ``x`` itself, the
    [dense -> BN -> relu] chain of ``convs``/``bns``, and with ``has_max``
    the max over axis -2 of ``x [B, S, K, F]``.  ``x`` enters as bf16
    under ``MXSR`` (its cotangent leaves bf16 too), as f32 under ``MX``.
    Updates the running statistics of every batch norm from the region's
    rows."""
    sr = dtype == MXSR
    chain = tuple((conv_weight(c), c.bias, bn.weight, bn.bias)
                  for c, bn in zip(convs, bns))
    norms = ([] if pre_bn is None else [pre_bn]) + list(bns)
    group, rows = _group_rows(norms[0], x)
    out, stats = mx_chain(
        (pre_bn is not None, has_max, sr),
        x.to(torch.bfloat16 if sr else torch.float32),
        (None if pre_bn is None else (pre_bn.weight, pre_bn.bias), chain),
        sr_key, group=group)
    for bn, (mean, var) in zip(norms, stats):
        bn.update_running(mean, var, bn_momentum, rows)
    return out


def max_region_last(conv, bn, x, dtype, bn_momentum: float):
    """The last layer of an SA scale's chain and the K-max over axis -2 of
    ``x [B, S, K, Fi]`` as the closed-form K-max region
    (``PointMLP.call_max`` in the JAX package): ``mx_chain((False, True,
    False), ...)`` in bf16 storage when the chain's array dtype is bf16,
    else f32.  Updates ``bn``'s running statistics from the region's."""
    storage = torch.bfloat16 if eff(dtype) == torch.bfloat16 \
        else torch.float32
    group, rows = _group_rows(bn, x)
    out, stats = mx_chain(
        (False, True, False), x,
        (None, ((conv_weight(conv), conv.bias, bn.weight, bn.bias),)),
        storage=storage, group=group)
    bn.update_running(*stats[0], bn_momentum, rows)
    return out


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
          dtype=None) -> torch.Tensor:
    """``x @ w.T (+ b)`` for a torch weight ``w [out, in]``.  With a
    compute dtype, x, w and b are cast first (``FQ``: rounded
    straight-through, output too); without one, mixed inputs promote."""
    if dtype == FQ:
        x, w = stq(x), stq(w)
        b = None if b is None else stq(b)
    elif dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
        b = None if b is None else b.to(dtype)
    else:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = torch.matmul(x, w.t())
    if b is not None:
        y = y + b.to(y.dtype)
    return stq(y) if dtype == FQ else y


def conv_weight(conv: nn.Module) -> torch.Tensor:
    """A 1x1 Conv1d/Conv2d weight as ``[out, in]``."""
    return conv.weight.reshape(conv.weight.shape[0], conv.weight.shape[1])


def eval_epilogue(bn, dtype) -> bool:
    """Whether the layer of batch norm ``bn`` ends in the eval kernel (see
    the module docstring)."""
    return not (bn.training or torch.is_grad_enabled()) \
        and bn.charts is None and dtype != FQ


def bn_eval(bn, z, dense_bias=None, storage=None,
            kmax: bool = False) -> torch.Tensor:
    """The eval kernel on a layer's product ``z`` with ``bn``'s running
    statistics and affine; ``storage`` only for a grouped first layer's
    f32 pre-activation."""
    return bn_relu_eval(z, bn.running_mean, bn.running_var, bn.eps,
                        bn.weight, bn.bias, dense_bias, storage, kmax)


def point_mlp(convs, bns, x: torch.Tensor, dtype,
              bn_momentum: float, kmax: bool = False) -> torch.Tensor:
    """Shared per-point MLP: [dense -> BN -> relu] per layer (the explicit
    chain of ``PointMLP`` in the JAX package); with ``kmax`` the max over
    axis -2 of the last layer's output."""
    dt = eff(dtype)
    last = len(convs) - 1
    for i, (conv, bn) in enumerate(zip(convs, bns)):
        if eval_epilogue(bn, dtype):
            x = bn_eval(bn, dense(x, conv_weight(conv), None, dt), conv.bias,
                        kmax=kmax and i == last)
            continue
        x = dense(x, conv_weight(conv), conv.bias,
                  dt if dtype != FQ else dtype)
        x = bn(x, bn_momentum)
        if dtype == FQ:
            x = stq(x)
        x = torch.relu(x)
        if kmax and i == last:
            x = torch.amax(x, dim=-2)
    # an empty chain (a one-layer SA scale after its grouped first layer)
    return torch.amax(x, dim=-2) if kmax and not len(convs) else x


def gfl_weights(conv, d_in: int, xyz_first: bool = False):
    """``(w_feat [F, d_in], w_xyz [F, 3])`` of a grouped first layer's
    weight ``[F, d_in + 3]``: the features first (MSG), or with
    ``xyz_first`` the xyz first (SSG)."""
    w = conv_weight(conv)
    if xyz_first:
        return w[:, 3:], w[:, :3]
    return w[:, :d_in], w[:, d_in:]


def gfl_pre_affine(conv, d_in: int, xyz, points, xyz_first: bool = False):
    """Per-point affine part ``W_f feat + W_x xyz + b``, ``[B, N, F]``."""
    w_feat, w_xyz = gfl_weights(conv, d_in, xyz_first)
    pre = dense(xyz, w_xyz)
    if d_in:
        return pre + dense(points, w_feat, conv.bias)
    return pre + conv.bias


def gfl_pre_tensor(conv, d_in: int, xyz, points, new_xyz, idx,
                   xyz_first: bool = False):
    """Pre-BN grouped activation ``[B, S, K, F]`` of the grouped first
    layer: one exact gather per scale of whichever side is narrower (raw
    inputs vs the ``pre_affine`` projection), minus the projected center
    (``GroupedFirstLayer.pre_tensor`` in the JAX package)."""
    w_feat, w_xyz = gfl_weights(conv, d_in, xyz_first)
    if 3 + d_in <= w_xyz.shape[0]:
        grouped = dense(gather_neighbors(xyz, idx), w_xyz)
        if d_in:
            grouped = grouped + dense(gather_neighbors(points, idx),
                                      w_feat, conv.bias)
        else:
            grouped = grouped + conv.bias
    else:
        grouped = gather_neighbors(
            gfl_pre_affine(conv, d_in, xyz, points, xyz_first), idx)
    return grouped - dense(new_xyz, w_xyz)[:, :, None, :]


def grouped_first_layer(conv, bn, d_in: int, xyz, points, new_xyz, idx,
                        dtype, bn_momentum: float, xyz_first: bool = False):
    """``[B, S, K, F]`` post-BN, post-relu output of the grouped first
    layer, cast to the chain's dtype."""
    grouped = gfl_pre_tensor(conv, d_in, xyz, points, new_xyz, idx,
                             xyz_first)
    if eval_epilogue(bn, dtype):
        return bn_eval(bn, grouped, storage=eff(dtype))
    grouped = cast(grouped, eff(dtype))
    grouped = bn(grouped, bn_momentum)
    if dtype == FQ:
        grouped = stq(grouped)
    return torch.relu(grouped)


def fps_start(xyz: torch.Tensor, train: bool,
              generator: torch.Generator | None) -> torch.Tensor | None:
    """FPS start indices: random (from ``generator``) when training with
    a generator, the reference's random start; None (index 0) otherwise."""
    B, N, _ = xyz.shape
    if train and generator is not None:
        start = torch.randint(0, N, (B,), generator=generator,
                              device=generator.device)
        return start.to(xyz.device)
    return None


def sa_scale(convs, bns, d_in: int, xyz, points, new_xyz, idx, dtype,
             bn_momentum: float, train: bool, sr_key,
             xyz_first: bool = False, max_region: bool = False):
    """One SA scale, ``[B, S, F_last]``: the grouped first layer, the MLP
    chain and the max over the neighbours, as one mixed-precision region
    when training in ``MX``/``MXSR`` (``_run_scale`` in the JAX
    package); otherwise, with ``max_region`` when training (not ``FQ``),
    the last layer and the max as :func:`max_region_last`."""
    if train and dtype in (MX, MXSR):
        pre = gfl_pre_tensor(convs[0], d_in, xyz, points, new_xyz, idx,
                             xyz_first)
        return region(dtype, pre, bns[0], convs[1:], bns[1:], True,
                      bn_momentum, sr_key)
    h = grouped_first_layer(convs[0], bns[0], d_in, xyz, points, new_xyz,
                            idx, dtype, bn_momentum, xyz_first)
    if train and max_region and dtype != FQ and len(convs) > 1:
        h = point_mlp(convs[1:-1], bns[1:-1], h, dtype, bn_momentum)
        return max_region_last(convs[-1], bns[-1], h, dtype, bn_momentum)
    return point_mlp(convs[1:], bns[1:], h, dtype, bn_momentum, kmax=True)


class SetAbstractionMsg(nn.Module):
    """Multi-scale grouping SA layer: one FPS, then per radius a ball
    query, grouped first layer, MLP chain and max over the neighbours;
    channels concatenated.  Grouped features are ``[feats, xyz - c]``."""

    def __init__(self, npoint: int, radius_list, nsample_list,
                 in_channel: int, mlp_list, fused: bool = True,
                 dtype=None, max_region: bool = False):
        super().__init__()
        self.max_region = max_region
        self.npoint = npoint
        self.radius_list = list(radius_list)
        self.nsample_list = list(nsample_list)
        self.d_in = in_channel
        self.fused = fused
        self.dtype = dtype
        self.conv_blocks = nn.ModuleList()
        self.bn_blocks = nn.ModuleList()
        for mlp in mlp_list:
            last = in_channel + 3
            convs, bns = nn.ModuleList(), nn.ModuleList()
            for out in mlp:
                convs.append(nn.Conv2d(last, out, 1))
                bns.append(BatchNorm(out))
                last = out
            self.conv_blocks.append(convs)
            self.bn_blocks.append(bns)

    def forward(self, xyz, points, bn_momentum: float = 0.1,
                generator: torch.Generator | None = None, sr_keys=None):
        """xyz ``[B, N, 3]``, points ``[B, N, d_in]`` -> (new_xyz
        ``[B, npoint, 3]``, new_points ``[B, npoint, sum of last
        widths]``).  ``sr_keys``: one ``MXSR`` key per scale."""
        train = self.training
        # the FPS kernel writes the centroids' coordinates itself
        _, new_xyz = farthest_points(xyz, self.npoint,
                                     fps_start(xyz, train, generator))
        if self.fused:
            idx_list = ball_query_nearest_shared(
                self.radius_list, self.nsample_list, xyz, new_xyz)
        else:
            idx_list = [query_ball_point(r, k, xyz, new_xyz)
                        for r, k in zip(self.radius_list,
                                        self.nsample_list)]
        outs = [sa_scale(convs, bns, self.d_in, xyz, points, new_xyz, idx,
                         self.dtype, bn_momentum, train,
                         None if sr_keys is None else sr_keys[i],
                         max_region=self.max_region)
                for i, (idx, convs, bns) in enumerate(zip(
                    idx_list, self.conv_blocks, self.bn_blocks))]
        return new_xyz, torch.cat(outs, dim=-1)


class SetAbstraction(nn.Module):
    """Single-scale grouping SA layer (``SetAbstraction`` of the JAX
    package, reference ``pointnet_util.py:160-201``): one FPS, the
    nearest-``nsample`` fused ball query (or with ``fused=False`` the
    first-``nsample``-by-index :func:`query_ball_point`), then one scale
    of :func:`sa_scale`.  Grouped features are ``[xyz - c, feats]``, xyz
    FIRST, so the first weight is ``[F, 3 + d_in]``.  The state_dict
    names are the reference's (``mlp_convs.{j}``, ``mlp_bns.{j}``)."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_channel: int, mlp, fused: bool = True, dtype=None,
                 max_region: bool = False):
        super().__init__()
        self.max_region = max_region
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.d_in = in_channel
        self.fused = fused
        self.dtype = dtype
        self.mlp_convs = nn.ModuleList()
        self.mlp_bns = nn.ModuleList()
        last = in_channel + 3
        for out in mlp:
            self.mlp_convs.append(nn.Conv2d(last, out, 1))
            self.mlp_bns.append(BatchNorm(out))
            last = out

    def forward(self, xyz, points, bn_momentum: float = 0.1,
                generator: torch.Generator | None = None, sr_key=None):
        """xyz ``[B, N, 3]``, points ``[B, N, d_in]`` -> (new_xyz
        ``[B, npoint, 3]``, new_points ``[B, npoint, mlp[-1]]``)."""
        train = self.training
        _, new_xyz = farthest_points(xyz, self.npoint,
                                     fps_start(xyz, train, generator))
        if self.fused:
            (idx,) = ball_query_nearest_shared([self.radius], [self.nsample],
                                               xyz, new_xyz)
        else:
            idx = query_ball_point(self.radius, self.nsample, xyz, new_xyz)
        return new_xyz, sa_scale(self.mlp_convs, self.mlp_bns, self.d_in,
                                 xyz, points, new_xyz, idx, self.dtype,
                                 bn_momentum, train, sr_key, xyz_first=True,
                                 max_region=self.max_region)


class SetAbstractionAll(nn.Module):
    """Group-all SA layer (``SetAbstraction(group_all=True)`` in the JAX
    package): one global group ``[xyz, points]``, MLP chain, max over
    points."""

    def __init__(self, in_channel: int, mlp, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.mlp_convs = nn.ModuleList()
        self.mlp_bns = nn.ModuleList()
        last = in_channel
        for out in mlp:
            self.mlp_convs.append(nn.Conv2d(last, out, 1))
            self.mlp_bns.append(BatchNorm(out))
            last = out

    def forward(self, xyz, points, bn_momentum: float = 0.1, sr_key=None):
        new_xyz, grouped = sample_and_group_all(xyz, points)
        if self.training and self.dtype in (MX, MXSR):
            return new_xyz, region(self.dtype, grouped, None, self.mlp_convs,
                                   self.mlp_bns, True, bn_momentum, sr_key)
        return new_xyz, point_mlp(self.mlp_convs, self.mlp_bns, grouped,
                                  self.dtype, bn_momentum, kmax=True)


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance upsampling + skip concat + MLP chain."""

    def __init__(self, in_channel: int, mlp, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.mlp_convs = nn.ModuleList()
        self.mlp_bns = nn.ModuleList()
        last = in_channel
        for out in mlp:
            self.mlp_convs.append(nn.Conv1d(last, out, 1))
            self.mlp_bns.append(BatchNorm(out))
            last = out

    def forward(self, xyz1, xyz2, points1, points2,
                bn_momentum: float = 0.1, sr_key=None):
        """xyz1 ``[B, N, 3]`` dense, xyz2 ``[B, S, 3]`` coarse, points1
        ``[B, N, D1]`` skip or None, points2 ``[B, S, D2]``."""
        interpolated = three_nn_interpolate(xyz1, xyz2, points2)
        if self.dtype == FQ:
            interpolated = stq(interpolated)
        if points1 is not None:
            x = torch.cat([points1, interpolated.to(points1.dtype)], dim=-1)
        else:
            x = interpolated
        if len(self.mlp_convs) and self.training and self.dtype in (MX, MXSR):
            x = region(self.dtype, x, None, self.mlp_convs, self.mlp_bns,
                       False, bn_momentum, sr_key)
        elif len(self.mlp_convs):
            x = point_mlp(self.mlp_convs, self.mlp_bns, x, self.dtype,
                          bn_momentum)
        return x
