"""Entry points of the port: the flagship model, its eval forward with
primitive fit, its train steps (supervised, self-sup and contrastive),
and :func:`dryrun_multichip`, the data- and point-parallel steps on
whatever process group is up.

Mirrors ``__graft_entry__._flagship`` / ``entry`` and the programs that
``bench.py`` times: ``pointnet2_part_seg_msg`` with 50 parts, in eval
mode, run with the convex self-sup loss against the input cloud itself;
and, in train mode, the supervised step and the self-sup step, at the
default encoder dtype (``"auto"`` = ``mxsr``, ``bench.py``'s headline
train fields) or with the f32 encoder (its secondary ones).  Weights are
random, made from a seed by :func:`init_weights`, which draws each
parameter as the JAX package's initializers do: flax's lecun-normal
kernels (a normal truncated at +-2 with std 1/sqrt(fan_in)), a grouped
first layer's xyz and feature columns apart at their own fan-ins, zero
biases, and fresh batch-norm statistics.
"""

import math

import numpy as np
import torch

from prifit_torch.models.pointnet2_part_seg_msg import get_model
from prifit_torch.nn.atlasnet import ChartDense
from prifit_torch.nn.norm import GroupNorm
from prifit_torch.nn.pointnet import STN
from prifit_torch.nn.pointnet2 import SetAbstraction, SetAbstractionMsg, \
    gfl_weights
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


# the standard deviation of a unit normal truncated at +-2: flax's
# ``variance_scaling(..., "truncated_normal")`` divides by it, so that the
# truncated draw has the variance 1 / fan_in
TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """Fill ``w`` in place as flax's ``lecun_normal()`` draws a kernel: a
    unit normal truncated at +-2, times ``1 / (sqrt(fan_in) *
    TRUNC_STD)`` (std ``1/sqrt(fan_in)``, every entry within ``2 /
    (sqrt(fan_in) * TRUNC_STD)``).  Each entry is one uniform draw from
    ``generator`` through the inverse normal CDF, so a seed gives the same
    weights under every torch version (``torch.nn.init.trunc_normal_``
    changed its sampler between versions)."""
    lo = 1.0 + math.erf(-2.0 / math.sqrt(2.0))    # 2 Phi(-2)
    w.uniform_(lo - 1.0, 1.0 - lo, generator=generator)
    w.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    w.mul_(1.0 / (fan_in ** 0.5 * TRUNC_STD))


def grouped_first_layers(model: torch.nn.Module) -> dict:
    """``{conv: (d_in, xyz_first)}`` of every grouped first layer in
    ``model``: the first conv of each scale of a ``SetAbstractionMsg``
    (features first) and of each ``SetAbstraction`` (xyz first), whose
    weight ``[F, d_in + 3]`` holds the JAX package's ``w_feat`` and
    ``w_xyz`` (:func:`prifit_torch.nn.pointnet2.gfl_weights`)."""
    out = {}
    for mod in model.modules():
        if isinstance(mod, SetAbstractionMsg):
            for convs in mod.conv_blocks:
                out[convs[0]] = (mod.d_in, False)
        elif isinstance(mod, SetAbstraction):
            out[mod.mlp_convs[0]] = (mod.d_in, True)
    return out


def init_weights(model: torch.nn.Module, generator: torch.Generator
                 ) -> None:
    """The JAX package's initializers, drawn from ``generator`` on the
    CPU: every 1x1 conv, ``nn.Linear`` and chart dense weight lecun-normal
    as flax draws it (:func:`lecun_normal_`: truncated at +-2, std
    1/sqrt(fan_in), fan_in its input width), with a grouped first layer's
    xyz columns and feature columns drawn apart, at fan-in 3 and d_in, as
    the JAX ``GroupedFirstLayer``'s ``w_xyz`` and ``w_feat``; zero
    biases; scale 1 and bias 0 for every group norm; and zero for a
    spatial transformer's last dense, which then outputs the identity.
    A group-all layer's first weight is one draw at fan-in d_in + 3, as
    the JAX ``PointMLP``'s ``w0`` is."""
    grouped = grouped_first_layers(model)
    with torch.no_grad():
        for mod in model.modules():
            if mod in grouped:
                d_in, xyz_first = grouped[mod]
                w_feat, w_xyz = gfl_weights(mod, d_in, xyz_first)
                lecun_normal_(w_xyz, 3, generator)
                if d_in:
                    lecun_normal_(w_feat, d_in, generator)
            elif isinstance(mod, (torch.nn.Conv1d, torch.nn.Conv2d)):
                lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
            elif isinstance(mod, (torch.nn.Linear, ChartDense)):
                lecun_normal_(mod.weight, mod.in_features, generator)
            elif isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
            else:
                continue
            if mod.bias is not None:
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
                   compute_dtype: str = "auto", stage_dtypes: str = "",
                   max_region: bool = False):
    """``(state, points, cls, target)``: the flagship with the encoder
    dtype ``compute_dtype`` (the JAX package's default ``"auto"`` =
    ``mxsr``; ``"f32"`` for the f32 encoder) and the per-stage overrides
    ``stage_dtypes`` (the trainer's ``--stage_dtypes``) in train mode,
    with ``max_region`` the SA scales' closed-form K-max region outside
    ``mx``/``mxsr`` (the trainer's ``PRIFIT_MAX_REGION=on``), random
    weights from seed 0 and an Adam
    :class:`~prifit_torch.train.state.TrainState`; a gaussian cloud
    ``[batch, npoint, 3]`` from seed 0 (the one :func:`flagship` makes),
    category 0, and random part labels ``[batch, npoint]`` from the same
    seed."""
    device = resolve_device(device)
    model = get_model(num_parts=50, compute_dtype=compute_dtype,
                      stage_dtypes=stage_dtypes, max_region=max_region,
                      device="cpu")
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


# the mxsr key of the dry run's steps: one key on every rank, as the JAX
# program has one
DRYRUN_KEY = (0x51ED270B, 0x3C6EF372)


def blob_embeddings(n_shapes: int, npoint: int, seed: int = 0):
    """``(emb [n, npoint, 16], xyz [n, npoint, 3])``: four orthogonal
    embedding directions (times 4, noise 0.15) and four xyz blobs 4 apart
    (noise 0.3), point ``i`` in blob ``i % 4``: a multi-cluster input
    (random embeddings collapse to one cluster under mean-shift, which
    would leave the multi-slot fit untested).  ``__graft_entry__``'s dry
    run builds the same."""
    rng = np.random.default_rng(seed)
    blob = np.arange(npoint) % 4
    emb = np.eye(16, dtype=np.float32)[:4][blob] * 4.0 \
        + rng.normal(size=(n_shapes, npoint, 16)) * 0.15
    centers = np.array([[0, 0, 0], [4, 0, 0], [0, 4, 0], [0, 0, 4]],
                       np.float32)
    xyz = centers[blob] + rng.normal(size=(n_shapes, npoint, 3)) * 0.3
    return emb.astype(np.float32), xyz.astype(np.float32)


def dryrun_multichip(device=None, *, batch: int | None = None,
                     npoint: int = 512, compute_dtype: str = "auto",
                     sp_points: int | None = None, quantile: float = 0.2,
                     msc_iterations: int = 2, max_num_clusters: int = 4,
                     n_per_prim: int = 16) -> dict:
    """One data-parallel supervised step and one self-sup step on the
    mesh of every rank of the process group that is up (one process:
    world size 1), then ``cluster_and_fit_point_sharded`` and one
    point-SP self-sup step on a ``(data, points)`` mesh with
    ``sp_points`` ranks on the points axis (default: half the ranks), as
    ``__graft_entry__.dryrun_multichip`` runs them.

    The flagship from :func:`train_flagship` (``compute_dtype``; ``batch``
    defaults to 2 a rank) on a gaussian cloud from seed 0, each rank
    taking its shard; ``npoint`` is 512, not the JAX dry run's 64: the
    FPS kernel takes no more centroids (sa1's 512) than points; every rank builds the same weights and data, and
    the steps keep them equal.  The steps' draws (FPS starts, dropout)
    come from a generator seeded with the rank's data coordinate; the
    ``mxsr`` key is :data:`DRYRUN_KEY` on every rank.  Returns the losses, the point-SP
    clustering's slot counts and radii (this rank's copy of the
    replicated result) and the state after the last step."""
    import torch.distributed as dist

    from prifit_torch.models.pointnet2_part_seg_msg import get_loss
    from prifit_torch.nn.norm import set_process_group
    from prifit_torch.parallel import make_mesh, shard_batch
    from prifit_torch.parallel.point_sp import (
        cluster_and_fit_point_sharded,
        make_dp_sp_mesh,
    )
    from prifit_torch.train.steps import (
        make_selfsup_step,
        make_selfsup_step_point_sp,
        make_supervised_step,
    )

    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh()
    batch = batch or 2 * world
    state, points, cls, target = train_flagship(
        batch, npoint, device=device, compute_dtype=compute_dtype)
    lr, mom = TRAIN_SETTINGS["lr"], TRAIN_SETTINGS["bn_momentum"]

    def generator(m):
        return torch.Generator(device=device).manual_seed(
            1 + (m.coords.get("data") or 0))

    # supervised and convex self-sup steps, batch-sharded
    p, c, t = shard_batch(mesh, (points, cls, target))
    gen = generator(mesh)
    set_process_group(state.model, mesh.group("data"))
    state, m_sup = make_supervised_step(get_loss)(
        state, p, c, t, lr, mom, gen, sr_key=DRYRUN_KEY)
    ss_kw = dict(quantile=quantile, msc_iterations=msc_iterations,
                 max_num_clusters=max_num_clusters, n_per_prim=n_per_prim)
    state, m_ss = make_selfsup_step(**ss_kw)(
        state, p, c, p, lr, mom, 1.0, gen, sr_key=DRYRUN_KEY)

    # 2-D (data, points) mesh: ring mean-shift + moment-summed fitting
    n_sp = sp_points or max(world // 2, 1)
    n_dp = world // n_sp
    mesh2 = make_dp_sp_mesh(n_dp, n_sp)
    emb, xyz = blob_embeddings(n_dp, npoint)
    emb, xyz = shard_batch(mesh2, (torch.as_tensor(emb, device=device),
                                   torch.as_tensor(xyz, device=device)))
    res, prims = cluster_and_fit_point_sharded(
        emb, xyz, mesh=mesh2, quantile=quantile, iterations=5,
        max_num_clusters=8)

    # the --sp_points train step: encoder DP over the data axis, convex
    # loss point-sharded, one optimizer update
    sp_step = make_selfsup_step_point_sp(
        mesh=mesh2, quantile=quantile, msc_iterations=msc_iterations,
        max_num_clusters=max_num_clusters, n_per_prim=n_per_prim)
    set_process_group(state.model, mesh2.group("data"))
    sp = shard_batch(mesh2, points[:n_dp])
    state, m_sp = sp_step(state, sp, cls[:sp.shape[0]], sp, lr, mom, 1.0,
                          generator(mesh2), sr_key=DRYRUN_KEY)
    out = {"sup_loss": m_sup["loss"].item(), "ss_loss": m_ss["ss_loss"].item(),
           "sp_loss": m_sp["ss_loss"].item(),
           "sp_clusters": res.num_clusters.tolist(),
           "sp_radii": prims.r.detach().cpu(), "state": state,
           "world": world, "sp_mesh": dict(mesh2.shape)}
    if not all(np.isfinite(out[k]) for k in ("sup_loss", "ss_loss",
                                              "sp_loss")):
        raise AssertionError(f"dryrun_multichip: a loss is not finite: "
                             f"{out}")
    return out
