"""Point-axis (sequence-parallel) sharding of the O(N^2) fit pipeline.

Port of ``prifit_tpu/parallel/point_sp.py``.  The reference subsamples
clouds (2048 of 5000) because its mean-shift kernel matrix is O(N^2); this
is the scaling path for clouds too large for one device's N^2: a 2-D
``(data, points)`` mesh of ranks (:func:`make_dp_sp_mesh`, rank ``d P +
p``) where

  - mean-shift runs as a RING over the ``points`` group: every rank holds
    an N/P slice of the seeds and passes the point chunks around the ring
    (:func:`~prifit_torch.parallel.collectives.ppermute`, whose backward
    runs the ring the other way), accumulating ``K @ X`` and the row sums
    -- each chunk of the [N, N] kernel matrix is made and used on one rank,
    never gathered.  Plain matmuls, as the JAX ring is (its Pallas
    mean-shift kernel is not on this path);
  - membership weights stay sharded with their points;
  - the weighted ellipsoid fit sums its moments over the ``points`` group
    (weight sums, centroids, covariances), then runs the guarded 3x3 eigh
    replicated, with the axis lengths from all-gathered local extrema;
  - NMS runs replicated on the all-gathered converged modes, through the
    NMS kernel (:func:`prifit_torch.clustering.mean_shift.nms_fixed_slots`)
    on a CUDA tensor: O(N^2) again but on modes, the one stage that needs
    the global mode graph.

Each rank passes its DATA shard with the full point axis (``[b, N, ...]``,
``b = B / n_data``, as the data-parallel encoder leaves it); the functions
take the rank's point slice themselves.  Results: cluster weights and
labels for the local point slice, everything else replicated over the
``points`` group.  The losses are replicated over every rank (the
convention of :mod:`prifit_torch.parallel.collectives`).

Semantics match :mod:`prifit_torch.clustering.mean_shift` /
:mod:`prifit_torch.geometry.fitting` (same guards and slot layout), with
the JAX module's two documented deviations, both bandwidth-related: the
quantile bandwidth is estimated from an all-gather of (up to)
``bandwidth_samples`` points in global order, and there is no
quantile-doubling retry -- pick a quantile that fits the slot budget.
"""

import torch

from prifit_torch.clustering.mean_shift import (
    ClusterResult,
    membership,
    nms_fixed_slots,
)
from prifit_torch.geometry.fitting import (
    COND_MAX,
    WSUM_EPS,
    PrimitiveParams,
    eigh3_guarded,
    fix_reflection,
)
from prifit_torch.kernels.bandwidth import kth_nn_distance
from prifit_torch.parallel.collectives import (
    all_gather,
    all_gather_stack,
    group_rank,
    group_size,
    ppermute,
    psum,
)
from prifit_torch.parallel.mesh import Mesh, grid_mesh
from prifit_torch.utils.guard import guard_exp, guard_sqrt


def make_dp_sp_mesh(n_data: int, n_points: int, devices=None) -> Mesh:
    """2-D ``(data, points)`` mesh: rank ``d * n_points + p`` at
    ``(d, p)``."""
    return grid_mesh(("data", "points"), (n_data, n_points), devices)


def _points_slice(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous slice of ``t``'s point axis (axis 1)."""
    size = group_size(group)
    if size == 1:
        return t
    n = t.shape[1]
    if n % size:
        raise ValueError(f"point axis of {n} does not split over {size} "
                         f"ranks")
    m = n // size
    r = group_rank(group)
    return t[:, r * m:(r + 1) * m]


def _ring_mean_shift(x_local, bw, iterations, axis, axis_size,
                     kernel_type="gaussian"):
    """Ring-blocked fixed-iteration mean-shift.

    ``x_local [B, n_loc, D]`` this rank's point slice (unit norm), ``bw
    [B]``, ``axis`` the ``points`` process group of ``axis_size`` ranks.
    Returns converged modes for the local seeds, ``[B, n_loc, D]``."""
    b2 = (bw ** 2)[:, None, None]
    q = x_local
    for _ in range(iterations):
        acc = torch.zeros_like(q)
        s = q.new_zeros(q.shape[:2])
        chunk = x_local
        for step in range(axis_size):
            dist = 2.0 - 2.0 * torch.matmul(q, chunk.transpose(1, 2))
            if kernel_type == "gaussian":
                K = guard_exp(-dist / b2 / 2.0)
            else:
                K = torch.relu(0.75 * (1.0 - dist / b2))
            acc = acc + torch.matmul(K, chunk)
            s = s + K.sum(-1)
            if step < axis_size - 1:     # the last pass would bring it home
                chunk = ppermute(chunk, axis, 1)
        new = acc / s[..., None]
        q = new / torch.linalg.norm(new, dim=-1, keepdim=True)
    return q


def _fit_one_slot_sharded(points_local, w_local, axis):
    """Moment-summed weighted ellipsoid fit of every slot: ``points_local
    [B, n_loc, 3]``, ``w_local [B, n_loc, K]`` -> ``(r, V, center,
    valid)`` ``[B, K, ...]``, replicated over ``axis`` (all moments are
    sums over it).  Mirrors :func:`prifit_torch.geometry.fitting.
    _fit_slots`; the JAX module's version fits one slot under ``vmap``."""
    w = w_local.transpose(1, 2)[..., None]                  # [B, K, n, 1]
    sum_w = psum(w_local.sum(dim=1), axis)                   # [B, K]
    safe = torch.clamp_min(sum_w, WSUM_EPS)[..., None]
    p = points_local[:, None]                                # [B, 1, n, 3]
    center = psum(torch.sum(p * w, dim=2), axis) / safe      # [B, K, 3]
    centered = p - center[:, :, None, :]
    cov = psum(torch.matmul((centered * w).transpose(-1, -2), centered),
               axis) / safe[..., None]
    s, V = eigh3_guarded(cov)
    s = s.detach()
    cond_ok = s[..., 0] / torch.clamp_min(s[..., 2], 1e-30) <= COND_MAX
    valid = cond_ok & (sum_w > WSUM_EPS)
    V = fix_reflection(V)
    transformed = torch.matmul(centered * w, V)              # [B, K, n, 3]
    # global extrema from all-gathered local ones (the gather's backward
    # hands the axis-length gradient to the rank of the extreme point)
    loc = torch.stack([transformed.amax(dim=2),
                       -transformed.amin(dim=2)], dim=-2)    # [B, K, 2, 3]
    glob = all_gather_stack(loc, axis)                       # [P, ...]
    mx = glob[..., 0, :].amax(dim=0)
    mn = -glob[..., 1, :].amax(dim=0)
    return (mx - mn) / 2.0, V, center, valid


def fit_ellipsoids_sharded(points_local, weights_local, slot_valid, axis):
    """Point-sharded batch fit: ``[B, n_loc, 3] x [B, n_loc, K] ->``
    :class:`PrimitiveParams` ``[B, K, ...]`` replicated over ``axis``;
    invalid slots get unit radii, identity axes and a zero center."""
    r, V, center, fv = _fit_one_slot_sharded(points_local, weights_local,
                                             axis)
    valid = fv & slot_valid
    m = valid[..., None]
    eye = torch.eye(3, dtype=V.dtype, device=V.device)
    return PrimitiveParams(
        r=torch.where(m, r, torch.ones_like(r)),
        V=torch.where(m[..., None], V, eye),
        center=torch.where(m, center, torch.zeros_like(center)),
        valid=valid)


def _bandwidth(sub: torch.Tensor, quantile: float) -> torch.Tensor:
    """Quantile K-th-NN bandwidth of each shape of ``sub [B, n, D]`` (the
    bandwidth kernel on a CUDA tensor): ``compute_bandwidth`` of the
    clustering module, batched."""
    k = max(int(quantile * sub.shape[1]), 1)
    with torch.no_grad():
        kth = kth_nn_distance(sub.detach().float().contiguous(), [k])
        return torch.mean(guard_sqrt(kth[:, 0], 1e-6), dim=-1)


def _cluster_local(x_local, *, quantile, iterations, max_num_clusters,
                   bandwidth_samples, axis, axis_size, kernel_type):
    """The local slice in, a ClusterResult with sharded weights out."""
    x_local = x_local / torch.clamp_min(
        torch.linalg.norm(x_local, dim=-1, keepdim=True), 1e-12)

    # bandwidth from a globally ordered subsample (the reference
    # subsamples too: num_samples in compute_bandwidth)
    n_loc = x_local.shape[1]
    m = min(max(bandwidth_samples // axis_size, 1), n_loc)
    sub = all_gather(x_local[:, :m].detach(), axis, dim=1)
    bw = _bandwidth(sub, quantile)                            # [B]

    modes_local = _ring_mean_shift(x_local, bw, iterations, axis,
                                   axis_size, kernel_type)
    modes = all_gather(modes_local, axis, dim=1)

    # NMS and the center choice on the gathered modes, replicated
    center_ids, valid, _ = nms_fixed_slots(modes, bw, max_num_clusters)
    centers = torch.gather(
        modes, 1, center_ids[..., None].expand(-1, -1, modes.shape[-1]))
    centers = centers * valid[..., None]

    sim = torch.matmul(centers, modes_local.transpose(1, 2))  # [B, K, n]
    sim = torch.where(valid[..., None], sim, torch.full_like(sim, -1e9))
    labels_local = torch.argmax(sim, dim=1)

    weights_local = membership(centers, valid, x_local, bw).transpose(1, 2)
    return ClusterResult(centers=centers, valid=valid, labels=labels_local,
                         weights=weights_local, bandwidth=bw,
                         num_clusters=valid.sum(-1))


def analytic_chamfer_sharded(params: PrimitiveParams, samples, sample_w,
                             target_local, axis, cuboid: bool = False,
                             data_axis=None):
    """Point-sharded analytic chamfer.

    Mirrors :func:`prifit_torch.geometry.losses.analytic_chamfer` with the
    TARGET cloud sharded over ``axis``: the SDF side sums over the local
    targets and then over ``axis``; the nearest-neighbour side takes each
    rank's minima over its targets and the least of their all-gather.
    Primitive samples are replicated (there are only K * n_per_prim).
    With ``data_axis`` the mean over shapes is over the global batch.

    ``params`` replicated ``[B, K, ...]``; ``samples [B, S, 3]``;
    ``sample_w [B, S]``; ``target_local [B, m_loc, 3]``."""
    from prifit_torch.geometry.sdf import sdf_primitives
    from prifit_torch.ops.chamfer import nn_squared_distance

    sdf = sdf_primitives(target_local, params.r, params.V, params.center,
                         cuboid)                              # [B, m, K]
    asdf = torch.where(params.valid[:, None, :], torch.abs(sdf),
                       torch.full_like(sdf, float("inf")))
    d_ts_sum = psum(torch.sum(torch.amin(asdf, dim=-1) ** 2, dim=-1), axis)
    m_total = target_local.shape[1] * group_size(axis)

    d_local = nn_squared_distance(samples, target_local)      # [B, S]
    d_st = torch.amin(all_gather_stack(d_local, axis), dim=0)

    w_sum = torch.clamp_min(sample_w.sum(-1), 1e-12)
    mean_st = torch.sum(d_st * sample_w, dim=-1) / w_sum
    has = params.valid.any(-1)
    zero = torch.zeros_like(mean_st)
    mean_ts = torch.where(has, d_ts_sum / m_total, zero)
    dists = torch.where(has, (mean_st + mean_ts) / 2.0, zero)
    num = psum(dists.sum(), data_axis)
    den = psum(has.sum().to(num.dtype), data_axis)
    return num / torch.clamp_min(den, 1.0)


def cluster_and_fit_point_sharded(
        X: torch.Tensor, points: torch.Tensor, *, mesh: Mesh,
        quantile: float = 0.05, iterations: int = 5,
        max_num_clusters: int = 25, bandwidth_samples: int = 1 << 30,
        kernel_type: str = "gaussian", fit: bool = True):
    """Cluster (and optionally fit) with the point axis sharded.

    Args:
        X: ``[b, N, D]`` embeddings of this rank's data shard; points:
            ``[b, N, 3]``.  N must divide over ``mesh.shape['points']``.
        bandwidth_samples: cap on the gathered bandwidth subsample
            (default: all points -- exact parity with the unsharded path).
    Returns:
        ``(ClusterResult, PrimitiveParams | None)``: weights and labels for
        this rank's point slice, everything else replicated over the
        ``points`` group.
    """
    axis = mesh.group("points")
    res = _cluster_local(
        _points_slice(X, axis), quantile=quantile, iterations=iterations,
        max_num_clusters=max_num_clusters,
        bandwidth_samples=bandwidth_samples, axis=axis,
        axis_size=mesh.shape["points"], kernel_type=kernel_type)
    params = fit_ellipsoids_sharded(_points_slice(points, axis),
                                    res.weights, res.valid, axis) \
        if fit else None
    return res, params


def convex_fit_loss_point_sharded(
        X: torch.Tensor, points: torch.Tensor, target: torch.Tensor, *,
        mesh: Mesh, quantile: float = 0.05, iterations: int = 5,
        max_num_clusters: int = 25, n_per_prim: int = 64,
        bandwidth_samples: int = 1 << 30, cuboid: bool = False):
    """The self-sup fit loss with the point axis sharded: ring mean-shift
    -> moment-summed fit -> (replicated) primitive sampling -> sharded
    analytic chamfer.  The sequence-parallel equivalent of
    :func:`prifit_torch.geometry.convex_loss.convex_loss` without the
    optional entropy/intersection terms; the loss is
    slot-permutation invariant, so it equals the unsharded pipeline's.

    Args:
        X ``[b, N, D]`` embeddings and points ``[b, N, 3]`` fit targets of
        this rank's data shard; target ``[b, M, 3]`` chamfer cloud (sharded
        over its M axis here).
    Returns:
        ``(loss [], PrimitiveParams)``; the loss is the mean over the
        global batch, replicated on every rank.
    """
    from prifit_torch.geometry.sampling import sample_primitives_batch

    axis = mesh.group("points")
    res, params = cluster_and_fit_point_sharded(
        X, points, mesh=mesh, quantile=quantile, iterations=iterations,
        max_num_clusters=max_num_clusters,
        bandwidth_samples=bandwidth_samples)
    samples, w = sample_primitives_batch(params, n_per_prim=n_per_prim,
                                         cuboid=cuboid)
    loss = analytic_chamfer_sharded(params, samples, w,
                                    _points_slice(target, axis), axis,
                                    cuboid, data_axis=mesh.group("data"))
    return loss, params
