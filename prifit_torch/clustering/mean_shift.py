"""Mean-shift clustering on the unit hypersphere into fixed cluster slots.

Port of ``prifit_tpu/clustering/mean_shift.py``, batched over shapes
``[B, ...]`` instead of ``vmap``:

  bandwidth  = mean over points of sqrt(K-th-NN squared chordal distance),
               K = int(quantile * N)           (bandwidth kernel)
  update     = m / |m|,  m = mean-shift step   (mean-shift kernel), x iters
  NMS        = nearest-mode counts -> neighbour (dist < bw) with the most
               members -> distinct representatives  (NMS kernels)
  membership = column-normalized von-Mises kernel

The kernels run for CUDA tensors, their plain versions for CPU tensors
(:mod:`prifit_torch.kernels`).  The epanechnikov steps and the seeded
steps of :func:`mean_shift_eff_iterations` are plain PyTorch on every
device: the JAX package runs them as plain jnp on the TPU too (only the
gaussian step has a Pallas kernel).  Gradients flow to the embeddings through
every mean-shift step (its backward kernel), the centers and the
membership; the bandwidth and NMS take none, as in the JAX package.  Each
of the four stages is a profiler range of its own name (read by
:mod:`prifit_torch.profile_forward`).
"""

from typing import NamedTuple

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from prifit_torch.kernels.bandwidth import kth_nn_distance
from prifit_torch.kernels.mean_shift import mean_shift_step
from prifit_torch.kernels.nms import nms_passes
from prifit_torch.utils.guard import guard_exp, guard_sqrt


class ClusterResult(NamedTuple):
    centers: torch.Tensor       # [B, K, D] cluster centers (zero-padded)
    valid: torch.Tensor         # [B, K] bool, slot holds a real cluster
    labels: torch.Tensor        # [B, N] int64 hard assignment into slots
    weights: torch.Tensor       # [B, N, K] soft membership, invalid = 0
    bandwidth: torch.Tensor     # [B] selected bandwidth
    num_clusters: torch.Tensor  # [B] int64 number of valid slots


@record_function("bandwidth_candidates")
def bandwidth_candidates(X: torch.Tensor, quantile: float,
                         num_candidates: int) -> torch.Tensor:
    """Bandwidths for quantile, 2q, 4q, ... of unit rows ``X [B, N, D]``
    from one counting pass -> ``[B, C]``.  No gradient (the reference
    computes it under ``torch.no_grad``)."""
    N = X.shape[1]
    ks = [max(min(int(quantile * (2 ** c) * N), N), 1)
          for c in range(num_candidates)]
    with torch.no_grad():
        kths = kth_nn_distance(X.detach().contiguous(), ks)   # [B, C, N]
        return torch.mean(guard_sqrt(kths, 1e-6), dim=-1)


def compute_bandwidth(X: torch.Tensor, quantile: float,
                      num_samples: int | None = None) -> torch.Tensor:
    """Quantile K-th-NN bandwidth of one shape's rows ``X [N, D]`` (not
    normalized here), a scalar: the mean over the first ``n =
    min(num_samples or N, N)`` rows of the square root of each row's
    ``K = max(int(quantile n), 1)``-th smallest squared chordal distance
    ``2 - 2 <x, y>`` among those rows.  The K-th value is the bandwidth
    kernel's on a CUDA tensor: the least grid value ``m 2^-22`` whose
    count reaches K, which the JAX package's 24-step bisection of [0, 4]
    also gives.  No gradient."""
    n = min(num_samples or X.shape[0], X.shape[0])
    k = max(int(quantile * n), 1)
    with torch.no_grad():
        kth = kth_nn_distance(X[None, :n].detach().float().contiguous(),
                              [k])[0, 0]
        return torch.mean(guard_sqrt(kth, 1e-6))


def _chordal_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``2 - 2 <a, b>`` over the last axis, ``[..., M, D] x [..., N, D] ->
    [..., M, N]`` (the squared chordal distance of unit rows)."""
    return 2.0 - 2.0 * torch.matmul(a, b.transpose(-1, -2))


@record_function("mean_shift_iterations")
def mean_shift_iterations(X: torch.Tensor, bandwidth: torch.Tensor,
                          iterations: int,
                          kernel_type: str = "gaussian") -> torch.Tensor:
    """``iterations`` mean-shift updates of every point of unit rows
    ``X [B, N, D]`` with per-shape ``bandwidth [B]``; each step moves to
    the kernel-weighted mean and renormalizes.  Returns the modes,
    differentiable in ``X`` through both arguments of every step.  The
    gaussian step is the mean-shift kernel (and its backward kernel) on a
    CUDA tensor; the epanechnikov step ``relu(0.75 (1 - d / b^2))`` is
    plain PyTorch, recomputed in the backward as the JAX package's
    ``jax.checkpoint`` does."""
    X = X.contiguous()
    b2 = (bandwidth ** 2).float().contiguous()
    new_X = X
    for _ in range(iterations):
        if kernel_type == "gaussian":
            m, _ = mean_shift_step(new_X, X, b2)
            new_X = m / torch.linalg.norm(m, dim=-1, keepdim=True)
        else:
            new_X = _recomputed(_plain_step, new_X, X, b2, kernel_type)
    return new_X


def _plain_step(s, X, b2, kernel_type: str):
    """One step of the rows ``s`` against ``X`` with per-shape ``b2``:
    the kernel-weighted mean of ``X``, renormalized.  ``"epanechnikov"``:
    ``relu(0.75 (1 - d / b^2))`` of the chordal distance (also
    :func:`mean_shift_iterations`' step); ``"gaussian"``: the reference's
    seeded similarity kernel ``exp(<s, x> / b^2)``.  Plain PyTorch on
    every device: the JAX package runs both as plain jnp on the TPU
    too."""
    b2 = b2[..., None, None]
    if kernel_type == "gaussian":
        K = guard_exp(torch.matmul(s, X.transpose(-1, -2)) / b2)
    elif kernel_type == "epanechnikov":
        K = torch.relu(0.75 * (1.0 - _chordal_sqdist(s, X) / b2))
    else:
        raise ValueError(f"unknown kernel {kernel_type}")
    s = torch.matmul(K, X) * (1.0 / torch.sum(K, dim=-1, keepdim=True))
    return s / torch.linalg.norm(s, dim=-1, keepdim=True)


def _recomputed(fn, *args):
    """``fn(*args)``, recomputed in the backward instead of stored (the
    JAX package's ``jax.checkpoint``: a step's ``[N, N]`` kernel matrix is
    not kept)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def mean_shift_eff_iterations(X: torch.Tensor, seeds: torch.Tensor,
                              bandwidth: torch.Tensor, iterations: int,
                              kernel_type: str = "gaussian"
                              ) -> torch.Tensor:
    """Seeded mean-shift updates (the reference's ``mean_shift_eff_``):
    only the seed rows ``seeds [..., M, D]`` move, against every row of
    ``X [..., N, D]``, with ``bandwidth`` a scalar or ``[...]``.  The
    reference's quirks are kept: the gaussian kernel is the similarity
    kernel ``exp(<s, x> / b^2)`` (clamped as ``guard_exp`` does), and a
    step replaces the seed by the kernel-weighted mean (renormalized)
    instead of shifting it.  Returns ``[..., M, D]``."""
    b2 = torch.as_tensor(bandwidth, dtype=X.dtype, device=X.device) ** 2
    s = seeds
    for _ in range(iterations):
        s = _recomputed(_plain_step, s, X, b2, kernel_type)
    return s


def nms_tail(counts, is_center, used, K: int):
    """Slot selection from the three NMS reductions, all ``[B, N]``.
    Keeps the K largest elected counts (ties to the lowest mode id, as
    ``lax.top_k`` does), then orders kept slots by ascending mode id."""
    N = counts.shape[-1]
    n_selected = is_center.sum(-1)
    n_distinct = (used & is_center).sum(-1)
    elected = torch.where(is_center, counts, torch.full_like(counts, -1.0))
    keep_ids = torch.sort(elected, dim=-1, descending=True,
                          stable=True).indices[..., :K]
    slot = torch.arange(K, device=counts.device)
    keep_valid = torch.gather(is_center, -1, keep_ids) & (
        slot < torch.clamp_max(n_selected, K)[..., None])
    sort_key = torch.where(keep_valid, keep_ids,
                           torch.full_like(keep_ids, N + 1))
    order = torch.sort(sort_key, dim=-1, stable=True).indices
    center_ids = torch.gather(keep_ids, -1, order)
    valid = torch.gather(keep_valid, -1, order)
    center_ids = torch.where(valid, center_ids, torch.zeros_like(center_ids))
    return center_ids, valid, n_distinct


@record_function("nms_fixed_slots")
def nms_fixed_slots(modes: torch.Tensor, bandwidth: torch.Tensor,
                    max_num_clusters: int):
    """Non-max suppression of converged modes ``[B, N, D]`` into
    ``max_num_clusters`` slots.  Returns ``(center_ids [B, K], valid
    [B, K], n_distinct [B])``; ``n_distinct`` counts the distinct labels
    over the untruncated center set (the reference's retry count)."""
    counts, is_center, used = nms_passes(
        modes.detach().contiguous(), bandwidth.detach().float().contiguous())
    return nms_tail(counts, is_center, used, max_num_clusters)


@record_function("membership")
def membership(centers, valid, X, bandwidth) -> torch.Tensor:
    """Soft von-Mises membership ``[B, K, N]``: similarity / b^2, the
    per-shape global max subtracted through a detached path, exp,
    normalized over the valid slots."""
    sim = torch.matmul(centers, X.transpose(-1, -2)) / (
        bandwidth ** 2)[:, None, None]
    sim = torch.where(valid[..., None], sim, torch.full_like(sim, -1e9))
    sim = sim - torch.amax(sim, dim=(1, 2), keepdim=True).detach()
    kernel = guard_exp(sim) * valid[..., None]
    denom = torch.sum(kernel, dim=1, keepdim=True)
    return kernel / torch.clamp_min(denom, 1e-12)


def _run_candidate(X, bw, iterations: int, max_num_clusters: int,
                   kernel_type: str):
    modes = mean_shift_iterations(X, bw, iterations, kernel_type)
    center_ids, valid, n_distinct = nms_fixed_slots(modes, bw,
                                                    max_num_clusters)
    centers = torch.gather(
        modes, 1, center_ids[..., None].expand(-1, -1, modes.shape[-1]))
    centers = centers * valid[..., None]
    # final labels: nearest kept center per converged mode
    sim = torch.matmul(centers, modes.transpose(-1, -2))        # [B, K, N]
    sim = torch.where(valid[..., None], sim, torch.full_like(sim, -1e9))
    labels = torch.argmax(sim, dim=1)
    return [centers, valid, labels, n_distinct, bw]


def cluster_batch(X: torch.Tensor, *, quantile: float = 0.01,
                  iterations: int = 5, max_num_clusters: int = 25,
                  num_candidates: int = 2, kernel_type: str = "gaussian",
                  hard_weights: bool = False) -> ClusterResult:
    """Cluster each shape's embeddings ``X [B, N, D]`` into fixed slots.

    Per shape, the first quantile-doubling bandwidth candidate with at
    most ``max_num_clusters`` distinct clusters wins (the last candidate
    otherwise).  The first candidate runs for the whole batch; the others
    only for the shapes that overflow.  Finding those shapes reads a flag
    back to the host, so a call synchronizes with the device once when
    ``num_candidates > 1``.

    ``kernel_type`` is the mean-shift kernel, ``"gaussian"`` or
    ``"epanechnikov"`` (see :func:`mean_shift_iterations`).
    ``hard_weights``: the weights are the one-hot argmax over the slots of
    the soft membership of the embedding (the reference's ``visualize``
    branch), not the labels of the modes.
    """
    K = max_num_clusters
    Xn = X / torch.clamp_min(torch.linalg.norm(X, dim=2, keepdim=True),
                             1e-12)
    bws0 = bandwidth_candidates(Xn, quantile, 1)[:, 0]
    sel = _run_candidate(Xn, bws0, iterations, K, kernel_type)

    if num_candidates > 1:
        overflow = sel[3] > K
        if bool(overflow.any()):                    # host sync
            ids = torch.nonzero(overflow)[:, 0]
            x_c = Xn[ids]
            bw_rest = bandwidth_candidates(x_c, quantile * 2.0,
                                           num_candidates - 1)
            new = [t[ids] for t in sel]
            taken = torch.zeros_like(ids, dtype=torch.bool)
            for c in range(1, num_candidates):
                cand = _run_candidate(x_c, bw_rest[:, c - 1], iterations, K,
                                      kernel_type)
                fits = cand[3] <= K
                use = ~taken & (fits | (c == num_candidates - 1))
                new = [torch.where(use.view((-1,) + (1,) * (n_.dim() - 1)),
                                   n_, o_) for n_, o_ in zip(cand, new)]
                taken = taken | use
            sel = [t.index_put((ids,), n_) for t, n_ in zip(sel, new)]

    centers, valid, labels, _, bw = sel
    w_kn = membership(centers, valid, Xn, bw)
    if hard_weights:
        hard = torch.nn.functional.one_hot(torch.argmax(w_kn, dim=1), K)
        weights = hard.to(w_kn.dtype) * valid[:, None, :]
    else:
        weights = w_kn.transpose(1, 2)
    return ClusterResult(centers=centers, valid=valid, labels=labels,
                         weights=weights, bandwidth=bw,
                         num_clusters=valid.sum(-1))


def cluster_single(X: torch.Tensor, *, quantile: float = 0.01,
                   iterations: int = 5, max_num_clusters: int = 25,
                   num_candidates: int = 2, kernel_type: str = "gaussian",
                   hard_weights: bool = False) -> ClusterResult:
    """Cluster one shape's embeddings ``X [N, D]``: :func:`cluster_batch`
    at one shape, its result without the batch axis (``centers [K, D]``,
    ``labels [N]``, ``bandwidth []``, ...).  The JAX package runs every
    candidate and picks the first that fits; its ``cluster_batch`` runs
    the others only on overflow, which picks the same candidate."""
    out = cluster_batch(X[None], quantile=quantile, iterations=iterations,
                        max_num_clusters=max_num_clusters,
                        num_candidates=num_candidates,
                        kernel_type=kernel_type, hard_weights=hard_weights)
    return ClusterResult(*(t[0] for t in out))
