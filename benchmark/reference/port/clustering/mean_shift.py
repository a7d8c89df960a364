# Frozen copy of prifit_torch/clustering/mean_shift.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""Mean-shift clustering on the unit hypersphere into fixed cluster slots.

Port of ``prifit_tpu/clustering/mean_shift.py``, batched over shapes
``[B, ...]`` instead of ``vmap``:

  bandwidth  = mean over points of sqrt(K-th-NN squared chordal distance),
               K = int(quantile * N)           (bandwidth kernel)
  update     = m / |m|,  m = mean-shift step   (mean-shift kernel), x iters
  NMS        = nearest-mode counts -> neighbour (dist < bw) with the most
               members -> distinct representatives  (NMS kernels)
  membership = column-normalized von-Mises kernel

The copy takes the kernels' plain versions
(:mod:`benchmark.reference.port.kernels`), the gaussian kernel only (the
program's epanechnikov and seeded steps, and its hard weights, are left
out: no cell takes them).  Gradients flow to the embeddings through
every mean-shift step (its backward kernel), the centers and the
membership; the bandwidth and NMS take none, as in the JAX package.  Each
of the four stages is a profiler range of its own name (read by
:mod:`prifit_torch.profile_forward`).
"""

from typing import NamedTuple

import torch
from torch.profiler import record_function

from benchmark.reference.port.kernels.bandwidth import kth_nn_distance
from benchmark.reference.port.kernels.mean_shift import mean_shift_step
from benchmark.reference.port.kernels.nms import nms_passes
from benchmark.reference.port.utils.guard import guard_exp, guard_sqrt


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


@record_function("mean_shift_iterations")
def mean_shift_iterations(X: torch.Tensor, bandwidth: torch.Tensor,
                          iterations: int) -> torch.Tensor:
    """``iterations`` gaussian mean-shift updates of every point of unit
    rows ``X [B, N, D]`` with per-shape ``bandwidth [B]``; each step moves
    to the kernel-weighted mean and renormalizes.  Returns the modes,
    differentiable in ``X`` through both arguments of every step."""
    X = X.contiguous()
    b2 = (bandwidth ** 2).float().contiguous()
    new_X = X
    for _ in range(iterations):
        m, _ = mean_shift_step(new_X, X, b2)
        new_X = m / torch.linalg.norm(m, dim=-1, keepdim=True)
    return new_X


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


def _run_candidate(X, bw, iterations: int, max_num_clusters: int):
    modes = mean_shift_iterations(X, bw, iterations)
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
                  num_candidates: int = 2) -> ClusterResult:
    """Cluster each shape's embeddings ``X [B, N, D]`` into fixed slots.

    Per shape, the first quantile-doubling bandwidth candidate with at
    most ``max_num_clusters`` distinct clusters wins (the last candidate
    otherwise).  The first candidate runs for the whole batch; the others
    only for the shapes that overflow.  Finding those shapes reads a flag
    back to the host, so a call synchronizes with the device once when
    ``num_candidates > 1``.
    """
    K = max_num_clusters
    Xn = X / torch.clamp_min(torch.linalg.norm(X, dim=2, keepdim=True),
                             1e-12)
    bws0 = bandwidth_candidates(Xn, quantile, 1)[:, 0]
    sel = _run_candidate(Xn, bws0, iterations, K)

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
                cand = _run_candidate(x_c, bw_rest[:, c - 1], iterations, K)
                fits = cand[3] <= K
                use = ~taken & (fits | (c == num_candidates - 1))
                new = [torch.where(use.view((-1,) + (1,) * (n_.dim() - 1)),
                                   n_, o_) for n_, o_ in zip(cand, new)]
                taken = taken | use
            sel = [t.index_put((ids,), n_) for t, n_ in zip(sel, new)]

    centers, valid, labels, _, bw = sel
    weights = membership(centers, valid, Xn, bw).transpose(1, 2)
    return ClusterResult(centers=centers, valid=valid, labels=labels,
                         weights=weights, bandwidth=bw,
                         num_clusters=valid.sum(-1))


