"""The port's clustering and its three kernels' plain versions against the
JAX package on the CPU (the jnp functions, and the Pallas kernels in
interpret mode, which round their matmul operands to bf16)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.clustering import mean_shift as T
from prifit_torch.kernels import bandwidth as KB
from prifit_torch.kernels import mean_shift as KM
from prifit_torch.kernels import nms as KN
from prifit_tpu.clustering import mean_shift as J
from prifit_tpu.ops.pallas.bandwidth import kth_nn_distance_pallas
from prifit_tpu.ops.pallas.mean_shift import _ref_step, mean_shift_step_pallas
from prifit_tpu.ops.pallas.nms import nms_passes_pallas

torch.set_num_threads(1)


def _unit_rows(seed, N, D):
    X = np.random.default_rng(seed).normal(size=(N, D)).astype(np.float32)
    return X / np.linalg.norm(X, axis=1, keepdims=True)


def _structured(seed, B, N, D=16, noise=0.15):
    """Four orthogonal directions plus gaussian noise, as in
    ``__graft_entry__.dryrun_multichip``."""
    rng = np.random.default_rng(seed)
    centers = np.eye(D, dtype=np.float32)[:4] * 4.0
    return (centers[np.arange(N) % 4]
            + rng.normal(size=(B, N, D)) * noise).astype(np.float32)


def _duplicate_modes(seed, N, D, n_anchors=7):
    """Converged-looking modes: exact copies of well-separated unit
    anchors, so every distance tie is exact in any summation order."""
    rng = np.random.default_rng(seed)
    anchors = rng.normal(size=(n_anchors, D)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
    return anchors[rng.integers(0, n_anchors, N)]


def test_bandwidth_plain_matches_bisect_and_pallas():
    """Against ``_kth_smallest_bisect`` within 1e-6 (f32 distance
    rounding against the 2.4e-7 bisection grid); against the Pallas
    kernel, whose bf16 operands move distances by up to ~4e-3, within
    5e-3."""
    X = _unit_rows(0, 256, 128)
    ks = [13, 26]
    Xj = jnp.asarray(X)
    ref = J._kth_smallest_bisect(J._chordal_sqdist(Xj, Xj), ks)
    pal = kth_nn_distance_pallas(Xj, tuple(ks), interpret=True)
    out = KB.kth_nn_distance(torch.from_numpy(X)[None], ks)[0].numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(out, np.asarray(pal), atol=5e-3)


def test_bandwidth_candidates_match():
    X = np.stack([_unit_rows(s, 200, 16) for s in (1, 2)])
    ref = np.stack([J._bandwidth_candidates(jnp.asarray(x), 0.05, 3)
                    for x in X])
    out = T.bandwidth_candidates(torch.from_numpy(X), 0.05, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


def test_mean_shift_step_matches_ref_and_pallas():
    """Against ``_ref_step`` within 1e-6 (f32, the exponent rounded
    differently); against the Pallas kernel (bf16 operands) within 5e-3,
    the bound the JAX package's own Pallas test uses."""
    X = _unit_rows(3, 256, 128)
    bw2 = np.float32(0.3)
    Xj = jnp.asarray(X)
    ref = _ref_step(Xj, Xj, bw2)
    pal = mean_shift_step_pallas(Xj, Xj, bw2, True)
    Xt = torch.from_numpy(X)[None]
    m, s = KM.mean_shift_step(Xt, Xt, torch.tensor([bw2]))
    np.testing.assert_allclose(m[0].numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(m[0].numpy(), np.asarray(pal), atol=5e-3)
    assert s.shape == (1, 256) and bool((s > 0).all())


def test_mean_shift_iterations_match():
    X = np.stack([_unit_rows(s, 128, 16) for s in (4, 5)])
    bw = np.array([0.6, 0.8], np.float32)
    ref = np.stack([J.mean_shift_iterations(jnp.asarray(x), b, 5)
                    for x, b in zip(X, bw)])
    out = T.mean_shift_iterations(torch.from_numpy(X), torch.from_numpy(bw),
                                  5)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_nms_passes_exact():
    """On exact-duplicate well-separated modes the counts, centers and
    used flags equal the jnp passes and the Pallas kernels exactly."""
    N, D = 256, 128
    modes = _duplicate_modes(6, N, D)
    bw = np.float32(0.35)
    counts, is_center, used = KN.nms_passes(torch.from_numpy(modes)[None],
                                            torch.tensor([bw]))
    pc, pi, pu = nms_passes_pallas(jnp.asarray(modes), jnp.asarray(bw),
                                   interpret=True)
    np.testing.assert_array_equal(counts[0].numpy(), np.asarray(pc))
    np.testing.assert_array_equal(is_center[0].numpy(), np.asarray(pi))
    np.testing.assert_array_equal(used[0].numpy(), np.asarray(pu))


@pytest.mark.parametrize("max_num_clusters", [25, 4])
def test_nms_fixed_slots_match(max_num_clusters):
    """Slot ids, validity and distinct-label counts exactly, including
    the truncation to fewer slots than surviving modes."""
    modes = np.stack([_duplicate_modes(s, 256, 16) for s in (7, 8)])
    bw = np.array([0.35, 0.35], np.float32)
    ref = [J.nms_fixed_slots(jnp.asarray(m), jnp.asarray(b),
                             max_num_clusters)
           for m, b in zip(modes, bw)]
    ids, valid, n_distinct = T.nms_fixed_slots(
        torch.from_numpy(modes), torch.from_numpy(bw), max_num_clusters)
    for b, (ri, rv, rn) in enumerate(ref):
        np.testing.assert_array_equal(ids[b].numpy(), np.asarray(ri))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(rv))
        assert int(n_distinct[b]) == int(rn)


def _assert_same_clustering(out, ref):
    """num_clusters and valid exactly; the same partition of the points
    into slots, and the weights within 1e-5 once the slots are matched.
    Which of a cluster's modes becomes its center can be decided by the
    rounding of the distance matmul among modes that agree to ~1e-4
    (fewer iterations) or to f32 rounding (converged), so the centers are
    held within 1e-3; and slots are ordered by center id, so there the
    slot ORDER may differ between the two frameworks.  The partition may
    not."""
    np.testing.assert_array_equal(out.num_clusters.numpy(),
                                  np.asarray(ref.num_clusters))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(out.bandwidth.numpy(),
                               np.asarray(ref.bandwidth), rtol=1e-6)
    for b in range(out.labels.shape[0]):
        lo, lr = out.labels[b].numpy(), np.asarray(ref.labels[b])
        slots = np.unique(lo)
        perm = np.empty_like(slots)
        for i, k in enumerate(slots):
            (targets,) = np.nonzero(np.bincount(lr[lo == k]))
            assert len(targets) == 1, "a port slot spans two JAX slots"
            perm[i] = targets[0]
        assert len(set(perm)) == len(slots)
        np.testing.assert_array_equal(perm[np.searchsorted(slots, lo)], lr)
        wo, wr = out.weights[b].numpy(), np.asarray(ref.weights[b])
        np.testing.assert_allclose(wo[:, slots], wr[:, perm], atol=1e-5)
        np.testing.assert_allclose(wo.sum(1), wr.sum(1), atol=1e-5)
        np.testing.assert_allclose(out.centers[b].numpy()[slots],
                                   np.asarray(ref.centers[b])[perm],
                                   atol=1e-3)


CLUSTER_KW = dict(quantile=0.05, iterations=10, max_num_clusters=25,
                  num_candidates=2)


@pytest.mark.parametrize("seed", [0, 3])
def test_cluster_batch_matches_structured(seed):
    """num_clusters, valid and labels exactly; weights within 1e-5 and
    centers within 1e-6 (f32 sums in another order)."""
    X = _structured(seed, 3, 256)
    ref = J.cluster_batch(jnp.asarray(X), **CLUSTER_KW)
    out = T.cluster_batch(torch.from_numpy(X), **CLUSTER_KW)
    assert (out.num_clusters.numpy() == 4).all()
    for name in ("num_clusters", "valid", "labels"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    np.testing.assert_allclose(out.weights.numpy(), np.asarray(ref.weights),
                               atol=1e-5)
    np.testing.assert_allclose(out.centers.numpy(), np.asarray(ref.centers),
                               atol=1e-6)


def test_cluster_batch_same_partition_when_center_choice_is_rounding():
    """A seed where a cluster's converged modes agree to f32 rounding, so
    which of them becomes the center (and so the slot order) follows the
    matmul's rounding: the same partition and weights, slots matched."""
    X = _structured(9, 3, 256)
    ref = J.cluster_batch(jnp.asarray(X), **CLUSTER_KW)
    out = T.cluster_batch(torch.from_numpy(X), **CLUSTER_KW)
    assert (out.num_clusters.numpy() == 4).all()
    _assert_same_clustering(out, ref)


def test_cluster_batch_retry_matches():
    """A mixed batch where only some shapes overflow the slots at the
    first bandwidth: the per-shape retry takes the same candidates."""
    rng = np.random.default_rng(10)
    parts = []
    for i in range(4):
        if i % 2 == 0:
            parts.append(rng.normal(size=(128, 16)))
        else:
            parts.append(rng.normal(size=(1, 16)) * 4.0
                         + rng.normal(size=(128, 16)) * 0.01)
    X = np.stack(parts).astype(np.float32)
    kw = dict(quantile=0.01, iterations=4, max_num_clusters=3,
              num_candidates=3)
    ref = J.cluster_batch(jnp.asarray(X), **kw)
    out = T.cluster_batch(torch.from_numpy(X), **kw)
    _assert_same_clustering(out, ref)
