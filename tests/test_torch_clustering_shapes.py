"""The port's clustering against the JAX package on the CPU at shapes other
than the main path's: widths 8 (the fitting demo's embeddings), 13 and 128
with N = 300 (no multiple of 64), and the shape function that the CUDA
wrappers share (``kernels/shapes.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.clustering import mean_shift as T
from prifit_torch.kernels.shapes import MAX_D, MAX_N, padded_width
from prifit_tpu.clustering import mean_shift as J
from prifit_tpu.geometry import create_synthetic_dataset

torch.set_num_threads(1)

N = 300
WIDTHS = [8, 13, 128]


def _unit_rows(seed, B, n, d):
    x = np.random.default_rng(seed).normal(size=(B, n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _structured(seed, B, n, d, k=4, noise=0.15):
    """``k`` clusters around orthogonal directions (magnitude 4) plus
    noise, shuffled over the points."""
    rng = np.random.default_rng(seed)
    lab = rng.permutation(np.arange(n) % k)
    return (4.0 * np.eye(d, dtype=np.float32)[lab]
            + rng.normal(size=(B, n, d)) * noise).astype(np.float32)


def _duplicate_modes(seed, B, n, d, n_anchors=6):
    """Exact copies of well-separated unit anchors: every distance tie is
    exact in any summation order."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        a = rng.normal(size=(n_anchors, d)).astype(np.float32)
        a /= np.linalg.norm(a, axis=1, keepdims=True)
        out.append(a[rng.integers(0, n_anchors, n)])
    return np.stack(out)


@pytest.mark.parametrize("d", WIDTHS)
def test_bandwidth_candidates(d):
    X = _unit_rows(d, 2, N, d)
    ref = np.stack([J._bandwidth_candidates(jnp.asarray(x), 0.05, 3)
                    for x in X])
    out = T.bandwidth_candidates(torch.from_numpy(X), 0.05, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("d", WIDTHS)
def test_mean_shift_one_step(d):
    X = _unit_rows(10 + d, 2, N, d)
    bw = np.array([0.5, 0.8], np.float32)
    ref = np.stack([J.mean_shift_iterations(jnp.asarray(x), b, 1)
                    for x, b in zip(X, bw)])
    out = T.mean_shift_iterations(torch.from_numpy(X), torch.from_numpy(bw),
                                  1)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("d", WIDTHS)
def test_nms_fixed_slots(d):
    """Slot ids, validity and distinct-label counts exactly, on modes with
    margin."""
    modes = _duplicate_modes(20 + d, 2, N, d)
    bw = np.array([0.35, 0.35], np.float32)
    ids, valid, n_distinct = T.nms_fixed_slots(
        torch.from_numpy(modes), torch.from_numpy(bw), 25)
    for b in range(2):
        ri, rv, rn = J.nms_fixed_slots(jnp.asarray(modes[b]),
                                       jnp.asarray(bw[b]), 25)
        np.testing.assert_array_equal(ids[b].numpy(), np.asarray(ri))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(rv))
        assert int(n_distinct[b]) == int(rn)


def _assert_same_partition(out, ref):
    """Equal cluster counts and validity, and the same partition of the
    points into slots (slots may be numbered otherwise: a cluster's center
    is a rounding choice among modes that agree to f32 rounding)."""
    np.testing.assert_array_equal(out.num_clusters.numpy(),
                                  np.asarray(ref.num_clusters))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    for b in range(out.labels.shape[0]):
        lo, lr = out.labels[b].numpy(), np.asarray(ref.labels[b])
        pairs = set(zip(lo.tolist(), lr.tolist()))
        assert len(pairs) == len(set(lo.tolist())) == len(set(lr.tolist()))


@pytest.mark.parametrize("d", WIDTHS)
def test_cluster_batch_structured(d):
    X = _structured(30 + d, 2, N, min(d, 16))
    if d > 16:
        X = np.concatenate([X, np.zeros((2, N, d - 16), np.float32)], -1)
    kw = dict(quantile=0.05, iterations=10, max_num_clusters=25,
              num_candidates=2)
    ref = J.cluster_batch(jnp.asarray(X), **kw)
    out = T.cluster_batch(torch.from_numpy(X), **kw)
    assert (out.num_clusters.numpy() == 4).all()
    _assert_same_partition(out, ref)
    np.testing.assert_allclose(out.bandwidth.numpy(),
                               np.asarray(ref.bandwidth), rtol=1e-6)


def test_cluster_batch_fitting_recipe():
    """The fitting demo's embeddings (``cli/fitting.py``): the synthetic
    scenes' one-hot weights cut to 8 columns plus 0.05, 3 ellipsoids of
    100 points, clustered with its settings (quantile 0.01, 20 steps, 8
    slots)."""
    scene = create_synthetic_dataset(2, seed=0, points_per_ellipsoid=100)
    emb = (scene.weights[:, :, :8] + 0.05).astype(np.float32)
    kw = dict(quantile=0.01, iterations=20, max_num_clusters=8,
              num_candidates=2)
    ref = J.cluster_batch(jnp.asarray(emb), **kw)
    out = T.cluster_batch(torch.from_numpy(emb), **kw)
    assert (out.num_clusters.numpy() == 3).all()
    _assert_same_partition(out, ref)
    np.testing.assert_allclose(out.weights.numpy(), np.asarray(ref.weights),
                               atol=1e-5)


@pytest.mark.parametrize("d, dp", [(1, 32), (8, 32), (13, 32), (32, 32),
                                   (33, 64), (64, 64), (65, 128),
                                   (128, 128)])
def test_padded_width(d, dp):
    assert padded_width("k", 1, d) == dp
    assert padded_width("k", MAX_N, d) == dp


@pytest.mark.parametrize("n, d, limit", [(300, 129, "1..128"),
                                         (300, 0, "1..128"),
                                         (8193, 128, "1..8192"),
                                         (0, 8, "1..8192")])
def test_padded_width_limits(n, d, limit):
    assert (MAX_D, MAX_N) == (128, 8192)
    with pytest.raises(ValueError, match=limit):
        padded_width("kernel", n, d)
