"""The port's library surface beyond the train and eval paths, against the
JAX package on the CPU: the chamfer family, ``lstsq`` and
``best_lambda``, the transforms, ``index_points`` and ``guard_acos``,
``cluster_single`` and ``cluster_batch`` with their kernel and weight
options, ``compute_bandwidth`` and the seeded mean-shift steps, and the
meters, timer, profiler and viz exporters.

Both sides get the same inputs, made with numpy from a seed.  Each test
states its tolerance and why.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prifit_torch.geometry.transforms as TT
import prifit_torch.ops.chamfer as TC
import prifit_torch.utils.meters as TMe
import prifit_torch.utils.viz as TV
import prifit_tpu.geometry.transforms as JT
import prifit_tpu.ops.chamfer as JC
import prifit_tpu.utils.meters as JMe
import prifit_tpu.utils.viz as JV
from prifit_torch.clustering import mean_shift as T
from prifit_torch.models import to_categorical
from prifit_torch.ops.lstsq import best_lambda, lstsq
from prifit_torch.ops.sampling import index_points
from prifit_torch.utils import StepTimer, debug_nans, guard_acos, sync, \
    trace
from prifit_tpu.clustering import mean_shift as J
from prifit_tpu.models import to_categorical as j_to_categorical
from prifit_tpu.ops.lstsq import best_lambda as j_best_lambda
from prifit_tpu.ops.lstsq import lstsq as j_lstsq
from prifit_tpu.ops.sampling import index_points as j_index_points
from prifit_tpu.utils.guard import guard_acos as j_guard_acos
from test_torch_clustering import _assert_same_clustering, _structured

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


# --------------------------------------------------------------- chamfer

def _clouds(seed, B=2, N=300, M=200):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(B, N, 3)).astype(np.float32)
    gt = rng.normal(size=(B, M, 3)).astype(np.float32)
    pm = rng.random((B, N)) < 0.8
    gm = rng.random((B, M)) < 0.7
    return pred, gt, pm, gm


CHAMFER_CASES = {
    "plain": lambda m, p, g, pm, gm: m.chamfer_distance(p, g),
    "masks": lambda m, p, g, pm, gm: m.chamfer_distance(
        p, g, pred_mask=pm, gt_mask=gm),
    "masks_sqrt": lambda m, p, g, pm, gm: m.chamfer_distance(
        p, g, sqrt=True, pred_mask=pm, gt_mask=gm),
    "one_side_0": lambda m, p, g, pm, gm: m.chamfer_distance_one_side(
        p, g, side=0),
    "one_side_1": lambda m, p, g, pm, gm: m.chamfer_distance_one_side(
        p, g, side=1),
    "single": lambda m, p, g, pm, gm: m.chamfer_distance_single_shape(
        p[0], g[0]),
    "single_sqrt_one_side": lambda m, p, g, pm, gm:
        m.chamfer_distance_single_shape(p[0], g[0], one_side=True,
                                        sqrt=True),
    "single_unreduced": lambda m, p, g, pm, gm:
        m.chamfer_distance_single_shape(p[0], g[0], reduce=False)[1],
    "pairwise": lambda m, p, g, pm, gm: m.chamfer_distance_pairwise_batch(
        p, g),
    "pairwise_sqrt": lambda m, p, g, pm, gm:
        m.chamfer_distance_pairwise_batch(p, g, sqrt=True),
    "nn_masked": lambda m, p, g, pm, gm: m.nn_squared_distance(
        p[1], g[1], gm[1]),
}


@pytest.mark.parametrize("case", CHAMFER_CASES)
def test_chamfer_family_matches_jax(case):
    """Values within 1e-6 relative and the gradient in ``pred`` within
    1e-5 of its largest entry: both sides pick the nearest neighbour by
    the same difference form (ties to the lowest index) and recompute the
    distance through it, so only the order of the final f32 means
    differs."""
    pred, gt, pm, gm = _clouds(4)
    fn = CHAMFER_CASES[case]
    ref, jg = jax.value_and_grad(lambda p: jnp.sum(fn(
        JC, p, jnp.asarray(gt), jnp.asarray(pm), jnp.asarray(gm))))(
        jnp.asarray(pred))
    p = _t(pred).requires_grad_(True)
    out = fn(TC, p, _t(gt), _t(pm), _t(gm))
    out.sum().backward()
    np.testing.assert_allclose(_np(out.sum()), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(_np(p.grad), np.asarray(jg), rtol=0,
                               atol=1e-5 * float(np.abs(jg).max()))


def test_chamfer_all_invalid_targets_give_the_sentinel():
    """A shape whose targets are all masked out: every distance is the
    JAX package's sentinel 1e10."""
    pred, gt, _, _ = _clouds(5, B=1)
    gm = np.zeros(gt.shape[:2], bool)
    ref = JC.nn_squared_distance(jnp.asarray(pred[0]), jnp.asarray(gt[0]),
                                 jnp.asarray(gm[0]))
    out = TC.nn_squared_distance(_t(pred), _t(gt), _t(gm))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref))
    assert float(out.min()) == 1e10


# ----------------------------------------------------------------- lstsq

def _lstsq_inputs(kind):
    rng = np.random.default_rng(7)
    if kind == "full_rank":
        A = rng.normal(size=(20, 5))
    else:
        col = rng.normal(size=(20, 1))
        A = np.concatenate([col, 2.0 * col, rng.normal(size=(20, 1))], 1)
    Y = rng.normal(size=(20, 2))
    return A.astype(np.float32), Y.astype(np.float32)


def _lstsq_grad_f64(A, Y, lamb):
    """The gradient of ``sum(x^2)`` in ``A`` of ``x = (A^T A + lamb I)^-1
    A^T Y`` in float64: ``2 (R Z^T - A Z x^T)`` with ``Z = M^-1 x`` and
    ``R = Y - A x``."""
    A, Y = A.astype(np.float64), Y.astype(np.float64)
    M = A.T @ A + lamb * np.eye(A.shape[1])
    x = np.linalg.solve(M, A.T @ Y)
    Z = np.linalg.solve(M, x)
    return 2.0 * ((Y - A @ x) @ Z.T - A @ Z @ x.T)


@pytest.mark.parametrize("kind, tol", [("full_rank", 1e-4),
                                       ("rank_deficient", 5e-4)])
def test_lstsq_matches_jax(kind, tol):
    """The solution and the gradient of ``sum(x^2)`` in ``Y`` within
    ``tol`` of their largest entries, and the gradient in ``A`` too where
    the rank is full.  Full rank takes the QR branch (1e-4: the f32
    factorizations round differently).  Rank-deficient takes the ridge
    branch with the lambda both sides pick (1e-3 here, by the same rank
    tests): ``A^T A + lambda I`` has condition number 6.8e4, so f32 solves
    may differ by up to 4e-3 of the largest entry; each side is 1.4e-4
    off the float64 solve and they differ by 2.7e-4, held within 5e-4.
    Its gradient in ``A`` meets that condition number squared: both sides'
    f32 gradients are O(1) of their largest entry off float64 (JAX 1.9,
    the port 2.4), so there the port's float64 step is held against the
    closed-form float64 gradient within 1e-8 (both kinds).  The solution
    is also held against numpy's least squares (full rank) or the float64
    ridge solve within ``tol``."""
    A, Y = _lstsq_inputs(kind)

    def loss_j(a, y):
        return jnp.sum(j_lstsq(a, y) ** 2)

    xj = j_lstsq(jnp.asarray(A), jnp.asarray(Y))
    gaj, gyj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(A),
                                                jnp.asarray(Y))
    a, y = _t(A).requires_grad_(True), _t(Y).requires_grad_(True)
    x = lstsq(a, y)
    (x ** 2).sum().backward()
    pairs = [(x, xj), (y.grad, gyj)]
    if kind == "full_rank":
        pairs.append((a.grad, gaj))
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=tol * np.abs(want).max())
    A64 = A.astype(np.float64)
    lamb = 0.0
    if kind == "full_rank":
        ref = np.linalg.lstsq(A64, Y, rcond=None)[0]
    else:
        lamb = float(best_lambda(a.T.detach() @ a.detach()))
        assert lamb == float(j_best_lambda(jnp.asarray(A.T @ A)))
        ref = np.linalg.solve(A64.T @ A64 + lamb * np.eye(3), A64.T @ Y)
    np.testing.assert_allclose(_np(x), ref, rtol=0,
                               atol=tol * np.abs(ref).max())
    a64 = torch.from_numpy(A64).requires_grad_(True)
    (lstsq(a64, torch.from_numpy(Y).double()) ** 2).sum().backward()
    want = _lstsq_grad_f64(A, Y, lamb)
    np.testing.assert_allclose(a64.grad.numpy(), want, rtol=0,
                               atol=1e-8 * np.abs(want).max())


@pytest.mark.parametrize("n", [1, 3])
def test_best_lambda_matches_jax(n):
    """The same lambda exactly: for a zero matrix the first candidate,
    for a rank-1 Gram matrix of scale ~20 the first above its rank
    tolerance."""
    rng = np.random.default_rng(n)
    v = rng.normal(size=(4, 1)) * np.sqrt(n * 5.0)
    for A in (np.zeros((4, 4)), (v @ v.T)):
        A = A.astype(np.float32)
        assert float(best_lambda(_t(A))) == float(j_best_lambda(
            jnp.asarray(A)))


# ------------------------------------------------------------ transforms

def test_rotation_matrix_a_to_b_matches_jax():
    """Random unit pairs (batched on the port's side), a pair with
    ``a = b`` (a singular frame: the identity on both) and ``a = -b``:
    within 1e-5."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(6, 3))
    b = rng.normal(size=(6, 3))
    a[4] = b[4] = [0.0, 0.0, 1.0]
    a[5], b[5] = [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]
    a = (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)
    b = (b / np.linalg.norm(b, axis=1, keepdims=True)).astype(np.float32)
    out = TT.rotation_matrix_a_to_b(_t(a), _t(b)).numpy()
    for i in range(6):
        ref = np.asarray(JT.rotation_matrix_a_to_b(jnp.asarray(a[i]),
                                                   jnp.asarray(b[i])))
        np.testing.assert_allclose(out[i], ref, atol=1e-5)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", out[:4], a[:4]),
                               b[:4], atol=1e-5)


def test_standardize_and_reverse_match_jax():
    """``standardize_points`` and its inverse on clouds with distinct
    principal extents: the same eigenvectors up to the solver's sign
    (``pca`` eigenvalues within 1e-5 relative), so the rotation of the
    smallest axis onto x and the standardized points agree within 1e-4
    once the sign is matched; the round trip returns the input within
    1e-4 on both sides."""
    rng = np.random.default_rng(11)
    pts = (rng.normal(size=(3, 200, 3)) * [3.0, 1.0, 0.3]
           + rng.normal(size=(3, 1, 3))).astype(np.float32)
    std_j, stds_j, means_j, Rs_j = JT.standardize_points(jnp.asarray(pts))
    std_t, stds_t, means_t, Rs_t = TT.standardize_points(_t(pts))
    for b in range(3):
        wj, vj = JT.pca(jnp.asarray(pts[b]))
        wt, vt = TT.pca(_t(pts[b]))
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5)
    np.testing.assert_allclose(means_t.numpy(), np.asarray(means_j),
                               atol=1e-6)
    # the smallest axis' sign is the solver's: R maps it onto +x, so a
    # flipped sign flips R's first row and the standardized x coordinate
    for b in range(3):
        Rj, Rt = np.asarray(Rs_j[b]), Rs_t[b].numpy()
        sign = np.sign(np.sum(Rj[0] * Rt[0]))
        flip = np.array([sign, 1.0, 1.0], np.float32)
        np.testing.assert_allclose(std_t[b].numpy() * flip,
                                   np.asarray(std_j[b]), atol=1e-4)
        np.testing.assert_allclose(stds_t[b].numpy(), np.asarray(stds_j[b]),
                                   rtol=1e-4)
    back_t = TT.reverse_all_transformations(std_t, means_t, stds_t, Rs_t)
    back_j = JT.reverse_all_transformations(std_j, means_j, stds_j, Rs_j)
    np.testing.assert_allclose(back_t.numpy(), pts, atol=1e-4)
    np.testing.assert_allclose(np.asarray(back_j), pts, atol=1e-4)
    one = TT.reverse_all_transformation(std_t[0], means_t[0], stds_t[0],
                                        Rs_t[0])
    np.testing.assert_allclose(one.numpy(), back_t[0].numpy(), atol=1e-6)


def test_projections_match_jax():
    """``project_to_plane`` within 1e-6 and ``project_to_point_cloud``
    exactly (nearest by the same difference form)."""
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    surf = rng.normal(size=(25, 3)).astype(np.float32)
    a = rng.normal(size=3).astype(np.float32)
    d = np.float32(0.7)
    ref = JT.project_to_plane(jnp.asarray(pts), jnp.asarray(a),
                              jnp.asarray(d))
    out = TT.project_to_plane(_t(pts), _t(a), torch.tensor(d))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    an = a / np.linalg.norm(a)
    np.testing.assert_allclose(out.numpy() @ an, d, atol=1e-5)
    np.testing.assert_array_equal(
        TT.project_to_point_cloud(_t(pts), _t(surf)).numpy(),
        np.asarray(JT.project_to_point_cloud(jnp.asarray(pts),
                                             jnp.asarray(surf))))


# ----------------------------------------------- index_points, guard_acos

def test_index_points_and_guard_acos_match_jax():
    """``index_points`` with ``[B, S, K]`` indices bit for bit, and its
    gradient (a scatter-add of the cotangent) within 1e-6; ``guard_acos``
    and its gradient within 1e-6, the clamped ends included (zero
    gradient outside ``(-1 + eps, 1 - eps)``)."""
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(2, 50, 6)).astype(np.float32)
    idx = rng.integers(0, 50, size=(2, 7, 4))
    w = rng.normal(size=(2, 7, 4, 6)).astype(np.float32)
    ref, jg = jax.value_and_grad(lambda p: jnp.sum(
        j_index_points(p, jnp.asarray(idx)) * w))(jnp.asarray(pts))
    p = _t(pts).requires_grad_(True)
    out = index_points(p, _t(idx))
    np.testing.assert_array_equal(
        out.detach().numpy(),
        np.asarray(j_index_points(jnp.asarray(pts), jnp.asarray(idx))))
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), atol=1e-6)

    x = np.array([-1.5, -1.0, -0.999999, -0.3, 0.0, 0.5, 0.9999995, 1.0, 2.0],
                 np.float32)
    ref, jg = jax.vmap(jax.value_and_grad(j_guard_acos))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    out = guard_acos(xt)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-6)


def test_to_categorical_matches_jax():
    """One-hot category labels, flattened, equal to the JAX package's."""
    y = np.array([[3], [0], [15]])
    np.testing.assert_array_equal(
        to_categorical(_t(y)).numpy(),
        np.asarray(j_to_categorical(jnp.asarray(y))))


# ------------------------------------------------------------ clustering

SINGLE_KW = dict(quantile=0.05, iterations=5, max_num_clusters=25,
                 num_candidates=2)


@pytest.mark.parametrize("seed", [0, 2])
def test_jax_cluster_single_is_cluster_batch_at_one_shape(seed):
    """The premise of the port's ``cluster_single`` (``cluster_batch`` at
    B=1): in the JAX package, ``cluster_single(X)`` and
    ``cluster_batch(X[None])[0]`` agree on centers, valid, labels,
    weights and bandwidth, also where the first candidate overflows (the
    second shape: 30 tight clusters into 25 slots)."""
    X = _structured(seed, 1, 256)[0]
    rng = np.random.default_rng(seed)
    tight = (np.eye(32, dtype=np.float32)[rng.integers(0, 30, 256)] * 4.0
             + rng.normal(size=(256, 32)).astype(np.float32) * 0.01)
    for x, kw in ((X, SINGLE_KW), (tight, dict(SINGLE_KW, quantile=0.01))):
        s = J.cluster_single(jnp.asarray(x), **kw)
        b = J.cluster_batch(jnp.asarray(x)[None], **kw)
        for name in ("valid", "labels", "num_clusters"):
            np.testing.assert_array_equal(np.asarray(getattr(s, name)),
                                          np.asarray(getattr(b, name))[0])
        for name in ("centers", "weights", "bandwidth"):
            np.testing.assert_allclose(np.asarray(getattr(s, name)),
                                       np.asarray(getattr(b, name))[0],
                                       atol=1e-6, err_msg=name)


def _batched(res):
    """A single-shape ``ClusterResult`` with a batch axis of 1."""
    return type(res)(*(t[None] for t in res))


@pytest.mark.parametrize("options", [
    dict(),
    dict(kernel_type="epanechnikov"),
    dict(hard_weights=True),
    dict(kernel_type="epanechnikov", hard_weights=True, quantile=0.2)],
    ids=["gaussian", "epanechnikov", "hard_weights", "epanechnikov_hard"])
def test_cluster_single_matches_jax(options):
    """``cluster_single`` against the JAX function on 4 structured
    clusters: the same partition, weights within 1e-5 once the slots are
    matched, centers within 1e-3 (``_assert_same_clustering``).  The
    epanechnikov kernel ``relu(0.75 (1 - d / b^2))``; ``hard_weights``
    one-hots the membership's argmax, which equals the label here."""
    kw = dict(SINGLE_KW, **options)
    X = _structured(6, 1, 256)[0]
    ref = J.cluster_single(jnp.asarray(X), **kw)
    out = T.cluster_single(_t(X), **kw)
    assert int(out.num_clusters) == 4
    assert out.weights.shape == (256, 25) and out.centers.shape == (25, 16)
    _assert_same_clustering(_batched(out), _batched(ref))
    if kw.get("hard_weights"):
        assert set(np.unique(out.weights.numpy())) == {0.0, 1.0}


@pytest.mark.parametrize("kernel_type", ["gaussian", "epanechnikov"])
def test_cluster_batch_options_match_jax(kernel_type):
    """``cluster_batch`` with ``hard_weights`` and each kernel on the
    mixed batch of ``test_cluster_batch_retry_matches``: the first and
    third shapes overflow 3 slots at the first bandwidth (128 modes), so
    the per-shape retry runs and must pick the same candidates (1
    cluster with the gaussian kernel, 3 with the epanechnikov); the
    one-hot weights make the same partition
    (``_assert_same_clustering``: weights equal once the slots are
    matched)."""
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
              num_candidates=3, kernel_type=kernel_type, hard_weights=True)
    ref = J.cluster_batch(jnp.asarray(X), **kw)
    out = T.cluster_batch(_t(X), **kw)
    want = 1 if kernel_type == "gaussian" else 3
    assert out.num_clusters.tolist() == [want, 1, want, 1]
    _assert_same_clustering(out, ref)
    np.testing.assert_array_equal(out.weights.sum(-1).numpy(),
                                  np.ones((4, 128), np.float32))


@pytest.mark.parametrize("quantile, num_samples",
                         [(0.01, None), (0.05, None), (0.3, 100),
                          (0.001, 64)])
def test_compute_bandwidth_matches_jax(quantile, num_samples):
    """Within 2e-6 relative.  Each row's K-th squared distance is a grid
    value ``m 2^-22`` on both sides (the bisection's resolution, 2.4e-7
    of the [0, 4] range); a row's value can move by one grid step where
    the two sides' f32 distances straddle a grid line, which moves the
    mean of the roots by far less.  The rows are unnormalized (the
    function does not normalize)."""
    rng = np.random.default_rng(int(quantile * 1000))
    X = _structured(3, 1, 256)[0] * rng.uniform(0.5, 1.0, (256, 1))
    X = X.astype(np.float32) / 4.0
    ref = J.compute_bandwidth(jnp.asarray(X), quantile, num_samples)
    out = T.compute_bandwidth(_t(X), quantile, num_samples)
    assert out.shape == ()
    np.testing.assert_allclose(float(out), float(ref), rtol=2e-6)


@pytest.mark.parametrize("kernel_type", ["gaussian", "epanechnikov"])
def test_mean_shift_eff_iterations_match_jax(kernel_type):
    """Three seeded steps of half the rows (the reference's similarity
    kernel for gaussian, seeds replaced by the weighted mean): values
    within 1e-5 and the gradient of a weighted sum in X and the seeds
    within 1e-4 of its largest entry (f32 sums in another order through
    three steps)."""
    X = _structured(8, 1, 256)[0]
    X = X / np.linalg.norm(X, axis=1, keepdims=True)
    seeds = X[::2].copy()
    w = np.random.default_rng(1).normal(size=seeds.shape).astype(np.float32)
    bw = np.float32(0.4 if kernel_type == "gaussian" else 0.8)

    def fj(x, s):
        return jnp.sum(J.mean_shift_eff_iterations(
            x, s, bw, 3, kernel_type) * w)

    ref = J.mean_shift_eff_iterations(jnp.asarray(X), jnp.asarray(seeds),
                                      bw, 3, kernel_type)
    gxj, gsj = jax.grad(fj, argnums=(0, 1))(jnp.asarray(X),
                                            jnp.asarray(seeds))
    x, s = _t(X).requires_grad_(True), _t(seeds).requires_grad_(True)
    out = T.mean_shift_eff_iterations(x, s, torch.tensor(bw), 3,
                                      kernel_type)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    (out * _t(w)).sum().backward()
    for got, want in ((x.grad, gxj), (s.grad, gsj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_epanechnikov_iterations_match_jax():
    """The batched epanechnikov steps against the JAX package's (one
    shape at a time): values within 1e-5, and the gradient of a weighted
    sum (through the recomputed steps) within 1e-4 of its largest
    entry."""
    X = _structured(4, 2, 200)
    X = X / np.linalg.norm(X, axis=2, keepdims=True)
    bw = np.array([0.6, 0.9], np.float32)
    w = np.random.default_rng(3).normal(size=X.shape).astype(np.float32)

    def fj(x):
        return sum(jnp.sum(J.mean_shift_iterations(
            x[b], bw[b], 4, "epanechnikov") * w[b]) for b in range(2))

    ref = np.stack([np.asarray(J.mean_shift_iterations(
        jnp.asarray(X[b]), bw[b], 4, "epanechnikov")) for b in range(2)])
    jg = np.asarray(jax.grad(fj)(jnp.asarray(X)))
    x = _t(X).requires_grad_(True)
    out = T.mean_shift_iterations(x, _t(bw), 4, "epanechnikov")
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5)
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0,
                               atol=1e-4 * np.abs(jg).max())
    with pytest.raises(ValueError, match="unknown kernel"):
        T.mean_shift_iterations(x, _t(bw), 1, "cosine")


# ------------------------------------------- meters, timer, profiler, viz

def test_meters_match_jax():
    """The running average, the step learning-rate drop and the pastel
    colours (the same ``random.Random`` draws) equal the JAX package's;
    the initializers have the stated means and spreads."""
    mt, mj = TMe.AverageValueMeter(), JMe.AverageValueMeter()
    for v, n in ((1.0, 1), (3.0, 3), (0.25, 2)):
        mt.update(v, n)
        mj.update(v, n)
        assert (mt.val, mt.sum, mt.count, mt.avg) == (mj.val, mj.sum,
                                                      mj.count, mj.avg)
    mt.reset()
    assert mt.count == 0 and mt.avg == 0
    for epoch in range(12):
        assert TMe.adjust_learning_rate(0.1, epoch, 4) == \
            JMe.adjust_learning_rate(0.1, epoch, 4)
    assert TMe.get_colors(7, rng=random.Random(3)) == JMe.get_colors(
        7, rng=random.Random(3))
    g = torch.Generator().manual_seed(0)
    w = TMe.conv_init(g, (200, 100))
    s = TMe.scale_init(g, (20000,))
    assert abs(float(w.mean())) < 1e-3 and abs(float(w.std()) - 0.02) < 1e-3
    assert abs(float(s.mean()) - 1.0) < 1e-3 and \
        abs(float(s.std()) - 0.02) < 1e-3


def test_step_timer_and_sync():
    """``time_fn`` and ``step`` record one time a call and wait for the
    result; ``sync`` returns the first element of the first tensor of a
    nest; ``summary`` has the JAX package's keys."""
    t = StepTimer()
    f = torch.nn.Linear(8, 8)
    x = torch.ones(4, 8)
    assert t.time_fn(f, x, warmup=1, reps=3) >= 0
    with t.step() as done:
        done({"a": (f(x), 1)})
    s = t.summary()
    assert s["n"] == 2 and set(s) == {"mean_s", "p50_s", "p95_s", "n"}
    assert sync([torch.tensor([2.5, 1.0]), torch.zeros(1)]) == 2.5
    assert StepTimer().summary() == {}


def test_trace_writes_a_profile_and_debug_nans_raises(tmp_path):
    """``trace`` writes a Chrome trace into its directory;
    ``debug_nans`` raises where a backward function returns NaN, and does
    not when disabled."""
    with trace(str(tmp_path / "prof")):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = list((tmp_path / "prof").iterdir())
    assert files and files[0].stat().st_size > 0
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    with debug_nans(True), pytest.raises(RuntimeError, match="nan"):
        torch.sqrt(x - 1.0).sum().backward()
    with debug_nans(False):
        torch.sqrt(x - 1.0).sum().backward()


def test_viz_exporters_match_jax(tmp_path):
    """``save_xyz`` and ``save_ply`` write the JAX package's bytes (also
    from a tensor); ``labels_to_colors`` gives its colours."""
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(12, 3)).astype(np.float32)
    labels = rng.integers(0, 4, 12)
    colors = JV.labels_to_colors(labels)
    np.testing.assert_array_equal(TV.labels_to_colors(_t(labels)), colors)
    JV.save_xyz(str(tmp_path / "j.xyz"), pts, colors)
    TV.save_xyz(str(tmp_path / "t.xyz"), _t(pts), colors)
    JV.save_ply(str(tmp_path / "j.ply"), pts, colors)
    TV.save_ply(str(tmp_path / "t.ply"), _t(pts), _t(colors))
    for ext in ("xyz", "ply"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
