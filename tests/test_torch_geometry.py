"""The port's fitting, sampling, SDF and analytic chamfer against the JAX
package on the CPU, fed the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from prifit_torch.geometry import fitting as TF
from prifit_torch.geometry import losses as TL
from prifit_torch.geometry import sampling as TS
from prifit_torch.geometry import sdf as TD
from prifit_torch.ops.chamfer import nn_squared_distance
from prifit_tpu.geometry import fitting as JF
from prifit_tpu.geometry import losses as JL
from prifit_tpu.geometry import sampling as JS
from prifit_tpu.geometry import sdf as JD
from prifit_tpu.ops.chamfer import nn_squared_distance as j_nn

torch.set_num_threads(1)

B, N, K = 2, 300, 5


def _fit_inputs(seed=0):
    """Four anisotropic blobs with soft memberships, one slot with no
    weight (fails the minimum-weight check) and one slot invalid from
    clustering."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(B, 4, 3)) * 3.0
    blob = rng.integers(0, 4, size=(B, N))
    scale = np.array([1.0, 0.5, 0.2])
    pts = (np.take_along_axis(centers, blob[..., None], 1)
           + rng.normal(size=(B, N, 3)) * scale).astype(np.float32)
    logits = np.eye(K)[blob] * 4.0 + rng.normal(size=(B, N, K)) * 0.3
    w = np.exp(logits)
    w[..., 4] = 0.0
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    slot_valid = np.ones((B, K), bool)
    slot_valid[1, 2] = False
    return pts, w, slot_valid


def _jax_params(pts, w, slot_valid):
    return JF.fit_ellipsoids_batch(jnp.asarray(pts), jnp.asarray(w),
                                   jnp.asarray(slot_valid))


def _torch_params(p):
    return TF.PrimitiveParams(*(torch.from_numpy(np.array(a)) for a in p))


def test_fit_matches():
    """r and center within 1e-4 (f32 weighted sums in another order);
    validity exactly; V up to the sign of each column, since eigenvector
    signs are not fixed across LAPACK builds (both sides keep det(V) =
    +1)."""
    pts, w, slot_valid = _fit_inputs()
    ref = _jax_params(pts, w, slot_valid)
    out = TF.fit_ellipsoids_batch(torch.from_numpy(pts), torch.from_numpy(w),
                                  torch.from_numpy(slot_valid))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert not out.valid[:, 4].any() and not out.valid[1, 2]
    np.testing.assert_allclose(out.r.numpy(), np.asarray(ref.r), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out.center.numpy(), np.asarray(ref.center),
                               atol=1e-4)
    Vo, Vr = out.V.numpy(), np.asarray(ref.V)
    sign = np.sign(np.sum(Vo * Vr, axis=-2, keepdims=True))
    np.testing.assert_allclose(Vo * sign, Vr, atol=1e-4)
    np.testing.assert_allclose(np.linalg.det(Vo), 1.0, atol=1e-4)


def test_sampling_matches():
    pts, w, slot_valid = _fit_inputs(1)
    ref_p = _jax_params(pts, w, slot_valid)
    n = 64
    rs, rw = JS.sample_primitives_batch(ref_p, n_per_prim=n)
    os_, ow = TS.sample_primitives_batch(_torch_params(ref_p), n)
    np.testing.assert_allclose(
        TS.fibonacci_sphere(n).numpy(), np.asarray(JS.fibonacci_sphere(n)),
        atol=1e-5)
    np.testing.assert_allclose(os_.numpy(), np.asarray(rs), atol=1e-4)
    np.testing.assert_allclose(ow.numpy(), np.asarray(rw), rtol=1e-5,
                               atol=1e-6)


def test_sdf_matches():
    pts, w, slot_valid = _fit_inputs(2)
    p = _jax_params(pts, w, slot_valid)
    q = np.random.default_rng(3).normal(size=(B, 50, 3)).astype(
        np.float32) * 3.0
    ref = jax.vmap(JD.sdf_primitives)(jnp.asarray(q), p.r, p.V, p.center)
    tp = _torch_params(p)
    out = TD.sdf_primitives(torch.from_numpy(q), tp.r, tp.V, tp.center)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_nn_squared_distance_matches():
    rng = np.random.default_rng(4)
    src = rng.normal(size=(B, 2100, 3)).astype(np.float32)
    dst = rng.normal(size=(B, 700, 3)).astype(np.float32)
    ref = jax.vmap(j_nn)(jnp.asarray(src), jnp.asarray(dst))
    out = nn_squared_distance(torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_analytic_chamfer_matches():
    """Fed the same params, samples and target: within 1e-5 relative."""
    pts, w, slot_valid = _fit_inputs(5)
    p = _jax_params(pts, w, slot_valid)
    samples, sw = JS.sample_primitives_batch(p, n_per_prim=64)
    ref = JL.analytic_chamfer(p, samples, sw, jnp.asarray(pts))
    out = TL.analytic_chamfer(_torch_params(p),
                              torch.from_numpy(np.array(samples)),
                              torch.from_numpy(np.array(sw)),
                              torch.from_numpy(pts))
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
