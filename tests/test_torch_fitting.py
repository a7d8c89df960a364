"""The port's fit-pipeline demo and its pieces against the JAX package on
the CPU: the synthetic scenes (bit for bit), the single-shape fits and
sampling views, and ``python -m prifit_torch.cli.fitting``'s ``main``
against ``prifit_tpu.cli.fitting.main`` at the JAX test's settings.

Eigenvector signs are whatever the solver picks, and the fit samples a
primitive along its axes, so where a sampled surface is compared the
port's ``torch.linalg.eigh`` takes JAX's signs (``align_eigh_signs``).
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prifit_torch.geometry as TG
import prifit_tpu.geometry as JG
from prifit_torch.cli.args_parser import parse_args
from prifit_torch.cli.fitting import main
from prifit_tpu.cli.args_parser import parse_args as j_parse_args
from prifit_tpu.cli.fitting import main as j_main
from test_torch_grad import align_eigh_signs, jax_eigh

torch.set_num_threads(1)

# the JAX package's own test of its demo (tests/test_train.py)
DEMO_ARGS = ["--batch_size", "1", "--quantile", "0.05",
             "--msc_iterations", "3", "--n_per_prim", "32"]
DELTA = 2.0 ** -20


@pytest.mark.parametrize("batch_size, seed", [(2, 0), (3, 7)])
def test_synthetic_scene_is_jax_bit_for_bit(batch_size, seed):
    """Every array of ``create_synthetic_dataset`` equal to the JAX
    package's, bit for bit (the same numpy draws in the same order)."""
    got = TG.create_synthetic_dataset(batch_size, seed=seed)
    want = JG.create_synthetic_dataset(batch_size, seed=seed)
    assert type(got).__name__ == "SyntheticScene"
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _soft_weights(scene, rng):
    """One-hot cluster weights blurred with uniform noise, 5 slots (two
    empty)."""
    w = scene.weights[0, :, :5] * 0.8 + rng.random((1500, 5)) * 0.2
    w[:, 3:] = 0.0
    return w.astype(np.float32)


def test_single_shape_fits_match_jax():
    """``fit_ellipsoid_weighted`` and ``fit_ellipsoids`` (views of the
    batched fit at one shape) against the JAX functions on soft weights:
    centers within 1e-5 relative; axes within 5e-5 up to each column's
    sign (the eigenvectors of an f32 covariance, from two solvers, differ
    by ~1e-5 in angle); radii within 3e-5 relative (each is half the
    extent of the points along an axis, which that angle moves by ~1e-5
    on a cloud of radius ~16); validity exactly (the two empty slots
    invalid); and the gradient of the radii in the weights within 1e-4
    of its largest entry (the guarded eigh backward)."""
    scene = JG.create_synthetic_dataset(1, seed=2)
    pts = scene.points[0]
    w = _soft_weights(scene, np.random.default_rng(0))
    r, V, c, valid = TG.fit_ellipsoid_weighted(torch.from_numpy(pts),
                                               torch.from_numpy(w[:, 1]))
    rj, Vj, cj, vj = JG.fit_ellipsoid_weighted(jnp.asarray(pts),
                                               jnp.asarray(w[:, 1]))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=3e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=1e-5)
    np.testing.assert_allclose(np.abs(V.numpy()), np.abs(np.asarray(Vj)),
                               atol=5e-5)
    assert bool(valid) == bool(vj)

    slot_valid = np.array([True, True, False, True, True])
    out = TG.fit_ellipsoids(torch.from_numpy(pts), torch.from_numpy(w),
                            torch.from_numpy(slot_valid))
    ref = JG.fit_ellipsoids(jnp.asarray(pts), jnp.asarray(w),
                            jnp.asarray(slot_valid))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert out.valid.tolist() == [True, True, False, False, False]
    np.testing.assert_allclose(out.r.numpy(), np.asarray(ref.r), rtol=3e-5)
    np.testing.assert_allclose(out.center.numpy(), np.asarray(ref.center),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.abs(out.V.numpy()),
                               np.abs(np.asarray(ref.V)), atol=5e-5)

    gj = jax.grad(lambda ww: jnp.sum(JG.fit_ellipsoids(
        jnp.asarray(pts), ww).r))(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    TG.fit_ellipsoids(torch.from_numpy(pts), wt).r.sum().backward()
    gj = np.asarray(gj)
    np.testing.assert_allclose(wt.grad.numpy(), gj, rtol=0,
                               atol=1e-4 * np.abs(gj).max())


@pytest.mark.parametrize("cuboid", [False, True])
def test_sample_primitives_matches_jax(cuboid):
    """``sample_primitives`` (a view of the batched sampling at one shape)
    on the JAX fit of a scene: points within 1e-5 of the largest
    coordinate and weights within 1e-5 relative, zero weight on the
    invalid slots."""
    scene = JG.create_synthetic_dataset(1, seed=4)
    ref_params = JG.fit_ellipsoids(jnp.asarray(scene.points[0]),
                                   jnp.asarray(scene.weights[0, :, :4]))
    params = TG.PrimitiveParams(*(torch.from_numpy(np.asarray(t))
                                  for t in ref_params))
    pts, w = TG.sample_primitives(params, 64, cuboid)
    pj, wj = JG.sample_primitives(ref_params, 64, cuboid)
    pj, wj = np.asarray(pj), np.asarray(wj)
    assert pts.shape == pj.shape and w.shape == wj.shape
    np.testing.assert_allclose(pts.numpy(), pj, rtol=0,
                               atol=1e-5 * np.abs(pj).max())
    np.testing.assert_allclose(w.numpy(), wj, rtol=1e-5)
    assert not w.reshape(4, -1)[3].any()


def _parse(text):
    """The numbers of the demo's printed lines: the fitted and true axes
    of each ellipsoid and the loss, chamfer and gradient norm."""
    fits = [(np.array(a.split(), float), np.array(b.split(), float))
            for a, b in re.findall(
                r"fitted \[\s*([^\]]*)\] true \[\s*([^\]]*)\]", text)]
    loss = re.search(r"convex loss (\S+) chamfer (\S+) \|grad\| (\S+)",
                     text)
    assert "fit pipeline OK" in text
    return fits, [float(v) for v in loss.groups()]


@pytest.fixture(scope="module")
def demo_runs():
    """JAX's ``main`` at its test's settings, its printed lines, and the
    loss and gradient norm of its pipeline under one jit on the scene's
    embeddings scaled by 1 and by 1 +- 2^-20 (the gradient's own spread);
    and the port's ``main`` on the CPU with its printed lines."""
    with pytest.MonkeyPatch.context() as mp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            j_main(j_parse_args(DEMO_ARGS))
        scene = JG.create_synthetic_dataset(1, seed=0)
        points = jnp.asarray(scene.points)
        emb = jnp.asarray(scene.weights[:, :, :8] + np.float32(0.05))

        def loss(e):
            return JG.convex_loss(points, points, e, quantile=0.05,
                                  iterations=3, max_num_clusters=8,
                                  n_per_prim=32).total

        fn = jax.jit(jax.value_and_grad(loss))
        jax_runs = []
        for s in (1.0, 1.0 + DELTA, 1.0 - DELTA):
            total, g = fn(emb * np.float32(s))
            jax_runs.append((float(total), float(jnp.linalg.norm(g))))
        align_eigh_signs(mp, jax_eigh)
        tbuf = io.StringIO()
        with contextlib.redirect_stdout(tbuf):
            port = main(parse_args(DEMO_ARGS), device="cpu")
    return buf.getvalue(), jax_runs, tbuf.getvalue(), port


def test_fitting_demo_prints_jax_lines(demo_runs):
    """The port's printed lines against JAX's: the same number of lines,
    true axes equal, fitted axes within one printed unit (0.01) and the
    loss and chamfer within one printed unit (1e-5) plus 1e-4 relative
    (the f32 step's limit)."""
    j_text, _, t_text, _ = demo_runs
    (j_fits, j_nums), (t_fits, t_nums) = _parse(j_text), _parse(t_text)
    assert len(t_fits) == len(j_fits) == 3
    for (tg, tw), (jg, jw) in zip(t_fits, j_fits):
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_allclose(tg, jg, rtol=0, atol=0.01 + 1e-9)
    for t, j in zip(t_nums[:2], j_nums[:2]):
        assert abs(t - j) <= 1e-5 + 1e-4 * abs(j), (t, j)


def test_fitting_demo_numbers_match_jax(demo_runs):
    """``main``'s returned numbers at full precision: the fitted radii and
    centers against the JAX fit within 1e-5 relative; the loss and
    chamfer within 1e-4 relative of JAX's; and the gradient norm, which
    is rounding-level here (the clusters are exact, so the membership is
    saturated: JAX's own norm moves by 25% when the embeddings are
    scaled by 1 - 2^-20), within twice JAX's own spread plus 5e-2
    relative."""
    _, jax_runs, _, port = demo_runs
    scene = JG.create_synthetic_dataset(1, seed=0)
    ref = JG.fit_ellipsoids_batch(jnp.asarray(scene.points),
                                  jnp.asarray(scene.weights))
    np.testing.assert_allclose(port["r"], np.asarray(ref.r)[:, :3],
                               rtol=1e-5)
    np.testing.assert_allclose(port["center"], np.asarray(ref.center)[:, :3],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port["true_r"], scene.params)
    total, gnorm = jax_runs[0]
    assert abs(port["total"] - total) <= 1e-4 * abs(total)
    assert port["chamfer"] == port["total"]
    spread = max(abs(g - gnorm) for _, g in jax_runs[1:])
    assert abs(port["grad_norm"] - gnorm) <= 2 * spread + 5e-2 * gnorm, (
        port["grad_norm"], gnorm, spread)
    assert port["grad_norm"] > 0
