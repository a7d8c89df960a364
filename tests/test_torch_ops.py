"""The port's point ops and their kernels' plain versions against the JAX
package on the CPU: FPS and the row gather bit-exactly (also against the
Pallas kernels in interpret mode), distances, ball queries and 3-NN
interpolation within f32 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.kernels.gather import gather_rows
from prifit_torch.ops import pairwise as tpair
from prifit_torch.ops import sampling as tsamp
from prifit_tpu.ops import pairwise as jpair
from prifit_tpu.ops import sampling as jsamp
from prifit_tpu.ops.pallas.fps import farthest_point_sample_pallas
from prifit_tpu.ops.pallas.gather import gather_rows_pallas

torch.set_num_threads(1)

HIGHEST = jax.lax.Precision.HIGHEST


def _cloud(seed, B, N):
    return np.random.default_rng(seed).normal(size=(B, N, 3)).astype(
        np.float32)


@pytest.mark.parametrize("explicit_start", [False, True])
def test_fps_exact(explicit_start):
    """Start 0 and a random start: the port's FPS is EXACTLY the JAX scan
    and the Pallas kernel (interpret mode)."""
    B, N, npoint = 3, 256, 48
    x = _cloud(0, B, N)
    if explicit_start:
        key = jax.random.PRNGKey(7)
        ref = jsamp.farthest_point_sample(jnp.asarray(x), npoint, key=key)
        pal = farthest_point_sample_pallas(jnp.asarray(x), npoint, key=key,
                                           interpret=True)
        start = torch.tensor(np.asarray(
            jax.random.randint(key, (B,), 0, N, dtype=jnp.int32)))
    else:
        ref = jsamp.farthest_point_sample(jnp.asarray(x), npoint,
                                          deterministic=True)
        pal = farthest_point_sample_pallas(jnp.asarray(x), npoint,
                                           deterministic=True,
                                           interpret=True)
        start = None
    out = tsamp.farthest_point_sample(torch.from_numpy(x), npoint,
                                      start).numpy()
    np.testing.assert_array_equal(out, np.asarray(ref))
    np.testing.assert_array_equal(out, np.asarray(pal))


def test_gather_bit_exact_against_pallas():
    """Ragged row count and odd width, as the Pallas test uses."""
    rng = np.random.default_rng(1)
    B, N, C, R = 3, 256, 5, 600
    pts = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, R)).astype(np.int32)
    ref = gather_rows_pallas(jnp.asarray(pts), jnp.asarray(idx),
                             interpret=True)
    out = gather_rows(torch.from_numpy(pts), torch.from_numpy(idx).long())
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_gather_neighbors_keeps_index_shape_and_bf16_bits():
    """``[B, S, K]`` indices into a bf16 table give ``[B, S, K, C]``
    with the table's exact bits (what the bf16 encoder feeds it)."""
    rng = np.random.default_rng(2)
    B, N, S, K, C = 2, 64, 10, 7, 6
    tab = torch.from_numpy(rng.normal(size=(B, N, C)).astype(
        np.float32)).bfloat16()
    idx = torch.from_numpy(rng.integers(0, N, size=(B, S, K)))
    out = tsamp.gather_neighbors(tab, idx)
    assert out.shape == (B, S, K, C) and out.dtype == torch.bfloat16
    ref = jsamp.index_points(jnp.asarray(tab.float().numpy()),
                             jnp.asarray(idx.numpy()))
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref))


def test_square_distance_and_min_k():
    """Expanded-form distances within 1e-5 (f32 matmul rounding); the
    k smallest of tie-free rows select the same indices."""
    a, b = _cloud(3, 2, 40), _cloud(4, 2, 70)
    ref = jpair.square_distance(jnp.asarray(a), jnp.asarray(b),
                                precision=HIGHEST)
    out = tpair.square_distance(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    rv, ri = jpair.min_k(ref, 9)
    ov, oi = tpair.min_k(out, 9)
    np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(ov.numpy(), np.asarray(rv), atol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_ball_query_matches(fused):
    """Gaussian clouds have no distance ties, so both ball queries select
    exactly the same neighbours as the JAX package."""
    B, N, S = 2, 512, 64
    x = _cloud(5, B, N)
    new = x[:, :S] + 0.01 * _cloud(6, B, S)
    radii, ks = [0.2, 0.4, 0.8], [16, 32, 64]
    xj, nj = jnp.asarray(x), jnp.asarray(new)
    xt, nt = torch.from_numpy(x), torch.from_numpy(new)
    if fused:
        ref = jsamp.ball_query_nearest_shared(radii, ks, xj, nj)
        out = tsamp.ball_query_nearest_shared(radii, ks, xt, nt)
    else:
        ref = [jsamp.query_ball_point(r, k, xj, nj)
               for r, k in zip(radii, ks)]
        out = [tsamp.query_ball_point(r, k, xt, nt)
               for r, k in zip(radii, ks)]
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_three_nn_interpolate_matches():
    """Inverse-distance weights within f32 rounding: 1e-5 absolute on
    unit-scale features."""
    rng = np.random.default_rng(7)
    dst, src = _cloud(8, 2, 300), _cloud(9, 2, 50)
    feats = rng.normal(size=(2, 50, 16)).astype(np.float32)
    ref = jsamp.three_nn_interpolate(jnp.asarray(dst), jnp.asarray(src),
                                     jnp.asarray(feats), precision=HIGHEST)
    out = tsamp.three_nn_interpolate(torch.from_numpy(dst),
                                     torch.from_numpy(src),
                                     torch.from_numpy(feats))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_sample_and_group_all_matches():
    x = _cloud(10, 2, 32)
    feats = np.random.default_rng(11).normal(size=(2, 32, 4)).astype(
        np.float32)
    rx, rp = jsamp.sample_and_group_all(jnp.asarray(x), jnp.asarray(feats))
    ox, op = tsamp.sample_and_group_all(torch.from_numpy(x),
                                        torch.from_numpy(feats))
    np.testing.assert_array_equal(ox.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(op.numpy(), np.asarray(rp))
