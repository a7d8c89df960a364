"""``--encoder_dtype sa_bf16`` (bf16 set-abstraction chains, f32 feature
propagation): a B=2 supervised step of ``pointnet2_part_seg_msg`` against
the JAX model's on the CPU, under ``test_torch_dtypes.py``'s setup and
rules (:func:`mode_runs`, :func:`check_supervised`)."""

from test_torch_dtypes import check_supervised, jax_state, mode_runs


def test_sa_bf16_supervised_step_matches_jax():
    """The loss bound that held: 1e-4 relative (measured 6.0e-5); every
    gradient within 0.59 of its bound.  No K-max backward kernel and no
    rounding cast runs."""
    port, jax_runs = mode_runs(jax_state(), dict(compute_dtype="sa_bf16"),
                               False)
    check_supervised(port, jax_runs, 0)
