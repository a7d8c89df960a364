"""The ``--stage_dtypes`` modes, each a B=2 supervised step of
``pointnet2_part_seg_msg`` against the JAX model's on the CPU: every
stage ``fq`` (bf16-rounded values, straight-through gradients, inside
each MLP chain), every stage ``q`` (f32 compute, each stage's output
rounded to bf16) and ``sa1:bf16,fp2:q``.  The setup and the rules are
``test_torch_dtypes.py``'s (:func:`mode_runs`, :func:`check_supervised`).

``q`` and ``fq`` compute in f32, but the f32 step's limits (each
gradient within 5e-2 of its norm) do not hold: a rounded output flips to
the next bf16 value where the two sides' f32 sums differ, and the batch
norms below amplify it, as in the bf16 modes (JAX's own gradients move by
0.12-0.34 of their norm under the 2^-20 input changes).  So the spread
rule holds them.
"""

import pytest

from test_torch_dtypes import check_supervised, jax_state, mode_runs

STAGES = ("sa1", "sa2", "sa3", "fp3", "fp2", "fp1")
MODES = {
    "fq": ",".join(f"{s}:fq" for s in STAGES),
    "q": ",".join(f"{s}:q" for s in STAGES),
    "sa1_bf16_fp2_q": "sa1:bf16,fp2:q",
}


@pytest.fixture(scope="module")
def runs():
    st = jax_state()
    return {name: mode_runs(st, dict(compute_dtype="f32", stage_dtypes=spec),
                            False)
            for name, spec in MODES.items()}


@pytest.mark.parametrize("mode", MODES)
def test_stage_dtypes_supervised_step_matches_jax(runs, mode):
    """One supervised step per spec.  The loss bound that held: 1e-4
    relative in all three (measured 6.3e-5 for ``fq``, 9.5e-6 for ``q``,
    2.3e-6 for ``sa1:bf16,fp2:q``); every gradient within 0.56 of its
    bound.  No K-max backward kernel and no rounding cast runs."""
    port, jax_runs = runs[mode]
    check_supervised(port, jax_runs, 0)
