# Frozen copy of prifit_torch/data/provider.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""Batch point-cloud augmentations (numpy, host-side).

The port's copy of ``prifit_tpu/data/provider.py``; the on-device
counterparts are in :mod:`prifit_torch.data.augment_torch`.

Reference-compatible port of ``provider.py`` with two deliberate changes:

- every random function takes an explicit ``rng: np.random.Generator``
  (the reference draws from the global ``np.random`` state; explicit
  generators are required for the per-host sharded input pipeline and for
  reproducibility — SURVEY.md §7 hard-part 5);
- the per-shape Python loops are vectorized with einsum/broadcasting
  (identical math, one kernel per batch).

Function names, argument names, defaults, and math match the reference
one-to-one (citations inline).  Unlike the reference, inputs are never
mutated in place.
"""

import numpy as np


def shift_point_cloud(batch_data, shift_range=0.1,
                      rng: np.random.Generator = None):
    """Per-shape uniform translation in [-range, range]^3 (``:278-290``)."""
    shifts = rng.uniform(-shift_range, shift_range,
                         (batch_data.shape[0], 3))
    return (batch_data + shifts[:, None, :]).astype(np.float32)


def random_scale_point_cloud(batch_data, scale_low=0.8, scale_high=1.25,
                             rng: np.random.Generator = None):
    """Per-shape isotropic scale (``:292-304``)."""
    scales = rng.uniform(scale_low, scale_high, batch_data.shape[0])
    return (batch_data * scales[:, None, None]).astype(np.float32)


