"""Random-augmentation combinator (rebuilds ``src/augment_utils.py``).

The port's copy of ``prifit_tpu/data/augment.py``.

The reference keeps an older duplicate of the provider functions plus an
``Augment`` class that applies each of {small perturbation rotation,
jitter, shift(0.05), scale(0.8-1.2)} with probability 0.3
(``src/augment_utils.py:114-127``; its duplicated augmentation functions
are NOT reproduced — the combinator composes the canonical
``prifit_torch.data.provider`` functions with the reference's parameters).
"""

import numpy as np

from prifit_torch.data import provider


class Augment:
    """Apply each configured augmentation with probability ``p``.

    Defaults reproduce the reference class exactly: perturbation rotation
    (sigma 0.06, clip 0.30 — augment_utils.py:47), jitter (0.01/0.05),
    shift range 0.05, isotropic scale 0.8-1.2, each with p = 0.3.
    """

    def __init__(self, p: float = 0.3, rotation: bool = True,
                 scale: bool = True, shift: bool = True,
                 jitter: bool = True, dropout: bool = False,
                 anisotropic: bool = False,
                 rng: np.random.Generator | None = None):
        self.p = p
        self.rng = rng if rng is not None else np.random.default_rng()
        self.ops = []
        if rotation:
            self.ops.append(
                lambda x: provider.rotate_perturbation_point_cloud(
                    x, angle_sigma=0.06, angle_clip=0.30, rng=self.rng))
        if jitter:
            self.ops.append(lambda x: provider.jitter_point_cloud(
                x, rng=self.rng))
        if shift:
            self.ops.append(lambda x: provider.shift_point_cloud(
                x, shift_range=0.05, rng=self.rng))
        if scale:
            self.ops.append(lambda x: provider.random_scale_point_cloud(
                x, scale_low=0.8, scale_high=1.2, rng=self.rng))
        if anisotropic:
            self.ops.append(
                lambda x: provider.random_anisotropic_scale_point_cloud(
                    x, rng=self.rng))
        if dropout:
            self.ops.append(lambda x: provider.random_point_dropout(
                x, rng=self.rng))

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        out = batch
        for op in self.ops:
            if self.rng.random() < self.p:
                out = op(out)
        return out
