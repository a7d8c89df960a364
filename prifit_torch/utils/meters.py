"""Training meters and small init and colour helpers.

Port of ``prifit_tpu/utils/meters.py`` (the non-viz half of the
reference's ``src/color_utils.py``): ``AverageValueMeter``, DCGAN-style
initializers (drawn from a ``torch.Generator`` where the JAX package takes
a key), the step learning-rate drop and the pastel colour generator, which
draws from a ``random.Random`` (or the ``random`` module) as the JAX
package's does, so one seed gives the same colours.
"""

import random

import torch


class AverageValueMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def conv_init(generator: torch.Generator, shape, dtype=torch.float32):
    """Convolution weights ~ N(0, 0.02) (the reference's ``weights_init``)."""
    return 0.02 * torch.randn(shape, generator=generator, dtype=dtype,
                              device=generator.device)


def scale_init(generator: torch.Generator, shape, dtype=torch.float32):
    """Batch-norm scale ~ N(1, 0.02)."""
    return 1.0 + conv_init(generator, shape, dtype)


def adjust_learning_rate(lr: float, epoch: int, phase: int) -> float:
    """Divide lr by 10 at the end of every ``phase`` epochs."""
    if epoch % phase == (phase - 1):
        return lr / 10.0
    return lr


def get_random_color(pastel_factor=0.5, rng=None):
    r = rng or random
    return [(x + pastel_factor) / (1.0 + pastel_factor)
            for x in [r.uniform(0, 1.0) for _ in range(3)]]


def color_distance(c1, c2):
    return sum(abs(x - y) for x, y in zip(c1, c2))


def generate_new_color(existing_colors, pastel_factor=0.5, rng=None):
    max_distance = None
    best_color = None
    for _ in range(100):
        color = get_random_color(pastel_factor, rng)
        if not existing_colors:
            return color
        best = min(color_distance(color, c) for c in existing_colors)
        if max_distance is None or best > max_distance:
            max_distance = best
            best_color = color
    return best_color


def get_colors(num_colors=10, rng=None):
    colors = []
    for _ in range(num_colors):
        colors.append(generate_new_color(colors, rng=rng))
    return colors
