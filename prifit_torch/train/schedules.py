"""Epoch-level schedules (port of ``prifit_tpu/train/schedules.py``).

Plain floats computed on the host once per epoch and passed to the train
steps.
"""

# reference constants
MOMENTUM_ORIGINAL = 0.1
MOMENTUM_DECAY = 0.5


def lr_schedule(epoch: int, learning_rate: float, lr_decay: float = 0.5,
                step_size: int = 20, lr_clip: float = 1e-5) -> float:
    """``max(lr0 * decay^(epoch // step), clip)``."""
    return max(learning_rate * (lr_decay ** (epoch // step_size)), lr_clip)


def bn_momentum_schedule(epoch: int, step_size: int = 20,
                         floor: float = 0.01) -> float:
    """``max(0.1 * 0.5^(epoch // step), 0.01)``."""
    m = MOMENTUM_ORIGINAL * (MOMENTUM_DECAY ** (epoch // step_size))
    return max(m, floor)


def lambda_schedule(epoch: int, lmbda: float, anneal_lambda: bool = False,
                    anneal_rate: float = 0.5,
                    anneal_step: int = 5) -> float:
    """Self-sup weight, annealed by ``anneal_rate`` every ``anneal_step``
    epochs when ``anneal_lambda``."""
    if not anneal_lambda:
        return lmbda
    return lmbda * (anneal_rate ** (epoch // anneal_step))
