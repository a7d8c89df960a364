# Frozen copy of prifit_torch/utils/guard.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""Numeric guards (the port's copy of ``prifit_tpu/utils/guard.py``).

Parity with the reference sanitizers: clamp the argument of ``exp`` to
[-13, 75], floor the argument of ``sqrt`` and clamp the argument of
``acos`` inside (-1, 1).
"""

import torch

EXP_LO = -13.0
EXP_HI = 75.0


def guard_exp(x: torch.Tensor, max_value: float = EXP_HI,
              min_value: float = EXP_LO) -> torch.Tensor:
    """exp with clamped argument."""
    return torch.exp(torch.clamp(x, min_value, max_value))


def guard_sqrt(x: torch.Tensor, minimum: float = 1e-5) -> torch.Tensor:
    """sqrt with floored argument."""
    return torch.sqrt(torch.clamp_min(x, minimum))


