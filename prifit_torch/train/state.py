"""Train state and optimizers (port of ``prifit_tpu/train/state.py``).

The optimizers follow the JAX package's torch semantics:

  - Adam(wd): L2 added to the gradient BEFORE the Adam moments
    (``torch.optim.Adam(weight_decay=...)``, not AdamW's decoupled decay);
  - SGD(momentum=0.9): ``buf = 0.9 buf + g``, update ``-lr buf``.

The learning rate is not part of the optimizer's construction: each train
step sets it, as the JAX step takes it as an argument.
"""

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    """What a train step updates in place: the model (parameters and
    batch-norm and ``beta`` buffers), its optimizer, and the step count."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params, name: str = "Adam", decay_rate: float = 1e-4
                   ) -> torch.optim.Optimizer:
    """Adam with betas (0.9, 0.999), eps 1e-8 and coupled weight decay
    ``decay_rate``, or SGD with momentum 0.9 and no decay (reference
    ``train_partseg_shapenet.py:252-261``).  Its learning rate is 0 until
    a step sets one."""
    if name.lower() == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=decay_rate)
    if name.lower() == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=0.9)
    raise ValueError(f"unknown optimizer {name!r}")


def create_train_state(model: torch.nn.Module, optimizer: str = "Adam",
                       decay_rate: float = 1e-4) -> TrainState:
    """A :class:`TrainState` at step 0 for ``model`` with a fresh
    optimizer over its parameters."""
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(), optimizer,
                                               decay_rate))
