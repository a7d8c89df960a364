"""Training: schedules, train state and optimizers, and the supervised,
self-sup and contrastive train steps (port of ``prifit_tpu/train``)."""

from prifit_torch.train.checkpoint import restore_checkpoint, \
    save_checkpoint
from prifit_torch.train.schedules import (
    bn_momentum_schedule,
    lambda_schedule,
    lr_schedule,
)
from prifit_torch.train.state import TrainState, create_train_state, \
    make_optimizer
from prifit_torch.train.steps import make_contrastive_step, \
    make_selfsup_step, make_supervised_step

__all__ = ["TrainState", "bn_momentum_schedule", "create_train_state",
           "lambda_schedule", "lr_schedule", "make_contrastive_step",
           "make_optimizer", "make_selfsup_step", "make_supervised_step",
           "restore_checkpoint", "save_checkpoint"]
