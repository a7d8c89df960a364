"""Train steps: supervised NLL, the self-supervised convex loss and the
ACD contrastive loss.

Port of ``prifit_tpu/train/steps.py::make_supervised_step``,
``make_selfsup_step`` and ``make_contrastive_step``.  A step runs the
train-mode forward, the backward and one optimizer update eagerly.
Unlike the JAX steps, which return a new state, it updates the state's
model (parameters, batch-norm running statistics, the self-sup ``beta``
buffer) and optimizer IN PLACE and returns the same state with its step
count advanced.

Randomness (the FPS start, dropout, with ``mxsr`` stages the stochastic
rounding, and the self-sup losses' draws) comes from the ``generator``
argument; without one FPS starts at index 0, the convex loss takes its
deterministic fallbacks, and dropout, ``mxsr`` and the contrastive loss
need one.  An ``mxsr``
step draws one base key of two uint32 words from the generator and reads
it to the host, once per step (the model's forward does, see
:mod:`prifit_torch.models.pointnet2_part_seg_msg`); ``sr_key`` gives that
key instead, for runs that must draw the same bits.  The
forward and the update are profiler ranges of their own names (read by
:mod:`prifit_torch.profile_forward`, which finds the backward's kernels
between them).
"""

from typing import Callable

import torch
from torch.profiler import record_function

from prifit_torch.data.augment_torch import augment_and_resample, \
    standard_train_augment
from prifit_torch.train.state import TrainState


def _apply_gradients(state: TrainState, lr: float) -> None:
    """One optimizer update at learning rate ``lr``.  A parameter the loss
    does not reach gets a zero gradient first, so that Adam's coupled
    weight decay still moves it, as the JAX optimizer does."""
    opt = state.optimizer
    with record_function("optimizer_step"):
        for group in opt.param_groups:
            group["lr"] = lr
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()
    state.step += 1


def _augment_generator(generator):
    if generator is None:
        raise ValueError("fused_augment needs a generator for its draws")
    return generator


def make_supervised_step(model_loss: Callable,
                         fused_augment: bool = False) -> Callable:
    """``model_loss(seg_logits, target, trans_feat) -> scalar`` (the model
    module's ``get_loss``) -> ``step(state, points, cls_onehot, target,
    lr, bn_momentum, generator=None, sr_key=None) -> (state, {loss,
    acc})``, updating ``state`` in place.  With ``fused_augment`` the
    step first augments ``points`` on the device
    (:func:`~prifit_torch.data.augment_torch.standard_train_augment`,
    drawing from ``generator`` before the forward does)."""

    def step(state: TrainState, points, cls_onehot, target, lr: float,
             bn_momentum: float, generator: torch.Generator | None = None,
             sr_key=None):
        if fused_augment:
            points = standard_train_augment(
                points, generator=_augment_generator(generator))
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with record_function("train_forward"):
            out = model(points, cls_onehot, bn_momentum=bn_momentum,
                        generator=generator, sr_key=sr_key)
            loss = model_loss(out.seg_logits, target, out.trans_feat)
        loss.backward()
        _apply_gradients(state, lr)
        with torch.no_grad():
            acc = (out.seg_logits.argmax(-1) == target).float().mean()
        return state, {"loss": loss.detach(), "acc": acc}

    return step


def make_selfsup_step(*, fused_augment: bool = False,
                      **convex_kwargs) -> Callable:
    """``convex_kwargs``: the model's convex-loss arguments (quantile,
    msc_iterations, max_num_clusters, n_per_prim, include_entropy_loss,
    include_intersect_loss, include_pruning, if_cuboid, alpha, ...; also
    ``entropy_sub`` and ``jitter``, which fix the loss's draws) ->
    ``step(state, points, cls_onehot, chamfer_points, lr, bn_momentum,
    lmbda, generator=None, sr_key=None) -> (state, {ss_loss,
    chamfer_loss})`` with
    ``ss_loss = mean(total_loss) * lmbda``, updating ``state`` in
    place.  With ``fused_augment`` the step first augments
    ``chamfer_points`` on the device and resamples ``points`` from it
    (:func:`~prifit_torch.data.augment_torch.augment_and_resample`, at
    ``points``' point count and channels, drawing from ``generator``
    before the forward does); ``points`` is then only a placeholder."""
    kwargs = {"include_convex_loss": True, **convex_kwargs}

    def step(state: TrainState, points, cls_onehot, chamfer_points,
             lr: float, bn_momentum: float, lmbda: float,
             generator: torch.Generator | None = None, sr_key=None):
        if fused_augment:
            chamfer_points, points = augment_and_resample(
                chamfer_points, points.shape[1], points.shape[-1],
                generator=_augment_generator(generator))
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with record_function("train_forward"):
            out = model(points, cls_onehot, chamfer_points=chamfer_points,
                        bn_momentum=bn_momentum, generator=generator,
                        sr_key=sr_key, **kwargs)
            ss_loss = torch.mean(out.total_loss) * lmbda
        ss_loss.backward()
        _apply_gradients(state, lr)
        return state, {"ss_loss": ss_loss.detach(),
                       "chamfer_loss": out.chamfer_loss.detach()}

    return step


def make_contrastive_step(selfsup_loss_fn: Callable,
                          margin: float = 0.5) -> Callable:
    """``selfsup_loss_fn(feat, target, generator, margin, uniforms=...)``
    (the model module's ``get_selfsup_loss``) -> ``step(state, points,
    cls_onehot, target, lr, bn_momentum, lmbda, generator=None,
    sr_key=None, uniforms=None) -> (state, {ss_loss})`` with ``ss_loss =
    loss(feat) * lmbda`` on the pre-head feature ``feat``, updating
    ``state`` in place.  ``target`` holds the ACD component labels;
    ``uniforms`` fixes the negatives' draw, else it comes from
    ``generator`` after the forward's."""

    def step(state: TrainState, points, cls_onehot, target, lr: float,
             bn_momentum: float, lmbda: float,
             generator: torch.Generator | None = None, sr_key=None,
             uniforms=None):
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with record_function("train_forward"):
            out = model(points, cls_onehot, bn_momentum=bn_momentum,
                        generator=generator, sr_key=sr_key)
            loss = selfsup_loss_fn(out.feat, target, generator, margin,
                                   uniforms=uniforms) * lmbda
        loss.backward()
        _apply_gradients(state, lr)
        return state, {"ss_loss": loss.detach()}

    return step
