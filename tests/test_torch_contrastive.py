"""The ACD pairwise contrastive loss and the contrastive train step of the
port against the JAX package on the CPU.

The negatives' subsample is drawn from a JAX key on the JAX side; the
port takes the same uniforms (``jax.random.uniform(key, [B, N, N])``,
the draw ``pairwise_contrastive_loss`` makes) through ``uniforms``.  The
step is held with the tolerances of ``tests/test_torch_train.py``: the
loss within 1e-5 relative, every gradient within ``JAX_RTOL`` of JAX's and
``F64_RTOL`` of the float64 port step's, relative to its norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.convert import params_from_jax
from prifit_torch.entry import acd_labels
from prifit_torch.models import pairwise_contrastive_loss
from prifit_torch.models.pointnet2_part_seg_msg import get_selfsup_loss
from prifit_torch.train.steps import make_contrastive_step
from prifit_tpu.models import get_module
from prifit_tpu.models.common import pairwise_contrastive_loss as j_loss
from test_torch_train import (B, BN_MOMENTUM, F64_RTOL, JAX_RTOL, LMBDA, LR,
                              N, PARTS, _assert_grads_match, _f64_grads,
                              _grads, _port_state, jax_variables)

torch.set_num_threads(1)

MARGIN = 0.5


def _feat_labels(kind, n=160, c=32):
    """Features ``[2, n, c]`` near their label's direction, and labels:
    ``"parts"`` 6 components; ``"unknown"`` also labels 64 and 70 (beyond
    the one-hot's 64 classes) and -1, which pair with no point."""
    rng = np.random.default_rng(3)
    lab = rng.integers(0, 6, size=(2, n))
    if kind == "unknown":
        lab[:, :30] = rng.choice([-1, 64, 70], size=(2, 30))
    dirs = rng.normal(size=(2, 71, c))
    feat = np.take_along_axis(dirs, (lab % 71)[..., None], 1) \
        + 0.8 * rng.normal(size=(2, n, c))
    return feat.astype(np.float32), lab


@pytest.mark.parametrize("kind", ["parts", "unknown"])
def test_pairwise_contrastive_loss_matches_jax(kind):
    """With JAX's uniforms passed in: the loss within 1e-5 relative and
    its gradient in the features within 1e-5 of the largest entry; a
    label outside ``[0, 64)`` has a zero one-hot row in JAX, and the
    port's point with such a label pairs with nobody (itself included),
    which the equal loss shows."""
    feat, lab = _feat_labels(kind)
    key = jax.random.PRNGKey(9)
    jval, jg = jax.value_and_grad(j_loss)(jnp.asarray(feat),
                                          jnp.asarray(lab), key, MARGIN)
    if kind == "unknown":
        assert not np.asarray(jax.nn.one_hot(jnp.asarray([64, -1]), 64)
                              ).any()
    u = torch.from_numpy(np.array(jax.random.uniform(
        key, lab.shape + lab.shape[1:])))
    ft = torch.from_numpy(feat).requires_grad_()
    val = pairwise_contrastive_loss(ft, torch.from_numpy(lab),
                                    margin=MARGIN, uniforms=u)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    ref = np.asarray(jg)
    np.testing.assert_allclose(ft.grad.numpy(), ref,
                               atol=1e-5 * np.abs(ref).max())


def test_contrastive_loss_draws_from_the_generator():
    """Without uniforms the loss draws ``U[0, 1)`` of ``[B, N, N]`` from
    the generator; with neither it raises."""
    feat, lab = _feat_labels("parts")
    ft, lt = torch.from_numpy(feat), torch.from_numpy(lab)
    got = get_selfsup_loss(ft, lt, torch.Generator().manual_seed(4), MARGIN)
    u = torch.rand((2, 160, 160), generator=torch.Generator().manual_seed(4))
    assert got.item() == get_selfsup_loss(ft, lt, None, MARGIN,
                                          uniforms=u).item()
    with pytest.raises(ValueError, match="generator"):
        pairwise_contrastive_loss(ft, lt)


@pytest.fixture(scope="module")
def step_runs():
    """One contrastive step on each side from the same weights (dropout
    0, FPS from index 0) on a gaussian cloud with ACD-like labels
    (``entry.acd_labels``): the
    JAX ``compute`` of ``make_contrastive_step`` with a fixed loss key, and
    the port's step with that key's uniforms."""
    rng = np.random.default_rng(41)
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    cls = np.zeros((B, 16), np.float32)
    cls[:, 7] = 1.0
    lab = acd_labels(torch.from_numpy(x)).numpy()
    model = get_module("pointnet2_part_seg_msg").get_model(
        num_parts=PARTS, compute_dtype="f32", dropout_rate=0.0)
    loss_key = jax.random.PRNGKey(8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRIFIT_DET_FPS", "1")
        variables = jax_variables(model, rng, x, cls)
        xj, cj, tj = jnp.asarray(x), jnp.asarray(cls), jnp.asarray(lab)

        def compute(params):
            out, upd = model.apply(
                {"params": params,
                 "batch_stats": variables["batch_stats"]}, xj, cj,
                train=True, bn_momentum=BN_MOMENTUM,
                rngs={"sampling": jax.random.PRNGKey(4),
                      "dropout": jax.random.PRNGKey(5)},
                mutable=["batch_stats"])
            loss = get_module("pointnet2_part_seg_msg").get_selfsup_loss(
                out.feat, tj, loss_key, MARGIN) * LMBDA
            return loss, upd

        (jl, _), jg = jax.jit(jax.value_and_grad(compute, has_aux=True))(
            variables["params"])
    u = torch.from_numpy(np.array(jax.random.uniform(loss_key, (B, N, N))))
    state = _port_state(variables)
    step = make_contrastive_step(get_selfsup_loss, margin=MARGIN)
    tensors = (torch.from_numpy(x), torch.from_numpy(cls),
               torch.from_numpy(lab))
    state, metrics = step(state, *tensors, LR, BN_MOMENTUM, LMBDA,
                          uniforms=u)
    f64 = _f64_grads(variables, lambda s, *a: step(s, *a, uniforms=u),
                     tensors, (LR, BN_MOMENTUM, LMBDA))
    return dict(jl=float(jl), jg=params_from_jax(jg), lab=lab,
                loss=metrics["ss_loss"].item(), grads=_grads(state.model),
                f64=f64, steps=state.step)


def test_contrastive_step_matches_jax(step_runs):
    """The loss within 1e-5 relative; every gradient within ``JAX_RTOL``
    of JAX's and ``F64_RTOL`` of the float64 step's; the loss does not
    reach the heads after ``feat`` (``conv2``, ``extra_conv_emb``), whose
    gradients are 0 on both sides; the step count advanced."""
    r = step_runs
    assert len(np.unique(r["lab"])) == 10
    np.testing.assert_allclose(r["loss"], r["jl"], rtol=1e-5)
    _assert_grads_match(r["grads"], r["jg"], JAX_RTOL)
    _assert_grads_match(r["grads"], r["f64"], F64_RTOL)
    for name in ("conv2.weight", "extra_conv_emb.weight"):
        assert not r["grads"][name].any() and not r["jg"][name].any()
    assert r["steps"] == 1
