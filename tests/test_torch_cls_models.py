"""The port's ModelNet40 classifiers (``pointnet_cls``,
``pointnet2_cls_ssg``, ``pointnet2_cls_msg``) against the JAX package on
the CPU, each with normals and without.

JAX variables (init, batch-norm statistics randomized; for
``pointnet_cls`` each transformer's last dense drawn small) reach
the port through ``prifit_torch.convert`` (``strict=True``).  FPS starts
at index 0 on both sides (``PRIFIT_DET_FPS=1``), the JAX models' fixed
dropout is patched out and the port's set to 0, all f32.  B=8, N=1024:
the head's batch norms after the global max have B rows, chaotic at B=2
(``test_torch_pointnet.py``).  Tolerances:

- eval-mode log-probabilities within 1e-5 of their largest entry;
- train-mode log-probabilities within 2e-4 of their largest entry, the
  running statistics after that forward within 5e-5 of theirs, the ``get_loss``
  value (NLL, plus 0.001 times the regularizer for ``pointnet_cls``)
  within 5e-5 relative, and every gradient within 5e-2 of its norm, the
  step tests' bound (``test_torch_train.py``).  These limits are JAX's
  error, not the port's: the head's ``bn1`` normalizes 8 rows of pooled
  features, the MSG and SSG layers' batch norms many rows whose mean is
  large against their spread, and JAX's f32 ``E[x^2] - E[x]^2`` and
  batch-norm backward round more coarsely.  Against the same model run
  in float64, JAX's train-mode log-probs are up to 1e-4 of the largest
  entry off (the port's 6e-6), its running statistics 1.4e-5 of theirs
  (the port's 1e-5), its loss 1.4e-5 relative (the port's 2e-7), its
  gradients up to 3.6e-2 of their norm (the port's 2.3e-3).
  Biases whose gradient is analytically 0 are left out
  (``_zero_grad_bias``).

The clouds are gaussian, scaled into the unit sphere like the loader's:
unscaled (radius about 4), JAX's error against float64 grew to 1e-3 of
the logits and 5.9e-2 of the gradients, the port's stayed at 2e-5.

At JAX's exact init ``pointnet_cls``'s transforms are the identity and
the regularizer's JAX gradient is NaN (the norm of a zero matrix);
torch's is 0 (``ROADMAP.md`` §3), checked on its own.
"""

import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.cli import train_partseg as T
from prifit_torch.cli.args_parser import parse_args
from prifit_torch.convert import params_from_jax, state_dict_from_jax
from prifit_torch.models import get_module
from prifit_tpu.cli import train_partseg as JT
from prifit_tpu.models import get_module as jget_module
from test_torch_partseg_ssg import NoDropout, randomize_stats

torch.set_num_threads(1)

B, N, K = 8, 1024, 40
TOL = 1e-5
GRAD_RTOL = 5e-2
TRAIN_TOL = 2e-4
LOSS_RTOL = 5e-5
STATS_TOL = 5e-5
BN_MOMENTUM = 0.1
NAMES = ("pointnet_cls", "pointnet2_cls_ssg", "pointnet2_cls_msg")
CASES = [(name, normal) for name in NAMES for normal in (True, False)]
RNGS = {"sampling": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(5)}


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _kwargs(name, normal):
    if name == "pointnet_cls":
        return dict(k=K, normal_channel=normal)
    return dict(num_class=K, normal_channel=normal)


def _cloud(rng, normal, b=B):
    """Gaussian clouds scaled into the unit sphere, as the ModelNet40
    loader's are, with unit normals."""
    x = rng.normal(size=(b, N, 6 if normal else 3)).astype(np.float32)
    x[..., :3] /= np.linalg.norm(x[..., :3], axis=-1).max(-1)[:, None, None]
    if normal:
        x[..., 3:] /= np.linalg.norm(x[..., 3:], axis=-1, keepdims=True)
    return x


def _perturb_transforms(params, rng):
    """Each transformer's last dense (0 at JAX's init, where the
    regularizer's JAX gradient is NaN and the transformer's layers get
    none) drawn small."""
    for stn in ("STN_0", "STN_1"):
        for a in params["feat"][stn]["Dense_5"].values():
            a += rng.normal(size=a.shape).astype(np.float32) * 0.01


def _port(name, normal, variables):
    model = get_module(name).get_model(**_kwargs(name, normal),
                                       device="cpu")
    if name == "pointnet_cls":
        model.dropout_rate = 0.0
    else:
        model.dropout_rates = (0.0, 0.0)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{n}-{'normals' if c else 'xyz'}" for n, c in CASES])
def run(request):
    """A classifier's JAX variables and cloud, its eval log-probs, and its
    jitted train-mode loss, log-probs, statistics and gradients."""
    name, normal = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRIFIT_DET_FPS", "1")
        mp.setattr(fnn, "Dropout", NoDropout)
        rng = np.random.default_rng(NAMES.index(name) * 2 + normal)
        x = _cloud(rng, normal)
        target = rng.integers(0, K, size=B)
        mod = jget_module(name)
        jmod = mod.get_model(**_kwargs(name, normal))
        v = jax.jit(lambda r: jmod.init(r, jnp.asarray(x), train=False))(
            {"params": jax.random.PRNGKey(0),
             "sampling": jax.random.PRNGKey(1),
             "dropout": jax.random.PRNGKey(2)})
        params = jax.tree_util.tree_map(np.array, v["params"])
        if name == "pointnet_cls":
            _perturb_transforms(params, rng)
        v = {"params": params,
             "batch_stats": randomize_stats(v["batch_stats"], rng)}
        # jitted: op by op, the MSG classifier's eval forward takes 10-15 s
        eval_logp, eval_aux = jax.jit(
            lambda v, x: jmod.apply(v, x, train=False))(v, jnp.asarray(x))

        def loss(p):
            (logp, aux), upd = jmod.apply(
                {"params": p, "batch_stats": v["batch_stats"]},
                jnp.asarray(x), train=True, bn_momentum=BN_MOMENTUM,
                rngs=RNGS, mutable=["batch_stats"])
            return mod.get_loss(logp, jnp.asarray(target), aux), (
                logp, upd["batch_stats"])

        (lv, (logp, stats)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(v["params"])
    return dict(name=name, normal=normal, x=x, target=target, v=v,
                eval_logp=eval_logp, eval_aux=eval_aux, loss=float(lv),
                logp=logp, stats=stats, grads=params_from_jax(grads))


def test_eval_forward_matches_jax(run):
    d = run
    model = _port(d["name"], d["normal"], d["v"]).eval()
    with torch.no_grad():
        logp, aux = model(torch.from_numpy(d["x"]))
    assert logp.shape == (B, K)
    _close(logp, d["eval_logp"])
    _close(aux, d["eval_aux"])


def _zero_grad_bias(name):
    """A bias whose gradient is analytically 0 (rounding noise on both
    sides): a dense bias a batch norm follows (the SA layers', the
    transformers' and encoder's, ``fc1``/``fc2``), and the bias of a
    batch norm before a max over the points or neighbours, whose shift
    the next batch norm removes (an SA layer's last; the relu between
    passes every row's max, which is positive)."""
    return re.search(r"(conv\d|conv_blocks\.\d+\.\d+|mlp_convs\.\d+|fc[12]"
                     r"|mlp_bns\.2|bn_blocks\.\d+\.2|bn3)\.bias$",
                     name) is not None


def test_train_forward_and_gradients_match_jax(run):
    d = run
    model = _port(d["name"], d["normal"], d["v"]).train()
    logp, aux = model(torch.from_numpy(d["x"]), bn_momentum=BN_MOMENTUM)
    _close(logp, d["logp"], TRAIN_TOL)
    want = state_dict_from_jax({"params": d["v"]["params"],
                                "batch_stats": d["stats"]})
    for name, t in model.named_buffers():
        _close(t, want[name], STATS_TOL)
    loss = get_module(d["name"]).get_loss(
        logp, torch.from_numpy(d["target"]), aux)
    loss.backward()
    np.testing.assert_allclose(loss.item(), d["loss"], rtol=LOSS_RTOL)
    checked = 0
    for name, p in model.named_parameters():
        if _zero_grad_bias(name):
            continue
        r = d["grads"][name]
        err = float((p.grad - r).norm() / r.norm())
        assert err <= GRAD_RTOL, f"{name}: relative gradient error {err}"
        checked += 1
    assert checked > 10


def test_pointnet_cls_at_identity_transform():
    """From JAX's exact init both transforms are the identity: JAX's
    regularizer gradient is NaN and reaches every layer up to the feature
    transform; the port's step stays finite."""
    rng = np.random.default_rng(9)
    x, target = _cloud(rng, True), rng.integers(0, K, size=B)
    mod = jget_module("pointnet_cls")
    jmod = mod.get_model(k=K)
    v = jax.jit(lambda r: jmod.init(r, jnp.asarray(x), train=False))(
        jax.random.PRNGKey(0))

    def loss(p):
        (logp, aux), _ = jmod.apply(
            {"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
            train=True, rngs=RNGS, mutable=["batch_stats"])
        return mod.get_loss(logp, jnp.asarray(target), aux)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn, "Dropout", NoDropout)
        grads = jax.jit(jax.grad(loss))(v["params"])
    assert np.isnan(np.asarray(grads["feat"]["Dense_0"]["kernel"])).all()
    model = _port("pointnet_cls", True, v).train()
    logp, aux = model(torch.from_numpy(x))
    get_module("pointnet_cls").get_loss(logp, torch.from_numpy(target),
                                        aux).backward()
    for name, p in model.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), name


def test_dropout_draws_from_the_generator():
    """Training at the JAX models' dropout rates draws the masks (and
    the SA layers' FPS starts) from the generator: the same seed gives
    the same log-probs, and no generator raises."""
    x = torch.from_numpy(_cloud(np.random.default_rng(3), True, 2))
    for name in NAMES:
        model = get_module(name).get_model(**_kwargs(name, True),
                                           device="cpu").train()
        a, _ = model(x, generator=torch.Generator().manual_seed(1))
        b, _ = model(x, generator=torch.Generator().manual_seed(1))
        assert torch.equal(a, b), name
        with pytest.raises(ValueError, match="generator"):
            model(x)


@pytest.mark.parametrize("name", NAMES + ("pointnet_sem_seg",
                                          "pointnet2_sem_seg"))
def test_trainer_refuses_like_jax(name):
    """The JAX trainer's ``build_model`` hands these models part-seg
    arguments and fails with a ``TypeError``; the port's trainer refuses
    them with one that says it builds part-seg models."""
    args = parse_args(["--model", name])
    with pytest.raises(TypeError):
        JT.build_model(args, jget_module(name))
    with pytest.raises(TypeError, match="part-seg models"):
        T.check_supported(args)
