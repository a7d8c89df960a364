"""The port's PointNet blocks and ``pointnet_part_seg`` against the JAX
package on the CPU.

Weights come from the JAX modules' init, with every batch norm's
statistics randomized, and reach the port through
``prifit_torch.convert`` (``strict=True`` for the whole model).
Tolerances: the transformers and the encoder (global, per point, with
the feature transform) within 1e-5 of their largest entry in eval mode
and in train mode (outputs and running statistics), the model's eval
logits, ``trans_feat``, ``feat`` and ``hidden`` within 1e-5;
``feature_transform_regularizer`` and its gradient within 1e-5; a fresh
model's transforms exactly the identity; and one B=2 supervised step
from JAX's init, the loss (NLL plus 0.001 times the regularizer) within
1e-5 relative and every gradient within 5e-2 of its norm (the step
tests' bound, ``test_torch_train.py``).

Where a test needs every layer to matter it gives the transformers' last
dense, which JAX starts at zero, small random values.  Two traps of
train mode: a transformer's batch norms after the max over the points
have one row per cloud, and at B=2 a feature whose two rows nearly agree
normalizes to ``d / sqrt(d^2 + eps)`` with ``d`` all rounding (the
cancelling ``E[x^2] - E[x]^2``), which moves such a transformer's output
by ~1e-3 on either side and off float64.  So the train-mode blocks are
held at B=8, and the step at B=2 starts from JAX's init, where the last
dense is 0 and the transforms are the identity whatever those features
are.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.convert import (
    _convert,
    _stn_entries,
    params_from_jax,
    state_dict_from_jax,
)
from prifit_torch.entry import init_weights
from prifit_torch.models import pointnet_part_seg as tps
from prifit_torch.nn import pointnet as tpn
from prifit_torch.train.state import create_train_state
from prifit_torch.train.steps import make_supervised_step
from prifit_tpu.models import pointnet_part_seg as jps
from prifit_tpu.nn import pointnet as jpn

torch.set_num_threads(1)

B, N, PARTS = 2, 128, 50
TOL = 1e-5
GRAD_RTOL = 5e-2
LR, BN_MOMENTUM = 1e-3, 0.1


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def randomize(variables, rng):
    """JAX variables with batch-norm statistics drawn from ``rng`` and
    every spatial transformer's last dense (zero at init) drawn small."""
    def stat(path, a):
        if str(path[-1].key) == "mean":
            return rng.normal(size=a.shape).astype(np.float32) * 0.1
        return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)

    def param(path, a):
        a = np.array(a)
        if str(path[-2].key) == "Dense_5" and str(path[-1].key) == "kernel":
            a += rng.normal(size=a.shape).astype(np.float32) * 0.01
        return a

    return {"params": jax.tree_util.tree_map_with_path(param,
                                                       variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                stat, variables["batch_stats"])}


def _load(module, variables, rows, prefix=""):
    sd = _convert(variables["params"], variables["batch_stats"], rows)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                           strict=True)
    return module


def _cloud(seed, c=3, b=B):
    return np.random.default_rng(seed).normal(size=(b, N, c)).astype(
        np.float32)


def _running(module):
    return {k: v for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("k,channel", [(3, 6), (64, 64)])
@pytest.mark.parametrize("train", [False, True])
def test_stn_matches_jax(k, channel, train):
    x = _cloud(1, channel, 8 if train else B)
    jmod = jpn.STN(k)
    v = randomize(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), False),
                  np.random.default_rng(2))
    want, upd = jmod.apply(v, jnp.asarray(x), train, 0.1,
                           mutable=["batch_stats"])
    stn = _load(tpn.STN(k, channel), {"params": {"stn": v["params"]},
                                      "batch_stats": {"stn":
                                                      v["batch_stats"]}},
                _stn_entries("stn"), "stn.").train(train)
    _close(stn(torch.from_numpy(x), 0.1), want)
    sd = _convert({"stn": v["params"]}, {"stn": upd["batch_stats"]},
                  _stn_entries("stn"))
    for name, t in _running(stn).items():
        _close(t, sd["stn." + name].numpy())


def _encoder_rows(feature_transform):
    rows = [(f"conv{j + 1}", None, "dense", (f"Dense_{j}",), None)
            for j in range(3)]
    rows += [(f"bn{j + 1}", None, "bn", (f"BatchNorm_{j}",), None)
             for j in range(3)]
    rows += [(*r[:3], ("STN_0",) + r[3][1:], r[4])
             for r in _stn_entries("stn")]
    if feature_transform:
        rows += [(*r[:3], ("STN_1",) + r[3][1:], r[4])
                 for r in _stn_entries("fstn")]
    return rows


@pytest.mark.parametrize("global_feat,feature_transform",
                         [(True, False), (False, False), (False, True)])
@pytest.mark.parametrize("train", [False, True])
def test_pointnet_encoder_matches_jax(global_feat, feature_transform, train):
    x = _cloud(3, 6, 8 if train else B)
    jmod = jpn.PointNetEncoder(global_feat, feature_transform)
    v = randomize(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), False),
                  np.random.default_rng(4))
    (feats, trans, trans_feat), _ = jmod.apply(
        v, jnp.asarray(x), train, mutable=["batch_stats"])
    enc = _load(tpn.PointNetEncoder(global_feat, feature_transform, 6), v,
                _encoder_rows(feature_transform)).train(train)
    got = enc(torch.from_numpy(x))
    assert got[0].shape == ((len(x), 1024) if global_feat
                            else (len(x), N, 1088))
    _close(got[0], feats)
    _close(got[1], trans)
    if feature_transform:
        _close(got[2], trans_feat)
    else:
        assert got[2] is None and trans_feat is None


def test_feature_transform_regularizer_matches_jax():
    t = (np.eye(64) + np.random.default_rng(5).normal(size=(B, 64, 64))
         * 0.1).astype(np.float32)
    want, grad = jax.value_and_grad(jpn.feature_transform_regularizer)(
        jnp.asarray(t))
    tt = torch.from_numpy(t).requires_grad_()
    got = tpn.feature_transform_regularizer(tt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)
    _close(tt.grad, grad)
    eye = torch.eye(3).expand(B, 3, 3)
    assert tpn.feature_transform_regularizer(eye).item() == 0.0


def test_fresh_model_starts_at_identity():
    """``init_weights`` zeroes each transformer's last dense, as the JAX
    initializer does, so a fresh model's transforms are the identity."""
    model = tps.get_model(PARTS, normal_channel=False, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    out = model.eval()(torch.from_numpy(_cloud(6)), torch.zeros(B, 16))
    assert torch.equal(out.trans_feat, torch.eye(128).expand(B, 128, 128))
    assert torch.equal(model.stn(torch.from_numpy(_cloud(6))),
                       torch.eye(3).expand(B, 3, 3))
    assert not model.fstn.fc3.weight.any() and model.conv2.weight.any()


@pytest.fixture(scope="module")
def part_seg():
    """JAX ``pointnet_part_seg`` variables (normals in, randomized), a
    batch, and JAX's jitted train-mode loss and gradients."""
    rng = np.random.default_rng(7)
    x = _cloud(8, 6)
    x[..., 3:] /= np.linalg.norm(x[..., 3:], axis=-1, keepdims=True)
    cls = np.zeros((B, 16), np.float32)
    cls[:, 4] = 1.0
    target = rng.integers(0, PARTS, size=(B, N))
    jmod = jps.get_model(PARTS, normal_channel=True)
    v = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(cls),
                  train=False)
    v_eval = randomize(v, rng)
    # train mode from JAX's init (the transformers' last dense at 0), with
    # that dense's bias drawn small: at the identity the regularizer's
    # norm is of a zero matrix, whose JAX gradient is NaN
    # (test_part_seg_step_at_identity)
    params = jax.tree_util.tree_map(np.array, v["params"])
    for t in ("stn", "fstn"):
        b = params[t]["Dense_5"]["bias"]
        b += rng.normal(size=b.shape).astype(np.float32) * 0.01
    v = {"params": params, "batch_stats": v_eval["batch_stats"]}

    def loss(params):
        out, upd = jmod.apply({"params": params,
                               "batch_stats": v["batch_stats"]},
                              jnp.asarray(x), jnp.asarray(cls), train=True,
                              bn_momentum=BN_MOMENTUM,
                              mutable=["batch_stats"])
        return jps.get_loss(out.seg_logits, jnp.asarray(target),
                            out.trans_feat), (upd["batch_stats"], out)

    (lv, (stats, out)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"])
    return dict(x=x, cls=cls, target=target, jmod=jmod, v=v, v_eval=v_eval,
                loss=float(lv), stats=stats, out=out,
                grads=params_from_jax(grads))


def _port(v):
    model = tps.get_model(PARTS, normal_channel=True, device="cpu")
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    return model


def test_part_seg_forward_matches_jax(part_seg):
    """The eval and train forwards: logits (the 4944-channel head),
    ``trans_feat``, ``feat`` and the 2064-d ``hidden``, and the loss with
    the regularizer."""
    d = part_seg
    x, cls = torch.from_numpy(d["x"]), torch.from_numpy(d["cls"])
    want = d["jmod"].apply(d["v_eval"], jnp.asarray(d["x"]),
                           jnp.asarray(d["cls"]), train=False)
    with torch.no_grad():
        got = _port(d["v_eval"]).eval()(x, cls)
        for a, b in ((got.seg_logits, want.seg_logits),
                     (got.trans_feat, want.trans_feat),
                     (got.feat, want.feat), (got.hidden, want.hidden)):
            _close(a, b)
        got = _port(d["v"]).train()(x, cls, bn_momentum=BN_MOMENTUM)
        _close(got.seg_logits, d["out"].seg_logits)
        _close(got.trans_feat, d["out"].trans_feat)
        loss = tps.get_loss(got.seg_logits, torch.from_numpy(d["target"]),
                            got.trans_feat)
    np.testing.assert_allclose(loss.item(), d["loss"], rtol=TOL)
    assert got.total_loss.item() == 0.0


def _zero_grad_bias(name):
    """A bias whose gradient is analytically zero, rounding noise on both
    sides: a dense bias a batch norm follows, and ``bn5``'s, whose shift
    reaches the head as the same constant on every row that ``bns1``
    normalizes (through ``out5`` and its max)."""
    return name == "bn5.bias" or re.fullmatch(
        r"((f?stn)\.)?(conv\w+|fc[12])\.bias", name) is not None \
        and not name.startswith("convs4")


def test_part_seg_supervised_step_matches_jax(part_seg):
    d = part_seg
    state = create_train_state(_port(d["v"]))
    _, m = make_supervised_step(tps.get_loss)(
        state, torch.from_numpy(d["x"]), torch.from_numpy(d["cls"]),
        torch.from_numpy(d["target"]), LR, BN_MOMENTUM)
    np.testing.assert_allclose(m["loss"].item(), d["loss"], rtol=TOL)
    for name, p in state.model.named_parameters():
        if _zero_grad_bias(name):
            continue
        r = d["grads"][name]
        if not bool(r.any()):
            # behind a transformer's last dense, which is 0
            assert not bool(p.grad.any()), name
            continue
        err = float((p.grad - r).norm() / r.norm())
        assert err <= GRAD_RTOL, f"{name}: relative gradient error {err}"
    sd = state_dict_from_jax({"params": d["v"]["params"],
                              "batch_stats": d["stats"]})
    for name, t in _running(state.model).items():
        # a transformer's bn5 takes its statistics from fc2 of bn4's
        # B=2-row normalized features (the module docstring's trap);
        # test_stn_matches_jax holds them at B=8
        if not name.startswith(("stn.bn5.", "fstn.bn5.")):
            _close(t, sd[name].numpy())


def test_part_seg_step_at_identity(part_seg):
    """At JAX's exact init both transforms are the identity and the
    regularizer is the norm of a zero matrix: JAX's gradient of it is NaN
    (``sqrt`` at 0), which reaches every layer up to the feature
    transform; torch's is 0, and the port's step stays finite."""
    d = part_seg
    v = jax.tree_util.tree_map(np.array, d["v"])
    for t in ("stn", "fstn"):
        v["params"][t]["Dense_5"]["bias"][:] = 0.0
    x, cls = jnp.asarray(d["x"]), jnp.asarray(d["cls"])

    def loss(params):
        out, _ = d["jmod"].apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x, cls,
            train=True, mutable=["batch_stats"])
        return jps.get_loss(out.seg_logits, jnp.asarray(d["target"]),
                            out.trans_feat)

    grads = jax.jit(jax.grad(loss))(v["params"])
    assert np.isnan(np.asarray(grads["conv1"]["kernel"])).all()
    state = create_train_state(_port(v))
    make_supervised_step(tps.get_loss)(
        state, torch.from_numpy(d["x"]), torch.from_numpy(d["cls"]),
        torch.from_numpy(d["target"]), LR, BN_MOMENTUM)
    for name, p in state.model.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), name
        assert bool(torch.isfinite(p).all()), name
