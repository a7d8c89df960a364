"""The port's single-scale SA layer and ``pointnet2_part_seg_ssg``
against the JAX package on the CPU.

JAX variables (init, batch-norm statistics randomized) reach the port
through ``prifit_torch.convert`` (``strict=True`` for the model; the SSG
grouped first layer's weight has the xyz columns FIRST).  FPS starts at
index 0 on both sides (``PRIFIT_DET_FPS=1``) and the JAX model's dropout,
which it fixes at 0.5, is patched out (the port's is 0).  Tolerances:

- ``SetAbstraction``, fused (nearest-k) and unfused (first-k by index)
  ball query, raw-gather (d_in = 3) and project-first (d_in = 64) first
  layer, eval and train: equal ``new_xyz``, features and running
  statistics within 1e-5 of their largest entry;
- one B=2 f32 supervised step: the loss within 1e-5 relative, every
  gradient within 5e-2 of its norm (``test_torch_train.py``'s bound),
  the running statistics within 1e-5;
- one zero-loss self-sup step from the same state (the model has no
  convex loss; JAX's step still applies Adam's weight decay and moves
  the statistics): every parameter within 1e-6, every running statistic
  within 1e-5;
- one ``mxsr`` supervised step with JAX's ``_mx_key`` patched to the
  port's key scheme: within twice JAX's own spread under the input
  scaled by 1 +- 2^-20, as ``test_torch_mixed.py`` holds the MSG model.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prifit_tpu.nn.pointnet2 as jpn2
from prifit_torch.convert import (
    _convert,
    _ssg_entries,
    params_from_jax,
    state_dict_from_jax,
)
from prifit_torch.models import pointnet2_part_seg_ssg as tssg
from prifit_torch.nn import mixed as M
from prifit_torch.nn.pointnet2 import SetAbstraction
from prifit_torch.train.state import create_train_state
from prifit_torch.train.steps import make_selfsup_step, make_supervised_step
from prifit_tpu.models import pointnet2_part_seg_ssg as jssg
from prifit_tpu.train.state import TrainState as JTrainState
from prifit_tpu.train.state import make_optimizer as j_make_optimizer
from prifit_tpu.train.steps import make_selfsup_step as j_make_selfsup_step
from test_torch_mixed import BASE, DELTA, _jkey, _spread

torch.set_num_threads(1)

B, N, PARTS = 2, 512, 50
LR, BN_MOMENTUM, LMBDA = 1e-3, 0.1, 1.0
TOL = 1e-5
GRAD_RTOL = 5e-2
SS_KW = dict(quantile=0.2, msc_iterations=2, max_num_clusters=4,
             n_per_prim=16)


class NoDropout(fnn.Module):
    """Stands in for ``flax.linen.Dropout``: the identity."""
    rate: float = 0.0
    deterministic: bool | None = None

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def randomize_stats(stats, rng):
    def randomize(path, a):
        if str(path[-1].key).endswith("mean"):
            return rng.normal(size=a.shape).astype(np.float32) * 0.1
        return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(randomize, stats)


def _sa_state_dict(params, stats):
    """The state_dict of one SSG SA layer from its JAX variables (the
    model's ``sa1`` rows)."""
    sd = _convert({"sa1": params}, {"sa1": stats},
                  [r for r in _ssg_entries() if r[0].startswith("sa1.")])
    return {k[len("sa1."):]: t for k, t in sd.items()}


@pytest.mark.parametrize("d_in", [3, 64])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("train", [False, True])
def test_set_abstraction_matches_jax(monkeypatch, d_in, fused, train):
    monkeypatch.setenv("PRIFIT_DET_FPS", "1")
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(B, 256, 3)).astype(np.float32)
    pts = rng.normal(size=(B, 256, d_in)).astype(np.float32)
    jmod = jpn2.SetAbstraction(64, 0.6, 16, [32, 32, 64], fused=fused)
    args = (jnp.asarray(xyz), jnp.asarray(pts))
    v = jmod.init({"params": jax.random.PRNGKey(0),
                   "sampling": jax.random.PRNGKey(1)}, *args, False)
    v = {"params": v["params"],
         "batch_stats": randomize_stats(v["batch_stats"], rng)}
    (jx, jf), upd = jmod.apply(v, *args, train, 0.1,
                               mutable=["batch_stats"])
    sa = SetAbstraction(64, 0.6, 16, d_in, [32, 32, 64], fused=fused)
    sa.load_state_dict(_sa_state_dict(v["params"], v["batch_stats"]),
                       strict=True)
    tx, tf = sa.train(train)(torch.from_numpy(xyz), torch.from_numpy(pts))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    _close(tf, jf)
    want = _sa_state_dict(v["params"], upd["batch_stats"])
    for name, t in sa.state_dict().items():
        if "running" in name:
            _close(t, want[name])


def _data(rng):
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    cls = np.zeros((B, 16), np.float32)
    cls[:, 2] = 1.0
    return x, cls, rng.integers(0, PARTS, size=(B, N))


def _variables(jmod, rng, x, cls):
    v = jax.jit(lambda r: jmod.init(r, jnp.asarray(x[:, :N]),
                                    jnp.asarray(cls), train=False))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)})
    return {"params": jax.tree_util.tree_map(np.array, v["params"]),
            "batch_stats": randomize_stats(v["batch_stats"], rng)}


def _port(v, compute_dtype="f32"):
    m = tssg.get_model(PARTS, compute_dtype=compute_dtype, dropout_rate=0.0,
                       device="cpu")
    m.load_state_dict(state_dict_from_jax(v), strict=True)
    return create_train_state(m)


RNGS = {"sampling": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(5)}


@pytest.fixture(scope="module")
def f32_runs():
    """The JAX f32 model's jitted supervised loss and gradients, and its
    jitted self-sup step (zero loss) from the same state, with the FPS
    start pinned and dropout patched out."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRIFIT_DET_FPS", "1")
        mp.setattr(fnn, "Dropout", NoDropout)
        rng = np.random.default_rng(21)
        x, cls, target = _data(rng)
        jmod = jssg.get_model(PARTS, compute_dtype="f32")
        v = _variables(jmod, rng, x, cls)
        xj, cj = jnp.asarray(x), jnp.asarray(cls)

        def sup(params):
            out, upd = jmod.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, xj, cj,
                train=True, bn_momentum=BN_MOMENTUM, rngs=RNGS,
                mutable=["batch_stats"])
            return jssg.get_loss(out.seg_logits, jnp.asarray(target)), \
                upd["batch_stats"]

        (loss, stats), grads = jax.jit(jax.value_and_grad(
            sup, has_aux=True))(v["params"])
        tx = j_make_optimizer("Adam", 1e-4)
        jstate = JTrainState(step=jnp.zeros((), jnp.int32),
                             params=v["params"],
                             batch_stats=v["batch_stats"], selfsup_state={},
                             opt_state=tx.init(v["params"]), tx=tx)
        ss_step = j_make_selfsup_step(jmod, include_convex_loss=True,
                                      **SS_KW)
        jstate, ss_m = ss_step(jstate, xj, xj, cj, LR, BN_MOMENTUM, LMBDA,
                               jax.random.PRNGKey(6))
    return dict(x=x, cls=cls, target=target, v=v, loss=float(loss),
                stats=stats, grads=params_from_jax(grads),
                ss_state=jstate, ss_loss=float(ss_m["ss_loss"]))


def _tensors(d, *keys):
    return [torch.from_numpy(d[k]) for k in keys]


def _zero_grad_bias(name):
    """A dense bias a batch norm follows, and sa3's last batch-norm bias
    (fp3's first batch norm removes its shift): analytically zero
    gradients, rounding noise on both sides."""
    return name.endswith(".bias") and (".mlp_convs." in name or name in (
        "conv1.bias", "sa3.mlp_bns.2.bias"))


def test_supervised_step_matches_jax(f32_runs):
    d = f32_runs
    state = _port(d["v"])
    _, m = make_supervised_step(tssg.get_loss)(
        state, *_tensors(d, "x", "cls", "target"), LR, BN_MOMENTUM)
    np.testing.assert_allclose(m["loss"].item(), d["loss"], rtol=TOL)
    checked = 0
    for name, p in state.model.named_parameters():
        if _zero_grad_bias(name):
            continue
        r = d["grads"][name]
        err = float((p.grad - r).norm() / r.norm())
        assert err <= GRAD_RTOL, f"{name}: relative gradient error {err}"
        checked += 1
    assert checked > 40
    want = state_dict_from_jax({"params": d["v"]["params"],
                                "batch_stats": d["stats"]})
    for name, t in state.model.named_buffers():
        _close(t, want[name])


def test_zero_loss_selfsup_step_matches_jax(f32_runs):
    """The self-sup step of a model with no convex loss: ``ss_loss`` is
    0, the step still runs (it raised before: a constant 0 has no
    gradient), every parameter moves as JAX's Adam with coupled weight
    decay moves it on zero gradients, and the batch-norm statistics
    take the forward's batch."""
    d = f32_runs
    state = _port(d["v"])
    before = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}
    _, m = make_selfsup_step(**SS_KW)(
        state, *_tensors(d, "x", "cls", "x"), LR, BN_MOMENTUM, LMBDA)
    assert m["ss_loss"].item() == 0.0 == d["ss_loss"]
    assert state.step == 1
    js = d["ss_state"]
    want = state_dict_from_jax({"params": js.params,
                                "batch_stats": js.batch_stats})
    moved = 0
    for name, t in state.model.state_dict().items():
        # a statistic is an f32 sum over the batch in another order: 1e-5
        # of its largest entry, as elsewhere (2.5e-6 measured)
        tol = 1e-6 if name in before else 1e-5
        _close(t, want[name], tol)
        if name in before:
            moved += not torch.equal(t, before[name])
    # every parameter but the zero-initialized biases (decay of 0 is 0)
    assert moved == sum(bool(p.any()) for p in before.values())


@pytest.fixture(scope="module")
def mxsr_runs():
    """The JAX ``mxsr`` model's jitted supervised loss, gradients and
    statistics on the data and on the data scaled by 1 +- 2^-20, with
    ``_mx_key`` patched to hand the regions ``fold_in(BASE, i)`` in call
    order (the port's scheme), and the port's step with ``sr_key=BASE``
    from the same weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRIFIT_DET_FPS", "1")
        mp.setattr(fnn, "Dropout", NoDropout)
        calls = [0]

        def mx_key(mod):
            i = calls[0]
            calls[0] += 1
            return _jkey(M.fold_in(BASE, i))

        mp.setattr(jpn2, "_mx_key", mx_key)
        rng = np.random.default_rng(22)
        x, cls, target = _data(rng)
        jmod = jssg.get_model(PARTS, compute_dtype="mxsr")
        v = _variables(jmod, rng, x, cls)

        def sup(params, xx):
            calls[0] = 0
            out, upd = jmod.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, xx,
                jnp.asarray(cls), train=True, bn_momentum=BN_MOMENTUM,
                rngs=RNGS, mutable=["batch_stats"])
            return jssg.get_loss(out.seg_logits, jnp.asarray(target)), \
                upd["batch_stats"]

        fn = jax.jit(jax.value_and_grad(sup, has_aux=True))
        runs = []
        for s in (1.0, 1.0 + DELTA, 1.0 - DELTA):
            (loss, stats), grads = fn(v["params"],
                                      jnp.asarray(x * np.float32(s)))
            runs.append(dict(loss=float(loss), grads=params_from_jax(grads),
                             stats=state_dict_from_jax(
                                 {"params": v["params"],
                                  "batch_stats": stats})))
        assert calls[0] == 6
    state = _port(v, "mxsr")
    _, m = make_supervised_step(tssg.get_loss)(
        state, torch.from_numpy(x), torch.from_numpy(cls),
        torch.from_numpy(target), LR, BN_MOMENTUM, sr_key=BASE)
    port = dict(loss=m["loss"].item(),
                grads={n: p.grad.clone()
                       for n, p in state.model.named_parameters()},
                stats=dict(state.model.named_buffers()))
    return port, runs


def test_mxsr_supervised_step_matches_jax(mxsr_runs):
    """bf16 storage makes the gradient at this size chaotic (ties in the
    bf16 K-max and relu boundaries flip under a 2^-20 change of the
    input), so each quantity is held within twice JAX's own spread under
    that change, plus the f32 floors (``test_torch_mixed.py``)."""
    port, runs = mxsr_runs
    ref = runs[0]
    assert abs(port["loss"] - ref["loss"]) <= 2 * _spread(
        runs, lambda r: r["loss"]) + 1e-6 * abs(ref["loss"])
    checked = 0
    for name, r in ref["grads"].items():
        if _zero_grad_bias(name):
            continue
        g = port["grads"][name]
        err = float((g - r).norm() / r.norm())
        own = max(float((j["grads"][name] - r).norm() / r.norm())
                  for j in runs[1:])
        assert err <= 2 * own + GRAD_RTOL, (name, err, own)
        checked += 1
    assert checked > 40
    for name, buf in port["stats"].items():
        spread = _spread(runs, lambda j: j["stats"][name].numpy())
        np.testing.assert_allclose(buf.numpy(), ref["stats"][name],
                                   rtol=0, atol=2 * spread + 1e-5,
                                   err_msg=name)


def test_mxsr_regions_and_keys(monkeypatch):
    """In ``mxsr`` training the six encoder stages run as regions in
    forward call order, sa1-3 with the K-max and the FP chains without,
    each with the key ``fold_in(base, i)``; without a generator or a key
    the forward raises."""
    import prifit_torch.nn.pointnet2 as tpn2
    calls = []
    real = tpn2.mx_chain

    def record(cfg, pre, params, key=None, **k):
        calls.append((cfg[:2], key))
        return real(cfg, pre, params, key, **k)

    monkeypatch.setattr(tpn2, "mx_chain", record)
    model = tssg.get_model(PARTS, dropout_rate=0.0, device="cpu").train()
    x = torch.from_numpy(_data(np.random.default_rng(0))[0][:1])
    model(x, torch.zeros(1, 16), sr_key=BASE)
    assert [c[0] for c in calls] == [(True, True)] * 2 + [(False, True)] + [
        (False, False)] * 3
    assert [c[1] for c in calls] == [M.fold_in(BASE, i) for i in range(6)]
    with pytest.raises(ValueError, match="generator"):
        model(x, torch.zeros(1, 16))
