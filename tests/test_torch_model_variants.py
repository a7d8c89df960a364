"""The ``extra_layers`` and ``reconstruct`` variants of the port's
``pointnet2_part_seg_msg``, its AtlasNet and ``chamfer_loss_dense``
against the JAX package on the CPU.

JAX variables (random init, batch-norm statistics randomized) go through
``prifit_torch.convert`` into the port with ``strict=True``.  Tolerances:
``chamfer_loss_dense`` and its gradient within 1e-6 (relative, absolute
near 0); AtlasNet's output and per-chart running statistics after one
train forward within 1e-5, and the gradient of its chamfer within 1e-4;
the variants' eval logits within 1e-5; a B=2 f32 self-sup step's losses
within 1e-4 relative of JAX's and every gradient within ``JAX_RTOL``
(``test_torch_train.py``) of JAX's and ``F64_TOL`` of the port's float64
step, with the JAX model's ``selfsup`` draws pinned and passed to the
port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.convert import params_from_jax, state_dict_from_jax
from prifit_torch.models.common import chamfer_loss_dense
from prifit_torch.models.pointnet2_part_seg_msg import get_model
from prifit_torch.nn.atlasnet import AtlasNet
from prifit_torch.train.state import create_train_state
from prifit_torch.train.steps import make_selfsup_step
from prifit_tpu.models import get_module
from prifit_tpu.models.common import chamfer_loss_dense as j_chamfer
import prifit_tpu.models.pointnet2_part_seg_msg as j_msg
import prifit_tpu.nn.pointnet2 as j_pointnet2
from prifit_tpu.nn.atlasnet import AtlasNet as JAtlasNet
from prifit_tpu.train.torch_port import export_msg_state_dict
from test_torch_convex_options import KEY, jax_draws
from test_torch_grad import align_eigh_signs, jax_eigh
from test_torch_train import (BN_MOMENTUM, JAX_RTOL, LMBDA, LR, SS_KW,
                              _zero_grad_bias, blob_cloud)

torch.set_num_threads(1)

B, PARTS = 2, 50
N = 512
# the self-sup step's gradients against its float64 run, relative to
# each gradient's norm (test_variant_selfsup_step_matches_jax)
F64_TOL = 1e-2
J_BALL_QUERY = j_pointnet2.ball_query_nearest_shared
VARIANTS = {"extra_layers": dict(extra_layers=True),
            "reconstruct": dict(reconstruct=True)}


def _randomize_stats(stats, rng):
    def randomize(path, a):
        if str(path[-1].key).endswith("mean"):
            return rng.normal(size=a.shape).astype(np.float32) * 0.1
        return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(randomize, stats)


def test_chamfer_loss_dense_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 300, 3)).astype(np.float32)
    y = rng.normal(size=(2, 200, 3)).astype(np.float32)
    y[:, :5] = x[:, :5]             # coincident points: distances at 0
    jv, (gx, gy) = jax.value_and_grad(j_chamfer, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    tx, ty = (torch.from_numpy(a).requires_grad_() for a in (x, y))
    tv = chamfer_loss_dense(tx, ty)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-6)
    for g, r in ((tx.grad, gx), (ty.grad, gy)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6,
                                   atol=1e-6 * np.abs(r).max())


def _atlasnet_setup():
    """JAX's AtlasNet with the ``reconstruct`` variant's variables (its
    statistics randomized), the port's loaded from their conversion, and
    8 latents.  (With 3, each chart's batch statistics come from 3 codes
    and both sides' train-mode outputs are 2-3e-5 off a float64 run of
    the port, rounding either way.)"""
    v = _setup("reconstruct")["variables"]
    model = AtlasNet()
    model.load_state_dict(
        {k[len("atlasnet."):]: t for k, t in state_dict_from_jax(v).items()
         if k.startswith("atlasnet.")}, strict=True)
    z = np.random.default_rng(4).normal(size=(8, 128)).astype(np.float32)
    jv = {c: v[c]["atlasnet"] for c in ("params", "batch_stats")}
    return JAtlasNet(), jv, model, z, v


def test_atlasnet_matches_jax():
    """The 11 x 11 grid a chart (3025 points), the output in eval mode,
    and in train mode the output and each chart's running statistics."""
    jm, jv, model, z, v = _atlasnet_setup()
    assert model.decoder.bns[0].running_mean.shape == (25, 130)

    model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(z))
    ref = jm.apply(jv, jnp.asarray(z), False)
    assert out.shape == ref.shape == (8, 25 * 121, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)

    model.train()
    with torch.no_grad():
        out = model(torch.from_numpy(z), 0.3)
    ref, upd = jm.apply(jv, jnp.asarray(z), True, 0.3,
                        mutable=["batch_stats"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    new = state_dict_from_jax({"params": v["params"], "batch_stats": dict(
        v["batch_stats"], atlasnet=upd["batch_stats"])})
    for k, t in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(),
                                       new["atlasnet." + k].numpy(),
                                       atol=1e-5, err_msg=k)


def test_atlasnet_chamfer_gradient_matches_jax():
    """The gradient of ``chamfer_loss_dense(AtlasNet(z), y)`` in train
    mode, for every AtlasNet parameter and for ``z``, within 1e-4 of the
    norm of JAX's (measured: at most 1.1e-5), and the loss within 1e-6
    relative.  The dense biases under a batch norm have an analytically
    zero gradient: each is held within 1e-6 of its weight's gradient norm
    (measured: at most 3.5e-8)."""
    jm, jv, model, z, v = _atlasnet_setup()
    y = np.random.default_rng(5).uniform(-1, 1, (8, 300, 3)).astype(
        np.float32)

    def jloss(params, zz):
        out, _ = jm.apply({"params": params,
                           "batch_stats": jv["batch_stats"]}, zz, True,
                          0.3, mutable=["batch_stats"])
        return j_chamfer(out, jnp.asarray(y))

    jl, (jgp, jgz) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jv["params"], jnp.asarray(z))
    ref = {k[len("atlasnet."):]: t for k, t in params_from_jax(dict(
        v["params"], atlasnet=jax.tree_util.tree_map(np.asarray, jgp))
    ).items() if k.startswith("atlasnet.")}
    tz = torch.from_numpy(z).requires_grad_()
    model.train()
    loss = chamfer_loss_dense(model(tz, 0.3), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    grads = dict(model.named_parameters(), z=tz)
    ref["z"] = torch.from_numpy(np.array(jgz))
    assert set(grads) == set(ref)
    for name, p in grads.items():
        g, r = p.grad, ref[name].reshape(p.shape)
        if name.startswith("decoder.convs.") and name.endswith("bias") \
                and ".convs.3." not in name:
            w = grads[name[:-len("bias")] + "weight"].grad
            assert float(g.norm()) <= 1e-6 * float(w.norm()), name
            continue
        err = float((g - r).norm() / r.norm())
        assert err <= 1e-4, f"{name}: relative gradient error {err}"


def _jax_model(variant):
    return get_module("pointnet2_part_seg_msg").get_model(
        num_parts=PARTS, compute_dtype="f32", dropout_rate=0.0,
        **VARIANTS[variant])


@functools.lru_cache(maxsize=None)
def _setup(name):
    """A variant's JAX model, its variables (initialized with the
    embedding tower, statistics randomized; under ``extra_layers``
    ``fp1_embed_conv1``'s xyz weights scaled so that a cloud of 3 blobs
    gives several clusters, as ``test_torch_train.py`` scales fp1's),
    and the blob cloud."""
    rng = np.random.default_rng(31)
    x = blob_cloud(rng)
    cls = np.zeros((B, 16), np.float32)
    cls[:, 5] = 1.0
    model = _jax_model(name)
    xs = jnp.asarray(x[:, :256])
    v = jax.jit(lambda r: model.init(r, xs, jnp.asarray(cls), train=True,
                                     embed=True))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)})
    params = jax.tree_util.tree_map(np.array, v["params"])
    if name == "extra_layers":
        params["fp1_embed_conv1"]["kernel"][16:22] *= 30.0
    else:
        params["fp1"]["PointMLP_0"]["w0"][16:22] *= 30.0
    return dict(name=name, model=model, x=x, cls=cls,
                variables={"params": params, "batch_stats": _randomize_stats(
                    v["batch_stats"], rng)})


@pytest.fixture(params=list(VARIANTS))
def variant(request):
    return _setup(request.param)


def _port_model(name, variables):
    model = get_model(num_parts=PARTS, compute_dtype="f32", dropout_rate=0.0,
                      device="cpu", **VARIANTS[name])
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def test_variant_eval_logits_match_jax(variant):
    """Eval logits within 1e-5; under ``reconstruct`` also the
    reconstruction and its chamfer, the forward's ``total_loss``."""
    d = variant
    out = d["model"].apply(d["variables"], jnp.asarray(d["x"]),
                           jnp.asarray(d["cls"]), train=False)
    model = _port_model(d["name"], d["variables"]).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(d["x"]), torch.from_numpy(d["cls"]))
    np.testing.assert_allclose(got.seg_logits.numpy(),
                               np.asarray(out.seg_logits), atol=1e-5)
    if d["name"] == "reconstruct":
        np.testing.assert_allclose(got.recon_points.numpy(),
                                   np.asarray(out.recon_points), atol=1e-5)
        np.testing.assert_allclose(got.total_loss.item(),
                                   float(out.total_loss), rtol=1e-5)
        assert got.chamfer_loss.item() == 0.0
    else:
        assert got.recon_points is None


def _step_grads(d, sub, jit, dtype):
    """The port's self-sup step from ``d``'s variables with the draws
    ``sub``, ``jit``, run in ``dtype``: (metrics, state, gradients)."""
    state = create_train_state(_port_model(d["name"], d["variables"]))
    x, cls = (torch.from_numpy(d[k]).to(dtype) for k in ("x", "cls"))
    state.model.to(dtype)
    step = make_selfsup_step(**SS_KW, entropy_sub=sub, jitter=jit.to(dtype))
    _, metrics = step(state, x, cls, x, LR, BN_MOMENTUM, LMBDA)
    return metrics, state, {n: p.grad.float().clone()
                            for n, p in state.model.named_parameters()}


def _eager_ball_query(radius_list, nsample_list, xyz, new_xyz):
    """JAX's ``ball_query_nearest_shared``, run op by op on the host from
    inside a jitted function (test_variant_selfsup_step_matches_jax)."""
    def run(a, b):
        with jax.disable_jit():
            return tuple(np.asarray(i) for i in J_BALL_QUERY(
                radius_list, nsample_list, jnp.asarray(a), jnp.asarray(b)))

    shapes = tuple(jax.ShapeDtypeStruct(new_xyz.shape[:2] + (k,), jnp.int32)
                   for k in nsample_list)
    return list(jax.pure_callback(run, shapes, xyz, new_xyz))


def _assert_variant_grads(grads, ref, tol):
    """Each gradient within ``tol`` of its reference's norm, exactly 0
    where the reference is; the biases with an analytically zero
    gradient (``_zero_grad_bias``, the embedding tower's and AtlasNet's
    dense biases under a batch norm) aside."""
    for name, g in grads.items():
        if _zero_grad_bias(name) or name in (
                "conv1_embed.bias", "conv2_embed.bias") or (
                name.startswith("atlasnet.decoder.convs.")
                and name.endswith("bias") and ".convs.3" not in name):
            continue
        r = ref[name].reshape(g.shape)
        if not bool(r.any()):
            assert not bool(g.any()), name
            continue
        err = float((g - r).norm() / r.norm())
        assert err <= tol, f"{name}: relative gradient error {err}"


def test_variant_selfsup_step_matches_jax(variant, monkeypatch):
    """One B=2 f32 self-sup step from the JAX state (``beta`` 1), with
    several clusters a shape: ss_loss and chamfer within 1e-4 relative of
    JAX's, ``beta`` 0.99 as JAX's, and every gradient within ``JAX_RTOL``
    of JAX's (measured: at most 3.5e-2 under ``extra_layers``, 3.0e-2
    under ``reconstruct``, both in sa1) and ``F64_TOL`` of the same port
    step run in float64 (at most 5.4e-3 and 6.7e-3).

    JAX's step is jitted, with its ball query run op by op (a host
    callback): jitted, JAX rounds the squared distance of one point of
    shape 1, 4.3e-7 outside sa1's 0.2 radius in float64, to inside the
    ball, where its op-by-op run and the port leave it out.  That one
    neighbour moves JAX's gradients by up to 0.37 of their norm and its
    loss by 3e-4 relative; with the same neighbours JAX's whole jitted
    step agrees with its op-by-op run."""
    d = variant
    orig = j_msg.convex_loss
    monkeypatch.setattr(j_msg, "convex_loss", lambda *a, key=None, **k: orig(
        *a, key=None if key is None else KEY, **k))
    monkeypatch.setattr(j_pointnet2, "ball_query_nearest_shared",
                        _eager_ball_query)
    monkeypatch.setenv("PRIFIT_DET_FPS", "1")
    v = d["variables"]

    def jloss(params):
        out, upd = d["model"].apply(
            {"params": params, "batch_stats": v["batch_stats"],
             "selfsup_state": {"beta": jnp.ones((), jnp.float32)}},
            jnp.asarray(d["x"]), jnp.asarray(d["cls"]),
            chamfer_points=jnp.asarray(d["x"]), train=True,
            bn_momentum=BN_MOMENTUM,
            rngs={"sampling": jax.random.PRNGKey(4),
                  "dropout": jax.random.PRNGKey(5),
                  "selfsup": jax.random.PRNGKey(6)},
            mutable=["batch_stats", "selfsup_state"],
            include_convex_loss=True, **SS_KW)
        return jnp.mean(out.total_loss) * LMBDA, (
            out.chamfer_loss, out.convex.clusters.num_clusters,
            upd["selfsup_state"]["beta"])

    (jl, (jcham, nc, jbeta)), jg = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(v["params"])
    sub, jit = jax_draws(KEY, d["x"].shape[1], d["x"].shape)
    monkeypatch.undo()
    align_eigh_signs(monkeypatch, jax_eigh)
    metrics, state, grads = _step_grads(d, sub, jit, torch.float32)

    assert min(np.asarray(nc).tolist()) > 1
    np.testing.assert_allclose(metrics["ss_loss"].item(), float(jl),
                               rtol=1e-4)
    np.testing.assert_allclose(metrics["chamfer_loss"].item(), float(jcham),
                               rtol=1e-4, atol=1e-7)
    assert state.model.beta.item() == pytest.approx(float(jbeta)) \
        == pytest.approx(0.99)
    _assert_variant_grads(grads, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg)), JAX_RTOL)
    _assert_variant_grads(grads, _step_grads(d, sub, jit, torch.float64)[2],
                          F64_TOL)


def test_extra_layers_reference_state_dict_loads():
    """``export_msg_state_dict(variables, extra_layers=True)``, the
    reference's names, loads into the port (every entry but ``beta``,
    which the reference has not) and gives JAX's eval logits."""
    d = _setup("extra_layers")
    sd = export_msg_state_dict(d["variables"], extra_layers=True)
    model = get_model(num_parts=PARTS, compute_dtype="f32", device="cpu",
                      extra_layers=True)
    res = model.load_state_dict({k: torch.from_numpy(np.asarray(a)).reshape(
        model.state_dict()[k].shape) for k, a in sd.items()}, strict=False)
    assert res.missing_keys == ["beta"] and not res.unexpected_keys
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(d["x"]), torch.from_numpy(d["cls"]))
    out = d["model"].apply(d["variables"], jnp.asarray(d["x"]),
                           jnp.asarray(d["cls"]), train=False)
    np.testing.assert_allclose(got.seg_logits.numpy(),
                               np.asarray(out.seg_logits), atol=1e-5)


@pytest.mark.parametrize("spec", ["fp1:bf16", "fp1:fq", "fp1:mxsr"])
def test_extra_layers_refuses_an_fp1_dtype(spec):
    """As the JAX model (traced, not run): under ``extra_layers`` an
    explicit fp1 dtype raises (``fp1:q`` does not), and the default dtype
    leaves fp1 f32."""
    with pytest.raises(ValueError, match="extra_layers"):
        get_model(num_parts=PARTS, extra_layers=True, stage_dtypes=spec,
                  device="cpu")
    jm = get_module("pointnet2_part_seg_msg").get_model(
        num_parts=PARTS, extra_layers=True, stage_dtypes=spec)
    with pytest.raises(ValueError, match="extra_layers"):
        jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 3)), jnp.zeros((1, 16)),
            train=False))
    model = get_model(num_parts=PARTS, extra_layers=True,
                      stage_dtypes="fp1:q", device="cpu")
    assert model.fp1.dtype is None and model.quant["fp1"]
    assert get_model(num_parts=PARTS, extra_layers=True,
                     device="cpu").fp1.dtype is None
