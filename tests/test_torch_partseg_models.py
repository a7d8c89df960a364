"""The port's ``dgcnn`` and ``reconstruction`` models and the model
registry against the JAX package on the CPU.

JAX variables reach the port through ``prifit_torch.convert``
(``strict=True``).  DGCNN's kNN graphs are discrete, so both sides run on
JAX's graphs: they are recorded from a JAX forward on the same weights
and replayed into both models' kNN calls (the port's own first graph is
asserted equal, on a cloud with a margin).  Tolerances:

- the whole ``dgcnn`` forward at 3 and 6 input channels: logits and
  embedding within 1e-4 of their largest entry;
- a B=2 supervised step of ``dgcnn`` and of ``reconstruction`` (FPS from
  index 0, JAX's dropout patched out): the loss within 1e-5 relative,
  every gradient within 5e-2 of its norm (``test_torch_train.py``'s
  bound), the encoder's running statistics within 1e-5;
- the ``dgcnn`` self-sup forward with the convex loss (10 mean-shift
  steps, 6 slots) on 3 blobs a cloud, with more than one cluster a shape
  asserted and the eigenvector signs aligned: ``total_loss`` within 1e-4
  relative, every gradient within 5e-2 of its norm.  DGCNN's random
  embedding is nearly constant within a blob, so after one step the NMS
  representative is a near-tie of member counts; after ten the modes
  have converged and whichever is chosen gives the same loss;
- ``reconstruction``'s eval logits and ``recon_points`` within 1e-5, and
  ``get_rec_selfsup_loss`` (contrastive with JAX's uniforms plus the
  chamfer of the reconstruction) within 1e-5 relative.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prifit_torch.nn.dgcnn as tdg
import prifit_tpu.nn.dgcnn as jdg
from prifit_torch import models as tmodels
from prifit_torch.convert import params_from_jax, state_dict_from_jax
from prifit_torch.models import dgcnn as tdgcnn
from prifit_torch.models import reconstruction as trec
from prifit_torch.ops import pairwise as tpw
from prifit_torch.train.state import create_train_state
from prifit_torch.train.steps import make_selfsup_step, make_supervised_step
from prifit_tpu.models import dgcnn as jdgcnn
from prifit_tpu.models import reconstruction as jrec
from test_torch_grad import align_eigh_signs, jax_eigh
from test_torch_knn_dgcnn import MARGIN_CLOUDS, NORMALS_SEED
from test_torch_partseg_ssg import NoDropout, randomize_stats

torch.set_num_threads(1)

B, PARTS, K = 2, 50, 16
LR, BN_MOMENTUM, LMBDA = 1e-3, 0.1, 1.0
GRAD_RTOL = 5e-2
CONVEX_KW = dict(quantile=0.05, msc_iterations=10, max_num_clusters=6,
                n_per_prim=32, num_bandwidth_candidates=2)
KNN = ("knn_with_dilation", "knn_points_normals")


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _grads_close(model, ref, skip=lambda name: False):
    checked = 0
    for name, p in model.named_parameters():
        r = ref[name]
        if skip(name):
            continue
        if not bool(r.any()):
            assert p.grad is None or not bool(p.grad.any()), name
            continue
        err = float((p.grad - r).norm() / r.norm())
        assert err <= GRAD_RTOL, f"{name}: relative gradient error {err}"
        checked += 1
    return checked


def test_registry_resolves_six_models():
    """Every registry name resolves to a port module of that name (the
    six part-seg models the trainers build and, since the registry's
    last five were ported, the classifiers and sem-seg models)."""
    assert len(tmodels.MODEL_NAMES) == 11
    for name in tmodels.MODEL_NAMES:
        mod = tmodels.get_module(name)
        assert mod.__name__ == f"prifit_torch.models.{name}"
        assert mod.get_model is not None and mod.get_loss is not None
    assert len(tmodels.PART_SEG) == 6
    assert tmodels.get_module("dgcnn_part") is tdgcnn
    with pytest.raises(ValueError, match="unknown model"):
        tmodels.get_module("nope")


# ------------------------------------------------------------- dgcnn

class graphs_of_jax:
    """Records the kNN graphs a JAX DGCNN forward computes (``record``),
    then hands the same graphs, in call order, to every later kNN call of
    the JAX model and of the port (``replay``, under ``monkeypatch``)."""

    def __init__(self, monkeypatch):
        self.mp, self.graphs = monkeypatch, []

    def record(self, fn):
        with pytest.MonkeyPatch.context() as mp:
            for name in KNN:
                real = getattr(jdg, name)

                def rec(*a, real=real):
                    out = real(*a)
                    self.graphs.append(np.array(out))
                    return out

                mp.setattr(jdg, name, rec)
            fn()
        return self.graphs

    def replay(self):
        state = {"jax": 0, "port": 0}

        def take(side, wrap):
            def fn(*a):
                i = state[side]
                state[side] += 1
                return wrap(self.graphs[i % len(self.graphs)])
            return fn

        for name in KNN:
            self.mp.setattr(jdg, name, take("jax", jnp.asarray))
            self.mp.setattr(tdg, name,
                            take("port", lambda g: torch.from_numpy(g).long()))


def _dgcnn_cloud(channels):
    if channels == 6:
        x = np.random.default_rng(NORMALS_SEED).normal(
            size=(B, 192, 6)).astype(np.float32)
        x[..., 3:] /= np.linalg.norm(x[..., 3:], axis=-1, keepdims=True)
        return x
    seed, n = MARGIN_CLOUDS[3]
    return np.random.default_rng(seed).normal(size=(B, n, 3)).astype(
        np.float32)


def _dgcnn_pair(channels, seed=0):
    jmod = jdgcnn.get_model(num_parts=PARTS, nn_nb=K,
                            normal_channel=channels == 6)
    x = _dgcnn_cloud(channels)
    v = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    model = tdgcnn.get_model(PARTS, nn_nb=K, normal_channel=channels == 6,
                             device="cpu")
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    return jmod, v, model, x


@pytest.mark.parametrize("channels", [3, 6])
def test_dgcnn_forward_matches_jax(monkeypatch, channels):
    jmod, v, model, x = _dgcnn_pair(channels)
    graphs = graphs_of_jax(monkeypatch)
    graphs.record(lambda: jmod.apply(v, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    own = (tpw.knn_points_normals(xt, K, K) if channels == 6
           else tpw.knn_with_dilation(xt, K, K))
    np.testing.assert_array_equal(own.numpy(), graphs.graphs[0])
    graphs.replay()
    want = jax.jit(jmod.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(xt)
    assert got.seg_logits.shape == (B, x.shape[1], PARTS)
    _close(got.seg_logits, want.seg_logits, 1e-4)
    _close(got.feat, want.feat, 1e-4)
    assert got.hidden is None and got.total_loss.item() == 0.0


def test_dgcnn_supervised_step_matches_jax(monkeypatch):
    jmod, v, model, x = _dgcnn_pair(3, seed=1)
    graphs = graphs_of_jax(monkeypatch)
    graphs.record(lambda: jmod.apply(v, jnp.asarray(x)))
    graphs.replay()
    target = np.random.default_rng(2).integers(0, PARTS, size=x.shape[:2])

    def loss(params):
        out = jmod.apply({"params": params}, jnp.asarray(x))
        return jdgcnn.get_loss(out.seg_logits, jnp.asarray(target))

    lv, grads = jax.jit(jax.value_and_grad(loss))(v["params"])
    state = create_train_state(model)
    _, m = make_supervised_step(tdgcnn.get_loss)(
        state, torch.from_numpy(x), torch.zeros(B, 16),
        torch.from_numpy(target), LR, BN_MOMENTUM)
    np.testing.assert_allclose(m["loss"].item(), float(lv), rtol=1e-5)
    # the embedding does not reach the supervised loss
    assert _grads_close(model, params_from_jax(grads)) == 27


def _blobs(n=192, seed=31):
    """``[B, n, 3]``: each cloud 3 gaussian blobs 4 apart (spread 0.3)."""
    rng = np.random.default_rng(seed)
    lab = np.arange(n) % 3
    return np.stack([np.eye(3)[rng.permutation(lab)] * 4.0
                     + rng.normal(size=(n, 3)) * 0.3
                     for _ in range(B)]).astype(np.float32)


def test_dgcnn_selfsup_matches_jax(monkeypatch):
    """The self-sup forward with the convex loss and its gradient on 3
    blobs a cloud (the model's entropy weight stays 1: no options on)."""
    jmod = jdgcnn.get_model(num_parts=PARTS, nn_nb=K)
    x = _blobs()
    xj = jnp.asarray(x)
    v = jmod.init(jax.random.PRNGKey(3), xj)
    model = tdgcnn.get_model(PARTS, nn_nb=K, device="cpu")
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    graphs = graphs_of_jax(monkeypatch)
    graphs.record(lambda: jmod.apply(v, xj))
    graphs.replay()
    align_eigh_signs(monkeypatch, jax_eigh)

    def loss(params):
        out = jmod.apply({"params": params}, xj, chamfer_points=xj,
                         train=True, include_convex_loss=True,
                         rngs={"selfsup": jax.random.PRNGKey(7)},
                         **CONVEX_KW)
        return jnp.mean(out.total_loss) * LMBDA, (
            out.convex.clusters.num_clusters, out.chamfer_loss)

    (lv, (nc, cham)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"])
    assert bool((np.asarray(nc) > 1).all()), nc
    state = create_train_state(model)
    _, m = make_selfsup_step(**CONVEX_KW)(
        state, torch.from_numpy(x), torch.zeros(B, 16), torch.from_numpy(x),
        LR, BN_MOMENTUM, LMBDA)
    np.testing.assert_allclose(m["ss_loss"].item(), float(lv), rtol=1e-4)
    np.testing.assert_allclose(m["chamfer_loss"].item(), float(cham),
                               rtol=1e-4)
    # the segmentation logits do not reach the self-sup loss
    assert _grads_close(model, params_from_jax(grads)) == 26


# ---------------------------------------------------- reconstruction

@pytest.fixture(scope="module")
def rec_setup():
    """JAX ``reconstruction`` variables (statistics randomized), a batch,
    and JAX's eval forward and jitted train-mode loss and gradients with
    the FPS start pinned and dropout patched out."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRIFIT_DET_FPS", "1")
        mp.setattr(fnn, "Dropout", NoDropout)
        rng = np.random.default_rng(23)
        x = rng.normal(size=(B, 512, 3)).astype(np.float32)
        cls = np.zeros((B, 16), np.float32)
        cls[:, 5] = 1.0
        target = rng.integers(0, PARTS, size=(B, 512))
        jmod = jrec.get_model(num_classes=PARTS)
        xj, cj = jnp.asarray(x), jnp.asarray(cls)
        v = jax.jit(lambda r: jmod.init(r, xj, cj, train=False))(
            {"params": jax.random.PRNGKey(0),
             "sampling": jax.random.PRNGKey(1),
             "dropout": jax.random.PRNGKey(2)})
        v = {"params": jax.tree_util.tree_map(np.array, v["params"]),
             "batch_stats": randomize_stats(v["batch_stats"], rng)}
        ev = jax.jit(lambda v: jmod.apply(v, xj, cj, train=False))(v)

        def sup(params):
            out, upd = jmod.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, xj, cj,
                train=True, bn_momentum=BN_MOMENTUM,
                rngs={"sampling": jax.random.PRNGKey(4),
                      "dropout": jax.random.PRNGKey(5)},
                mutable=["batch_stats"])
            return jrec.get_loss(out.seg_logits, jnp.asarray(target)), \
                upd["batch_stats"]

        (loss, stats), grads = jax.jit(jax.value_and_grad(
            sup, has_aux=True))(v["params"])
    return dict(x=x, cls=cls, target=target, v=v, ev=ev, loss=float(loss),
                stats=stats, grads=params_from_jax(grads))


def _rec_port(v):
    model = trec.get_model(PARTS, dropout_rate=0.0, device="cpu")
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    return model


def test_reconstruction_eval_forward_matches_jax(rec_setup):
    d = rec_setup
    with torch.no_grad():
        got = _rec_port(d["v"]).eval()(torch.from_numpy(d["x"]),
                                       torch.from_numpy(d["cls"]))
    assert got.recon_points.shape == (B, 25 * 121, 3)
    _close(got.seg_logits, d["ev"].seg_logits, 1e-5)
    _close(got.feat, d["ev"].feat, 1e-5)
    _close(got.recon_points, d["ev"].recon_points, 1e-5)
    for a, b in zip(got.hidden, d["ev"].hidden):
        _close(a, b, 1e-5)
    assert got.total_loss.item() == 0.0 and got.convex is None


def _zero_grad_bias(name):
    """Dense biases a batch norm follows, and sa3's last batch-norm bias:
    analytically zero gradients (``test_torch_train.py``)."""
    return name.endswith(".bias") and (
        ".conv_blocks." in name or ".mlp_convs." in name
        or name in ("conv1.bias", "sa3.mlp_bns.2.bias"))


def test_reconstruction_supervised_step_matches_jax(rec_setup):
    """AtlasNet runs in the forward but does not reach the loss: its
    gradients are 0 on both sides.  Its per-chart statistics come from
    one latent a cloud (2 rows of distinct values a chart), where
    train-mode batch norm is ill-conditioned (``test_torch_model_
    variants.py``), so only the encoder's statistics are compared."""
    d = rec_setup
    state = create_train_state(_rec_port(d["v"]))
    _, m = make_supervised_step(trec.get_loss)(
        state, torch.from_numpy(d["x"]), torch.from_numpy(d["cls"]),
        torch.from_numpy(d["target"]), LR, BN_MOMENTUM)
    np.testing.assert_allclose(m["loss"].item(), d["loss"], rtol=1e-5)
    assert _grads_close(state.model, d["grads"], _zero_grad_bias) > 60
    want = state_dict_from_jax({"params": d["v"]["params"],
                                "batch_stats": d["stats"]})
    for name, t in state.model.named_buffers():
        if not name.startswith("atlasnet.") and "running" in name:
            _close(t, want[name], 1e-5)


def test_rec_selfsup_loss_matches_jax():
    rng = np.random.default_rng(9)
    feat = rng.normal(size=(B, 256, 32)).astype(np.float32)
    target = rng.integers(0, 5, size=(B, 256))
    pts = rng.normal(size=(B, 300, 3)).astype(np.float32)
    gt = rng.normal(size=(B, 256, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (B, 256, 256))))
    for lcont, lrec in ((0.0, 1.0), (0.5, 2.0)):
        want = jrec.get_rec_selfsup_loss(
            jnp.asarray(feat), jnp.asarray(target), jnp.asarray(pts),
            jnp.asarray(gt), key, lcont=lcont, lrec=lrec)
        got = trec.get_rec_selfsup_loss(
            torch.from_numpy(feat), torch.from_numpy(target),
            torch.from_numpy(pts), torch.from_numpy(gt), lcont=lcont,
            lrec=lrec, uniforms=u)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
