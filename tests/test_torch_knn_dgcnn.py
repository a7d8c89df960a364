"""The port's kNN graphs, ``sample_and_group`` and DGCNN blocks against
the JAX package on the CPU.

Inputs come from numpy seeds; weights from the JAX modules' init, through
``prifit_torch.convert`` where a whole model is compared.  Tolerances:
the kNN graphs (``knn``, ``knn_with_dilation`` on 3 and 64 channels,
``knn_points_normals`` on 6) exactly equal, on clouds whose distances
have a margin; ``sample_and_group`` equal ``new_xyz`` and features within
1e-5; GroupNorm, ``get_graph_feature`` (with and without normals), each
edge convolution order at C=3 and C=64 fed the same graph, the encoder
fed JAX's graphs and ``DGCNNGn`` within 1e-5 of the largest entry.  A
kNN graph is discrete: where two distances are near-equal, matmuls that
round differently pick different neighbours, so the layers are held on
one graph given to both sides.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.convert import state_dict_from_jax
import prifit_torch.nn.dgcnn as tdg
from prifit_torch.nn.norm import GroupNorm
from prifit_torch.ops import pairwise as tpw
from prifit_torch.ops import sampling as tsamp
import prifit_tpu.nn.dgcnn as jdg
from prifit_tpu.ops import pairwise as jpw
from prifit_tpu.ops import sampling as jsamp

torch.set_num_threads(1)

B, N, K = 2, 192, 12
TOL = 1e-5


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _cloud(seed, c=3, n=N):
    return np.random.default_rng(seed).normal(size=(B, n, c)).astype(
        np.float32)


def _normals_cloud(seed, n=N):
    x = _cloud(seed, 6, n)
    x[..., 3:] /= np.linalg.norm(x[..., 3:], axis=-1, keepdims=True)
    return x


# (seed, N) of clouds whose kNN graphs have a margin (_margin_ok) at
# 3 and 64 channels, and of the 6-channel cloud with normals
MARGIN_CLOUDS = {3: (43, N), 64: (39, 96)}
NORMALS_SEED = 31


def _margin_ok(d, k):
    """The ``k + 1`` smallest of each row of the float64 distances ``d``
    are apart by more than 1e-5 relative, far more than f32 rounding
    moves them."""
    s = np.sort(d, axis=-1)[..., :k + 1]
    return bool((np.diff(s, axis=-1) > 1e-5 * (1 + s[..., 1:])).all())


def _d64(x):
    x = x.astype(np.float64)
    return ((x[:, :, None] - x[:, None]) ** 2).sum(-1)


@pytest.mark.parametrize("c", [3, 64])
def test_knn_and_dilation_match_jax(c):
    seed, n = MARGIN_CLOUDS[c]
    x = _cloud(seed, c, n)
    assert _margin_ok(_d64(x), 2 * K + 1)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_array_equal(tpw.knn(xt, K).numpy(),
                                  np.asarray(jpw.knn(xj, K)))
    for k1, k2 in ((K, 2 * K), (K, K), (5, 2 * K + 1)):
        np.testing.assert_array_equal(
            tpw.knn_with_dilation(xt, k1, k2).numpy(),
            np.asarray(jpw.knn_with_dilation(xj, k1, k2)))


def test_knn_points_normals_matches_jax():
    x = _normals_cloud(NORMALS_SEED)
    x64 = x.astype(np.float64)
    d = _d64(x[..., :3]) * (3.0 - 2.0 * np.einsum(
        "bnc,bmc->bnm", x64[..., 3:], x64[..., 3:]))
    assert _margin_ok(d, 2 * K)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for k1, k2 in ((K, 2 * K), (K, K), (2 * K, K)):
        np.testing.assert_array_equal(
            tpw.knn_points_normals(xt, k1, k2).numpy(),
            np.asarray(jpw.knn_points_normals(xj, k1, k2)))


@pytest.mark.parametrize("with_points", [True, False])
def test_sample_and_group_matches_jax(with_points):
    x = _cloud(3, n=256)
    f = _cloud(4, 5, n=256) if with_points else None
    jx, jp = jsamp.sample_and_group(
        64, 0.6, 16, jnp.asarray(x), None if f is None else jnp.asarray(f),
        deterministic=True)
    tx, tp = tsamp.sample_and_group(
        64, 0.6, 16, torch.from_numpy(x),
        None if f is None else torch.from_numpy(f))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert tp.shape == (B, 64, 16, 8 if with_points else 3)
    _close(tp, jp)


@pytest.mark.parametrize("groups,shape", [(2, (B, N, K, 64)),
                                          (8, (B, N, 512)),
                                          (4, (B, N, 256))])
def test_group_norm_matches_flax(groups, shape):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=shape[-1]).astype(np.float32)
    bias = rng.normal(size=shape[-1]).astype(np.float32)
    want = fnn.GroupNorm(num_groups=groups).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    gn = GroupNorm(groups, shape[-1])
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
    _close(gn(torch.from_numpy(x)), want)


def test_get_graph_feature_matches_jax():
    seed, n = MARGIN_CLOUDS[64]
    x = _cloud(seed, 64, n)
    want, jidx = jdg.get_graph_feature(jnp.asarray(x), K, 2 * K)
    got, idx = tdg.get_graph_feature(torch.from_numpy(x), K, 2 * K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(got, want)
    xn = _normals_cloud(NORMALS_SEED)
    want, jidx = jdg.get_graph_feature_with_normals(jnp.asarray(xn), K, K)
    got, idx = tdg.get_graph_feature_with_normals(torch.from_numpy(xn), K, K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(got, want)


def _edge_weights(conv, params):
    with torch.no_grad():
        k = np.asarray(params["kernel"])                   # [2C, F]
        conv.conv.weight.copy_(torch.from_numpy(k.T.copy())[..., None, None])
        conv.norm.weight.copy_(torch.from_numpy(
            np.array(params["GroupNorm_0"]["scale"])))
        conv.norm.bias.copy_(torch.from_numpy(
            np.array(params["GroupNorm_0"]["bias"])))


@pytest.mark.parametrize("c,features", [(3, 64), (64, 64), (64, 128)])
@pytest.mark.parametrize("order", ["proj", "edge"])
def test_edge_conv_orders_match_jax(monkeypatch, c, features, order):
    """Each order of the edge convolution at C=3 and C=64 on one graph,
    against the JAX ``_EdgeConv`` in the same order and against the
    reference layout (``get_graph_feature``, then the conv on every
    edge)."""
    x = _cloud(8, c)
    idx = np.array(jpw.knn(jnp.asarray(x), K))
    monkeypatch.setenv("PRIFIT_EDGECONV", order)
    jmod = jdg._EdgeConv(features, 2)
    rng = np.random.default_rng(9)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(idx))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(
            np.float32) * 0.1, v["params"])
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(idx))
    conv = tdg.EdgeConv(c, features, 2)
    _edge_weights(conv, params)
    xt, it = torch.from_numpy(x), torch.from_numpy(idx).long()
    got = conv(xt, it, order=order)
    _close(got, want)
    edges, _ = tdg.get_graph_feature(xt, K, K, idx=it)
    y = torch.matmul(edges, tdg.conv_weight(conv.conv).t())
    ref = torch.amax(torch.nn.functional.leaky_relu(conv.norm(y), 0.2), 2)
    _close(got, ref.detach().numpy())
    auto = conv(xt, it)
    assert torch.equal(auto, conv(xt, it, order="proj" if c >= features
                                  else "edge"))


def _record_graphs(monkeypatch):
    """Patch the JAX DGCNN's kNN functions to record their graphs, and
    return the list they go to, in call order."""
    graphs = []
    for name in ("knn_with_dilation", "knn_points_normals"):
        fn = getattr(jdg, name)

        def rec(*a, fn=fn):
            out = fn(*a)
            graphs.append(np.array(out))
            return out

        monkeypatch.setattr(jdg, name, rec)
    return graphs


def _replay_graphs(monkeypatch, graphs):
    it = iter(graphs)
    for name in ("knn_with_dilation", "knn_points_normals"):
        monkeypatch.setattr(tdg, name,
                            lambda *a: torch.from_numpy(next(it)).long())


@pytest.mark.parametrize("channels", [3, 6])
def test_dgcnn_gn_matches_jax(monkeypatch, channels):
    """``DGCNNGn`` (emb 32, 7 segments) on JAX's weights: the embedding
    and logits within 1e-5 on the port's own graphs (equal to JAX's here,
    asserted), and again with JAX's graphs replayed into the port."""
    x = _normals_cloud(10) if channels == 6 else _cloud(10)
    jmod = jdg.DGCNNGn(32, channels, K, 1, num_seg=7)
    graphs = _record_graphs(monkeypatch)
    v = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    graphs.clear()
    want = jmod.apply(v, jnp.asarray(x))
    model = tdg.DGCNNGn(32, channels, K, 1, num_seg=7)
    sd = state_dict_from_jax({"params": {"dgcnn": v["params"]}})
    model.load_state_dict({k[len("dgcnn."):]: t for k, t in sd.items()},
                          strict=True)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        own = model(xt)
        idx0 = (tpw.knn_points_normals(xt, K, K) if channels == 6
                else tpw.knn_with_dilation(xt, K, K))
        np.testing.assert_array_equal(idx0.numpy(), graphs[0])
        _replay_graphs(monkeypatch, graphs)
        replayed = model(xt)
    for got in (own, replayed):
        _close(got[0], want[0])
        _close(got[1], want[1])


def test_dgcnn_encoder_with_dilation_matches_jax(monkeypatch):
    """``DGCNNEncoderGn`` with dilation 2 fed JAX's graphs: the global
    and per-point features within 1e-5."""
    x = _cloud(11)
    jmod = jdg.DGCNNEncoderGn(3, K, 2)
    graphs = _record_graphs(monkeypatch)
    v = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    graphs.clear()
    want = jmod.apply(v, jnp.asarray(x))
    enc = tdg.DGCNNEncoderGn(3, K, 2)
    p = v["params"]
    with torch.no_grad():
        for i in range(3):
            _edge_weights(enc.edge_convs[i], p[f"_EdgeConv_{i}"])
        enc.conv.weight.copy_(torch.from_numpy(
            np.array(p["Dense_0"]["kernel"]).T.copy())[..., None])
        enc.conv.bias.copy_(torch.from_numpy(np.array(p["Dense_0"]["bias"])))
        enc.norm.weight.copy_(torch.from_numpy(
            np.array(p["GroupNorm_0"]["scale"])))
        enc.norm.bias.copy_(torch.from_numpy(
            np.array(p["GroupNorm_0"]["bias"])))
        _replay_graphs(monkeypatch, graphs)
        got = enc(torch.from_numpy(x))
    assert len(graphs) == 2 and graphs[0].shape == (B, N, K)
    _close(got[0], want[0])
    _close(got[1], want[1])
